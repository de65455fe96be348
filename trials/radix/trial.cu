// design trial: variants of the radix hist and scatter kernels
#include <cuda_runtime.h>
#include <stdint.h>
#define TILE 4096
#define FULL 0xffffffffu

__device__ __forceinline__ int dig(int k, int s) { return (k >> s) & 255; }
__device__ __forceinline__ unsigned match_ballot(int d) {
  unsigned p = FULL;
#pragma unroll
  for (int b = 0; b < 8; ++b) { bool bit = (d >> b) & 1; unsigned o = __ballot_sync(FULL, bit); p &= bit ? o : ~o; }
  return p;
}
__device__ __forceinline__ void cp16(void* s, const void* g) {
  unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(a), "l"(g) : "memory");
}

// ---------------- hist: MATCH 0 ballot, 1 match_any, 2 per-warp atomic, 3 block atomic, 4 per-warp atomic x2 parts
template <int MATCH>
__global__ void __launch_bounds__(256) hist_k(const int* __restrict__ key, int* __restrict__ hist, long long n, int shift) {
  __shared__ int cnt[8][256 * (MATCH == 4 ? 2 : 1)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 8 * 256 * (MATCH == 4 ? 2 : 1); i += 256) (&cnt[0][0])[i] = 0;
  __syncthreads();
  const long long wrow = (long long)blockIdx.x * TILE + warp * 512;
  const int4* src = reinterpret_cast<const int4*>(key + wrow);
  int4 q[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = __ldg(src + c * 32 + lane);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int ks[4] = {q[c].x, q[c].y, q[c].z, q[c].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = dig(ks[j], shift);
      if (MATCH == 0) { unsigned p = match_ballot(d); if (__ffs(p) - 1 == lane) atomicAdd(&cnt[warp][d], __popc(p)); }
      else if (MATCH == 1) { unsigned p = __match_any_sync(FULL, d); if (__ffs(p) - 1 == lane) atomicAdd(&cnt[warp][d], __popc(p)); }
      else if (MATCH == 2) atomicAdd(&cnt[warp][d], 1);
      else if (MATCH == 3) atomicAdd(&cnt[0][d], 1);
      else atomicAdd(&cnt[warp][2 * d + (lane & 1)], 1);
    }
  }
  __syncthreads();
  int tot = 0;
  if (MATCH == 3) tot = cnt[0][threadIdx.x];
  else if (MATCH == 4) { for (int w = 0; w < 8; ++w) tot += cnt[w][2 * threadIdx.x] + cnt[w][2 * threadIdx.x + 1]; }
  else { for (int w = 0; w < 8; ++w) tot += cnt[w][threadIdx.x]; }
  hist[(long long)blockIdx.x * 256 + threadIdx.x] = tot;
}

// ---------------- scatter: WARPS per block, MATCH 0 ballot, 1 match_any, 2 atomicOr; MINB launch bound
template <int WARPS, int MATCH, int MINB>
__global__ void __launch_bounds__(WARPS * 32, MINB)
scatter_k(const int* __restrict__ key, const int* __restrict__ val, const int* __restrict__ off,
          int* __restrict__ ko, int* __restrict__ vo, long long n, int shift) {
  constexpr int T = WARPS * 32, WR = TILE / WARPS, ST = WR / 32;
  extern __shared__ __align__(16) int sm[];
  int* skey = sm; int* sval = sm + TILE; int* cnt = sm + 2 * TILE;   // [WARPS][256]
  int* msk = cnt + WARPS * 256;                                       // [WARPS][256] (MATCH 2)
  int* delta = msk + (MATCH == 2 ? WARPS * 256 : 0); int* wsum = delta + 256;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  const int wb = warp * WR;
  for (int q = lane; q < WR / 4; q += 32) { cp16(skey + wb + 4 * q, key + base + wb + 4 * q); cp16(sval + wb + 4 * q, val + base + wb + 4 * q); }
  int* wc = cnt + warp * 256; int* wm = msk + warp * 256;
  for (int d = lane; d < 256; d += 32) { wc[d] = 0; if (MATCH == 2) wm[d] = 0; }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  int k[ST], r[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    k[s] = skey[wb + s * 32 + lane];
    const int d = dig(k[s], shift);
    unsigned p;
    if (MATCH == 0) p = match_ballot(d);
    else if (MATCH == 1) p = __match_any_sync(FULL, d);
    else { atomicOr((unsigned*)&wm[d], 1u << lane); __syncwarp(); p = (unsigned)wm[d]; }
    const int seen = wc[d];
    r[s] = seen + __popc(p & below);
    __syncwarp();
    if ((p >> lane) == 1u) { wc[d] = seen + __popc(p); if (MATCH == 2) wm[d] = 0; }
    __syncwarp();
  }
  __syncthreads();
  if (tid < 256) {
    int tot = 0;
    for (int w = 0; w < WARPS; ++w) { int c = cnt[w * 256 + tid]; cnt[w * 256 + tid] = tot; tot += c; }
    int inc = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) { int y = __shfl_up_sync(FULL, inc, o); if (lane >= o) inc += y; }
    if (lane == 31) wsum[warp] = inc;
    delta[tid] = inc - tot;
  }
  __syncthreads();
  if (tid < 256) {
    int start = delta[tid];
    for (int w = 0; w < warp; ++w) start += wsum[w];
    for (int w = 0; w < WARPS; ++w) cnt[w * 256 + tid] += start;
    delta[tid] = off[blockIdx.x * 256LL + tid] - start;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < ST; ++s) { r[s] += wc[dig(k[s], shift)]; skey[r[s]] = k[s]; }
  int v[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) v[s] = sval[wb + s * 32 + lane];
  __syncthreads();
#pragma unroll
  for (int s = 0; s < ST; ++s) sval[r[s]] = v[s];
  __syncthreads();
  for (int j = tid; j < TILE; j += T) {
    const int kk = skey[j];
    const long long pos = (long long)delta[dig(kk, shift)] + j;
    ko[pos] = kk; vo[pos] = sval[j];
  }
}

template <int W, int M, int B>
static int launch_sc(const int* key, const int* val, const int* off, int* ko, int* vo, long long n, int shift, void* st) {
  const int smem = (2 * TILE + W * 256 * (M == 2 ? 2 : 1) + 256 + 16) * 4;
  cudaFuncSetAttribute(scatter_k<W, M, B>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  scatter_k<W, M, B><<<(unsigned)(n / TILE), W * 32, smem, (cudaStream_t)st>>>(key, val, off, ko, vo, n, shift);
  return (int)cudaGetLastError();
}
template <int M>
static int launch_h(const int* key, int* hist, long long n, int shift, void* st) {
  hist_k<M><<<(unsigned)(n / TILE), 256, 0, (cudaStream_t)st>>>(key, hist, n, shift);
  return (int)cudaGetLastError();
}

extern "C" int hist_launch(int variant, const int* key, int* hist, long long n, int shift, void* st) {
  switch (variant) {
    case 0: return launch_h<0>(key, hist, n, shift, st);
    case 1: return launch_h<1>(key, hist, n, shift, st);
    case 2: return launch_h<2>(key, hist, n, shift, st);
    case 3: return launch_h<3>(key, hist, n, shift, st);
    case 4: return launch_h<4>(key, hist, n, shift, st);
  }
  return -1;
}
extern "C" int scatter_launch(int variant, const int* key, const int* val, const int* off, int* ko, int* vo, long long n, int shift, void* st) {
  switch (variant) {
    case 0: return launch_sc<8, 0, 1>(key, val, off, ko, vo, n, shift, st);
    case 1: return launch_sc<8, 1, 1>(key, val, off, ko, vo, n, shift, st);
    case 2: return launch_sc<8, 2, 1>(key, val, off, ko, vo, n, shift, st);
    case 3: return launch_sc<8, 0, 4>(key, val, off, ko, vo, n, shift, st);
    case 4: return launch_sc<8, 1, 4>(key, val, off, ko, vo, n, shift, st);
    case 5: return launch_sc<8, 2, 4>(key, val, off, ko, vo, n, shift, st);
    case 6: return launch_sc<16, 0, 1>(key, val, off, ko, vo, n, shift, st);
    case 7: return launch_sc<16, 1, 1>(key, val, off, ko, vo, n, shift, st);
    case 8: return launch_sc<16, 2, 1>(key, val, off, ko, vo, n, shift, st);
    case 9: return launch_sc<16, 1, 2>(key, val, off, ko, vo, n, shift, st);
  }
  return -1;
}

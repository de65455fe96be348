// design trial 2: histogram and scatter variants at two tiles
#include <cuda_runtime.h>
#include <stdint.h>
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

// hist A: per-warp shared atomics, 256 threads
template <int TL>
__global__ void __launch_bounds__(256) hist_atomic(const int* __restrict__ key, int* __restrict__ hist, int shift) {
  constexpr int WR = TL / 8, Q = WR / 128;
  __shared__ int cnt[8][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = lane; d < 256; d += 32) cnt[warp][d] = 0;
  __syncwarp();
  const int4* src = reinterpret_cast<const int4*>(key + (long long)blockIdx.x * TL + warp * WR);
  int4 q[Q];
#pragma unroll
  for (int c = 0; c < Q; ++c) q[c] = __ldg(src + c * 32 + lane);
#pragma unroll
  for (int c = 0; c < Q; ++c) {
    atomicAdd(&cnt[warp][dig(q[c].x, shift)], 1); atomicAdd(&cnt[warp][dig(q[c].y, shift)], 1);
    atomicAdd(&cnt[warp][dig(q[c].z, shift)], 1); atomicAdd(&cnt[warp][dig(q[c].w, shift)], 1);
  }
  __syncthreads();
  int tot = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) tot += cnt[w][threadIdx.x];
  hist[(long long)blockIdx.x * 256 + threadIdx.x] = tot;
}

// hist B: a byte counter per (warp, digit, lane), plain loads and stores, 256 threads, 64 KB dynamic
template <int TL>
__global__ void __launch_bounds__(256) hist_bytes(const int* __restrict__ key, int* __restrict__ hist, int shift) {
  constexpr int WR = TL / 8, Q = WR / 128;
  static_assert(WR / 32 < 256, "byte counters");
  extern __shared__ __align__(16) unsigned char cb[];     // [8][256][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* wc = cb + warp * 256 * 32;
  int4* z = reinterpret_cast<int4*>(wc);
  for (int i = lane; i < 256 * 32 / 16; i += 32) z[i] = make_int4(0, 0, 0, 0);
  __syncwarp();
  const int4* src = reinterpret_cast<const int4*>(key + (long long)blockIdx.x * TL + warp * WR);
  int4 q[Q];
#pragma unroll
  for (int c = 0; c < Q; ++c) q[c] = __ldg(src + c * 32 + lane);
#pragma unroll
  for (int c = 0; c < Q; ++c) {
    wc[dig(q[c].x, shift) * 32 + lane] += 1; wc[dig(q[c].y, shift) * 32 + lane] += 1;
    wc[dig(q[c].z, shift) * 32 + lane] += 1; wc[dig(q[c].w, shift) * 32 + lane] += 1;
  }
  __syncthreads();
  const int t = threadIdx.x;
  int tot = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const unsigned* row = reinterpret_cast<const unsigned*>(cb + (w * 256 + t) * 32);
#pragma unroll
    for (int i = 0; i < 8; ++i) tot = __dp4a((int)row[(i + (t >> 2)) & 7], (int)0x01010101, tot);
  }
  hist[(long long)blockIdx.x * 256 + t] = tot;
}

// scatter P: rank per warp, scan, a u16 permutation of the tile in shared memory, write-out through it
template <int TL, int W>
__global__ void __launch_bounds__(W * 32)
scatter_perm(const int* __restrict__ key, const int* __restrict__ val, const int* __restrict__ off,
             int* __restrict__ ko, int* __restrict__ vo, int shift) {
  constexpr int T = W * 32, WR = TL / W, ST = WR / 32;
  extern __shared__ __align__(16) int sm[];
  int* skey = sm; int* sval = sm + TL; int* cnt = sm + 2 * TL; int* delta = cnt + W * 256; int* wsum = delta + 256;
  unsigned short* perm = reinterpret_cast<unsigned short*>(wsum + 32);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * TL;
  const int wb = warp * WR;
  for (int q = lane; q < WR / 4; q += 32) { cp16(skey + wb + 4 * q, key + base + wb + 4 * q); cp16(sval + wb + 4 * q, val + base + wb + 4 * q); }
  int* wc = cnt + warp * 256;
  for (int d = lane; d < 256; d += 32) wc[d] = 0;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  int r[ST];
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int d = dig(skey[wb + s * 32 + lane], shift);
    const unsigned p = match_ballot(d);
    const int seen = wc[d];
    r[s] = seen + __popc(p & below);
    __syncwarp();
    if ((p >> lane) == 1u) wc[d] = seen + __popc(p);
    __syncwarp();
  }
  __syncthreads();
  if (tid < 256) {
    int tot = 0;
    for (int w = 0; w < W; ++w) { int c = cnt[w * 256 + tid]; cnt[w * 256 + tid] = tot; tot += c; }
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
    for (int w = 0; w < W; ++w) cnt[w * 256 + tid] += start;
    delta[tid] = off[blockIdx.x * 256LL + tid] - start;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    const int row = wb + s * 32 + lane;
    perm[wc[dig(skey[row], shift)] + r[s]] = (unsigned short)row;
  }
  __syncthreads();
  for (int j = tid; j < TL; j += T) {
    const int row = perm[j];
    const int kk = skey[row];
    const long long pos = (long long)delta[dig(kk, shift)] + j;
    ko[pos] = kk; vo[pos] = sval[row];
  }
}

template <int TL, int W>
static int lsp(const int* k, const int* v, const int* o, int* ko, int* vo, long long n, int shift, void* st) {
  const int smem = (2 * TL + W * 256 + 256 + 32) * 4 + TL * 2;
  cudaFuncSetAttribute(scatter_perm<TL, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  scatter_perm<TL, W><<<(unsigned)(n / TL), W * 32, smem, (cudaStream_t)st>>>(k, v, o, ko, vo, shift);
  return (int)cudaGetLastError();
}
template <int TL>
static int lha(const int* k, int* h, long long n, int shift, void* st) {
  hist_atomic<TL><<<(unsigned)(n / TL), 256, 0, (cudaStream_t)st>>>(k, h, shift);
  return (int)cudaGetLastError();
}
template <int TL>
static int lhb(const int* k, int* h, long long n, int shift, void* st) {
  const int smem = 8 * 256 * 32;
  cudaFuncSetAttribute(hist_bytes<TL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  hist_bytes<TL><<<(unsigned)(n / TL), 256, smem, (cudaStream_t)st>>>(k, h, shift);
  return (int)cudaGetLastError();
}
extern "C" int hist_launch(int v, const int* k, int* h, long long n, int shift, void* st) {
  switch (v) {
    case 0: return lha<4096>(k, h, n, shift, st);
    case 1: return lhb<4096>(k, h, n, shift, st);
    case 2: return lha<8192>(k, h, n, shift, st);
    case 3: return lhb<8192>(k, h, n, shift, st);
  }
  return -1;
}
extern "C" int scatter_launch(int v, const int* k, const int* vv, const int* o, int* ko, int* vo, long long n, int shift, void* st) {
  switch (v) {
    case 0: return lsp<4096, 8>(k, vv, o, ko, vo, n, shift, st);
    case 1: return lsp<4096, 16>(k, vv, o, ko, vo, n, shift, st);
    case 2: return lsp<8192, 8>(k, vv, o, ko, vo, n, shift, st);
    case 3: return lsp<8192, 16>(k, vv, o, ko, vo, n, shift, st);
    case 4: return lsp<8192, 32>(k, vv, o, ko, vo, n, shift, st);
  }
  return -1;
}
extern "C" int variant_tile(int v, int is_hist) {
  if (is_hist) return v < 2 ? 4096 : 8192;
  return v < 2 ? 4096 : 8192;
}

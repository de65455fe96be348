// design trial 4: the histogram at tile 8192 by shared atomics against
// byte counters a lane (no atomics), at 4, 8 and 16 warps a block
#include <cuda_runtime.h>
#include <stdint.h>
#define TL 8192
__device__ __forceinline__ int dig(int k, int s) { return (k >> s) & 255; }

template <int W>
__global__ void __launch_bounds__(W * 32) hist_atomic(const int* __restrict__ key, int* __restrict__ hist, int shift) {
  constexpr int WR = TL / W, Q = WR / 128;
  __shared__ int cnt[W][256];
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
  for (int d = threadIdx.x; d < 256; d += W * 32) {
    int tot = 0;
    for (int w = 0; w < W; ++w) tot += cnt[w][d];
    hist[(long long)blockIdx.x * 256 + d] = tot;
  }
}

// byte counter [warp][digit][lane]; each lane counts at most TL / (W * 32) <= 255 rows
template <int W>
__global__ void __launch_bounds__(W * 32) hist_bytes(const int* __restrict__ key, int* __restrict__ hist, int shift) {
  constexpr int WR = TL / W, Q = WR / 128;
  static_assert(WR / 32 <= 255, "byte counters");
  extern __shared__ __align__(16) unsigned char cb[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* wc = cb + warp * 256 * 32;
  int4* z = reinterpret_cast<int4*>(wc);
  for (int i = lane; i < 256 * 32 / 16; i += 32) z[i] = make_int4(0, 0, 0, 0);
  __syncwarp();
  const int4* src = reinterpret_cast<const int4*>(key + (long long)blockIdx.x * TL + warp * WR);
#pragma unroll 4
  for (int c = 0; c < Q; ++c) {
    const int4 q = __ldg(src + c * 32 + lane);
    wc[dig(q.x, shift) * 32 + lane] += 1; wc[dig(q.y, shift) * 32 + lane] += 1;
    wc[dig(q.z, shift) * 32 + lane] += 1; wc[dig(q.w, shift) * 32 + lane] += 1;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < 256; d += W * 32) {
    int tot = 0;
    for (int w = 0; w < W; ++w) {
      const unsigned* row = reinterpret_cast<const unsigned*>(cb + (w * 256 + d) * 32);
#pragma unroll
      for (int i = 0; i < 8; ++i) tot = __dp4a((int)row[(i + (d >> 2)) & 7], (int)0x01010101, tot);
    }
    hist[(long long)blockIdx.x * 256 + d] = tot;
  }
}

template <int W> static int la(const int* k, int* h, long long n, int s, void* st) {
  hist_atomic<W><<<(unsigned)(n / TL), W * 32, 0, (cudaStream_t)st>>>(k, h, s); return (int)cudaGetLastError();
}
template <int W> static int lb(const int* k, int* h, long long n, int s, void* st) {
  const int smem = W * 256 * 32;
  cudaFuncSetAttribute(hist_bytes<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  hist_bytes<W><<<(unsigned)(n / TL), W * 32, smem, (cudaStream_t)st>>>(k, h, s); return (int)cudaGetLastError();
}
extern "C" int hist_launch(int v, const int* k, int* h, long long n, int s, void* st) {
  switch (v) {
    case 0: return la<8>(k, h, n, s, st);
    case 1: return la<16>(k, h, n, s, st);
    case 2: return la<4>(k, h, n, s, st);
    case 3: return lb<4>(k, h, n, s, st);
    case 4: return lb<2>(k, h, n, s, st);
    case 5: return lb<8>(k, h, n, s, st);
  }
  return -1;
}

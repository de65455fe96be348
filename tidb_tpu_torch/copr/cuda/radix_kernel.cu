// radix_kernel.cu: one stable counting-sort pass of the SCATTER radix
// partition, as two CUDA kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tidb_tpu/copr/pallas/radix_kernel.py:
//   radix_hist    <- _hist_kernel    (pallas_call at radix_kernel.py:92)
//   radix_scatter <- _scatter_kernel (pallas_call at radix_kernel.py:105)
// Between them the wrapper (radix_kernel.py) takes an exclusive cumsum
// over the per-tile counts flattened digit-major, as counting_sort_pass
// does in the JAX package.
//
// The partition key is carried through the pass: both kernels take the
// int32 key and the pass's shift and compute the digit (key >> shift) &
// 255 themselves, and radix_scatter stores the key beside the value, so
// the next pass reads its keys in the new order with no gather.  With
// key = digit and shift = 0 they compute what the TPU kernels compute.
//
// Bound on the H100 (3.35 TB/s HBM3), per pass over n rows and
// T = ceil(n / KERNEL_TILE) tiles: radix_hist reads 4n bytes of keys and
// writes 1024 T bytes of counts; radix_scatter reads 8n bytes (keys and
// values) plus the 1024 T bytes of offsets and writes 8n.  Both are bound
// by memory traffic: a row costs a few dozen integer operations.
//
// Design: one block per KERNEL_TILE = 8192 rows; a warp owns a
// contiguous sub-range of the tile; the ragged last tile (and a pointer
// that is not 16-byte aligned) takes scalar loads and is masked, not
// padded.
//   - radix_hist (8 warps): each lane loads its 32 keys with eight
//     16-byte loads, then adds one to its warp's own 256 shared counters
//     per row; the 8 warp histograms are summed at the end.  Shared
//     atomics on one address from one warp cost no more than on distinct
//     ones here, so the dead rows' tail key (28-37% of the rows on the
//     main path, all on one digit of the lower passes) does not slow it;
//     aggregating a warp's equal digits first (a match, then one atomic a
//     group) costs more than it saves.
//   - radix_scatter (16 warps): each warp copies its 512 keys and values
//     into shared memory with 16-byte cp.async copies and ranks its rows
//     in order, 32 a step: the lanes that share a lane's digit come from 8
//     ballots (the MatchAny of CUB's onesweep), the rank is __popc of
//     those below it plus a running per-warp count of the digit in shared
//     memory.  One scan over (digit, warp) turns the counts into each
//     (warp, digit)'s start in the tile sorted by digit, and each row's
//     index is written there: a 16-bit permutation of the tile, which
//     keeps the registers at 64 a thread (two blocks an SM) where a sorted
//     copy of the rows would need them held across the scan.  The
//     write-out walks the permutation linearly: thread i stores sorted
//     row i at off[tile][d] + (i - start of d), so neighbouring threads
//     store to neighbouring addresses within each digit's run (32 rows a
//     run on uniform digits, against 2 at the TPU's 512-row tile).  Four
//     barriers a tile.
// Rows keep their order within a digit, so the permutation equals the
// plain version's bit for bit whatever the tile.
//
// Error reporting: a negative key (outside the partition key's domain
// [0, 2^31)) sets bit 0 of *err; a target position outside [0, n) sets
// bit 1 and the store is skipped.  Each launch function returns the
// first CUDA error of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define RADIX_TILE 512          // the TPU kernels' tile (rk.TILE)
#define KERNEL_TILE 8192        // rows per block of these kernels
#define RADIX_DIGITS 256
#define FULL_MASK 0xffffffffu

#define HIST_THREADS 256
#define HIST_WARP_ROWS (KERNEL_TILE / (HIST_THREADS / 32))      // 1024
#define SCATTER_THREADS 512
#define SCATTER_WARPS (SCATTER_THREADS / 32)
#define SCATTER_WARP_ROWS (KERNEL_TILE / SCATTER_WARPS)        // 512
#define SCATTER_STEPS (SCATTER_WARP_ROWS / 32)                 // 16

static_assert(KERNEL_TILE % RADIX_TILE == 0 &&
              ((KERNEL_TILE / RADIX_TILE) & (KERNEL_TILE / RADIX_TILE - 1)) == 0,
              "KERNEL_TILE is a power-of-two multiple of RADIX_TILE");
static_assert(HIST_THREADS == RADIX_DIGITS, "one thread per digit bin");
static_assert(SCATTER_THREADS >= RADIX_DIGITS, "a thread per digit bin");
static_assert(HIST_WARP_ROWS % 128 == 0 && SCATTER_WARP_ROWS % 128 == 0,
              "whole 16-byte loads per lane");
static_assert(KERNEL_TILE <= 65536, "a 16-bit permutation of the tile");

struct ScatterSmem {                          // 99,360 bytes, dynamic
  int key[KERNEL_TILE];                       // the tile as loaded
  int val[KERNEL_TILE];
  // per-warp digit counts, then each (warp, digit)'s start in the sorted tile
  int cnt[SCATTER_WARPS][RADIX_DIGITS];
  int delta[RADIX_DIGITS];                    // off[tile][d] - start of d
  int wsum[RADIX_DIGITS / 32];
  unsigned short perm[KERNEL_TILE];           // sorted position -> row
};
static_assert(sizeof(ScatterSmem) <= 232448, "fits a block's shared memory");

__device__ __forceinline__ int digit_of(int key, int shift) {
  return (key >> shift) & (RADIX_DIGITS - 1);
}

// Lanes of the warp whose digit equals this lane's: one ballot per bit.
__device__ __forceinline__ unsigned match_digit(int d) {
  unsigned peers = FULL_MASK;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned ones = __ballot_sync(FULL_MASK, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp copies its m rows (m <= SCATTER_WARP_ROWS) of src into dst.
__device__ __forceinline__ void stage_rows(int* dst, const int* src, int m,
                                           int lane) {
  if (m == SCATTER_WARP_ROWS && aligned16(src)) {
#pragma unroll
    for (int q = lane; q < SCATTER_WARP_ROWS / 4; q += 32) {
      cp_async16(dst + 4 * q, src + 4 * q);
    }
  } else {
    for (int i = lane; i < m; i += 32) dst[i] = src[i];
  }
}

__device__ __forceinline__ void count_key(int* wcnt, int key, int shift,
                                          bool& bad) {
  bad |= key < 0;
  atomicAdd(&wcnt[digit_of(key, shift)], 1);
}

__global__ void __launch_bounds__(HIST_THREADS)
radix_hist_kernel(const int* __restrict__ key, int* __restrict__ hist,
                  long long n, int shift, int* __restrict__ err) {
  __shared__ int cnt[HIST_THREADS / 32][RADIX_DIGITS];   // 8 KiB
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wrow = (long long)blockIdx.x * KERNEL_TILE
                         + warp * HIST_WARP_ROWS;
  const long long left = n - wrow;
  const int m = left <= 0 ? 0
                : (left < HIST_WARP_ROWS ? (int)left : HIST_WARP_ROWS);
  int* wcnt = cnt[warp];
  for (int d = lane; d < RADIX_DIGITS; d += 32) wcnt[d] = 0;
  __syncwarp();
  bool bad = false;
  if (m == HIST_WARP_ROWS && aligned16(key + wrow)) {
    const int4* src = reinterpret_cast<const int4*>(key + wrow);
    int4 q[HIST_WARP_ROWS / 128];
#pragma unroll
    for (int c = 0; c < HIST_WARP_ROWS / 128; ++c) {
      q[c] = __ldg(src + c * 32 + lane);
    }
#pragma unroll
    for (int c = 0; c < HIST_WARP_ROWS / 128; ++c) {
      count_key(wcnt, q[c].x, shift, bad);
      count_key(wcnt, q[c].y, shift, bad);
      count_key(wcnt, q[c].z, shift, bad);
      count_key(wcnt, q[c].w, shift, bad);
    }
  } else {
    for (int i = lane; i < m; i += 32) count_key(wcnt, key[wrow + i], shift, bad);
  }
  if (bad) atomicOr(err, 1);
  __syncthreads();
  int tot = 0;
#pragma unroll
  for (int w = 0; w < HIST_THREADS / 32; ++w) tot += cnt[w][threadIdx.x];
  hist[(long long)blockIdx.x * RADIX_DIGITS + threadIdx.x] = tot;
}

__global__ void __launch_bounds__(SCATTER_THREADS)
radix_scatter_kernel(const int* __restrict__ key, const int* __restrict__ val,
                     const int* __restrict__ off, int* __restrict__ key_out,
                     int* __restrict__ val_out, long long n, int shift,
                     int* __restrict__ err) {
  extern __shared__ __align__(16) unsigned char smem[];
  ScatterSmem& sm = *reinterpret_cast<ScatterSmem*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)blockIdx.x * KERNEL_TILE;
  const int rows = (int)(n - base < KERNEL_TILE ? n - base : KERNEL_TILE);
  const int wbase = warp * SCATTER_WARP_ROWS;
  const int m = rows <= wbase ? 0
                : (rows - wbase < SCATTER_WARP_ROWS ? rows - wbase
                                                    : SCATTER_WARP_ROWS);

  // 1. this warp's sub-range into shared memory
  stage_rows(sm.key + wbase, key + base + wbase, m, lane);
  stage_rows(sm.val + wbase, val + base + wbase, m, lane);
  int* wcnt = sm.cnt[warp];
  for (int d = lane; d < RADIX_DIGITS; d += 32) wcnt[d] = 0;
  cp_async_wait_all();
  __syncwarp();

  // 2. stable rank of each row among the warp's earlier rows of its digit
  const unsigned below = (1u << lane) - 1u;
  int r[SCATTER_STEPS];
  bool bad = false;
#pragma unroll
  for (int s = 0; s < SCATTER_STEPS; ++s) {
    const int i = s * 32 + lane;
    const bool live = i < m;
    const int k = live ? sm.key[wbase + i] : 0;
    bad |= k < 0;
    const int d = digit_of(k, shift);
    const unsigned peers = match_digit(d) & __ballot_sync(FULL_MASK, live);
    const int seen = wcnt[d];
    r[s] = seen + __popc(peers & below);
    __syncwarp();
    if (live && (peers >> lane) == 1u) wcnt[d] = seen + __popc(peers);  // last lane of its group
    __syncwarp();
  }
  if (bad) atomicOr(err, 1);
  __syncthreads();

  // 3. thread t < 256 owns digit t: exclusive scan over the warps, then
  //    over the digits (a warp scan by shuffles, then the 8 warp totals)
  if (tid < RADIX_DIGITS) {
    int tot = 0;
#pragma unroll
    for (int w = 0; w < SCATTER_WARPS; ++w) {
      const int c = sm.cnt[w][tid];
      sm.cnt[w][tid] = tot;
      tot += c;
    }
    int inc = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) sm.wsum[warp] = inc;
    sm.delta[tid] = inc - tot;
  }
  __syncthreads();
  if (tid < RADIX_DIGITS) {
    int start = sm.delta[tid];
    for (int w = 0; w < warp; ++w) start += sm.wsum[w];
#pragma unroll
    for (int w = 0; w < SCATTER_WARPS; ++w) sm.cnt[w][tid] += start;
    sm.delta[tid] = off[blockIdx.x * (long long)RADIX_DIGITS + tid] - start;
  }
  __syncthreads();

  // 4. the permutation that sorts the tile by digit
#pragma unroll
  for (int s = 0; s < SCATTER_STEPS; ++s) {
    const int i = s * 32 + lane;
    if (i < m) {
      const int row = wbase + i;
      sm.perm[wcnt[digit_of(sm.key[row], shift)] + r[s]] = (unsigned short)row;
    }
  }
  __syncthreads();

  // 5. coalesced write-out of each digit's run
  bool oob = false;
  for (int j = tid; j < rows; j += SCATTER_THREADS) {
    const int row = sm.perm[j];
    const int k = sm.key[row];
    const long long pos = (long long)sm.delta[digit_of(k, shift)] + j;
    if (pos >= 0 && pos < n) {
      key_out[pos] = k;
      val_out[pos] = sm.val[row];
    } else {
      oob = true;
    }
  }
  if (oob) atomicOr(err, 2);
}

extern "C" int radix_kernel_tile(void) { return KERNEL_TILE; }

extern "C" int radix_hist_launch(const int* key, int* hist, long long n,
                                 int shift, int* err, int device,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  const long long tiles = (n + KERNEL_TILE - 1) / KERNEL_TILE;
  radix_hist_kernel<<<(unsigned)tiles, HIST_THREADS, 0,
                      (cudaStream_t)stream>>>(key, hist, n, shift, err);
  return (int)cudaGetLastError();
}

extern "C" int radix_scatter_launch(const int* key, const int* val,
                                    const int* off, int* key_out,
                                    int* val_out, long long n, int shift,
                                    int* err, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  e = cudaFuncSetAttribute(radix_scatter_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(ScatterSmem));
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (n + KERNEL_TILE - 1) / KERNEL_TILE;
  radix_scatter_kernel<<<(unsigned)tiles, SCATTER_THREADS,
                         sizeof(ScatterSmem), (cudaStream_t)stream>>>(
      key, val, off, key_out, val_out, n, shift, err);
  return (int)cudaGetLastError();
}

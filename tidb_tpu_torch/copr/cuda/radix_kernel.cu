// radix_kernel.cu: one stable counting-sort pass, as two CUDA kernels
// for Hopper (sm_90a), each instantiated for two key types:
//   int32 keys: the SCATTER radix partition's key, in [0, 2^31);
//   int64 keys: the sort keys of stable_argsort (ops/sort.py), any value,
//               ordered as signed.
//
// Replaces the Pallas TPU kernels of tidb_tpu/copr/pallas/radix_kernel.py:
//   radix_hist    <- _hist_kernel    (pallas_call at radix_kernel.py:92)
//   radix_scatter <- _scatter_kernel (pallas_call at radix_kernel.py:105)
// and, in its int64 instantiation, the counting-sort pass under the
// multi-key lax.sort of tidb_tpu/copr/exec.py:340 and :579 and
// tidb_tpu/copr/segment.py:178.  Between the two kernels the wrapper
// (radix_kernel.py) takes an exclusive cumsum over the per-tile counts
// flattened digit-major, as counting_sort_pass does in the JAX package.
//
// The key is carried through the pass: both kernels take the key and
// the pass's shift and compute the digit themselves, and radix_scatter
// stores the key beside the int32 value, so the next pass reads its keys
// in the new order with no gather.  An int32 key's digit is
// (key >> shift) & 255; an int64 key's is taken from the key with its
// sign bit flipped (the top digit XOR 0x80), so unsigned digit order is
// signed key order.  With key = digit and shift = 0 the int32 kernels
// compute what the TPU kernels compute.
//
// Bound on the H100 (3.35 TB/s HBM3), per pass over n rows of a key of
// w bytes and T = ceil(n / tile) tiles: radix_hist reads w n bytes of
// keys and writes 1024 T bytes of counts; radix_scatter reads (w + 4) n
// bytes (keys and values) plus the 1024 T bytes of offsets and writes
// (w + 4) n.  Both are bound by memory traffic: a row costs a few dozen
// integer operations.
//
// Design: one block per KERNEL_TILE = 8192-row tile for both key types.
// The scatter stages the tile's keys and values, the counts and the
// permutation in shared memory: 99,360 bytes for int32 keys (two blocks
// an SM) and 132,128 for int64 (one block an SM).  A 4096-row int64 tile
// (74,784 bytes, three blocks an SM by shared memory) measured slower,
// 0.1311 against 0.1172 ms at 8,388,608 rows (trials/sort/tile64.py):
// a digit's run halves to 16 rows and the write-out, not occupancy,
// sets the scatter's time.  A warp owns a contiguous sub-range of the
// tile; the ragged last tile (and a pointer that is not 16-byte aligned)
// takes scalar loads and is masked, not padded.
//   - radix_hist (8 warps): each lane loads its keys with eight 16-byte
//     loads, then adds one to its warp's own 256 shared counters per
//     row; the 8 warp histograms are summed at the end.  Shared atomics
//     on one address from one warp cost no more than on distinct ones
//     here, so a skewed digit (the dead rows' tail key, a 0/1 flag) does
//     not slow it; aggregating a warp's equal digits first (a match,
//     then one atomic a group) costs more than it saves.
//   - radix_scatter (16 warps): each warp copies its keys and values
//     into shared memory with 16-byte cp.async copies and ranks its rows
//     in order, 32 a step: the lanes that share a lane's digit come from 8
//     ballots (the MatchAny of CUB's onesweep), the rank is __popc of
//     those below it plus a running per-warp count of the digit in shared
//     memory.  One scan over (digit, warp) turns the counts into each
//     (warp, digit)'s start in the tile sorted by digit, and each row's
//     index is written there: a 16-bit permutation of the tile, which
//     keeps the registers at 64 a thread where a sorted copy of the rows
//     would need them held across the scan.  The write-out walks
//     the permutation linearly: thread i stores sorted row i at
//     off[tile][d] + (i - start of d), so neighbouring threads store to
//     neighbouring addresses within each digit's run.  Four barriers a
//     tile.
// Rows keep their order within a digit, so the permutation equals the
// plain version's bit for bit whatever the tile.
//
// Error reporting: a negative int32 key (outside the partition key's
// domain [0, 2^31)) sets bit 0 of *err; every int64 key is valid.  A
// target position outside [0, n) sets bit 1 and the store is skipped.
// Each launch function returns the first CUDA error of its launch.

#include "radix_common.cuh"

#define RADIX_TILE 512          // the TPU kernels' tile (rk.TILE)
#define KERNEL_TILE 8192        // rows per block

#define HIST_THREADS 256
#define HIST_WARPS (HIST_THREADS / 32)
#define SCATTER_THREADS 512
#define SCATTER_WARPS (SCATTER_THREADS / 32)
#define SM_SHARED_BYTES 233472  // 228 KiB of shared memory an SM
#define BLOCK_RESERVED_BYTES 1024

static_assert(KERNEL_TILE % RADIX_TILE == 0 &&
              ((KERNEL_TILE / RADIX_TILE) & (KERNEL_TILE / RADIX_TILE - 1)) == 0,
              "KERNEL_TILE is a power-of-two multiple of RADIX_TILE");
static_assert(HIST_THREADS == RADIX_DIGITS, "one thread per digit bin");
static_assert(SCATTER_THREADS >= RADIX_DIGITS, "a thread per digit bin");

template <typename K> struct Geometry {
  static constexpr int kTile = KERNEL_TILE;
  static constexpr int kHistWarpRows = kTile / HIST_WARPS;
  static constexpr int kScatterWarpRows = kTile / SCATTER_WARPS;
  static constexpr int kScatterSteps = kScatterWarpRows / 32;
  static constexpr int kPerLoad = 16 / (int)sizeof(K);   // keys a 16-byte load
  static constexpr int kHistLoads = kHistWarpRows / (32 * kPerLoad);
  static_assert(kHistWarpRows % (32 * kPerLoad) == 0 &&
                kScatterWarpRows % 128 == 0, "whole 16-byte loads per lane");
  static_assert(kTile <= 65536, "a 16-bit permutation of the tile");
};

template <typename K> struct ScatterSmem {    // dynamic
  K key[KERNEL_TILE];                         // the tile as loaded
  int val[KERNEL_TILE];
  // per-warp digit counts, then each (warp, digit)'s start in the sorted tile
  int cnt[SCATTER_WARPS][RADIX_DIGITS];
  int delta[RADIX_DIGITS];                    // off[tile][d] - start of d
  int wsum[RADIX_DIGITS / 32];
  unsigned short perm[KERNEL_TILE];           // sorted position -> row
};
static_assert(sizeof(ScatterSmem<int>) == 99360, "int32 scatter smem");
static_assert(sizeof(ScatterSmem<long long>) == 132128, "int64 scatter smem");
static_assert(2 * (sizeof(ScatterSmem<int>) + BLOCK_RESERVED_BYTES)
              <= SM_SHARED_BYTES, "two int32 scatter blocks an SM");
static_assert(sizeof(ScatterSmem<long long>) <= 232448,
              "an int64 scatter block fits a block's shared memory");

template <typename K>
__device__ __forceinline__ void count_key(int* wcnt, K key, int shift,
                                          bool& bad) {
  bad |= KeyOps<K>::bad(key);
  atomicAdd(&wcnt[KeyOps<K>::digit(key, shift)], 1);
}

// The keys of one 16-byte load (little-endian words).
__device__ __forceinline__ void count_load(int* wcnt, int4 q, int shift,
                                           bool& bad, int) {
  count_key<int>(wcnt, q.x, shift, bad);
  count_key<int>(wcnt, q.y, shift, bad);
  count_key<int>(wcnt, q.z, shift, bad);
  count_key<int>(wcnt, q.w, shift, bad);
}

__device__ __forceinline__ void count_load(int* wcnt, int4 q, int shift,
                                           bool& bad, long long) {
  count_key<long long>(wcnt, join64(q.x, q.y), shift, bad);
  count_key<long long>(wcnt, join64(q.z, q.w), shift, bad);
}

template <typename K>
__global__ void __launch_bounds__(HIST_THREADS)
radix_hist_kernel(const K* __restrict__ key, int* __restrict__ hist,
                  long long n, int shift, int* __restrict__ err) {
  using G = Geometry<K>;
  __shared__ int cnt[HIST_WARPS][RADIX_DIGITS];   // 8 KiB
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wrow = (long long)blockIdx.x * G::kTile
                         + warp * G::kHistWarpRows;
  const long long left = n - wrow;
  const int m = left <= 0 ? 0
                : (left < G::kHistWarpRows ? (int)left : G::kHistWarpRows);
  int* wcnt = cnt[warp];
  for (int d = lane; d < RADIX_DIGITS; d += 32) wcnt[d] = 0;
  __syncwarp();
  bool bad = false;
  if (m == G::kHistWarpRows && aligned16(key + wrow)) {
    const int4* src = reinterpret_cast<const int4*>(key + wrow);
    int4 q[G::kHistLoads];
#pragma unroll
    for (int c = 0; c < G::kHistLoads; ++c) q[c] = __ldg(src + c * 32 + lane);
#pragma unroll
    for (int c = 0; c < G::kHistLoads; ++c) {
      count_load(wcnt, q[c], shift, bad, K());
    }
  } else {
    for (int i = lane; i < m; i += 32) {
      count_key<K>(wcnt, key[wrow + i], shift, bad);
    }
  }
  if (bad) atomicOr(err, 1);
  __syncthreads();
  int tot = 0;
#pragma unroll
  for (int w = 0; w < HIST_WARPS; ++w) tot += cnt[w][threadIdx.x];
  hist[(long long)blockIdx.x * RADIX_DIGITS + threadIdx.x] = tot;
}

template <typename K>
__global__ void __launch_bounds__(SCATTER_THREADS)
radix_scatter_kernel(const K* __restrict__ key, const int* __restrict__ val,
                     const int* __restrict__ off, K* __restrict__ key_out,
                     int* __restrict__ val_out, long long n, int shift,
                     int* __restrict__ err) {
  using G = Geometry<K>;
  using Ops = KeyOps<K>;
  extern __shared__ __align__(16) unsigned char smem[];
  ScatterSmem<K>& sm = *reinterpret_cast<ScatterSmem<K>*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)blockIdx.x * G::kTile;
  const int rows = (int)(n - base < G::kTile ? n - base : G::kTile);
  const int wbase = warp * G::kScatterWarpRows;
  const int m = rows <= wbase ? 0
                : (rows - wbase < G::kScatterWarpRows ? rows - wbase
                                                      : G::kScatterWarpRows);

  // 1. this warp's sub-range into shared memory
  stage_rows<G::kScatterWarpRows>(sm.key + wbase, key + base + wbase, m,
                                  lane);
  stage_rows<G::kScatterWarpRows>(sm.val + wbase, val + base + wbase, m,
                                  lane);
  int* wcnt = sm.cnt[warp];
  for (int d = lane; d < RADIX_DIGITS; d += 32) wcnt[d] = 0;
  cp_async_wait_all();
  __syncwarp();

  // 2. stable rank of each row among the warp's earlier rows of its digit
  const unsigned below = (1u << lane) - 1u;
  int r[G::kScatterSteps];
  bool bad = false;
#pragma unroll
  for (int s = 0; s < G::kScatterSteps; ++s) {
    const int i = s * 32 + lane;
    const bool live = i < m;
    const K k = live ? sm.key[wbase + i] : K(0);
    bad |= Ops::bad(k);
    const int d = Ops::digit(k, shift);
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
  for (int s = 0; s < G::kScatterSteps; ++s) {
    const int i = s * 32 + lane;
    if (i < m) {
      const int row = wbase + i;
      sm.perm[wcnt[Ops::digit(sm.key[row], shift)] + r[s]] =
          (unsigned short)row;
    }
  }
  __syncthreads();

  // 5. coalesced write-out of each digit's run
  bool oob = false;
  for (int j = tid; j < rows; j += SCATTER_THREADS) {
    const int row = sm.perm[j];
    const K k = sm.key[row];
    const long long pos = (long long)sm.delta[Ops::digit(k, shift)] + j;
    if (pos >= 0 && pos < n) {
      key_out[pos] = k;
      val_out[pos] = sm.val[row];
    } else {
      oob = true;
    }
  }
  if (oob) atomicOr(err, 2);
}

template <typename K>
static int hist_launch(const K* key, int* hist, long long n, int shift,
                       int* err, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  const long long tiles = (n + KERNEL_TILE - 1) / KERNEL_TILE;
  radix_hist_kernel<K><<<(unsigned)tiles, HIST_THREADS, 0,
                         (cudaStream_t)stream>>>(key, hist, n, shift, err);
  return (int)cudaGetLastError();
}

template <typename K>
static int scatter_launch(const K* key, const int* val, const int* off,
                          K* key_out, int* val_out, long long n, int shift,
                          int* err, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  void (*kernel)(const K*, const int*, const int*, K*, int*, long long, int,
                 int*) = radix_scatter_kernel<K>;
  e = cudaFuncSetAttribute((const void*)kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(ScatterSmem<K>));
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (n + KERNEL_TILE - 1) / KERNEL_TILE;
  kernel<<<(unsigned)tiles, SCATTER_THREADS, sizeof(ScatterSmem<K>),
           (cudaStream_t)stream>>>(key, val, off, key_out, val_out, n, shift,
                                   err);
  return (int)cudaGetLastError();
}

extern "C" int radix_kernel_tile(void) { return KERNEL_TILE; }

extern "C" int radix_hist_launch(const int* key, int* hist, long long n,
                                 int shift, int* err, int device,
                                 void* stream) {
  return hist_launch<int>(key, hist, n, shift, err, device, stream);
}

extern "C" int radix_hist64_launch(const long long* key, int* hist,
                                   long long n, int shift, int* err,
                                   int device, void* stream) {
  return hist_launch<long long>(key, hist, n, shift, err, device, stream);
}

extern "C" int radix_scatter_launch(const int* key, const int* val,
                                    const int* off, int* key_out,
                                    int* val_out, long long n, int shift,
                                    int* err, int device, void* stream) {
  return scatter_launch<int>(key, val, off, key_out, val_out, n, shift, err,
                             device, stream);
}

extern "C" int radix_scatter64_launch(const long long* key, const int* val,
                                      const int* off, long long* key_out,
                                      int* val_out, long long n, int shift,
                                      int* err, int device, void* stream) {
  return scatter_launch<long long>(key, val, off, key_out, val_out, n, shift,
                                   err, device, stream);
}

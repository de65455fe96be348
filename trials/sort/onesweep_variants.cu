// onesweep_variants.cu: tidb_tpu_torch/copr/cuda/onesweep.cu with the
// design switches that trials/sort/onesweep_tile.py sets in a copy
// (OS_TILE, OS_THREADS, OS_PERSISTENT, OS_PREFETCH).  At their defaults
// it is the kernel source's design; the persistent grid and the prefetch
// of the next tile into a second staging buffer live only here, since
// neither beat one block a tile on the H100 (PERF.md).  Built with -I
// tidb_tpu_torch/copr/cuda for radix_common.cuh.
//
// onesweep.cu: the stable LSD radix sort of one int64 key, as a onesweep
// sort for Hopper (sm_90a): one kernel reads the key once for the
// histograms of all its digits, then one kernel a pass scatters the rows,
// each tile finding its offsets by a decoupled look-back over the tiles
// before it (Adinets & Merrill, "Onesweep: A Faster Least Significant
// Digit Radix Sort for GPUs", 2022).
//
// Replaces the stable multi-key lax.sort of the JAX package's device
// programs (tidb_tpu/copr/exec.py:340 SORT, :579 TopN,
// tidb_tpu/copr/segment.py:178 SEGMENT), which ops/sort.py lowers to one
// such sort a key; on the TPU the sort's passes would be the Pallas
// kernels of tidb_tpu/copr/pallas/radix_kernel.py (_hist_kernel,
// _scatter_kernel).  Each pass gives bit for bit what counting_sort_pass
// (radix_kernel.cu's int64 instantiation and exclusive_offsets) gives.
//
// A key's digit at shift s is taken from the key with its sign bit
// flipped, ((key ^ INT64_MIN) >> s) & 255 read as unsigned, as in
// radix_kernel.cu, so unsigned digit order is signed key order.  The
// values are int32 (the permutation).
//
// Kernels:
//   radix_hist_all64: the (passes, 256) global digit histograms of a key
//     in one read.  Grid-stride blocks of 8 warps load 16 bytes a lane;
//     each warp adds one to its own copy of passes x 256 shared counters
//     per (row, pass) (one copy a warp, as radix_kernel.cu's histogram:
//     a skewed digit then costs no more than a uniform one); each block
//     adds its nonzero counters to the output with one global atomic
//     each.  Counts do not depend on the order of the rows, so one
//     histogram serves every pass of the key.
//   radix_onesweep64: one stable counting-sort pass.  A block takes its
//     tile's index from an atomic counter, so a tile looks back only at
//     tiles that started before it (forward progress whatever the order
//     in which blocks are scheduled).  The tile's keys and values are
//     staged with 16-byte cp.async copies and ranked in order within
//     their digit as in radix_kernel.cu's scatter (8 ballots a step,
//     per-warp running counts, a 16-bit permutation of the tile, a
//     coalesced write-out of each digit's run).  For each digit the tile
//     publishes its count as an aggregate as soon as it is ranked, builds
//     its permutation, then looks back over earlier tiles, summing
//     aggregates until it meets an inclusive prefix, and publishes its own
//     inclusive prefix.  A row lands at
//       excl_scan(hist_p)[digit] + prefix(tile, digit) + rank,
//     the offset exclusive_offsets gives it.  Each block scans the 256
//     digit totals itself in its prologue.
//   radix_onesweep64_sort: one entry a key: a memset of the workspace,
//     the histogram, then the passes, ping-ponging two buffer pairs; the
//     last pass stores the values (the permutation) only, as int64 when
//     the caller wants the sort's final permutation.  Without values the
//     first pass takes each row's index as its value, so a sort's first
//     key needs no arange.
//
// Status words are 64 bits: the flag in the top two bits (0 not ready,
// 1 aggregate, 2 inclusive prefix) and the count below, since a prefix
// reaches n (up to 2^31 - 1 rows), past the 30 bits a 32-bit packing
// leaves.  The count rides in the same word as its flag and nothing else
// is read on the strength of the flag, so a volatile 64-bit store
// publishes and a volatile load reads (single-copy atomic, not cached in
// L1); no fence is needed, and none stalls a block that still has
// stores of its previous tile in flight.  The look-back reads
// LOOKBACK tiles at once, so the first wave, in which every tile starts
// together, walks its chain LOOKBACK tiles a round trip.
//
// Bound on the H100 (3.35 TB/s HBM3), per pass over n rows: 8 n bytes
// of keys and 4 n of values read, as much written (no key store on a
// key's last pass): 24 n bytes, against 32 n for the histogram and
// scatter of counting_sort_pass, which read the keys twice.  The
// histogram reads 8 n bytes once a key.  A row costs a few dozen integer
// operations, so both kernels are bound by memory traffic.
//
// Shared memory: the pass stages its tile as radix_kernel.cu's int64
// scatter does (OS_TILE keys and values, per-warp counts, the
// permutation): 135,208 bytes at the 8192-row tile and 512 threads, one
// block an SM; 69,672 at a 4096-row tile and 256 threads, three.
// trials/sort/onesweep_tile.py times those, a persistent grid
// (OS_PERSISTENT) and a persistent block that stages its next tile while
// it sorts this one (OS_PREFETCH): none beat the default on the H100, so
// the load is not what a pass waits on.
//
// Error reporting: a target position outside [0, n) (a histogram that
// does not describe the key) sets bit 1 of *err and the store is
// skipped.  Each launch function returns the first CUDA error of its
// launches, and adds each launch it issues without error to a host
// counter the caller gives (the wrappers' launch counts).

#include <mutex>

#include "radix_common.cuh"

#ifndef OS_TILE
#define OS_TILE 8192            // rows per tile of a pass
#endif
#ifndef OS_THREADS
#define OS_THREADS 512          // threads a pass block
#endif
#ifndef OS_PERSISTENT
#define OS_PERSISTENT 0         // 1: a grid of resident blocks loops over tiles
#endif
#ifndef OS_PREFETCH
#define OS_PREFETCH 0           // 1: a persistent block stages its next tile
#endif                          //    while it sorts this one
#define OS_BUFS (1 + OS_PREFETCH)
#define OS_WARPS (OS_THREADS / 32)
#define OS_WARP_ROWS (OS_TILE / OS_WARPS)
#define OS_STEPS (OS_WARP_ROWS / 32)
#define LOOKBACK 8              // earlier tiles a look-back step reads

#define HA_THREADS 256          // threads a histogram block
#define HA_WARPS (HA_THREADS / 32)
#define HA_UNROLL 4             // 16-byte loads in flight a lane
#define MAX_PASSES 8            // digits of an int64 key

#define FLAG_AGG (1ull << 62)
#define FLAG_INC (2ull << 62)
#define COUNT_MASK ((1ull << 62) - 1)

static_assert(OS_THREADS >= RADIX_DIGITS, "a thread per digit bin");
static_assert(OS_WARP_ROWS % 128 == 0, "whole 16-byte loads per lane");
static_assert(OS_TILE <= 65536, "a 16-bit permutation of the tile");
static_assert(OS_TILE % OS_THREADS == 0, "whole rows a thread");

#if OS_PREFETCH
typedef unsigned short cnt_t;   // counts and starts < 2^16 leave room for
#else                           // the second buffer
typedef int cnt_t;
#endif

struct OnesweepSmem {                     // dynamic
  long long key[OS_BUFS][OS_TILE];        // the tile as loaded
  int val[OS_BUFS][OS_TILE];
  // per-warp digit counts, then each (warp, digit)'s start in the sorted tile
  cnt_t cnt[OS_WARPS][RADIX_DIGITS];
  long long delta[RADIX_DIGITS];          // destination of digit d's run - its start
  int start[RADIX_DIGITS];                // digit d's start in the sorted tile
  int gbase[RADIX_DIGITS];                // excl_scan(hist_p)
  int wsum[RADIX_DIGITS / 32];
  int tile;
  unsigned short perm[OS_TILE];           // sorted position -> row
};

static_assert(sizeof(OnesweepSmem) <= 232448,
              "a pass block fits a block's shared memory");

__device__ __forceinline__ int digit64(long long key, int shift) {
  return KeyOps<long long>::digit(key, shift);
}

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Inclusive scan of x over the lanes of a warp.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// --------------------------------------------------------------------- //
// the histograms of every digit of a key
// --------------------------------------------------------------------- //

__device__ __forceinline__ void count_all(int* wc, long long key,
                                          int passes) {
  const unsigned long long u =
      (unsigned long long)key ^ 0x8000000000000000ull;
#pragma unroll
  for (int p = 0; p < MAX_PASSES; ++p) {
    if (p < passes) {
      atomicAdd(&wc[p * RADIX_DIGITS + (int)((u >> (8 * p)) & 255)], 1);
    }
  }
}

__global__ void __launch_bounds__(HA_THREADS)
radix_hist_all64_kernel(const long long* __restrict__ key,
                        int* __restrict__ hist, long long n, int passes) {
  extern __shared__ int hcnt[];           // [HA_WARPS][passes][256]
  const int tid = threadIdx.x;
  const int span = passes * RADIX_DIGITS;
  for (int i = tid; i < HA_WARPS * span; i += HA_THREADS) hcnt[i] = 0;
  __syncthreads();
  int* wc = hcnt + (tid >> 5) * span;
  // an int64 pointer is 8-aligned: at most one key before the first
  // 16-byte boundary, at most one after the last whole pair
  const long long head = aligned16(key) ? 0 : 1;
  const long long pairs = n > head ? (n - head) >> 1 : 0;
  const int4* src = reinterpret_cast<const int4*>(key + head);
  const long long stride = (long long)gridDim.x * HA_THREADS;
  long long q = (long long)blockIdx.x * HA_THREADS + tid;
  for (; q + (HA_UNROLL - 1) * stride < pairs; q += HA_UNROLL * stride) {
    int4 v[HA_UNROLL];
#pragma unroll
    for (int u = 0; u < HA_UNROLL; ++u) v[u] = __ldg(src + q + u * stride);
#pragma unroll
    for (int u = 0; u < HA_UNROLL; ++u) {
      count_all(wc, join64(v[u].x, v[u].y), passes);
      count_all(wc, join64(v[u].z, v[u].w), passes);
    }
  }
  for (; q < pairs; q += stride) {
    const int4 v = __ldg(src + q);
    count_all(wc, join64(v.x, v.y), passes);
    count_all(wc, join64(v.z, v.w), passes);
  }
  if (blockIdx.x == 0 && tid == 0) {
    if (head && n > 0) count_all(wc, key[0], passes);
    if (head + 2 * pairs < n) count_all(wc, key[head + 2 * pairs], passes);
  }
  __syncthreads();
  for (int i = tid; i < span; i += HA_THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < HA_WARPS; ++w) s += hcnt[w * span + i];
    if (s) atomicAdd(hist + i, s);
  }
}

// --------------------------------------------------------------------- //
// one pass
// --------------------------------------------------------------------- //

// The rows of earlier tiles with digit d: aggregates summed back to the
// nearest inclusive prefix, LOOKBACK tiles a step.  Every earlier tile
// was taken by a running block, which publishes its aggregate without
// waiting on anything, so the spin ends.
__device__ __forceinline__ long long look_back(
    const unsigned long long* __restrict__ status, int tile, int d) {
  long long prefix = 0;
  int j = tile - 1;
  bool done = tile == 0;
  while (!done) {
    unsigned long long v[LOOKBACK];
#pragma unroll
    for (int i = 0; i < LOOKBACK; ++i) {
      v[i] = j - i >= 0
          ? ld_status(status + (long long)(j - i) * RADIX_DIGITS + d) : 0ull;
    }
    int i = 0;
    for (; i < LOOKBACK; ++i) {
      const unsigned long long flag = v[i] & ~COUNT_MASK;
      if (flag == 0) break;               // not ready yet: read it again
      prefix += (long long)(v[i] & COUNT_MASK);
      if (flag == FLAG_INC) {
        done = true;
        break;
      }
    }
    j -= i;
  }
  return prefix;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies of all but its newest group.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// This warp's rows of the tile's key and values (or row indices) into
// one staging buffer, as one group of copies.
__device__ __forceinline__ void stage_tile(
    long long* skey, int* sval, int tile, const long long* __restrict__ key,
    const int* __restrict__ val, long long n) {
  const int lane = threadIdx.x & 31;
  const long long base = (long long)tile * OS_TILE;
  const int rows = (int)(n - base < OS_TILE ? n - base : OS_TILE);
  const int wbase = (threadIdx.x >> 5) * OS_WARP_ROWS;
  const int m = rows <= wbase ? 0
                : (rows - wbase < OS_WARP_ROWS ? rows - wbase : OS_WARP_ROWS);
  stage_rows<OS_WARP_ROWS>(skey + wbase, key + base + wbase, m, lane);
  if (val) {
    stage_rows<OS_WARP_ROWS>(sval + wbase, val + base + wbase, m, lane);
  } else {                                // no values: each row's index
    for (int i = lane; i < m; i += 32) {
      sval[wbase + i] = (int)(base + wbase + i);
    }
  }
  cp_async_commit();
}

// This warp's digit counts to zero (while its copies are in flight).
__device__ __forceinline__ void zero_counts(OnesweepSmem& sm) {
  cnt_t* wcnt = sm.cnt[threadIdx.x >> 5];
  for (int d = threadIdx.x & 31; d < RADIX_DIGITS; d += 32) wcnt[d] = 0;
}

// One staged tile, its warp's counts zeroed: rank, publish, look back,
// write out.
__device__ __forceinline__ void onesweep_tile(
    OnesweepSmem& sm, const long long* skey, const int* sval, int tile,
    unsigned long long* __restrict__ status,
    long long* __restrict__ key_out, int* __restrict__ val_out,
    long long* __restrict__ val_out64, long long n, int shift, int store_key,
    int* __restrict__ err) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)tile * OS_TILE;
  const int rows = (int)(n - base < OS_TILE ? n - base : OS_TILE);
  const int wbase = warp * OS_WARP_ROWS;
  const int m = rows <= wbase ? 0
                : (rows - wbase < OS_WARP_ROWS ? rows - wbase : OS_WARP_ROWS);
  cnt_t* wcnt = sm.cnt[warp];

  // 1. stable rank of each row among the warp's earlier rows of its digit
  const unsigned below = (1u << lane) - 1u;
  int r[OS_STEPS];
#pragma unroll
  for (int s = 0; s < OS_STEPS; ++s) {
    const int i = s * 32 + lane;
    const bool live = i < m;
    const int d = digit64(live ? skey[wbase + i] : 0ll, shift);
    const unsigned peers = match_digit(d) & __ballot_sync(FULL_MASK, live);
    const int seen = wcnt[d];
    r[s] = seen + __popc(peers & below);
    __syncwarp();
    if (live && (peers >> lane) == 1u) wcnt[d] = (cnt_t)(seen + __popc(peers));  // last lane of its group
    __syncwarp();
  }
  __syncthreads();

  // 2. thread t < 256 owns digit t: the tile's count, published at once
  //    as its aggregate (tile 0's is its inclusive prefix), the exclusive
  //    scan over the warps, then a warp scan over the digits
  int tot = 0;
  if (tid < RADIX_DIGITS) {
#pragma unroll
    for (int w = 0; w < OS_WARPS; ++w) {
      const int c = sm.cnt[w][tid];
      sm.cnt[w][tid] = (cnt_t)tot;
      tot += c;
    }
    st_status(status + (long long)tile * RADIX_DIGITS + tid,
              (tile == 0 ? FLAG_INC : FLAG_AGG) | (unsigned long long)tot);
    const int inc = warp_scan(tot, lane);
    if (lane == 31) sm.wsum[warp] = inc;
    sm.start[tid] = inc - tot;
  }
  __syncthreads();
  if (tid < RADIX_DIGITS) {
    int start = sm.start[tid];
    for (int w = 0; w < warp; ++w) start += sm.wsum[w];
    sm.start[tid] = start;
#pragma unroll
    for (int w = 0; w < OS_WARPS; ++w) sm.cnt[w][tid] += (cnt_t)start;
  }
  __syncthreads();

  // 3. the permutation that sorts the tile by digit; then the look-back,
  //    which the permutation's stores gave the earlier tiles time to feed
#pragma unroll
  for (int s = 0; s < OS_STEPS; ++s) {
    const int i = s * 32 + lane;
    if (i < m) {
      const int row = wbase + i;
      sm.perm[wcnt[digit64(skey[row], shift)] + r[s]] = (unsigned short)row;
    }
  }
  if (tid < RADIX_DIGITS) {
    const long long prefix = look_back(status, tile, tid);
    if (tile > 0) {
      st_status(status + (long long)tile * RADIX_DIGITS + tid,
                FLAG_INC | (unsigned long long)(prefix + tot));
    }
    sm.delta[tid] = (long long)sm.gbase[tid] + prefix - sm.start[tid];
  }
  __syncthreads();

  // 4. coalesced write-out of each digit's run
  bool oob = false;
  for (int j = tid; j < rows; j += OS_THREADS) {
    const int row = sm.perm[j];
    const long long k = skey[row];
    const long long pos = sm.delta[digit64(k, shift)] + j;
    if (pos >= 0 && pos < n) {
      if (store_key) key_out[pos] = k;
      if (val_out64) {
        val_out64[pos] = sval[row];
      } else {
        val_out[pos] = sval[row];
      }
    } else {
      oob = true;
    }
  }
  if (oob) atomicOr(err, 2);
}

__global__ void __launch_bounds__(OS_THREADS)
radix_onesweep64_kernel(const long long* __restrict__ key,
                        const int* __restrict__ val,
                        const int* __restrict__ hist_p,
                        unsigned long long* __restrict__ status_p,
                        int* __restrict__ counter_p,
                        long long* __restrict__ key_out,
                        int* __restrict__ val_out,
                        long long* __restrict__ val_out64, long long n,
                        int shift, int store_key, int* __restrict__ err) {
  extern __shared__ __align__(16) unsigned char smem[];
  OnesweepSmem& sm = *reinterpret_cast<OnesweepSmem*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long n_tiles = (n + OS_TILE - 1) / OS_TILE;

  // prologue: each digit's base, the exclusive scan of the pass's totals
  int h = 0;
  if (tid < RADIX_DIGITS) {
    h = hist_p[tid];
    const int inc = warp_scan(h, lane);
    if (lane == 31) sm.wsum[tid >> 5] = inc;
    sm.gbase[tid] = inc - h;
  }
  __syncthreads();
  if (tid < RADIX_DIGITS) {
    int b = sm.gbase[tid];
    for (int w = 0; w < (tid >> 5); ++w) b += sm.wsum[w];
    sm.gbase[tid] = b;
  }
  // a block takes tiles in the order of the counter until none is left
#if OS_PREFETCH
  // the tile after this one is taken, and staged into the other buffer,
  // before this one is sorted; it publishes its aggregate only when its
  // turn comes, which waits on nothing but tiles before it
  if (tid == 0) sm.tile = atomicAdd(counter_p, 1);
  __syncthreads();
  int tile = sm.tile;
  int buf = 0;
  if (tile < n_tiles) stage_tile(sm.key[0], sm.val[0], tile, key, val, n);
  while (tile < n_tiles) {
    __syncthreads();                      // the other buffer is free
    if (tid == 0) sm.tile = atomicAdd(counter_p, 1);
    __syncthreads();
    const int next = sm.tile;
    if (next < n_tiles) {
      stage_tile(sm.key[buf ^ 1], sm.val[buf ^ 1], next, key, val, n);
      zero_counts(sm);
      cp_async_wait_prior();
    } else {
      zero_counts(sm);
      cp_async_wait_all();
    }
    __syncwarp();
    onesweep_tile(sm, sm.key[buf], sm.val[buf], tile, status_p, key_out,
                  val_out, val_out64, n, shift, store_key, err);
    tile = next;
    buf ^= 1;
  }
#else
  for (;;) {
    if (tid == 0) sm.tile = atomicAdd(counter_p, 1);
    __syncthreads();                      // also: the previous tile is done
    const int tile = sm.tile;
    if (tile >= n_tiles) break;
    stage_tile(sm.key[0], sm.val[0], tile, key, val, n);
    zero_counts(sm);
    cp_async_wait_all();
    __syncwarp();
    onesweep_tile(sm, sm.key[0], sm.val[0], tile, status_p, key_out, val_out,
                  val_out64, n, shift, store_key, err);
    __syncthreads();
  }
#endif
}

// --------------------------------------------------------------------- //
// launchers
// --------------------------------------------------------------------- //

static long long n_tiles_of(long long n) {
  return (n + OS_TILE - 1) / OS_TILE;
}

// What a launch needs of its device, found once a device (the dynamic
// shared memory limits set, the SM count, the blocks an SM holds), so
// that a sort's launches cost the host no attribute queries.
#define MAX_DEVICES 64

struct DeviceSetup {
  bool ready;
  int sms;
  int hist_per_sm[MAX_PASSES + 1];      // by passes
  int pass_per_sm;
};

static DeviceSetup g_setup[MAX_DEVICES];
static std::mutex g_setup_mu;

static int hist_smem(int passes) {
  return HA_WARPS * passes * RADIX_DIGITS * (int)sizeof(int);
}

static int device_setup(int device, const DeviceSetup** out) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_setup_mu);
  DeviceSetup& d = g_setup[device];
  if (!d.ready) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)radix_hist_all64_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, hist_smem(MAX_PASSES));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute((const void*)radix_onesweep64_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(OnesweepSmem));
    }
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                 device);
    }
    for (int p = 1; p <= MAX_PASSES && e == cudaSuccess; ++p) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &d.hist_per_sm[p], radix_hist_all64_kernel, HA_THREADS,
          hist_smem(p));
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &d.pass_per_sm, radix_onesweep64_kernel, OS_THREADS,
          sizeof(OnesweepSmem));
    }
    if (e != cudaSuccess) return (int)e;
    d.ready = true;
  }
  *out = &d;
  return 0;
}

// The error of the launch just issued; one more in *launched (if given)
// when there is none.
static int issued(int* launched) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && launched) ++*launched;
  return (int)e;
}

static int hist_all(const long long* key, int* hist, long long n, int passes,
                    const DeviceSetup& d, cudaStream_t stream,
                    int* launched) {
  // blocks enough to fill the card, none without work
  const long long work = (n / 2 + HA_THREADS * HA_UNROLL - 1)
                         / (HA_THREADS * HA_UNROLL);
  long long blocks = (long long)d.sms * d.hist_per_sm[passes];
  if (work < blocks) blocks = work;
  if (blocks < 1) blocks = 1;
  radix_hist_all64_kernel<<<(unsigned)blocks, HA_THREADS, hist_smem(passes),
                            stream>>>(key, hist, n, passes);
  return issued(launched);
}

static unsigned pass_blocks(long long n, const DeviceSetup& d) {
  const long long tiles = n_tiles_of(n);
#if OS_PERSISTENT || OS_PREFETCH
  const long long resident = (long long)d.sms * d.pass_per_sm;
  return (unsigned)(tiles < resident ? tiles : resident);
#else
  (void)d;
  return (unsigned)tiles;
#endif
}

static int onesweep_pass(const long long* key, const int* val,
                         const int* hist_p, unsigned long long* status_p,
                         int* counter_p, long long* key_out, int* val_out,
                         long long* val_out64, long long n, int shift,
                         int store_key, int* err, unsigned blocks,
                         cudaStream_t stream, int* launched) {
  radix_onesweep64_kernel<<<blocks, OS_THREADS, sizeof(OnesweepSmem),
                            stream>>>(key, val, hist_p, status_p, counter_p,
                                      key_out, val_out, val_out64, n, shift,
                                      store_key, err);
  return issued(launched);
}

// The workspace of one key: the passes' tile counters (64 bytes), their
// histograms (1 KiB each), then their status words (n_tiles x 256 x 8
// bytes each), all zeroed by radix_onesweep64_sort.
#define WS_COUNTERS 64

extern "C" long long radix_onesweep64_workspace_bytes(long long n,
                                                      int passes) {
  return WS_COUNTERS + (long long)passes * RADIX_DIGITS * sizeof(int)
         + (long long)passes * n_tiles_of(n) * RADIX_DIGITS
           * (long long)sizeof(unsigned long long);
}

extern "C" int onesweep_tile_rows(void) { return OS_TILE; }

extern "C" int onesweep_smem_bytes(void) { return (int)sizeof(OnesweepSmem); }

// hist (passes x 256 int32) must be zeroed: the blocks add into it.
// *launched gains one for the launch.
extern "C" int radix_hist_all64_launch(const long long* key, int* hist,
                                       long long n, int passes, int device,
                                       void* stream, int* launched) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0 || passes <= 0) return 0;
  if (passes > MAX_PASSES) return (int)cudaErrorInvalidValue;
  const DeviceSetup* d = nullptr;
  const int rc = device_setup(device, &d);
  if (rc) return rc;
  return hist_all(key, hist, n, passes, *d, (cudaStream_t)stream, launched);
}

// One pass; status_p (n_tiles x 256 words) and *counter_p must be zeroed.
// *launched gains one for the launch.
extern "C" int radix_onesweep64_launch(
    const long long* key, const int* val, const int* hist_p,
    unsigned long long* status_p, int* counter_p, long long* key_out,
    int* val_out, long long n, int shift, int store_key, int* err,
    int device, void* stream, int* launched) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return 0;
  const DeviceSetup* d = nullptr;
  const int rc = device_setup(device, &d);
  if (rc) return rc;
  return onesweep_pass(key, val, hist_p, status_p, counter_p, key_out,
                       val_out, nullptr, n, shift, store_key, err,
                       pass_blocks(n, *d), (cudaStream_t)stream, launched);
}

// A key's passes 0 .. passes-1: pass p reads (key, val) for p = 0, else
// the pair pass p-1 wrote, and writes pair A for an even p, pair B for an
// odd one; the last pass writes no keys, and writes its values as int64
// to val_out64 where one is given.  A null val stands for the row
// indices 0 .. n-1 (the first key of a sort), which the first pass makes
// itself.  So, without val_out64, the values end in val_a for an odd
// number of passes and in val_b for an even one; key_a is needed from 2
// passes on, key_b from 3.  launched[0] gains one for the histogram's
// launch and launched[1] one for each pass's (launched may be null).
extern "C" int radix_onesweep64_sort(
    const long long* key, const int* val, long long* key_a, int* val_a,
    long long* key_b, int* val_b, long long* val_out64, long long n,
    int passes, void* workspace, int* err, int device, void* stream,
    int* launched) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0 || passes <= 0) return 0;
  if (passes > MAX_PASSES) return (int)cudaErrorInvalidValue;
  const DeviceSetup* d = nullptr;
  int rc = device_setup(device, &d);
  if (rc) return rc;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* ws = (unsigned char*)workspace;
  int* counters = (int*)ws;
  int* hist = (int*)(ws + WS_COUNTERS);
  unsigned long long* status =
      (unsigned long long*)(hist + passes * RADIX_DIGITS);
  const long long status_words = n_tiles_of(n) * RADIX_DIGITS;
  e = cudaMemsetAsync(workspace, 0,
                      (size_t)radix_onesweep64_workspace_bytes(n, passes), s);
  if (e != cudaSuccess) return (int)e;
  rc = hist_all(key, hist, n, passes, *d, s, launched);
  if (rc) return rc;
  const unsigned blocks = pass_blocks(n, *d);
  const long long* kin = key;
  const int* vin = val;
  for (int p = 0; p < passes; ++p) {
    long long* kout = (p & 1) ? key_b : key_a;
    int* vout = (p & 1) ? val_b : val_a;
    const bool last = p + 1 == passes;
    rc = onesweep_pass(kin, vin, hist + p * RADIX_DIGITS,
                       status + p * status_words, counters + p, kout, vout,
                       last ? val_out64 : nullptr, n, 8 * p, !last, err,
                       blocks, s, launched ? launched + 1 : nullptr);
    if (rc) return rc;
    kin = kout;
    vin = vout;
  }
  return 0;
}

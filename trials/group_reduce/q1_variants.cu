// Design trials of group_reduce's small-G path at TPC-H Q1's shape:
// G = 12 slots, int32 gids, one bool mask, the four SUM arguments at
// their placed widths (int8 quantity, int32 price, two int64 products),
// nine lanes: the count and the (hi, lo) limbs of each argument.  The
// lanes are fixed at compile time here; the repo's kernel
// (tidb_tpu_torch/copr/cuda/group_reduce.cu) decodes them at run time.
//
//   variant 0, "staged one-hot" (candidate a): a tile of 2048 rows is
//     staged in shared memory; the block's six warps split the nine lanes
//     into three groups of three, two warps a group, and each thread
//     keeps its group's 3 x 12 slots in registers, adding a row by a
//     compare-and-select over the slots;
//   variant 1, "warp tables" (candidate b): a table a warp in shared
//     memory (12 x 9 int64); the warp's 32 rows find their peers of equal
//     gid (__match_any_sync), sum the nine values over the peers by
//     shuffles, and the lowest peer adds the sums to the warp's table
//     (distinct gids, distinct slots: no atomics);
//   variant 2, "private tables, fixed lanes": the repo kernel's design
//     (a table a thread in shared memory, slot-major, thread-minor, four
//     rows a thread a step by vector loads) with the lanes fixed, a row's
//     nine lanes updated together;
//   variant 3: the same, a lane's four rows updated together, then the
//     next lane's (the repo kernel's order, branch-free as it is);
//   variant 4: variant 3 with the lanes' columns read at run time.
// Every variant ends with one device atomic a (lane, slot) a block.
// Built by trials/group_reduce/trial.py, which times the variants and the
// repo kernel on the same inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 12;
constexpr int L = 9;            // count, then (hi, lo) of qty, price, dp, ch
constexpr unsigned FULL = 0xffffffffu;

struct In {
  const int* gid;
  const unsigned char* mask;
  const signed char* qty;
  const int* price;
  const long long* dp;
  const long long* ch;
  long long n;
  unsigned long long* table;    // L x G
};

__device__ __forceinline__ void lanes_of(const In& a, long long i,
                                         long long* v) {
  const long long s[4] = {a.qty[i], a.price[i], a.dp[i], a.ch[i]};
  v[0] = 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[1 + 2 * k] = s[k] >> 32;
    v[2 + 2 * k] = s[k] & 0xffffffffLL;
  }
}

// ---- variant 0: staged tile, lane groups, one-hot registers ----------
constexpr int T0 = 2048, THREADS0 = 192, LPG = 3;

struct Tile0 {
  int gid[T0];
  long long dp[T0], ch[T0];
  int price[T0];
  signed char qty[T0];
  unsigned char mask[T0];
};

__global__ void __launch_bounds__(THREADS0) staged_onehot(In a) {
  extern __shared__ __align__(16) unsigned char raw_smem[];
  Tile0& t = *reinterpret_cast<Tile0*>(raw_smem);
  const int tid = threadIdx.x;
  const int grp = (tid >> 5) / 2;             // two warps a lane group
  const int sub = tid & 63;                   // thread within its group
  long long acc[LPG][G];
#pragma unroll
  for (int l = 0; l < LPG; ++l)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[l][g] = 0;
  for (long long base = (long long)blockIdx.x * T0; base < a.n;
       base += (long long)gridDim.x * T0) {
    __syncthreads();
    for (int r = tid; r < T0; r += THREADS0) {
      const long long i = base + r;
      const bool in = i < a.n;
      t.gid[r] = in ? a.gid[i] : -1;
      t.mask[r] = in ? a.mask[i] : 0;
      t.qty[r] = in ? a.qty[i] : 0;
      t.price[r] = in ? a.price[i] : 0;
      t.dp[r] = in ? a.dp[i] : 0;
      t.ch[r] = in ? a.ch[i] : 0;
    }
    __syncthreads();
    for (int r = sub; r < T0; r += 64) {
      const int g = t.gid[r];
      if (!t.mask[r] || g < 0 || g >= G) continue;
      const long long s[4] = {t.qty[r], t.price[r], t.dp[r], t.ch[r]};
      long long v[L];
      v[0] = 1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[1 + 2 * k] = s[k] >> 32;
        v[2 + 2 * k] = s[k] & 0xffffffffLL;
      }
#pragma unroll
      for (int l = 0; l < LPG; ++l) {
        long long x = grp == 0 ? v[l] : grp == 1 ? v[3 + l] : v[6 + l];
#pragma unroll
        for (int s2 = 0; s2 < G; ++s2) acc[l][s2] += g == s2 ? x : 0;
      }
    }
  }
#pragma unroll
  for (int l = 0; l < LPG; ++l)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      long long v = acc[l][g];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
      if ((tid & 31) == 0 && v)
        atomicAdd(&a.table[(grp * LPG + l) * G + g], (unsigned long long)v);
    }
}

// ---- variant 1: a table a warp, peers by __match_any_sync ------------
constexpr int THREADS1 = 256, WARPS1 = THREADS1 / 32;

__global__ void __launch_bounds__(THREADS1) warp_tables(In a) {
  __shared__ long long tab[WARPS1][L][G];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = lane; j < L * G; j += 32) (&tab[warp][0][0])[j] = 0;
  __syncwarp();
  const long long step = (long long)gridDim.x * THREADS1;
  for (long long base = (long long)blockIdx.x * THREADS1 + warp * 32;
       base < a.n; base += step) {
    const long long i = base + lane;
    int key = -1;
    long long v[L];
#pragma unroll
    for (int l = 0; l < L; ++l) v[l] = 0;
    if (i < a.n && a.mask[i]) {
      const int g = a.gid[i];
      if (g >= 0 && g < G) { key = g; lanes_of(a, i, v); }
    }
    unsigned peers = __match_any_sync(FULL, key);
    const int first = __ffs(peers) - 1;
    // the sum over the peers, at the lowest (Westphal's reduce_peers)
    int rel = __popc(peers << (32 - lane)) ;
    if (lane == 0) rel = 0;
    unsigned rest = peers & (0xfffffffeu << lane);
    while (__any_sync(FULL, rest)) {
      const int next = __ffs(rest);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const long long y = __shfl_sync(FULL, v[l], next ? next - 1 : lane);
        if (next) v[l] += y;
      }
      const unsigned done = __ballot_sync(FULL, rel & 1);
      rest &= ~done;
      rel >>= 1;
    }
    if (key >= 0 && lane == first)
#pragma unroll
      for (int l = 0; l < L; ++l) tab[warp][l][key] += v[l];
    __syncwarp();
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L * G; j += THREADS1) {
    long long s = 0;
    for (int w = 0; w < WARPS1; ++w) s += (&tab[w][0][0])[j];
    if (s) atomicAdd(&a.table[j], (unsigned long long)s);
  }
}

// ---- variants 2-4: private tables, lanes fixed ------------------------
// LANE_MAJOR: a lane's four rows, then the next lane's (the repo kernel's
// order), instead of a row's nine lanes, then the next row's; RT_COLS: the
// lanes' columns read from shared memory at run time
constexpr int THREADS2 = 256, VEC = 4;

template <bool LANE_MAJOR, bool RT_COLS>
__global__ void __launch_bounds__(THREADS2) private_fixed(In a) {
  extern __shared__ long long ptab[];          // G x L x THREADS2
  __shared__ int colv[L];
  const int tid = threadIdx.x;
  if (tid < L) colv[tid] = tid;
  __syncthreads();
  for (int e = 0; e < G * L; ++e) ptab[e * THREADS2 + tid] = 0;
  const long long step = (long long)gridDim.x * THREADS2 * VEC;
  for (long long i0 = ((long long)blockIdx.x * THREADS2 + tid) * VEC;
       i0 < a.n; i0 += step) {
    int g[VEC];
    long long s[4][VEC];
    unsigned m;
    if (i0 + VEC <= a.n) {
      const int4 gv = __ldg((const int4*)(a.gid + i0));
      g[0] = gv.x; g[1] = gv.y; g[2] = gv.z; g[3] = gv.w;
      m = __ldg((const unsigned*)(a.mask + i0));
      const unsigned q = __ldg((const unsigned*)(a.qty + i0));
      const int4 p = __ldg((const int4*)(a.price + i0));
      const longlong2 d0 = __ldg((const longlong2*)(a.dp + i0));
      const longlong2 d1 = __ldg((const longlong2*)(a.dp + i0 + 2));
      const longlong2 c0 = __ldg((const longlong2*)(a.ch + i0));
      const longlong2 c1 = __ldg((const longlong2*)(a.ch + i0 + 2));
#pragma unroll
      for (int u = 0; u < VEC; ++u) s[0][u] = (signed char)(q >> (8 * u));
      s[1][0] = p.x; s[1][1] = p.y; s[1][2] = p.z; s[1][3] = p.w;
      s[2][0] = d0.x; s[2][1] = d0.y; s[2][2] = d1.x; s[2][3] = d1.y;
      s[3][0] = c0.x; s[3][1] = c0.y; s[3][2] = c1.x; s[3][3] = c1.y;
    } else {
      m = 0;
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const long long i = i0 + u;
        const bool in = i < a.n;
        g[u] = in ? a.gid[i] : -1;
        m |= (in ? (unsigned)a.mask[i] : 0u) << (8 * u);
        s[0][u] = in ? a.qty[i] : 0;
        s[1][u] = in ? a.price[i] : 0;
        s[2][u] = in ? a.dp[i] : 0;
        s[3][u] = in ? a.ch[i] : 0;
      }
    }
    if (!LANE_MAJOR) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        if (!((m >> (8 * u)) & 0xffu) || g[u] < 0 || g[u] >= G) continue;
        long long* row = &ptab[g[u] * L * THREADS2 + tid];
        row[0] += 1;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          row[(1 + 2 * k) * THREADS2] += s[k][u] >> 32;
          row[(2 + 2 * k) * THREADS2] += s[k][u] & 0xffffffffLL;
        }
      }
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int c = RT_COLS ? colv[l] : l;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const bool use = ((m >> (8 * u)) & 0xffu) && g[u] >= 0 && g[u] < G;
          const int k = (l - 1) / 2;
          const long long v = l == 0 ? 1
              : (l & 1) ? s[k][u] >> 32 : s[k][u] & 0xffffffffLL;
          long long* p = &ptab[((use ? g[u] : 0) * L + c) * THREADS2 + tid];
          *p += use ? v : 0;
        }
      }
    }
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int e = warp; e < G * L; e += THREADS2 / 32) {
    long long v = 0;
    for (int t = lane; t < THREADS2; t += 32) v += ptab[e * THREADS2 + t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    if (lane == 0 && v)   // entry e = slot e / L, lane e % L
      atomicAdd(&a.table[(e % L) * G + e / L], (unsigned long long)v);
  }
}

int grid_of(const void* k, int threads, size_t smem, long long rows_per_block,
            long long n) {
  int dev = 0, sms = 0, resident = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, k, threads, smem);
  const long long need = (n + rows_per_block - 1) / rows_per_block;
  const long long cap = (long long)resident * sms;
  const long long g = need < cap ? need : cap;
  return g > 0 ? (int)g : 1;
}

}  // namespace

// the table (L x G, lane-major) zeroed, then one variant's launch
extern "C" int q1_variant(int variant, const int* gid,
                          const unsigned char* mask, const signed char* qty,
                          const int* price, const long long* dp,
                          const long long* ch, long long n,
                          unsigned long long* table, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  In a{gid, mask, qty, price, dp, ch, n, table};
  cudaError_t e = cudaMemsetAsync(table, 0, L * G * 8, st);
  if (e != cudaSuccess) return (int)e;
  if (variant == 0) {
    const size_t smem = sizeof(Tile0);
    cudaFuncSetAttribute(staged_onehot,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    staged_onehot<<<grid_of((const void*)staged_onehot, THREADS0, smem, T0,
                            n), THREADS0, smem, st>>>(a);
  } else if (variant == 1) {
    warp_tables<<<grid_of((const void*)warp_tables, THREADS1, 0, THREADS1,
                          n), THREADS1, 0, st>>>(a);
  } else {
    void (*k)(In) = variant == 2 ? private_fixed<false, false>
                    : variant == 3 ? private_fixed<true, false>
                                   : private_fixed<true, true>;
    const size_t smem = (size_t)G * L * THREADS2 * 8;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    k<<<grid_of((const void*)k, THREADS2, smem, THREADS2 * VEC, n),
        THREADS2, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// group_reduce.cu: the masked grouped reductions of an aggregation's
// state table (DENSE/SCALAR, and the segment reduce of SORT, SEGMENT and
// SCATTER), as one CUDA kernel launch for Hopper (sm_90a).
//
// Replaces tidb_tpu/copr/exec.py:87 _reduce, as _one_agg_state (:125)
// and _agg_partial_states (:244) call it once a state lane, which XLA
// fuses into the scan on the TPU (a one-hot compare for G <= 64, a
// scatter beyond).  Here one launch reduces every lane of a state table
// over one read of the gids, the masks and the value columns.
//
// A lane is (kind, source column, mask).  Rows i with mask[i] and
// 0 <= gid[i] < G reduce into slot gid[i] of the lane's table; every
// other row is dropped (G itself is the callers' sink slot).  No gids:
// G == 1.  Kinds:
//   count     the mask's ones                       (int64 sum of 1)
//   sum       the source widened to int64           (wraps as int64)
//   sum_hi32  its high limb, v >> 32                (int64 sum)
//   sum_lo32  its low limb, v & 0xFFFFFFFF          (int64 sum)
//   min, max  the source widened to int64
//   fmin/fmax an order-preserving int64 key of the double; a NaN takes
//             the key that wins (LLONG_MIN for min, LLONG_MAX for max),
//             so NaN propagates as jnp.min/jnp.max propagate it
//   fsum      three 32-bit limbs of the value in fixed point,
//             round(v * 2^s), s = 94 - e, where 2^e bounds the largest
//             finite |v| of the lane (a first pass finds it, one scale a
//             lane).  Limb sums are exact integers (|limb| < 2^32,
//             n < 2^30 rows), so the result is the same bits on every
//             launch; each term is rounded once, to 2^-s, and the total
//             once more when it is turned back into a double.  NaN and
//             +-inf rows set flags instead (NaN, or +inf with -inf,
//             gives NaN).
// Sources are read at their stored width (int8/16/32/64, uint8,
// float32/64) and widened in registers: the callers make no widening,
// limb-split or mask-to-int pass.  A lane takes one int64 table column,
// an fsum lane three.
//
// Bound on the H100 (3.35 TB/s HBM3): each distinct source, mask and the
// gids are read once (4 or 8 B a row), and the G x ncol table written
// once.  TPC-H Q1 (int32 gids, the mask, int8 quantity, int32 price, two
// int64 products, 9 lanes) reads 26 B a row.
//
// Where the table lives, by G x ncol (the table's entries):
//   - up to PRIV_ENTRIES (112): one private table a thread in shared
//     memory (256 threads x 112 x 8 B fill the SM's 227 KB), so a row's
//     lane costs one shared load, an add and a store, whatever G is, with
//     no atomics and no bank conflicts (slot-major, thread-minor).  A
//     block folds its threads' tables warp by warp and adds one partial
//     an entry to device memory.  SCALAR (G = 1) and TPC-H Q1 (G = 12,
//     9 columns) take this path.  A register table a thread cannot hold
//     Q1's 108 entries, and a one-hot compare-and-add over them costs
//     more instructions than the memory bound allows.
//   - up to SMEM_ENTRIES (12288): one table a block in shared memory,
//     updated with shared atomics, then added to device memory with one
//     atomic an entry.
//   - beyond: device atomics into the table itself.  A warp takes 32
//     consecutive rows; rows of equal gid next to each other (SORT and
//     SEGMENT hand over gids in segment order) are summed by a segmented
//     shuffle scan first, and only a run's last row issues the atomics,
//     one a column.  The scan runs only where the warp's ballot of run
//     heads finds a run, so random gids pay one ballot.
// The table is slot-major (entry (g, c) at g ncol + c): a row's columns
// share a sector, so random gids over a table larger than the L2 touch
// one line a row, not one a column.  An all-sum table is zeroed by a
// memset, any other filled by a kernel.
// The first two read each thread's VEC (4) consecutive rows a step with
// one vector load a column where the column's pointer allows it, scalar
// loads for a tail and an unaligned pointer; the last reads a row a
// thread, 32 consecutive rows a warp.  The grid is as many blocks as fit
// on the card at once.
//
// The lanes are decoded at run time: the block's plan (each source's lane
// of each kind, each mask's count lane) is copied to shared memory, and a
// source's kinds run as bodies specialized on the kind and the source's
// dtype, the sources in a run-time loop so that the code stays small.
// trials/group_reduce/ holds the design trials of the small-G path: a
// staged tile with one-hot registers and a table a warp (peers by
// __match_any_sync) lost to the private tables; the private tables with
// the lanes fixed at compile time run at about three times this kernel's
// speed at Q1's shape, the cost of the run-time plan (PERF.md).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// -- the lane arithmetic: plain C++ apart from the __device__ marks, so
// -- that tests/test_torch_group_reduce.py also compiles it for the host

constexpr int MAX_SRCS = 8;          // distinct source columns a launch
constexpr int MAX_MASKS = 8;         // distinct masks a launch
constexpr int MAX_LANES = 32;        // distinct lanes a launch
constexpr int MAX_COLS = 48;         // table columns a launch
constexpr int FSUM_BITS = 94;        // |round(v * 2^s)| < 2^94

enum Dtype { DT_I8 = 0, DT_I16 = 1, DT_I32 = 2, DT_I64 = 3, DT_U8 = 4,
             DT_F32 = 5, DT_F64 = 6 };
enum Kind { K_COUNT = 0, K_SUM = 1, K_SUM_HI32 = 2, K_SUM_LO32 = 3,
            K_MIN = 4, K_MAX = 5, K_FSUM = 6, K_FMIN = 7, K_FMAX = 8 };
enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };

__host__ __device__ constexpr int dtype_bytes(int dt) {
  return dt == DT_I8 || dt == DT_U8 ? 1 : dt == DT_I16 ? 2
         : dt == DT_I32 || dt == DT_F32 ? 4 : 8;
}

// an element's stored bits (its low dtype_bytes bytes) widened: integers
// to int64, floats to the bits of a double
__device__ inline long long widen(int dt, unsigned long long w) {
  switch (dt) {
    case DT_I8: return (long long)(signed char)(unsigned char)(w & 0xffu);
    case DT_I16: return (long long)(short)(unsigned short)(w & 0xffffu);
    case DT_I32: return (long long)(int)(unsigned)(w & 0xffffffffu);
    case DT_U8: return (long long)(w & 0xffu);
    case DT_F32:
      return __double_as_longlong((double)__uint_as_float((unsigned)w));
    default: return (long long)w;
  }
}

__host__ __device__ constexpr int kind_op(int k) {
  return k == K_MIN || k == K_FMIN ? OP_MIN
         : k == K_MAX || k == K_FMAX ? OP_MAX : OP_SUM;
}

__host__ __device__ constexpr int kind_cols(int k) {
  return k == K_FSUM ? 3 : 1;
}

__host__ __device__ constexpr bool kind_float(int k) {
  return k == K_FSUM || k == K_FMIN || k == K_FMAX;
}

__host__ __device__ constexpr long long neutral_of(int op) {
  return op == OP_SUM ? 0LL : (op == OP_MIN ? LLONG_MAX : LLONG_MIN);
}

__host__ __device__ inline long long combine(int op, long long a,
                                             long long b) {
  if (op == OP_SUM)
    return (long long)((unsigned long long)a + (unsigned long long)b);
  if (op == OP_MIN) return a < b ? a : b;
  return a > b ? a : b;
}

__device__ inline bool bits_nonfinite(long long b) {
  return ((b >> 52) & 0x7ff) == 0x7ff;
}

__device__ inline bool bits_nan(long long b) {
  return bits_nonfinite(b) && (b & 0xfffffffffffffLL) != 0;
}

// order-preserving int64 key of a double's bits (-0.0 below +0.0); the
// keys LLONG_MIN and LLONG_MAX belong to NaNs only
__device__ inline long long f64_key(long long b, bool nan_low) {
  if (bits_nan(b)) return nan_low ? LLONG_MIN : LLONG_MAX;
  return b >= 0 ? b : (b ^ LLONG_MAX);
}

__device__ inline double f64_of_key(long long k) {
  return __longlong_as_double(k >= 0 ? k : (k ^ LLONG_MAX));
}

// s with |v| * 2^s < 2^FSUM_BITS for every finite |v| <= the lane's max
__device__ inline int fsum_scale(unsigned long long mx) {
  const long long b = (long long)mx;
  if (b == 0) return 0;
  const int biased = (int)((b >> 52) & 0x7ff);
  return FSUM_BITS - ((biased > 0 ? biased : 1) - 1022);
}

// three signed 32-bit limbs, limb l of weight 2^(32 l), of round(v 2^s)
__device__ inline void fsum_limbs(double v, int s, long long* ln) {
  const double q = rint(ldexp(v, s));
  const double a = fabs(q);
  const double hi = floor(ldexp(a, -64));              // < 2^30
  // exact: a - hi 2^64 is a multiple of a's last place below 2^64
  const unsigned long long r = (unsigned long long)(a - ldexp(hi, 64));
  long long l0 = (long long)(r & 0xffffffffULL);
  long long l1 = (long long)(r >> 32);
  long long l2 = (long long)hi;
  if (q < 0) { l0 = -l0; l1 = -l1; l2 = -l2; }
  ln[0] = l0; ln[1] = l1; ln[2] = l2;
}

// a row's columns for a lane of kind k over its widened source value w;
// an fsum row that is NaN or +-inf returns its flag (1 NaN, 2 +inf,
// 4 -inf) and has no columns
__device__ inline int lane_value(int k, long long w, int scale,
                                 long long* ln) {
  switch (k) {
    case K_COUNT: ln[0] = 1; return 0;
    case K_SUM_HI32: ln[0] = w >> 32; return 0;
    case K_SUM_LO32: ln[0] = w & 0xffffffffLL; return 0;
    case K_FMIN: ln[0] = f64_key(w, true); return 0;
    case K_FMAX: ln[0] = f64_key(w, false); return 0;
    case K_FSUM:
      if (bits_nonfinite(w)) return bits_nan(w) ? 1 : (w > 0 ? 2 : 4);
      fsum_limbs(__longlong_as_double(w), scale, ln);
      return 0;
    default: ln[0] = w; return 0;     // sum, min, max
  }
}

// a float lane's slot back to a double: e points at the slot's entry of
// the lane's first column (an fsum lane's three limbs follow it), flag
// is the slot's fsum flags, mx the lane's largest finite |v| bits
__device__ inline double finalize_float(int k, const long long* e, int flag,
                                        unsigned long long mx) {
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const double pinf = __longlong_as_double(0x7ff0000000000000LL);
  const double ninf = __longlong_as_double((long long)0xfff0000000000000ULL);
  if (k == K_FMIN || k == K_FMAX) {
    const long long key = e[0];
    if (key == (k == K_FMIN ? LLONG_MIN : LLONG_MAX)) return nan;
    if (key == (k == K_FMIN ? LLONG_MAX : LLONG_MIN))   // no row reached g
      return k == K_FMIN ? pinf : ninf;
    return f64_of_key(key);
  }
  if ((flag & 1) || (flag & 6) == 6) return nan;
  if (flag & 2) return pinf;
  if (flag & 4) return ninf;
  // carry the limbs into hi 2^64 + lo with lo in [0, 2^64)
  const long long l0 = e[0];
  const long long l1 = e[1] + (l0 >> 32);
  long long hi = e[2] + (l1 >> 32);
  unsigned long long lo = ((unsigned long long)(l1 & 0xffffffffLL) << 32) |
                          (unsigned long long)(l0 & 0xffffffffLL);
  const bool neg = hi < 0;
  if (neg) {                                     // two's-complement negate
    lo = ~lo + 1ULL;
    hi = ~hi + (lo == 0ULL ? 1 : 0);
  }
  const double mag = ldexp((double)hi, 64) + (double)lo;
  return ldexp(neg ? -mag : mag, -fsum_scale(mx));
}

// -- end of the lane arithmetic --

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;               // consecutive rows a thread a step
constexpr int UNROLL = 4;            // device-memory path: rows a thread a
                                     // step
constexpr int PRIV_ENTRIES = 112;    // 256 x 112 x 8 B + the plan <= 227 KB
constexpr int SMEM_ENTRIES = 12288;  // 96 KB a block
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int N_KINDS = K_FMAX + 1;

enum Mode { M_PRIV = 0, M_SMEM = 1, M_GLOBAL = 2 };

struct LaneDesc {
  int kind, mask, col;
  int flag;                 // fsum: its row of flags, else -1
  int fout;                 // float kinds: its row of out, else -1
};

struct Args {
  const void* gids;         // int32 or int64, or null
  int gid_bytes;            // 4, 8, or 0 (no gids: every row slot 0)
  int gid_vec;              // gids may take vector loads
  long long n, G;
  int nsrc, nmask, nlane, ncol;
  const void* src[MAX_SRCS];
  int src_dt[MAX_SRCS];
  int src_vec[MAX_SRCS];
  const unsigned char* mask[MAX_MASKS];
  int mask_vec[MAX_MASKS];
  // the lane of source s and kind k, or -1 (a launch has at most one);
  // the count lane of mask k, or -1
  int plan[MAX_SRCS][N_KINDS];
  int count_of[MAX_MASKS];
  LaneDesc lane[MAX_LANES];
  int col_op[MAX_COLS];
  long long* table;         // G x ncol, slot-major: (g, c) at g ncol + c
  int* flags;               // fsum lanes x G
  unsigned long long* mx;   // a lane: its largest finite |v| (fsum)
};

template <class T>
__device__ __forceinline__ T ldg(const void* p, long long byte_off) {
  return __ldg((const T*)((const char*)p + byte_off));
}

__device__ __forceinline__ unsigned long long ld_elem(const void* p, int b,
                                                      long long i) {
  if (b == 1) return ldg<unsigned char>(p, i);
  if (b == 2) return ldg<unsigned short>(p, 2 * i);
  if (b == 4) return ldg<unsigned int>(p, 4 * i);
  return ldg<unsigned long long>(p, 8 * i);
}

// a step's VEC elements of one column as loaded, up to 32 bytes; nothing
// reads them before the step has issued all its loads, so one step waits
// on device memory once, not once a column
struct Raw {
  uint4 a, b;
};

// element u (0 <= u < VEC, unrolled) of a Raw at its stored width b
__device__ __forceinline__ unsigned long long elem(const Raw& r, int b,
                                                   int u) {
  if (b == 8) {
    const uint4& q = u < 2 ? r.a : r.b;
    return (u & 1) ? ((unsigned long long)q.w << 32 | q.z)
                   : ((unsigned long long)q.y << 32 | q.x);
  }
  if (b == 4) return u == 0 ? r.a.x : u == 1 ? r.a.y : u == 2 ? r.a.z : r.a.w;
  if (b == 2) return ((u < 2 ? r.a.x : r.a.y) >> (16 * (u & 1))) & 0xffffu;
  return (r.a.x >> (8 * u)) & 0xffu;
}

__device__ __forceinline__ void put(Raw& r, int b, int u,
                                    unsigned long long w) {
  if (b == 8) {
    uint4& q = u < 2 ? r.a : r.b;
    if (u & 1) { q.z = (unsigned)w; q.w = (unsigned)(w >> 32); }
    else { q.x = (unsigned)w; q.y = (unsigned)(w >> 32); }
  } else if (b == 4) {
    (u == 0 ? r.a.x : u == 1 ? r.a.y : u == 2 ? r.a.z : r.a.w) = (unsigned)w;
  } else if (b == 2) {
    (u < 2 ? r.a.x : r.a.y) |= (unsigned)(w & 0xffffu) << (16 * (u & 1));
  } else {
    r.a.x |= (unsigned)(w & 0xffu) << (8 * u);
  }
}

// VEC consecutive elements from row i0: one or two vector loads where
// the pointer allows and the rows are whole, else scalar loads (0 past n)
__device__ __forceinline__ void ld_raw(const void* p, int b, int vec,
                                       long long i0, long long n, Raw& r) {
  r.a = make_uint4(0u, 0u, 0u, 0u);
  r.b = r.a;
  if (vec && i0 + VEC <= n) {
    if (b == 8) {
      r.a = ldg<uint4>(p, 8 * i0);
      r.b = ldg<uint4>(p, 8 * i0 + 16);
    } else if (b == 4) {
      r.a = ldg<uint4>(p, 4 * i0);
    } else if (b == 2) {
      const uint2 x = ldg<uint2>(p, 2 * i0);
      r.a.x = x.x;
      r.a.y = x.y;
    } else {
      r.a.x = ldg<unsigned>(p, i0);
    }
  } else {
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      if (i0 + u < n) put(r, b, u, ld_elem(p, b, i0 + u));
  }
}

// the masks of VEC rows from i0, byte u for row u (0 past n)
__device__ __forceinline__ unsigned ld_mask(const unsigned char* p, int vec,
                                            long long i0, long long n) {
  if (vec && i0 + VEC <= n) return ldg<unsigned>(p, i0);
  unsigned m = 0;
#pragma unroll
  for (int u = 0; u < VEC; ++u)
    if (i0 + u < n) m |= (unsigned)ldg<unsigned char>(p, i0 + u) << (8 * u);
  return m;
}

// the loads of the step at row i0 (none past n): the gids, the masks
// and each source
template <int NS>
__device__ __forceinline__ void load_step(const Args& a, long long i0,
                                          Raw& gr, unsigned* mw, Raw* rs) {
  if (a.gid_bytes) ld_raw(a.gids, a.gid_bytes, a.gid_vec, i0, a.n, gr);
#pragma unroll
  for (int k = 0; k < MAX_MASKS; ++k)
    mw[k] = k < a.nmask ? ld_mask(a.mask[k], a.mask_vec[k], i0, a.n) : 0u;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (s < a.nsrc)
      ld_raw(a.src[s], dtype_bytes(a.src_dt[s]), a.src_vec[s], i0, a.n, rs[s]);
}

__device__ __forceinline__ long long ld_gid(const Args& a, long long i) {
  if (a.gid_bytes == 4) return ldg<int>(a.gids, 4 * i);
  if (a.gid_bytes == 8) return ldg<long long>(a.gids, 8 * i);
  return 0;
}

__device__ __forceinline__ void atomic_combine(int op, long long* p,
                                               long long v) {
  if (op == OP_SUM)
    atomicAdd((unsigned long long*)p, (unsigned long long)v);
  else if (op == OP_MIN)
    atomicMin(p, v);
  else
    atomicMax(p, v);
}

// the launch's plan, copied from the parameters to shared memory once a
// block, so that a step reads it with a broadcast shared load
struct Plan {
  int sk[MAX_SRCS][N_KINDS];  // source s's lane of kind k: col << 8 | mask
  int ck[MAX_MASKS];          // mask k's count lane: its col (or -1)
  int fs_flag[MAX_SRCS];      // source s's fsum lane: its row of flags
  int fs_scale[MAX_SRCS];     // and its scale, from the prepass
};

__device__ __forceinline__ void load_plan(const Args& a, Plan& p) {
  for (int j = threadIdx.x; j < MAX_SRCS * N_KINDS; j += blockDim.x) {
    const int s = j / N_KINDS, k = j % N_KINDS, l = a.plan[s][k];
    p.sk[s][k] = l < 0 ? -1 : (a.lane[l].col << 8 | a.lane[l].mask);
    if (k == K_FSUM) {
      p.fs_flag[s] = l < 0 ? 0 : a.lane[l].flag;
      p.fs_scale[s] = l < 0 ? 0 : fsum_scale(a.mx[l]);
    }
  }
  if (threadIdx.x < MAX_MASKS) {
    const int l = a.count_of[threadIdx.x];
    p.ck[threadIdx.x] = l < 0 ? -1 : a.lane[l].col;
  }
}

// the byte-per-row mask words of a lane
__device__ __forceinline__ unsigned pick(const unsigned* mw, int m) {
  unsigned w = mw[0];
#pragma unroll
  for (int k = 1; k < MAX_MASKS; ++k)
    if (m == k) w = mw[k];
  return w;
}

// a lane of kind K over a thread's VEC rows (raw: its source's widened
// values; col, its first column; mask, its mask's index; flag and scale
// for fsum), into the private (M_PRIV) or block (M_SMEM) table in shared
// memory: slot[u] is row u's slot (-1: dropped), off[u] its offset in a
// private table (slot 0's for a dropped row).  The kind is a template
// argument, so a row costs its mask bit, its transform and, a column, one
// shared load, combine and store (M_PRIV) or one shared atomic (M_SMEM)
template <int MODE, int K>
__device__ __forceinline__ void lane_rows(const Args& a, int col, int mask,
                                          int flag_row, int scale,
                                          const long long* raw,
                                          const int* slot, const int* off,
                                          const unsigned* mw,
                                          long long* tab) {
  constexpr int OP = kind_op(K), NC = kind_cols(K);
  constexpr long long NEU = neutral_of(OP);
  const unsigned m = a.nmask == 1 ? mw[0] : pick(mw, mask);
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    long long ln[3];
    const int flag = lane_value(K, raw[u], scale, ln);
    bool use = slot[u] >= 0 && ((m >> (8 * u)) & 0xffu);
    if (K == K_FSUM && use && flag) {    // a NaN or +-inf fsum row
      atomicOr(&a.flags[flag_row * a.G + slot[u]], flag);
      use = false;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if constexpr (MODE == M_PRIV) {
        // branch-free: a row that does not reduce adds the neutral to
        // slot 0 (its off[u]), so the warp never diverges here
        long long* p = &tab[off[u] + (col + c) * THREADS];
        *p = combine(OP, *p, use ? ln[c] : NEU);
      } else if (use) {
        atomic_combine(OP, &tab[slot[u] * a.ncol + col + c], ln[c]);
      }
    }
  }
}

// the lanes of source s, whose dtype DT is a template argument (so its
// VEC elements decode with a shift or two), each present kind a
// specialized body
template <int MODE, int DT>
__device__ __forceinline__ void source_step(const Args& a, const Plan& pl,
                                            int s, const Raw& r,
                                            const int* slot, const int* off,
                                            const unsigned* mw,
                                            long long* tab) {
  long long raw[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u)
    raw[u] = widen(DT, elem(r, dtype_bytes(DT), u));
#define GR_ROWS(K)                                                         \
  if (pl.sk[s][K] >= 0)                                                    \
    lane_rows<MODE, K>(a, pl.sk[s][K] >> 8, pl.sk[s][K] & 0xff,            \
                       pl.fs_flag[s], pl.fs_scale[s], raw, slot, off, mw, tab)
  if constexpr (DT >= DT_F32) {
    GR_ROWS(K_FSUM); GR_ROWS(K_FMIN); GR_ROWS(K_FMAX);
  } else {
    GR_ROWS(K_SUM); GR_ROWS(K_SUM_HI32); GR_ROWS(K_SUM_LO32);
    GR_ROWS(K_MIN); GR_ROWS(K_MAX);
  }
#undef GR_ROWS
}

template <int MODE>
__device__ __forceinline__ void source_lanes(const Args& a, const Plan& pl,
                                             int s, const Raw& r,
                                             const int* slot, const int* off,
                                             const unsigned* mw,
                                             long long* tab) {
  switch (a.src_dt[s]) {
#define GR_DT(DT) \
    case DT: source_step<MODE, DT>(a, pl, s, r, slot, off, mw, tab); break
    GR_DT(DT_I8); GR_DT(DT_I16); GR_DT(DT_I32); GR_DT(DT_U8);
    GR_DT(DT_F32); GR_DT(DT_F64);
    default: source_step<MODE, DT_I64>(a, pl, s, r, slot, off, mw, tab);
#undef GR_DT
  }
}

// the table in shared memory: M_PRIV one a thread, slot-major,
// thread-minor (G x ncol x THREADS); M_SMEM one a block, slot-major, as
// the table in device memory.
// NS bounds the sources (nsrc <= NS), so the step's loads take only the
// registers they need
template <int MODE, int NS>
__global__ void __launch_bounds__(THREADS)
group_reduce_lanes_kernel(const __grid_constant__ Args a) {
  extern __shared__ long long tab[];
  __shared__ Plan pl;
  const int tid = threadIdx.x;
  const int entries = (int)a.G * a.ncol;
  if constexpr (MODE == M_PRIV) {
    for (int e = 0; e < entries; ++e)
      tab[e * THREADS + tid] = neutral_of(a.col_op[e % a.ncol]);
  } else {
    for (int e = tid; e < entries; e += THREADS)
      tab[e] = neutral_of(a.col_op[e % a.ncol]);
  }
  load_plan(a, pl);
  __syncthreads();

  const long long step = (long long)gridDim.x * THREADS * VEC;
  for (long long i0 = ((long long)blockIdx.x * THREADS + tid) * VEC;
       i0 < a.n; i0 += step) {
    // every load of the step first, then the lanes
    Raw gr = {}, rs[NS];
    unsigned mw[MAX_MASKS];
    load_step<NS>(a, i0, gr, mw, rs);
    long long g[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      g[u] = a.gid_bytes == 4 ? widen(DT_I32, elem(gr, 4, u))
             : a.gid_bytes == 8 ? (long long)elem(gr, 8, u) : 0;
    int slot[VEC], off[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      slot[u] = i0 + u < a.n && g[u] >= 0 && g[u] < a.G ? (int)g[u] : -1;
      off[u] = (slot[u] < 0 ? 0 : slot[u]) * a.ncol * THREADS + tid;
    }
    // one body a source (a run-time loop; the source's registers come by
    // a select over the NS loaded ones), so the code stays small
#pragma unroll 1
    for (int s = 0; s < a.nsrc; ++s) {
      Raw r = rs[0];
#pragma unroll
      for (int t = 1; t < NS; ++t)
        if (s == t) r = rs[t];
      source_lanes<MODE>(a, pl, s, r, slot, off, mw, tab);
    }
    const long long none[VEC] = {0, 0, 0, 0};
#pragma unroll 1
    for (int k = 0; k < a.nmask; ++k)
      if (pl.ck[k] >= 0)
        lane_rows<MODE, K_COUNT>(a, pl.ck[k], k, 0, 0, none, slot, off, mw,
                                 tab);
  }
  __syncthreads();

  if constexpr (MODE == M_PRIV) {
    // warp w folds entries w, w + WARPS, ..: a lane 8 threads' values,
    // then shuffles; one atomic an entry that any row reached
    const int lane = tid & 31, warp = tid >> 5;
    for (int e = warp; e < entries; e += WARPS) {
      const int c = e % a.ncol;
      const int op = a.col_op[c];
      long long v = neutral_of(op);
#pragma unroll
      for (int t = lane; t < THREADS; t += 32)
        v = combine(op, v, tab[e * THREADS + t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v = combine(op, v, __shfl_down_sync(FULL_MASK, v, o));
      if (lane == 0 && v != neutral_of(op))
        atomic_combine(op, &a.table[e], v);
    }
  } else {
    for (int e = tid; e < entries; e += THREADS) {
      const int op = a.col_op[e % a.ncol];
      if (tab[e] != neutral_of(op)) atomic_combine(op, &a.table[e], tab[e]);
    }
  }
}

// one column's value of a row of the warp's 32 consecutive rows (x, the
// neutral for a row that does not reduce): the rows of a run (equal
// adjacent keys, first..last) are summed by a segmented shuffle scan
// where the warp has runs, and a run's last row adds the run with one
// device atomic
template <int OP>
__device__ __forceinline__ void run_add(const Args& a, int col, long long x,
                                        long long key, bool runs, int first,
                                        bool last) {
  constexpr long long NEU = neutral_of(OP);
  const int lane = threadIdx.x & 31;
  if (runs) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL_MASK, x, o);
      if (lane - o >= first) x = combine(OP, x, y);
    }
  }
  if (last && key >= 0 && x != NEU)
    atomic_combine(OP, &a.table[key * a.ncol + col], x);
}

// a lane of kind K (col, mask, flag_row and scale as lane_rows takes
// them) at one row a thread (w: its source's widened value, u: the row's
// byte in the mask words)
template <int K>
__device__ __forceinline__ void run_lane(const Args& a, int col, int mask,
                                         int flag_row, int scale, long long w,
                                         const unsigned* mw, int u,
                                         long long key, bool runs, int first,
                                         bool last) {
  constexpr int OP = kind_op(K), NC = kind_cols(K);
  constexpr long long NEU = neutral_of(OP);
  long long ln[3] = {NEU, NEU, NEU};
  const unsigned m = a.nmask == 1 ? mw[0] : pick(mw, mask);
  if (key >= 0 && ((m >> (8 * u)) & 0xffu)) {
    const int flag = lane_value(K, w, scale, ln);
    if (K == K_FSUM && flag) {
      atomicOr(&a.flags[flag_row * a.G + key], flag);
      ln[0] = ln[1] = ln[2] = NEU;
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
    run_add<OP>(a, col + c, ln[c], key, runs, first, last);
}

// the lanes of source s, of dtype DT, at one row a thread
template <int DT>
__device__ __forceinline__ void run_source(const Args& a, const Plan& pl,
                                           int s, unsigned long long bits,
                                           const unsigned* mw, int u,
                                           long long key, bool runs,
                                           int first, bool last) {
  const long long w = widen(DT, bits);
#define GR_RUN(K)                                                       \
  if (pl.sk[s][K] >= 0)                                                 \
    run_lane<K>(a, pl.sk[s][K] >> 8, pl.sk[s][K] & 0xff, pl.fs_flag[s], \
                pl.fs_scale[s], w, mw, u, key, runs, first, last)
  if constexpr (DT >= DT_F32) {
    GR_RUN(K_FSUM); GR_RUN(K_FMIN); GR_RUN(K_FMAX);
  } else {
    GR_RUN(K_SUM); GR_RUN(K_SUM_HI32); GR_RUN(K_SUM_LO32);
    GR_RUN(K_MIN); GR_RUN(K_MAX);
  }
#undef GR_RUN
}

// the table in device memory: a warp takes UNROLL runs of 32 consecutive
// rows, each row a thread (run_add)
template <int NS>
__global__ void __launch_bounds__(THREADS)
group_reduce_lanes_global_kernel(const __grid_constant__ Args a) {
  __shared__ Plan pl;
  load_plan(a, pl);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long base = warp * 32 * UNROLL; base < a.n; base += step) {
    // the gids and the sources of the step first, then the masks, each
    // folded into its word as it arrives (the gids' and sources' loads
    // are in flight by then)
    long long gid[UNROLL];
    unsigned long long bits[NS][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * 32 + lane;
      const bool in = i < a.n;
      gid[u] = in ? ld_gid(a, i) : -1;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        bits[s][u] = s < a.nsrc && in
            ? ld_elem(a.src[s], dtype_bytes(a.src_dt[s]), i) : 0ull;
    }
    unsigned mw[MAX_MASKS];
#pragma unroll
    for (int k = 0; k < MAX_MASKS; ++k) {
      mw[k] = 0;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + u * 32 + lane;
        if (k < a.nmask && i < a.n && ldg<unsigned char>(a.mask[k], i))
          mw[k] |= 1u << (8 * u);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long key = gid[u] >= 0 && gid[u] < a.G ? gid[u] : -1;
      const long long prev = __shfl_up_sync(FULL_MASK, key, 1);
      const unsigned heads =
          __ballot_sync(FULL_MASK, lane == 0 || prev != key);
      const bool runs = heads != FULL_MASK;       // warp-uniform
      // the first row of this row's run, and whether this row ends it
      const int first = 31 - __clz(heads & (FULL_MASK >> (31 - lane)));
      const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
#pragma unroll 1
      for (int s = 0; s < a.nsrc; ++s) {
        unsigned long long b = bits[0][u];
#pragma unroll
        for (int t = 1; t < NS; ++t)
          if (s == t) b = bits[t][u];
        switch (a.src_dt[s]) {
#define GR_DT(DT)                                                        \
          case DT:                                                       \
            run_source<DT>(a, pl, s, b, mw, u, key, runs, first, last);  \
            break
          GR_DT(DT_I8); GR_DT(DT_I16); GR_DT(DT_I32); GR_DT(DT_U8);
          GR_DT(DT_F32); GR_DT(DT_F64);
          default: run_source<DT_I64>(a, pl, s, b, mw, u, key, runs, first,
                                      last);
#undef GR_DT
        }
      }
#pragma unroll 1
      for (int k = 0; k < a.nmask; ++k)
        if (pl.ck[k] >= 0)
          run_lane<K_COUNT>(a, pl.ck[k], k, 0, 0, 0, mw, u, key, runs, first,
                            last);
    }
  }
}

// every entry at its column's neutral (entry j is column j % ncol), by
// consecutive threads on consecutive entries
__global__ void group_reduce_fill_kernel(const __grid_constant__ Args a) {
  const long long total = a.G * a.ncol;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < total; j += (long long)gridDim.x * blockDim.x)
    a.table[j] = neutral_of(a.col_op[j % a.ncol]);
}

// fsum lane l: the bits of the largest finite |v| over the rows that
// reduce, read over its source, its mask and the gids only
__global__ void __launch_bounds__(THREADS)
group_reduce_fsum_maxabs_kernel(const __grid_constant__ Args a, int l,
                                int s) {
  const LaneDesc d = a.lane[l];
  const int b = dtype_bytes(a.src_dt[s]);
  unsigned long long m = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.n;
       i += (long long)gridDim.x * THREADS) {
    if (!ldg<unsigned char>(a.mask[d.mask], i)) continue;
    const long long g = ld_gid(a, i);
    const long long w = widen(a.src_dt[s], ld_elem(a.src[s], b, i));
    if (g < 0 || g >= a.G || bits_nonfinite(w)) continue;
    const unsigned long long ab = (unsigned long long)(w & LLONG_MAX);
    m = ab > m ? ab : m;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_down_sync(FULL_MASK, m, o);
    m = y > m ? y : m;
  }
  if ((threadIdx.x & 31) == 0 && m) atomicMax(&a.mx[l], m);
}

// the float lanes' tables back to doubles, out row d.fout
__global__ void group_reduce_finalize_kernel(const __grid_constant__ Args a,
                                             double* out) {
  for (int l = 0; l < a.nlane; ++l) {
    const LaneDesc d = a.lane[l];
    if (d.fout < 0) continue;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < a.G; g += (long long)gridDim.x * blockDim.x)
      out[d.fout * a.G + g] = finalize_float(
          d.kind, &a.table[g * a.ncol + d.col],
          d.flag >= 0 ? a.flags[d.flag * a.G + g] : 0, a.mx[l]);
  }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device >= 0 && device < 64 && cached[device]) return cached[device];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  n = n > 0 ? n : 1;
  if (device >= 0 && device < 64) cached[device] = n;
  return n;
}

int grid_for(long long work, int per_block, int resident, int device) {
  const long long need = (work + per_block - 1) / per_block;
  const long long cap = (long long)resident * sm_count(device);
  const long long g = need < cap ? need : cap;
  return g > 0 ? (int)g : 1;
}

int mode_of(long long G, int ncol) {
  const long long entries = G * ncol;
  return entries <= PRIV_ENTRIES ? M_PRIV
         : entries <= SMEM_ENTRIES ? M_SMEM : M_GLOBAL;
}

template <class K>
int launch_main(K kernel, const Args& a, size_t smem, int per_block,
                int device, cudaStream_t st, int* launches) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                    THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid_for(a.n, per_block, resident, device), THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launches;
  return (int)e;
}

// the main kernel of the table's mode, for up to NS sources
template <int NS>
int launch_mode(const Args& a, long long total, int device, cudaStream_t st,
                int* launches) {
  switch (mode_of(a.G, a.ncol)) {
    case M_PRIV:
      return launch_main(group_reduce_lanes_kernel<M_PRIV, NS>, a,
                         (size_t)total * THREADS * sizeof(long long),
                         THREADS * VEC, device, st, launches);
    case M_SMEM:
      return launch_main(group_reduce_lanes_kernel<M_SMEM, NS>, a,
                         (size_t)total * sizeof(long long), THREADS * VEC,
                         device, st, launches);
    default:
      return launch_main(group_reduce_lanes_global_kernel<NS>, a, 0,
                         THREADS * UNROLL, device, st, launches);
  }
}

bool aligned(const void* p, int b) {
  const int need = b * VEC < 16 ? b * VEC : 16;
  return ((uintptr_t)p % need) == 0;
}

}  // namespace

extern "C" int group_reduce_limits(int* out) {
  out[0] = MAX_SRCS; out[1] = MAX_MASKS; out[2] = MAX_LANES;
  out[3] = MAX_COLS; out[4] = PRIV_ENTRIES; out[5] = SMEM_ENTRIES;
  return 0;
}

// One state table: nlane lanes, lane l = (kinds[l], srcs_of[l], masks_of
// [l]) (srcs_of -1 for a count), at most one a (source, kind) and one
// count a mask, a float kind only over a float source and an integer
// kind only over an integer one.  table: G x ncol int64, slot-major
// (the columns in lane order, an fsum lane three); flags: G int32 an
// fsum lane, in lane order; mx: nlane uint64; out: G doubles a float
// lane, in lane order.  Adds one to *launches for the launch of the main
// kernel (the fill, the fsum prepass and the finalize are not counted).
extern "C" int group_reduce_lanes_launch(
    const void* gids, int gid_bytes, long long n, long long G,
    int nsrc, const void* const* srcs, const int* src_dts,
    int nmask, const void* const* masks,
    int nlane, const int* kinds, const int* srcs_of, const int* masks_of,
    long long* table, int* flags, unsigned long long* mx, double* out,
    int device, void* stream, int* launches) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (G < 1 || n < 0 || (gid_bytes != 0 && gid_bytes != 4 && gid_bytes != 8)
      || (gid_bytes == 0 && G != 1) || nsrc < 0 || nsrc > MAX_SRCS
      || nmask < 1 || nmask > MAX_MASKS || nlane < 1 || nlane > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.gids = gids; a.gid_bytes = gid_bytes; a.n = n; a.G = G;
  a.gid_vec = gid_bytes && aligned(gids, gid_bytes);
  a.nsrc = nsrc; a.nmask = nmask; a.nlane = nlane;
  for (int s = 0; s < nsrc; ++s) {
    if (src_dts[s] < DT_I8 || src_dts[s] > DT_F64)
      return (int)cudaErrorInvalidValue;
    a.src[s] = srcs[s]; a.src_dt[s] = src_dts[s];
    a.src_vec[s] = aligned(srcs[s], dtype_bytes(src_dts[s]));
  }
  for (int k = 0; k < nmask; ++k) {
    a.mask[k] = (const unsigned char*)masks[k];
    a.mask_vec[k] = aligned(masks[k], 1);
  }
  for (int s = 0; s < MAX_SRCS; ++s)
    for (int k = 0; k < N_KINDS; ++k) a.plan[s][k] = -1;
  for (int k = 0; k < MAX_MASKS; ++k) a.count_of[k] = -1;
  int col = 0, nflag = 0, nout = 0;
  for (int l = 0; l < nlane; ++l) {
    const int k = kinds[l], s = srcs_of[l], m = masks_of[l];
    if (k < K_COUNT || k > K_FMAX || m < 0 || m >= nmask || s >= nsrc
        || (k == K_COUNT) != (s < 0) || col + kind_cols(k) > MAX_COLS)
      return (int)cudaErrorInvalidValue;
    // a source's dtype family takes only its kinds
    if (s >= 0 && (src_dts[s] >= DT_F32) != kind_float(k))
      return (int)cudaErrorInvalidValue;
    int& slot = s < 0 ? a.count_of[m] : a.plan[s][k];
    if (slot >= 0) return (int)cudaErrorInvalidValue;   // one a launch
    slot = l;
    a.lane[l] = LaneDesc{k, m, col, k == K_FSUM ? nflag++ : -1,
                         kind_float(k) ? nout++ : -1};
    for (int c = 0; c < kind_cols(k); ++c) a.col_op[col + c] = kind_op(k);
    col += kind_cols(k);
  }
  a.ncol = col;
  a.table = table; a.flags = flags; a.mx = mx;
  cudaStream_t st = (cudaStream_t)stream;

  const long long total = (long long)col * G;
  bool sums = true;                       // every neutral 0: a memset
  for (int c = 0; c < col; ++c) sums = sums && a.col_op[c] == OP_SUM;
  if (sums) {
    e = cudaMemsetAsync(table, 0, total * sizeof(long long), st);
  } else {
    group_reduce_fill_kernel<<<grid_for(total, 256, 8, device), 256, 0,
                               st>>>(a);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(mx, 0, nlane * sizeof(*mx), st);
  if (e == cudaSuccess && nflag)
    e = cudaMemsetAsync(flags, 0, nflag * G * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  for (int l = 0; l < nlane && n > 0; ++l) {
    if (kinds[l] != K_FSUM) continue;
    group_reduce_fsum_maxabs_kernel<<<grid_for(n, THREADS, 8, device),
                                      THREADS, 0, st>>>(a, l, srcs_of[l]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int ns = nsrc <= 2 ? 2 : nsrc <= 4 ? 4 : 8;
  const int rc = ns == 2 ? launch_mode<2>(a, total, device, st, launches)
                 : ns == 4 ? launch_mode<4>(a, total, device, st, launches)
                           : launch_mode<8>(a, total, device, st, launches);
  if (rc != 0 || nout == 0) return rc;
  group_reduce_finalize_kernel<<<grid_for(G, 256, 8, device), 256, 0, st>>>(
      a, out);
  return (int)cudaGetLastError();
}

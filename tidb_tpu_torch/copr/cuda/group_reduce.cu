// group_reduce.cu: the masked grouped reduction of the DENSE/SCALAR
// aggregation path (and of the SCATTER segment reduce), as CUDA kernels
// for Hopper (sm_90a).
//
// Replaces tidb_tpu/copr/exec.py:87 _reduce, which XLA fuses into the
// scan on the TPU (a one-hot compare for G <= 64, a scatter beyond).
// Contract, as _reduce's: rows i with mask[i] and 0 <= gid[i] < G
// reduce into table[gid[i]] by sum, min or max; every other row is
// dropped (G itself is the callers' sink slot).  No gids: G == 1.
//
// Bound on the H100 (3.35 TB/s HBM3): the kernel reads each row's value
// (8 bytes), mask (1) and gid (4 or 8) once and writes the G-slot table
// once: 13 bytes a row with int32 gids, 9 for SCALAR.  A row costs a few
// integer operations (up to 16 compare-and-adds on the register path),
// so memory traffic bounds it.
//
// Lanes.  Every kind reduces int64 lanes, so that atomics are exact and
// the result does not depend on the order in which rows arrive:
//   - int64 sum/min/max: the value itself (atomicAdd on unsigned long
//     long wraps as int64 does; atomicMin/atomicMax on long long);
//   - float64 min/max: an order-preserving int64 key of the value's
//     bits; a NaN takes the key that wins (LLONG_MIN for min, LLONG_MAX
//     for max), so NaN propagates as jnp.min/jnp.max propagate it;
//   - float64 sum: three 32-bit limbs of the value in fixed point,
//     round(v * 2^s), where s = 94 - e and 2^e bounds the largest
//     finite |v| of the call (a first pass finds it).  Limb sums are
//     exact integers (|limb| < 2^32, n < 2^30 rows), so the result is
//     the same bits on every launch; each term is rounded once, to
//     2^-s, and the total once more when it is turned back into a
//     double.  NaN and +-inf rows set flags instead (NaN, or +inf with
//     -inf, gives NaN).
//
// Where the table lives, by G:
//   - G <= REG_SLOTS (16): registers.  Each thread keeps all G slots
//     and adds a row to its slot by a compare-and-select over the slots
//     (the one-hot of the TPU's lowering), the warp then reduces them
//     with shuffles, and each block adds one partial a slot to the table
//     in device memory.  SCALAR (G = 1) and TPC-H Q1 (G = 12) take this
//     path: one hot slot costs no atomics per row.
//   - G <= SMEM_SLOTS (4096): shared memory.  Each block reduces its
//     rows into its own table with shared atomics, then adds the table
//     to device memory with one atomic a slot.
//   - larger G (up to the bucket space of the SCATTER path): one atomic
//     a row into the table in device memory.
// Each thread walks the rows grid-stride, UNROLL rows a step, loading
// them all before it reduces any; the grid is as many blocks as fit on
// the card at once.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// -- the lane arithmetic: plain C++ apart from the __device__ marks, so
// -- that tests/test_torch_group_reduce.py also compiles it for the host

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int REG_SLOTS = 16;
constexpr int SMEM_SLOTS = 4096;
constexpr int FSUM_BITS = 94;        // |round(v * 2^s)| < 2^94
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Kind { I64_SUM = 0, I64_MIN = 1, I64_MAX = 2, F64_MIN = 3, F64_MAX = 4,
            F64_SUM = 5 };
enum Op { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2 };
// where the table lives: registers for G == 1 or G <= 16, shared memory,
// or device memory only
enum Mode { M_REG1 = 1, M_REG16 = 16, M_SMEM = 0, M_GLOBAL = -1 };

template <int K> struct Traits;
template <> struct Traits<I64_SUM> { static constexpr int L = 1, OP = OP_SUM; };
template <> struct Traits<I64_MIN> { static constexpr int L = 1, OP = OP_MIN; };
template <> struct Traits<I64_MAX> { static constexpr int L = 1, OP = OP_MAX; };
template <> struct Traits<F64_MIN> { static constexpr int L = 1, OP = OP_MIN; };
template <> struct Traits<F64_MAX> { static constexpr int L = 1, OP = OP_MAX; };
template <> struct Traits<F64_SUM> { static constexpr int L = 3, OP = OP_SUM; };

struct Args {
  const long long* vals;        // int64 values or float64 bits
  const unsigned char* mask;    // bool
  const void* gids;             // int32 or int64, or null
  int gid_bytes;                // 4, 8, or 0 (no gids: every row slot 0)
  long long n;
  long long G;
  long long* table;             // L * G lanes, lane-major
  int* flags;                   // F64_SUM: G flags (1 NaN, 2 +inf, 4 -inf)
  unsigned long long* mx;       // F64_SUM: bits of the largest finite |v|
};

template <int OP>
__host__ __device__ constexpr long long neutral_of() {
  return OP == OP_SUM ? 0LL : (OP == OP_MIN ? LLONG_MAX : LLONG_MIN);
}

template <int OP>
__device__ __forceinline__ long long combine(long long a, long long b) {
  if (OP == OP_SUM)
    return (long long)((unsigned long long)a + (unsigned long long)b);
  if (OP == OP_MIN) return a < b ? a : b;
  return a > b ? a : b;
}

__device__ __forceinline__ bool bits_nonfinite(long long b) {
  return ((b >> 52) & 0x7ff) == 0x7ff;
}

__device__ __forceinline__ bool bits_nan(long long b) {
  return bits_nonfinite(b) && (b & 0xfffffffffffffLL) != 0;
}

// order-preserving int64 key of a double's bits (-0.0 below +0.0); the
// keys LLONG_MIN and LLONG_MAX belong to NaNs only
__device__ __forceinline__ long long f64_key(long long b, bool nan_low) {
  if (bits_nan(b)) return nan_low ? LLONG_MIN : LLONG_MAX;
  return b >= 0 ? b : (b ^ LLONG_MAX);
}

__device__ __forceinline__ double f64_of_key(long long k) {
  return __longlong_as_double(k >= 0 ? k : (k ^ LLONG_MAX));
}

// s with |v| * 2^s < 2^FSUM_BITS for every finite |v| <= the call's max
__device__ __forceinline__ int fsum_scale(const unsigned long long* mx) {
  const long long b = (long long)*mx;
  if (b == 0) return 0;
  const int biased = (int)((b >> 52) & 0x7ff);
  return FSUM_BITS - ((biased > 0 ? biased : 1) - 1022);
}

// three signed 32-bit limbs, lane l of weight 2^(32 l), of round(v 2^s)
__device__ __forceinline__ void fsum_limbs(double v, int s, long long* ln) {
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

// a row's lanes; for a float sum, a NaN or +-inf row returns its flag
// (1 NaN, 2 +inf, 4 -inf) and has no lanes
template <int K>
__device__ __forceinline__ int row_lanes(long long raw, int scale,
                                         long long* ln) {
  if constexpr (K == F64_MIN || K == F64_MAX) {
    ln[0] = f64_key(raw, K == F64_MIN);
  } else if constexpr (K == F64_SUM) {
    if (bits_nonfinite(raw)) return bits_nan(raw) ? 1 : (raw > 0 ? 2 : 4);
    fsum_limbs(__longlong_as_double(raw), scale, ln);
  } else {
    ln[0] = raw;
  }
  return 0;
}

// float kinds: slot g's int64 lanes back to a double
template <int K>
__device__ __forceinline__ double finalize_slot(const Args& a, long long g) {
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const double pinf = __longlong_as_double(0x7ff0000000000000LL);
  const double ninf = __longlong_as_double((long long)0xfff0000000000000ULL);
  if constexpr (K == F64_MIN || K == F64_MAX) {
    const long long k = a.table[g];
    if (k == (K == F64_MIN ? LLONG_MIN : LLONG_MAX)) return nan;
    if (k == (K == F64_MIN ? LLONG_MAX : LLONG_MIN))   // no row reached g
      return K == F64_MIN ? pinf : ninf;
    return f64_of_key(k);
  }
  const int f = a.flags[g];
  if ((f & 1) || (f & 6) == 6) return nan;
  if (f & 2) return pinf;
  if (f & 4) return ninf;
  // carry the limbs into hi 2^64 + lo with lo in [0, 2^64)
  const long long G = a.G;
  const long long l0 = a.table[g];
  const long long l1 = a.table[G + g] + (l0 >> 32);
  long long hi = a.table[2 * G + g] + (l1 >> 32);
  unsigned long long lo = ((unsigned long long)(l1 & 0xffffffffLL) << 32) |
                          (unsigned long long)(l0 & 0xffffffffLL);
  const bool neg = hi < 0;
  if (neg) {                                     // two's-complement negate
    lo = ~lo + 1ULL;
    hi = ~hi + (lo == 0ULL ? 1 : 0);
  }
  const double mag = ldexp((double)hi, 64) + (double)lo;
  return ldexp(neg ? -mag : mag, -fsum_scale(a.mx));
}

// -- end of the lane arithmetic --

template <int OP>
__device__ __forceinline__ void atomic_combine(long long* p, long long v) {
  if (OP == OP_SUM)
    atomicAdd((unsigned long long*)p, (unsigned long long)v);
  else if (OP == OP_MIN)
    atomicMin(p, v);
  else
    atomicMax(p, v);
}

__device__ __forceinline__ long long load_gid(const Args& a, long long i) {
  if (a.gid_bytes == 4) return ((const int*)a.gids)[i];
  if (a.gid_bytes == 8) return ((const long long*)a.gids)[i];
  return 0;
}

template <int K, int MODE>
__global__ void __launch_bounds__(THREADS) group_reduce_kernel(Args a) {
  constexpr int L = Traits<K>::L;
  constexpr int OP = Traits<K>::OP;
  constexpr int NG = MODE > 0 ? MODE : 1;
  extern __shared__ long long smem[];
  const long long NEU = neutral_of<OP>();
  const int tid = threadIdx.x;
  const int scale = K == F64_SUM ? fsum_scale(a.mx) : 0;

  long long acc[L][NG];
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[l][g] = NEU;
  if constexpr (MODE == M_SMEM) {
    for (long long j = tid; j < L * a.G; j += THREADS) smem[j] = NEU;
    __syncthreads();
  }

  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long base = (long long)blockIdx.x * THREADS * UNROLL + tid;
       base < a.n; base += step) {
    long long raw[UNROLL], gid[UNROLL];
    bool use[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * THREADS;
      use[u] = false;
      raw[u] = 0;
      gid[u] = 0;
      if (i < a.n) {
        use[u] = a.mask[i] != 0;
        gid[u] = load_gid(a, i);
        raw[u] = a.vals[i];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = gid[u];
      if (!use[u] || g < 0 || g >= a.G) continue;
      long long ln[L];
      const int flag = row_lanes<K>(raw[u], scale, ln);
      if (flag) {                        // a NaN or +-inf float-sum row
        atomicOr(&a.flags[g], flag);
        continue;
      }
      if constexpr (MODE > 0) {
#pragma unroll
        for (int s = 0; s < NG; ++s) {
          const bool hit = NG == 1 || g == s;
#pragma unroll
          for (int l = 0; l < L; ++l)
            acc[l][s] = combine<OP>(acc[l][s], hit ? ln[l] : NEU);
        }
      } else if constexpr (MODE == M_SMEM) {
#pragma unroll
        for (int l = 0; l < L; ++l) atomic_combine<OP>(&smem[l * a.G + g], ln[l]);
      } else {
#pragma unroll
        for (int l = 0; l < L; ++l)
          atomic_combine<OP>(&a.table[l * a.G + g], ln[l]);
      }
    }
  }

  if constexpr (MODE > 0) {
    // warp partials by shuffles, block partials in warp order, then one
    // atomic a slot into device memory
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int s = 0; s < NG; ++s) {
        long long v = acc[l][s];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v = combine<OP>(v, __shfl_down_sync(FULL_MASK, v, o));
        if (lane == 0) smem[(warp * L + l) * NG + s] = v;
      }
    __syncthreads();
    if (tid < L * NG) {
      const int l = tid / NG, s = tid % NG;
      long long v = NEU;
      for (int w = 0; w < WARPS; ++w) v = combine<OP>(v, smem[(w * L + l) * NG + s]);
      if (s < a.G && v != NEU) atomic_combine<OP>(&a.table[l * a.G + s], v);
    }
  } else if constexpr (MODE == M_SMEM) {
    __syncthreads();
    for (long long j = tid; j < L * a.G; j += THREADS) {
      const long long v = smem[j];
      if (v != NEU) atomic_combine<OP>(&a.table[j], v);
    }
  }
}

__global__ void fill_kernel(long long* p, long long n, long long v) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    p[i] = v;
}

// F64_SUM: the bits of the largest finite |v| over the rows that reduce
__global__ void __launch_bounds__(THREADS) fsum_maxabs_kernel(Args a) {
  unsigned long long m = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.n;
       i += (long long)gridDim.x * THREADS) {
    if (!a.mask[i]) continue;
    const long long g = load_gid(a, i);
    const long long b = a.vals[i];
    if (g < 0 || g >= a.G || bits_nonfinite(b)) continue;
    const unsigned long long ab = (unsigned long long)(b & LLONG_MAX);
    m = ab > m ? ab : m;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_down_sync(FULL_MASK, m, o);
    m = y > m ? y : m;
  }
  if ((threadIdx.x & 31) == 0 && m) atomicMax(a.mx, m);
}

template <int K>
__global__ void finalize_kernel(Args a, double* out) {
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < a.G;
       g += (long long)gridDim.x * blockDim.x)
    out[g] = finalize_slot<K>(a, g);
}

int sm_count(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

int grid_for(long long work, int per_block, int resident, int device) {
  const long long need = (work + per_block - 1) / per_block;
  const long long cap = (long long)resident * sm_count(device);
  const long long g = need < cap ? need : cap;
  return g > 0 ? (int)g : 1;
}

template <int K, int MODE>
int launch_main(const Args& a, int device, cudaStream_t st) {
  constexpr int L = Traits<K>::L;
  const size_t smem = MODE > 0 ? (size_t)WARPS * L * MODE * sizeof(long long)
                      : MODE == M_SMEM ? (size_t)L * a.G * sizeof(long long)
                                       : 0;
  cudaError_t e = cudaFuncSetAttribute(
      group_reduce_kernel<K, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, group_reduce_kernel<K, MODE>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (resident < 1) resident = 1;
  const int grid = grid_for(a.n, THREADS * UNROLL, resident, device);
  group_reduce_kernel<K, MODE><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int K>
int launch_kind(const Args& a, double* out, int device, cudaStream_t st) {
  constexpr int L = Traits<K>::L;
  const long long slots = L * a.G;
  fill_kernel<<<grid_for(slots, 256, 8, device), 256, 0, st>>>(
      a.table, slots, neutral_of<Traits<K>::OP>());
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (K == F64_SUM) {
    e = cudaMemsetAsync(a.flags, 0, a.G * sizeof(int), st);
    if (e == cudaSuccess) e = cudaMemsetAsync(a.mx, 0, sizeof(*a.mx), st);
    if (e != cudaSuccess) return (int)e;
    if (a.n > 0) {
      fsum_maxabs_kernel<<<grid_for(a.n, THREADS, 8, device), THREADS, 0, st>>>(a);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  if (a.n > 0) {
    const int rc = a.G == 1               ? launch_main<K, M_REG1>(a, device, st)
                   : a.G <= REG_SLOTS     ? launch_main<K, M_REG16>(a, device, st)
                   : a.G <= SMEM_SLOTS    ? launch_main<K, M_SMEM>(a, device, st)
                                          : launch_main<K, M_GLOBAL>(a, device, st);
    if (rc != 0) return rc;
  }
  if constexpr (K == F64_MIN || K == F64_MAX || K == F64_SUM) {
    finalize_kernel<K><<<grid_for(a.G, 256, 8, device), 256, 0, st>>>(a, out);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace

extern "C" int group_reduce_reg_slots(void) { return REG_SLOTS; }
extern "C" int group_reduce_smem_slots(void) { return SMEM_SLOTS; }

// kind: 0-2 int64 sum/min/max, 3-4 float64 min/max, 5 float64 sum.
// table: 3 G int64 for kind 5, else G; flags (G int32) and mx (one
// uint64) for kind 5 only; out (G float64) for kinds 3-5.  The int64
// kinds leave their result in table[0, G).
extern "C" int group_reduce_launch(const void* vals, const void* mask,
                                   const void* gids, int gid_bytes,
                                   long long n, long long G, int kind,
                                   long long* table, int* flags,
                                   unsigned long long* mx, double* out,
                                   int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (G < 1 || n < 0 || (gid_bytes != 0 && gid_bytes != 4 && gid_bytes != 8))
    return (int)cudaErrorInvalidValue;
  Args a{(const long long*)vals, (const unsigned char*)mask, gids, gid_bytes,
         n, G, table, flags, mx};
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case I64_SUM: return launch_kind<I64_SUM>(a, out, device, st);
    case I64_MIN: return launch_kind<I64_MIN>(a, out, device, st);
    case I64_MAX: return launch_kind<I64_MAX>(a, out, device, st);
    case F64_MIN: return launch_kind<F64_MIN>(a, out, device, st);
    case F64_MAX: return launch_kind<F64_MAX>(a, out, device, st);
    case F64_SUM: return launch_kind<F64_SUM>(a, out, device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

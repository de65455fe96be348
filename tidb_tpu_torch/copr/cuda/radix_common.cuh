// radix_common.cuh: what the counting-sort kernels share (radix_kernel.cu,
// onesweep.cu): the digit of a key, the warp's digit match, and the
// 16-byte cp.async staging of a warp's rows into shared memory.
// build.py hashes this header into the name of every library it builds,
// so a change here rebuilds both.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RADIX_DIGITS 256
#define FULL_MASK 0xffffffffu

// The digit of a key and its validity, by key type.
template <typename K> struct KeyOps;

template <> struct KeyOps<int> {
  static __device__ __forceinline__ int digit(int key, int shift) {
    return (key >> shift) & (RADIX_DIGITS - 1);
  }
  static __device__ __forceinline__ bool bad(int key) { return key < 0; }
};

template <> struct KeyOps<long long> {
  static __device__ __forceinline__ int digit(long long key, int shift) {
    const unsigned long long u =
        (unsigned long long)key ^ 0x8000000000000000ull;
    return (int)(u >> shift) & (RADIX_DIGITS - 1);
  }
  static __device__ __forceinline__ bool bad(long long) { return false; }
};

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

// One warp copies its m rows (m <= ROWS) of src into dst.
template <int ROWS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int m,
                                           int lane) {
  constexpr int CHUNKS = ROWS * (int)sizeof(T) / 16;
  if (m == ROWS && aligned16(src)) {
    unsigned char* d = reinterpret_cast<unsigned char*>(dst);
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
#pragma unroll
    for (int q = lane; q < CHUNKS; q += 32) cp_async16(d + 16 * q, s + 16 * q);
  } else {
    for (int i = lane; i < m; i += 32) dst[i] = src[i];
  }
}

__device__ __forceinline__ long long join64(int lo, int hi) {
  return (long long)(((unsigned long long)(unsigned)hi << 32)
                     | (unsigned long long)(unsigned)lo);
}


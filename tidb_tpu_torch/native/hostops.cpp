// ported from tidb_tpu/native/hostops.cpp @ ba365f2
// Host-side columnar aggregation primitives (C++17, ctypes ABI).
//
// Reference analog: the tight per-row loops inside TiDB's hash
// aggregation executor (pkg/executor/aggregate/agg_hash_executor.go:94)
// and unistore's coprocessor closure executor (closure_exec.go:468).
// The TPU engine's CPU fallback routes high-NDV group-by through
// np.bincount, whose mandatory weight/bin dtype conversions cost 3-4x
// the compulsory memory traffic; these loops count straight off the
// narrow physical column representation (chunk/column.py narrowed()).
//
// Counts use an int32 table: the engine bounds rows per batch below
// 2^31 (the limb-exact SUM fence), so no group count can overflow.

#include <cstdint>
#include <cstring>

extern "C" {

// table[key[i] - lo]++ for every i; caller zeroes `table` (size `range`).
void hops_count_i32(const int32_t* keys, int64_t n, int64_t lo,
                    int32_t* table) {
    for (int64_t i = 0; i < n; i++) table[keys[i] - lo]++;
}

void hops_count_i64(const int64_t* keys, int64_t n, int64_t lo,
                    int32_t* table) {
    for (int64_t i = 0; i < n; i++) table[keys[i] - lo]++;
}

// inv[i] = lookup[key[i] - lo] (dense group-id assignment through the
// occupied-slot lookup built from the count table).
void hops_gather_i32(const int32_t* keys, int64_t n, int64_t lo,
                     const int32_t* lookup, int64_t* inv) {
    for (int64_t i = 0; i < n; i++) inv[i] = lookup[keys[i] - lo];
}

void hops_gather_i64(const int64_t* keys, int64_t n, int64_t lo,
                     const int32_t* lookup, int64_t* inv) {
    for (int64_t i = 0; i < n; i++) inv[i] = lookup[keys[i] - lo];
}

}  // extern "C"

# ported from tidb_tpu/testing/bench_kv.py @ aaa930f
"""benchkv-style micro-benchmark of the native MVCC engine
(cmd/benchkv/main.go analog): loads N committed keys, then measures
random point-gets (in-process, ctypes overhead excluded via
kv_bench_gets) and a full snapshot scan — memtable-only vs flushed to an
immutable sorted run (the LSM read path).

The engine is the port's own, built from ``native/kvstore.cpp`` by
``store/kv.py`` into ``_build/libtpukv-<hash>.so``.  The JAX package's
script runs at import; this one runs only from ``main()``.

Usage: python -m tidb_tpu_torch.testing.bench_kv   [BENCHKV_KEYS=2000000]
"""

import ctypes
import os
import time

from tidb_tpu_torch.store.kv import _load_lib

KEYS = 2_000_000
GETS = 1_000_000


def _lib():
    lib = _load_lib()
    lib.kv_bench_gets.restype = ctypes.c_int64
    lib.kv_bench_gets.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_uint64, ctypes.c_uint64]
    return lib


def bench(n: int, flush: bool, gets: int = GETS) -> tuple:
    """Load ``n`` keys into a fresh engine (flushed to a sorted run when
    ``flush``), then time ``gets`` random point-gets and one full scan;
    prints the line and returns (µs a get, rows the scan returned,
    scan seconds)."""
    lib = _lib()
    h = ctypes.c_void_p(lib.kv_open())
    try:
        lib.kv_set_flush_threshold(h, 0)
        for i in range(n):
            k = b"%012d" % i
            v = b"value-%d" % i
            sts = lib.kv_alloc_ts(h)
            lib.kv_prewrite(h, k, len(k), v, len(v), k, len(k), sts, 0)
            lib.kv_commit(h, k, len(k), sts, lib.kv_alloc_ts(h))
        if flush:
            lib.kv_flush(h)
        ts = lib.kv_alloc_ts(h)
        ns = lib.kv_bench_gets(h, gets, 42, ts)
        buf = ctypes.create_string_buffer(64 << 20)
        used = ctypes.c_int64()
        trunc = ctypes.c_uint8()
        t = time.time()
        got = lib.kv_scan(h, b"", 0, b"", 0, ts, n + 100_000, buf, len(buf),
                          ctypes.byref(used), ctypes.byref(trunc))
        st = time.time() - t
    finally:
        lib.kv_close(h)
    print(("flushed " if flush else "memtable"),
          f"get {ns/1e3/gets:.3f} us/op   scan {n/st/1e6:.1f} M rows/s "
          f"(n={got})")
    return ns / 1e3 / gets, got, st


def main(n: int | None = None, gets: int = GETS) -> list:
    """Both runs, memtable then flushed, over ``n`` keys (default
    ``BENCHKV_KEYS``, else 2,000,000)."""
    if n is None:
        n = int(os.environ.get("BENCHKV_KEYS", str(KEYS)))
    return [bench(n, False, gets), bench(n, True, gets)]


if __name__ == "__main__":
    main()

# ported from tidb_tpu/copr/nativeops.py @ ba365f2
"""ctypes loader for the native host aggregation primitives.

Reference analog: the reference's aggregation hot loops are compiled Go
(agg_hash_executor.go); ours are C++ (native/hostops.cpp) behind numpy
fallbacks — `count_keys`/`gather_lookup` return None when the library
is unavailable, and the caller takes the numpy path.

The port's copy builds its own ``tidb_tpu_torch/native/hostops.cpp``
with g++ at first use into ``tidb_tpu_torch/_build/``, under a name
taken from the hash of the source (a temporary file renamed into place,
as ``store/kv.py`` builds the KV engine); it never loads the JAX
package's ``tidb_tpu/native/*.so``.  A failed build still degrades to
numpy, as in the JAX package, but ``available()`` then says False and
``build_error()`` why: the tests and ``chip_smoke.py`` assert the
library is there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "hostops.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# the JAX package's native/Makefile flags for this library
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None


def library_path() -> Path:
    """Where the library built from this exact source lives."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libtpuhostops-{tag}.so"


def build_library() -> Path:
    """Compile the library with g++ unless this source's library exists;
    raises ``subprocess.CalledProcessError`` when g++ fails."""
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build_library()))
            I64, I32P, I64P = (ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.POINTER(ctypes.c_int64))
            lib.hops_count_i32.argtypes = [I32P, I64, I64, I32P]
            lib.hops_count_i64.argtypes = [I64P, I64, I64, I32P]
            lib.hops_gather_i32.argtypes = [I32P, I64, I64, I32P, I64P]
            lib.hops_gather_i64.argtypes = [I64P, I64, I64, I32P, I64P]
            for fn in ("hops_count_i32", "hops_count_i64",
                       "hops_gather_i32", "hops_gather_i64"):
                getattr(lib, fn).restype = None
            _lib = lib
        except (OSError, subprocess.CalledProcessError,
                AttributeError) as e:
            # only the expected degradations fall back to numpy: no
            # toolchain / failed build (CalledProcessError), unloadable
            # .so (OSError), stale library missing a symbol
            # (AttributeError).  Anything else is a real bug and raises.
            _lib = None
            _error = f"{type(e).__name__}: {e}" + (
                f"\n{e.stderr}" if getattr(e, "stderr", None) else "")
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded)."""
    _load()
    return _error


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def count_keys(keys: np.ndarray, lo: int, rng: int) -> Optional[np.ndarray]:
    """Histogram of (keys - lo) over [0, rng) as int32 counts, or None
    when the native library is unavailable / dtype unsupported."""
    lib = _load()
    if lib is None or keys.dtype not in (np.int32, np.int64):
        return None
    keys = np.ascontiguousarray(keys)
    table = np.zeros(rng, np.int32)
    if keys.dtype == np.int32:
        lib.hops_count_i32(_ptr(keys, ctypes.c_int32), len(keys), lo,
                           _ptr(table, ctypes.c_int32))
    else:
        lib.hops_count_i64(_ptr(keys, ctypes.c_int64), len(keys), lo,
                           _ptr(table, ctypes.c_int32))
    return table


def gather_lookup(keys: np.ndarray, lo: int,
                  lookup: np.ndarray) -> Optional[np.ndarray]:
    """inv[i] = lookup[keys[i] - lo] (int64 group ids), or None."""
    lib = _load()
    if lib is None or keys.dtype not in (np.int32, np.int64):
        return None
    keys = np.ascontiguousarray(keys)
    lookup = np.ascontiguousarray(lookup, np.int32)
    inv = np.empty(len(keys), np.int64)
    if keys.dtype == np.int32:
        lib.hops_gather_i32(_ptr(keys, ctypes.c_int32), len(keys), lo,
                            _ptr(lookup, ctypes.c_int32),
                            _ptr(inv, ctypes.c_int64))
    else:
        lib.hops_gather_i64(_ptr(keys, ctypes.c_int64), len(keys), lo,
                            _ptr(lookup, ctypes.c_int32),
                            _ptr(inv, ctypes.c_int64))
    return inv


__all__ = ["available", "build_error", "build_library", "count_keys",
           "gather_lookup", "library_path"]

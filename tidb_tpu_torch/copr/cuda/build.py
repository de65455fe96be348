# ported from tidb_tpu/copr/nativeops.py @ a9e9482
"""Build and load the port's CUDA kernels.

The counterpart of the JAX package's native-library loader
(``copr/nativeops.py``: make, then ctypes).  Each ``.cu`` source of this
directory has a plain C interface; it is compiled with ``nvcc`` for
sm_90a into a shared library in ``tidb_tpu_torch/_build/``, named by the
hash of the source and of the directory's shared headers (``*.cuh``)
so that a stale library is never reused, and loaded with ctypes.
``build_all`` starts one ``nvcc`` per source at once.

``nvcc`` comes from the CUDA toolkit that torch finds (``CUDA_HOME``).
Nothing here runs when a module is imported: a kernel library is built
at its first use, or by an explicit ``build_all``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

import torch

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(SRC_DIR))

BUILD_LOG: list = []     # nvcc/ptxas output of the builds in this process

# guards every kernel module's ``LAUNCHES`` counters: statements of
# several connection threads launch at once, and a bare += loses counts
_LAUNCH_MU = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc failed to build a kernel library (never a device OOM, though
    the compiler's own text may say "out of memory":
    ``faults.is_oom_error``)."""


def count_launches(launches: dict, name: str, n: int = 1) -> None:
    """Add ``n`` to ``launches[name]`` under the counters' lock."""
    with _LAUNCH_MU:
        launches[name] += n


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")
    return path


def library_path(src: Path) -> Path:
    """Where the library of this exact source (and headers) is built."""
    h = hashlib.sha256(Path(src).read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    tag = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(src).stem}-{tag}.so"


def build_all(srcs: Sequence[Path]) -> list:
    """Compile each source whose library is not built yet, all at once
    (one ``nvcc`` each); returns the libraries' paths in order."""
    sos = [library_path(s) for s in srcs]
    todo = [(s, so) for s, so in zip(srcs, sos) if not so.exists()]
    if not todo:
        return sos
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs.append((so, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for so, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG.append(out)
        if proc.returncode != 0:
            failed.append(f"{so.name}: nvcc failed ({proc.returncode}):\n"
                          f"{out}")
        else:
            os.replace(tmp, so)   # atomic: a concurrent build never sees half
    if failed:
        raise KernelBuildError("\n".join(failed))
    return sos


class Library:
    """One kernel library, built at first use and loaded once per
    process; ``setup(lib)`` declares its functions' ctypes signatures
    and checks the constants it exports."""

    def __init__(self, src: Path, setup: Callable[[ctypes.CDLL], None]):
        self.src = Path(src)
        self._setup = setup
        self._mu = threading.Lock()
        self._lib: ctypes.CDLL | None = None

    def get(self) -> ctypes.CDLL:
        with self._mu:
            if self._lib is None:
                lib = ctypes.CDLL(str(build_all([self.src])[0]))
                self._setup(lib)
                self._lib = lib
            return self._lib


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C launchers
    take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


# the CUDA runtime's error strings of the codes a launcher may return
# (cudaGetErrorString): 2 is the one device OOM among them
CUDA_ERRORS = {1: "invalid argument", 2: "out of memory",
               98: "invalid device function",
               209: "no kernel image is available for execution on the "
                    "device",
               700: "an illegal memory access was encountered",
               701: "too many resources requested for launch",
               719: "unspecified launch failure"}


def raise_on(rc: int, name: str) -> None:
    """Raise for a launcher's nonzero CUDA error code, with the
    runtime's text for it: ``faults.is_oom_error`` reads "out of
    memory" (code 2) as a device OOM, and no other code."""
    if rc != 0:
        text = CUDA_ERRORS.get(rc, "see cudaGetErrorString")
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({text})")


__all__ = ["SRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "BUILD_LOG", "CUDA_ERRORS",
           "KernelBuildError", "Library",
           "build_all", "library_path", "nvcc", "stream_of", "raise_on"]

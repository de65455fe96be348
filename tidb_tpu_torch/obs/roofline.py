# ported from tidb_tpu/obs/roofline.py @ df101aa
"""copgauge roofline attribution: achieved vs peak bytes/s and FLOPs/s
per program digest.

Reference analog: Flare's roofline framing (PAPERS.md) — a measured
time is unactionable until it is decomposed into WHERE the time went: a
digest running at 80% of peak memory bandwidth is memory-bound
(tiling/width levers), one at 60% of peak FLOPs is compute-bound
(algorithmic levers), and one whose whole launch fits in dispatch
overhead is launch-bound (fusion/batching levers).

Per digest, the store combines a measured launch time with the static
``LaunchCost`` flops and transfer bytes into achieved GB/s and GFLOP/s
against a per-backend peak table.  On the card the time is the launch's
DEVICE time, from CUDA events around it on the lead stream (the
scheduler's drain reads them once both completed); on the CPU it is the
drain's wall, as in the JAX package.  The peaks are DECLARED constants
per device kind (they define the denominator of a percentage, not a
claim about any chip's true ceiling): ``NVIDIA_PEAKS`` from NVIDIA's
datasheets for the cards it names, the JAX package's ``TPU_PEAKS`` for
TPU kinds; a card the table does not name gets a one-time device copy
and matmul microbench, and the CPU a numpy one, each saying so in its
source string.

Everything here is measured-nanoseconds + frozen LaunchCost arithmetic:
no device touch but the microbench of a card the table does not name.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..analysis.calibrate import BoundedLRU, CALIB_ALPHA

# bounded per-digest attribution entries (the calibration store's
# eviction policy)
ROOFLINE_STORE_CAP = 128
# a digest whose EWMA launch time sits under this is launch-bound: the
# program is dominated by dispatch/launch overhead, not by data or math
LAUNCH_BOUND_MS = 0.5

# declared per-device-kind peaks: (bytes/s of HBM bandwidth, flops/s).
# Substring-matched against the JAX package's TPU device kinds, most
# specific first.  These are roofline DENOMINATORS — deliberately round
# public numbers; the port keeps them so a kind string names the same
# denominator in both packages.
TPU_PEAKS = (
    ("v5p", (2765e9, 459e12)),
    ("v5e", (819e9, 197e12)),
    ("v5", (819e9, 197e12)),
    ("v6", (1640e9, 918e12)),
    ("v4", (1228e9, 275e12)),
    ("v3", (900e9, 123e12)),
    ("v2", (700e9, 46e12)),
)
DEFAULT_TPU_PEAKS = (900e9, 100e12)

# declared NVIDIA peaks: (bytes/s of HBM bandwidth, flops/s), substring-
# matched against torch.cuda.get_device_name (lowercased), most specific
# first.  The port's lanes are int64 and float64 CUDA-core work, not
# tensor-core products, so the flops denominator is the FP32 CUDA-core
# peak.  Source: NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5 80 GB
# column ("NVIDIA H100 80GB HBM3"): GPU memory bandwidth 3.35 TB/s,
# FP32 67 teraFLOPS (dense, at the 700 W board power).
NVIDIA_PEAKS = (
    ("h100 80gb hbm3", (3.35e12, 67e12)),
)

# device microbench of a card NVIDIA_PEAKS does not name: one 256 MiB
# copy and one float32 matmul, best of REPS, timed by CUDA events
_CUDA_BENCH_MB = 256
_CUDA_BENCH_N = 4096
_CUDA_BENCH_REPS = 3

# CPU microbench shape: one stacked copy + one small matmul, best of
# REPS — a stable-enough boot-time denominator, not a benchmark
_CPU_BENCH_MB = 16
_CPU_BENCH_N = 192
_CPU_BENCH_REPS = 3

_cpu_peaks_cache: Optional[tuple] = None
_peaks_mu = threading.Lock()
_cuda_peaks_cache: dict = {}


def _cpu_microbench() -> tuple:
    """Calibrated-at-boot CPU peaks: measured host copy bandwidth and
    matmul flops (best-of-reps).  Cached for the process lifetime."""
    import numpy as np
    a = np.ones((_CPU_BENCH_MB << 20) // 8, dtype=np.float64)
    best_bw = 0.0
    for _ in range(_CPU_BENCH_REPS):
        t0 = time.perf_counter()
        b = a.copy()
        dt = time.perf_counter() - t0
        best_bw = max(best_bw, 2.0 * a.nbytes / max(dt, 1e-9))
    del b
    m = np.ones((_CPU_BENCH_N, _CPU_BENCH_N), dtype=np.float64)
    best_fl = 0.0
    flops = 2.0 * _CPU_BENCH_N ** 3
    for _ in range(_CPU_BENCH_REPS):
        t0 = time.perf_counter()
        m @ m
        dt = time.perf_counter() - t0
        best_fl = max(best_fl, flops / max(dt, 1e-9))
    return (best_bw, best_fl)


def _cuda_microbench(device) -> tuple:
    """Measured peaks of a card NVIDIA_PEAKS does not name: device copy
    bandwidth (read + write) and float32 matmul flops, best-of-reps by
    CUDA events.  Runs once a device kind in a process."""
    import torch
    a = torch.empty((_CUDA_BENCH_MB << 20) // 4, dtype=torch.float32,
                    device=device)
    b = torch.empty_like(a)
    m = torch.ones((_CUDA_BENCH_N, _CUDA_BENCH_N), dtype=torch.float32,
                   device=device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def best(fn) -> float:
        fn()                                  # warm
        ms = float("inf")
        for _ in range(_CUDA_BENCH_REPS):
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms = min(ms, start.elapsed_time(end))
        return max(ms, 1e-6) / 1e3

    bw = 2.0 * a.numel() * 4 / best(lambda: b.copy_(a))
    fl = 2.0 * _CUDA_BENCH_N ** 3 / best(lambda: m @ m)
    del a, b, m
    return (bw, fl)


def backend_peaks(device_kind: str, device=None) -> tuple:
    """(bytes_per_s, flops_per_s, source) for a device kind string:
    declared for the TPU kinds and the NVIDIA cards of the tables, a
    device microbench for another card (``device``, a torch CUDA
    device, names it), the numpy microbench for the CPU."""
    kind = (device_kind or "").lower()
    if "tpu" in kind:
        for sub, peaks in TPU_PEAKS:
            if sub in kind:
                return (*peaks, f"declared:{sub}")
        return (*DEFAULT_TPU_PEAKS, "declared:tpu-default")
    for sub, peaks in NVIDIA_PEAKS:
        if sub in kind:
            return (*peaks, f"declared:nvidia-datasheet:{sub}")
    if device is not None and getattr(device, "type", None) == "cuda":
        with _peaks_mu:
            ent = _cuda_peaks_cache.get(kind)
            if ent is None:
                ent = _cuda_peaks_cache[kind] = _cuda_microbench(device)
        return (*ent, f"microbench:cuda:{kind}")
    global _cpu_peaks_cache
    with _peaks_mu:
        if _cpu_peaks_cache is None:
            _cpu_peaks_cache = _cpu_microbench()
        bw, fl = _cpu_peaks_cache
    return (bw, fl, "microbench:cpu")


# device tuple -> its peaks (tuples are few)
_mesh_peaks_cache: dict = {}


def _mesh_kind(mesh) -> tuple:
    """(device kind, count of physical devices, first CUDA device or
    None) of the port's device tuple: the card's name
    (``torch.cuda.get_device_name``) or "" for the CPU; its logical
    devices over one card count once."""
    try:
        dev = mesh[0]
        n_dev = len({(d.type, d.index) for d in mesh})
    except (IndexError, TypeError, AttributeError):
        return "", 1, None
    if getattr(dev, "type", None) != "cuda":
        return "", 1, None
    import torch
    return str(torch.cuda.get_device_name(dev)), n_dev, dev


def peaks_for_mesh(mesh) -> tuple:
    """Per-device-tuple peak lookup (the kind of its first device);
    aggregate peaks scale by the count of physical devices — the
    attribution compares whole-tuple bytes and flops against
    whole-tuple capability.  Memoized by the tuple: the drain asks once
    a launch."""
    ent = _mesh_peaks_cache.get(mesh)
    if ent is None:
        kind, n_dev, dev = _mesh_kind(mesh)
        bw, fl, src = backend_peaks(kind, dev)
        if len(_mesh_peaks_cache) >= 16:
            _mesh_peaks_cache.clear()
        ent = _mesh_peaks_cache[mesh] = (bw * n_dev, fl * n_dev, src)
    return ent


@dataclass
class RoofStat:
    """One digest's measured utilization state (EWMA over launches)."""
    ewma_ms: float = 0.0
    transfer_bytes: int = 0      # static LaunchCost bytes per launch
    flops: int = 0               # static LaunchCost flops per launch
    measured_hbm: int = 0        # last measured launch peak (copgauge)
    samples: int = 0

    def attribution(self, peaks: tuple) -> dict:
        """Achieved rates vs the peak table + the roofline verdict."""
        t_s = max(self.ewma_ms, 1e-6) / 1e3
        bw, fl = peaks[0], peaks[1]
        bytes_pct = 100.0 * (self.transfer_bytes / t_s) / max(bw, 1.0)
        flops_pct = 100.0 * (self.flops / t_s) / max(fl, 1.0)
        if self.ewma_ms < LAUNCH_BOUND_MS:
            bound = "launch-bound"
        elif bytes_pct >= flops_pct:
            bound = "memory-bound"
        else:
            bound = "compute-bound"
        return {
            "ewma_ms": round(self.ewma_ms, 3),
            "achieved_gbps": round(self.transfer_bytes / t_s / 1e9, 3),
            "achieved_gflops": round(self.flops / t_s / 1e9, 3),
            "bytes_pct": round(min(bytes_pct, 100.0), 3),
            "flops_pct": round(min(flops_pct, 100.0), 3),
            # distance from the roofline: the optimization headroom
            "gap_pct": round(
                100.0 - min(max(bytes_pct, flops_pct), 100.0), 3),
            "bound": bound,
            "measured_hbm": self.measured_hbm,
            "samples": self.samples,
        }


class RooflineStore:
    """Bounded per-digest utilization store; one per process like the
    calibration correction store it mirrors."""

    def __init__(self, cap: int = ROOFLINE_STORE_CAP):
        self._mu = threading.Lock()
        self._entries = BoundedLRU(cap)
        self._peaks: tuple = (0.0, 0.0, "unknown")
        self.observed = 0
        from ..utils.metrics import global_registry
        reg = global_registry()
        self._m_bytes = reg.gauge(
            "tidb_tpu_roofline_bytes_pct",
            "achieved memory bandwidth as % of the backend peak, per "
            "program digest", labels=("digest",))
        self._m_flops = reg.gauge(
            "tidb_tpu_roofline_flops_pct",
            "achieved FLOP rate as % of the backend peak, per program "
            "digest", labels=("digest",))

    def observe(self, digest: str, cost, measured_ns: int,
                peaks: tuple, measured_hbm: int = 0) -> None:
        """Feed one measured launch: EWMA the digest's wall time and
        refresh its static work terms; gauges follow."""
        if cost is None or measured_ns <= 0:
            return
        meas_ms = measured_ns / 1e6
        short = digest[:12]
        with self._mu:
            self._peaks = peaks
            ent = self._entries.get(digest)
            if ent is None:
                ent = RoofStat()
                self._entries.put(digest, ent)
            ent.ewma_ms = meas_ms if ent.samples == 0 else \
                (1.0 - CALIB_ALPHA) * ent.ewma_ms + CALIB_ALPHA * meas_ms
            ent.transfer_bytes = int(cost.transfer_bytes)
            ent.flops = int(cost.flops)
            if measured_hbm > 0:
                ent.measured_hbm = int(measured_hbm)
            ent.samples += 1
            self.observed += 1
            att = ent.attribution(peaks)
        self._m_bytes.set(att["bytes_pct"], digest=short)
        self._m_flops.set(att["flops_pct"], digest=short)

    def get(self, digest: str) -> Optional[dict]:
        with self._mu:
            ent = self._entries.get(digest)
            if ent is None:
                return None
            return ent.attribution(self._peaks)

    def top(self, n: int = 8) -> dict:
        """Top digests by roofline gap (furthest from peak) and by
        measured residency — the /hbm drill-down tables."""
        with self._mu:
            peaks = self._peaks
            rows = [(d, ent.attribution(peaks))
                    for d, ent in self._entries.items()]
        by_gap = sorted(rows, key=lambda kv: -kv[1]["gap_pct"])[:n]
        by_res = sorted(rows, key=lambda kv: -kv[1]["measured_hbm"])[:n]
        return {"by_gap": {d[:16]: att for d, att in by_gap},
                "by_residency": {d[:16]: att for d, att in by_res}}

    def stats(self) -> dict:
        counts: dict = {}
        with self._mu:
            peaks = self._peaks
            n = len(self._entries)
            for _d, ent in self._entries.items():
                b = ent.attribution(peaks)["bound"]
                counts[b] = counts.get(b, 0) + 1
        return {
            "entries": n,
            "observed": self.observed,
            "peak_bytes_per_s": peaks[0],
            "peak_flops_per_s": peaks[1],
            "peak_source": peaks[2],
            "bounds": counts,
        }

    def reset(self) -> None:
        with self._mu:
            self._entries.clear()
            self.observed = 0


_STORE: Optional[RooflineStore] = None
_STORE_MU = threading.Lock()


def roofline_store() -> RooflineStore:
    global _STORE
    with _STORE_MU:
        if _STORE is None:
            _STORE = RooflineStore()
        return _STORE


def roofline_status(n: int = 8) -> dict:
    """The roofline half of the ``/hbm`` status route."""
    store = roofline_store()
    return {**store.stats(), **store.top(n)}


__all__ = ["RoofStat", "RooflineStore", "roofline_store",
           "roofline_status", "backend_peaks", "peaks_for_mesh",
           "LAUNCH_BOUND_MS", "ROOFLINE_STORE_CAP", "TPU_PEAKS",
           "NVIDIA_PEAKS"]

# ported from tidb_tpu/analysis/calibrate.py @ 6298005
"""copmeter: closed-loop cost calibration for the static launch model.

Reference analog: Flare's split between a slow adaptive control path
and a fast compiled data path (PAPERS.md) — calibration runs host-side
and cheap, the launch path stays static and pre-priced.  The static
``LaunchCost`` model (analysis/copcost) is turned into a launch-time
prediction (``predict_ms``), and a per-program-digest correction store
keyed by the restart-stable dag digest (analysis/compilekey
``stable_digest``) bends it by the digest's measured ``time_factor``,
hard-clamped to ``[CALIB_CLAMP_MIN, CALIB_CLAMP_MAX]`` = [1/8, 8]:
measured feedback may bend the static model, never replace it.

The port holds the read side the planner's strategy choice reaches
(``arbitrated_ms``, executor/plan._arbitrate_strategy).  Nothing feeds
the store yet: its write side (``observe``, the OOM bumps, the
cross-process merge and the persistence through the compile cache's
manifest) comes with the scheduler that measures launches and the
compile cache (ROADMAP.md, Queue 1 entry 10), and the analysis gate's
calibration pass with the gates (entry 11).  Until then the store is
empty and ``arbitrated_ms`` is ``predict_ms``.

Like copcost, this module never imports jax or torch.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Optional

# the clamp: measured feedback bends the static model, never replaces it
CALIB_CLAMP_MIN = 1.0 / 8.0
CALIB_CLAMP_MAX = 8.0

# nominal device throughput the static time prediction assumes; the
# time_factor absorbs (clamped) per-digest deviation from it.  These
# define the *unit* of the prediction, not a claim about any chip.
NOMINAL_BYTES_PER_MS = 32 << 20          # ~32 GB/s effective transfer
NOMINAL_FLOPS_PER_MS = 50_000_000        # ~50 GFLOP/s effective
DISPATCH_OVERHEAD_MS = 0.05              # per-launch fixed dispatch


def clamp_factor(f: float) -> float:
    """The ONLY sanctioned way to apply a measured correction factor:
    hard-clamped to [CALIB_CLAMP_MIN, CALIB_CLAMP_MAX]."""
    return min(max(float(f), CALIB_CLAMP_MIN), CALIB_CLAMP_MAX)


def predict_ms(cost) -> float:
    """Static launch-time prediction from a LaunchCost: transfer at the
    nominal bandwidth + flops at the nominal rate + fixed dispatch
    overhead.  The absolute scale is nominal by construction — the
    per-digest time_factor calibrates it against measured wall time."""
    return (DISPATCH_OVERHEAD_MS
            + cost.transfer_bytes / NOMINAL_BYTES_PER_MS
            + cost.flops / NOMINAL_FLOPS_PER_MS)


@dataclass
class Correction:
    """One digest's measured corrections (EWMA, clamped)."""
    time_factor: float = 1.0     # measured / predicted launch time
    samples: int = 0             # launches observed


class CorrectionStore:
    """Per-digest correction store (the control path): the read side.

    Keys are restart-stable dag digests (analysis/compilekey
    ``stable_digest`` hex).  Readers get a copy, never a live
    Correction to race on."""

    def __init__(self):
        self._mu = threading.Lock()
        self._entries: dict[str, Correction] = {}

    def get(self, digest: str) -> Optional[Correction]:
        with self._mu:
            ent = self._entries.get(digest)
            return replace(ent) if ent is not None else None

    def stats(self) -> dict:
        with self._mu:
            return {"entries": len(self._entries)}


def arbitrated_ms(digest: str, cost) -> float:
    """Per-digest calibrated launch-time estimate for STRATEGY
    ARBITRATION (executor/plan picking SORT vs SEGMENT vs SCATTER for a
    high-NDV group-by): the static predict_ms bent by the digest's
    measured (clamped) time_factor when launches have been observed,
    the untouched static prediction otherwise.  A digest whose measured
    factor beats a rival's flips selection with NO code change — the
    closed-loop the ROADMAP names for the real-TPU hndv cliff."""
    pred = predict_ms(cost)
    ent = correction_store().get(digest)
    if ent is not None and ent.samples > 0:
        pred *= clamp_factor(ent.time_factor)
    return pred


_STORE: Optional[CorrectionStore] = None
_STORE_MU = threading.Lock()


def correction_store() -> CorrectionStore:
    """Process-wide correction store (one per process, like the metric
    registry and the compile cache)."""
    global _STORE
    with _STORE_MU:
        if _STORE is None:
            _STORE = CorrectionStore()
        return _STORE


__all__ = ["CorrectionStore", "Correction", "correction_store",
           "clamp_factor", "predict_ms", "arbitrated_ms",
           "CALIB_CLAMP_MIN", "CALIB_CLAMP_MAX",
           "NOMINAL_BYTES_PER_MS", "NOMINAL_FLOPS_PER_MS",
           "DISPATCH_OVERHEAD_MS"]

# ported from tidb_tpu/analysis/calibrate.py @ 02e96d8
"""copmeter: closed-loop cost calibration for the static launch model.

Reference analog: Flare's split between a slow adaptive control path
and a fast compiled data path (PAPERS.md) — calibration runs host-side
and cheap, the launch path stays static and pre-priced:

- a bounded, LRU-evicted per-program-digest correction store
  (``CorrectionStore``) keyed by the RESTART-STABLE dag digest
  (analysis/compilekey ``stable_digest``), holding EWMA factors per
  digest: ``time_factor`` (measured launch wall time over the static
  model's predicted time: the flops term that feeds RU pricing and the
  micro-batch window) and ``mem_factor`` (the modeled HBM terms that
  feed budget admission and fusion footprint caps: moved by measured
  launch peaks, ``observe_mem``, and doubled on every OOM-classified
  launch failure, ``observe_oom``), both HARD-CLAMPED to
  ``[CALIB_CLAMP_MIN, CALIB_CLAMP_MAX]`` = [1/8, 8]: measured feedback
  may bend the static model, never replace it;
- the write side is the scheduler's drain (sched/scheduler): every warm
  served launch's attributed wall time (``observe``) and, for a
  one-program launch, its measured peak (``observe_mem``: on the card
  ``torch.cuda.max_memory_allocated`` around the launch);
- persistence THROUGH the program cache's manifest
  (compilecache/manifest, ``sync_manifest``): corrections ride the same
  JSON file as the program entries, and a breaker-quarantined digest's
  corrections are purged with them; ``merge_payload`` folds another
  process's payload in;
- consumers: the scheduler (corrected ``LaunchCost`` for RU pricing,
  HBM-budget admission, the fusion footprint cap, the window and the
  deadline-aware shedding) and the planner's strategy choice
  (``arbitrated_ms``, executor/plan._arbitrate_strategy), which reads
  measured launch times once the drain has fed them.

The analysis gate's calibration pass (``simulate_corpus_calibration``)
comes with the gates (ROADMAP.md, Queue 1 entry 11).  Like copcost, this
module never imports torch.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Optional

# the clamp: measured feedback bends the static model, never replaces it
CALIB_CLAMP_MIN = 1.0 / 8.0
CALIB_CLAMP_MAX = 8.0
# EWMA step per observed launch
CALIB_ALPHA = 0.25
# bounded LRU cap on tracked digests — shared with the scheduler's
# per-digest device-time attribution map (one eviction policy)
CALIB_STORE_CAP = 256
# multiplicative memory-correction bump per OOM-classified failure:
# two OOMs quadruple the modeled footprint (still clamped)
CALIB_OOM_BUMP = 2.0
# throttle manifest writes: calibration persists at most this often
CALIB_PERSIST_S = 1.0

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


class BoundedLRU:
    """Thread-safe bounded map with LRU eviction — the ONE eviction
    policy shared by the correction store and the scheduler's
    per-digest device-time attribution map."""

    def __init__(self, cap: int = CALIB_STORE_CAP):
        self.cap = max(int(cap), 1)
        self._mu = threading.Lock()
        self._od: OrderedDict = OrderedDict()
        self.evictions = 0

    def _evict_locked(self) -> None:
        while len(self._od) > self.cap:
            self._od.popitem(last=False)
            self.evictions += 1

    def get(self, key, default=None):
        with self._mu:
            if key in self._od:
                self._od.move_to_end(key)
                return self._od[key]
            return default

    def put(self, key, value) -> None:
        with self._mu:
            self._od[key] = value
            self._od.move_to_end(key)
            self._evict_locked()

    def bump(self, key, delta) -> None:
        """Accumulate ``delta`` onto a numeric slot (the device-ns
        attribution idiom), LRU-touching the key."""
        with self._mu:
            self._od[key] = self._od.get(key, 0) + delta
            self._od.move_to_end(key)
            self._evict_locked()

    def pop(self, key, default=None):
        with self._mu:
            return self._od.pop(key, default)

    def clear(self) -> None:
        with self._mu:
            self._od.clear()

    def items(self) -> list:
        with self._mu:
            return list(self._od.items())

    def __len__(self) -> int:
        with self._mu:
            return len(self._od)


@dataclass
class Correction:
    """One digest's measured corrections (all EWMA, all clamped)."""
    time_factor: float = 1.0     # measured / predicted launch time
    mem_factor: float = 1.0      # measured-watermark footprint
                                 # correction (copgauge; the OOM x2
                                 # bump is its fast path)
    err: float = 0.0             # EWMA relative error of the
                                 # CALIBRATED prediction (EXPLAIN's N%)
    mem_err: float = 0.0         # EWMA relative error of the
                                 # calibrated HBM-peak prediction
    ewma_ms: float = 0.0         # EWMA measured launch wall time
    samples: int = 0
    mem_samples: int = 0         # measured-watermark observations
    oom_bumps: int = 0

    def payload(self) -> dict:
        return {"time_factor": round(self.time_factor, 4),
                "mem_factor": round(self.mem_factor, 4),
                "err": round(self.err, 4),
                "mem_err": round(self.mem_err, 4),
                "ewma_ms": round(self.ewma_ms, 4),
                "samples": self.samples,
                "mem_samples": self.mem_samples,
                "oom_bumps": self.oom_bumps}

    @classmethod
    def from_payload(cls, d: dict) -> "Correction":
        return cls(
            time_factor=clamp_factor(d.get("time_factor", 1.0)),
            mem_factor=clamp_factor(d.get("mem_factor", 1.0)),
            err=max(float(d.get("err", 0.0)), 0.0),
            mem_err=max(float(d.get("mem_err", 0.0)), 0.0),
            ewma_ms=max(float(d.get("ewma_ms", 0.0)), 0.0),
            samples=max(int(d.get("samples", 0)), 0),
            mem_samples=max(int(d.get("mem_samples", 0)), 0),
            oom_bumps=max(int(d.get("oom_bumps", 0)), 0))


def merge_correction_payloads(base: Optional[dict],
                              other: dict) -> dict:
    """Observation-count-weighted merge of two correction payloads —
    the cross-process twin of the in-process EWMA.  The side with more observations dominates (w = n_other /
    (n_base + n_other)), every factor re-passes ``clamp_factor`` so
    the [CALIB_CLAMP_MIN, CALIB_CLAMP_MAX] invariant survives any
    merge order, and sample counts take the MAX of the two sides —
    summing would double-count the same launches on every sync round
    and let a stale payload outvote live measurement forever.
    Time and memory channels merge independently on their own counts;
    ``oom_bumps`` takes the max (each bump already multiplied the
    factor it describes)."""
    if not base:
        return dict(other)
    out = dict(base)
    n_b = max(base.get("samples", 0), 0)
    n_o = max(other.get("samples", 0), 0)
    if n_o > 0:
        w = n_o / max(n_b + n_o, 1)
        tf_b = base.get("time_factor", 1.0)
        out["time_factor"] = round(clamp_factor(
            tf_b + w * (other.get("time_factor", 1.0) - tf_b)), 4)
        for field in ("err", "ewma_ms"):
            v_b = max(base.get(field, 0.0), 0.0)
            out[field] = round(v_b + w * (max(other.get(field, 0.0),
                                              0.0) - v_b), 4)
        out["samples"] = max(n_b, n_o)
    m_b = max(base.get("mem_samples", 0), 0)
    m_o = max(other.get("mem_samples", 0), 0)
    if m_o > 0:
        w = m_o / max(m_b + m_o, 1)
        mf_b = base.get("mem_factor", 1.0)
        out["mem_factor"] = round(clamp_factor(
            mf_b + w * (other.get("mem_factor", 1.0) - mf_b)), 4)
        me_b = max(base.get("mem_err", 0.0), 0.0)
        out["mem_err"] = round(me_b + w * (max(other.get("mem_err",
                                                         0.0),
                                               0.0) - me_b), 4)
        out["mem_samples"] = max(m_b, m_o)
    out["oom_bumps"] = max(base.get("oom_bumps", 0),
                           other.get("oom_bumps", 0))
    if out["oom_bumps"] > base.get("oom_bumps", 0):
        # a peer saw OOMs we did not: adopt the larger (clamped)
        # memory correction outright — admission safety beats EWMA
        out["mem_factor"] = round(clamp_factor(
            max(out.get("mem_factor", 1.0),
                other.get("mem_factor", 1.0))), 4)
    return out


class CorrectionStore:
    """Bounded per-digest EWMA correction store (the control path).

    Keys are RESTART-STABLE dag digests (analysis/compilekey
    ``stable_digest`` hex), so persisted corrections match the same
    program after a restart.  All mutation happens under one leaf
    lock; readers get plain floats (never a live Correction to race
    on) via ``factors``/``expected_ns``."""

    def __init__(self, cap: int = CALIB_STORE_CAP):
        self._mu = threading.Lock()
        self._entries: BoundedLRU = BoundedLRU(cap)
        self._dirty = False
        self._last_persist = 0.0
        self._restored_dirs: set = set()
        self.observed = 0            # launches fed back (lifetime)
        self.mem_observed = 0        # measured watermarks fed back
        self.oom_events = 0          # OOM bumps recorded (lifetime)

    # ---- feedback ---------------------------------------------------- #

    def observe(self, digest: str, cost, measured_ns: int) -> None:
        """Feed one measured launch back: EWMA the digest's
        time_factor toward the clamped measured/predicted ratio and
        track the calibrated model's remaining relative error."""
        meas_ms = measured_ns / 1e6
        if cost is None or meas_ms <= 0:
            return
        pred = predict_ms(cost)
        ratio = clamp_factor(meas_ms / max(pred, 1e-9))
        with self._mu:
            ent = self._entries.get(digest)
            if ent is None:
                ent = Correction()
                self._entries.put(digest, ent)
            # error of the model as it stood BEFORE this update — the
            # honest "how wrong were we" number EXPLAIN reports
            rel = abs(pred * clamp_factor(ent.time_factor) - meas_ms) \
                / max(meas_ms, 1e-9)
            ent.err = rel if ent.samples == 0 else \
                (1.0 - CALIB_ALPHA) * ent.err + CALIB_ALPHA * rel
            ent.time_factor = clamp_factor(
                ent.time_factor + CALIB_ALPHA * (ratio - ent.time_factor))
            ent.ewma_ms = meas_ms if ent.samples == 0 else \
                (1.0 - CALIB_ALPHA) * ent.ewma_ms + CALIB_ALPHA * meas_ms
            ent.samples += 1
            self.observed += 1
            self._dirty = True

    def observe_mem(self, digest: str, cost, measured_bytes: int) -> None:
        """Measured launch watermark feedback (copgauge): EWMA the
        digest's ``mem_factor`` toward the clamped factor that would
        make the modeled (non-exact) HBM terms — inter_bytes +
        output_bytes, exactly what ``corrected_cost`` scales — match
        the measured peak.  The exact resident-input term is never
        corrected (copcost pins it byte-for-byte), so the target solves
        ``exact + f * modeled == measured`` for f.  This is the
        continuous twin of ``observe_oom``'s x2 bump: admission
        headroom now tightens AND loosens from evidence instead of
        waiting for a device fault."""
        if cost is None or measured_bytes <= 0:
            return
        modeled = int(cost.inter_bytes) + int(cost.output_bytes)
        if modeled <= 0:
            return
        exact = cost.peak_hbm_bytes - modeled
        target = clamp_factor((measured_bytes - exact) / modeled)
        with self._mu:
            ent = self._entries.get(digest)
            if ent is None:
                ent = Correction()
                self._entries.put(digest, ent)
            # error of the memory model as it stood BEFORE this update
            pred = exact + modeled * clamp_factor(ent.mem_factor)
            rel = abs(pred - measured_bytes) / max(measured_bytes, 1)
            ent.mem_err = rel if ent.mem_samples == 0 else \
                (1.0 - CALIB_ALPHA) * ent.mem_err + CALIB_ALPHA * rel
            ent.mem_factor = clamp_factor(
                ent.mem_factor + CALIB_ALPHA * (target - ent.mem_factor))
            ent.mem_samples += 1
            self.mem_observed += 1
            self._dirty = True

    def observe_oom(self, digest: str) -> None:
        """An OOM-classified launch failure: the modeled footprint was
        too small — bump the digest's memory correction (clamped) so
        budget admission and fusion caps see a bigger program next
        time (streaming / solo launches instead of a device fault)."""
        with self._mu:
            ent = self._entries.get(digest)
            if ent is None:
                ent = Correction()
                self._entries.put(digest, ent)
            ent.mem_factor = clamp_factor(ent.mem_factor * CALIB_OOM_BUMP)
            ent.oom_bumps += 1
            self.oom_events += 1
            self._dirty = True

    # ---- application ------------------------------------------------- #

    def get(self, digest: str) -> Optional[Correction]:
        with self._mu:
            ent = self._entries.get(digest)
            return replace(ent) if ent is not None else None

    def corrected_cost(self, digest: str, cost):
        """LaunchCost with this digest's measured corrections applied:
        time_factor scales the flops work term, mem_factor the modeled
        (non-exact) intermediate/output HBM terms.  Exact admission
        metadata — the resident input bytes — is never corrected.
        Unknown digests return ``cost`` unchanged (the static model)."""
        with self._mu:
            ent = self._entries.get(digest)
            if ent is None or (ent.samples == 0 and ent.oom_bumps == 0
                               and ent.mem_samples == 0):
                return cost
            tf = clamp_factor(ent.time_factor)
            mf = clamp_factor(ent.mem_factor)
        return replace(cost,
                       flops=int(cost.flops * tf),
                       inter_bytes=int(cost.inter_bytes * mf),
                       output_bytes=int(cost.output_bytes * mf))

    def expected_ns(self, digest: str) -> int:
        """EWMA measured launch time of this digest in ns (0 = never
        measured) — the deadline-shedding backlog unit and the
        micro-batch window's hold ceiling."""
        with self._mu:
            ent = self._entries.get(digest)
            if ent is None or ent.samples == 0:
                return 0
            return int(ent.ewma_ms * 1e6)

    def purge(self, digest: str) -> None:
        """Quarantine hygiene: a breaker-opened digest's corrections
        are dropped with its manifest entries — measured feedback from
        a poisoned program must not survive its quarantine."""
        with self._mu:
            if self._entries.pop(digest) is not None:
                self._dirty = True

    def reset(self) -> None:
        with self._mu:
            self._entries.clear()
            self._restored_dirs.clear()
            self._dirty = False

    # ---- persistence (through the copforge manifest) ----------------- #

    def entries_payload(self) -> dict:
        with self._mu:
            return {d: ent.payload() for d, ent in self._entries.items()}

    def restore(self, manifest) -> int:
        """Merge persisted corrections (digests not already observed
        live win nothing — live EWMA state is fresher than disk)."""
        loaded = manifest.load_calibration()
        n = 0
        with self._mu:
            for d, payload in sorted(loaded.items()):
                if self._entries.get(d) is None:
                    self._entries.put(d, Correction.from_payload(payload))
                    n += 1
        return n

    def merge_payload(self, digest: str, payload: dict) -> bool:
        """Fold one shared payload (another process's) into this store — observation-count-weighted EWMA merge
        (``merge_correction_payloads``), clamp preserved.  A digest
        never seen locally adopts the peer's payload outright (a
        digest measured hot in process A prices correctly in B before
        B ever launches it).  Returns True when the local entry
        actually moved."""
        with self._mu:
            ent = self._entries.get(digest)
            if ent is None:
                fresh = Correction.from_payload(payload)
                if fresh.samples == 0 and fresh.mem_samples == 0 \
                        and fresh.oom_bumps == 0:
                    return False       # nothing measured: not worth a slot
                self._entries.put(digest, fresh)
                self._dirty = True
                return True
            merged = Correction.from_payload(
                merge_correction_payloads(ent.payload(), payload))
            changed = (abs(merged.time_factor - ent.time_factor) > 1e-6
                       or abs(merged.mem_factor - ent.mem_factor) > 1e-6
                       or merged.samples != ent.samples
                       or merged.mem_samples != ent.mem_samples
                       or merged.oom_bumps != ent.oom_bumps)
            if changed:
                self._entries.put(digest, merged)
                self._dirty = True
            return changed

    def sync_manifest(self, force: bool = False) -> None:
        """Throttled restore+persist against the copforge manifest (a
        no-op without a cache dir).  First sync per directory restores
        persisted corrections; later syncs write dirty state at most
        every CALIB_PERSIST_S."""
        from ..compilecache import compile_cache
        cache = compile_cache()
        m = cache.manifest
        if m is None:
            return
        with self._mu:
            fresh_dir = m.cache_dir not in self._restored_dirs
            if fresh_dir:
                self._restored_dirs.add(m.cache_dir)
            now = time.monotonic()
            due = force or (self._dirty
                            and now - self._last_persist >= CALIB_PERSIST_S)
            if due:
                self._dirty = False
                self._last_persist = now
        if fresh_dir:
            self.restore(m)
        if due:
            m.save_calibration(self.entries_payload())

    # ---- introspection ----------------------------------------------- #

    def stats(self) -> dict:
        with self._mu:
            items = self._entries.items()
            errs = [e.err for _d, e in items if e.samples > 0]
            merrs = [e.mem_err for _d, e in items if e.mem_samples > 0]
            return {
                "entries": len(items),
                "observed": self.observed,
                "mem_observed": self.mem_observed,
                "oom_events": self.oom_events,
                "evictions": self._entries.evictions,
                "mean_err_pct": round(100.0 * sum(errs) / len(errs), 2)
                if errs else None,
                "mean_mem_err_pct": round(
                    100.0 * sum(merrs) / len(merrs), 2)
                if merrs else None,
                "digests": {
                    d: e.payload() for d, e in sorted(
                        items, key=lambda kv: -kv[1].samples)[:8]},
            }


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


__all__ = ["CorrectionStore", "Correction", "BoundedLRU",
           "correction_store", "clamp_factor", "predict_ms",
           "arbitrated_ms", "merge_correction_payloads",
           "CALIB_CLAMP_MIN", "CALIB_CLAMP_MAX", "CALIB_ALPHA",
           "CALIB_STORE_CAP", "CALIB_OOM_BUMP", "CALIB_PERSIST_S",
           "NOMINAL_BYTES_PER_MS", "NOMINAL_FLOPS_PER_MS",
           "DISPATCH_OVERHEAD_MS"]

# ported from tidb_tpu/faults/plan.py @ ba365f2
"""FaultPlan: seeded, deterministic fault injection at named seams.

Reference analog: tikv/tidb failpoints (failpoint.Inject on rpc/region
errors, the seam pkg/store/copr exercises its backoff loop through) —
but deterministic: every decision is a pure function of (seed, seam,
program digest, attempt counter), so a chaos run replays bit-identically
and a test can poison exactly one member of a fused launch.  Off by
default; armed via the TIDB_TPU_FAULTS env var, the `tidb_tpu_faults`
sysvar, or programmatic `install()` (tests).

Seams (every recovery path in the engine is exercisable on a CPU mesh
through these, no real TPU required):

- ``build``     program build/trace (scheduler resolving a compiled
                program for a cop task)
- ``launch``    device launch (compiled program invocation; fused
                launches consult the seam once PER MEMBER digest, so a
                poisoned member forces the blast-radius demux)
- ``transfer``  device->host transfer / host merge (CopClient result
                decode)
- ``dispatch``  store dispatch (CopClient._retry, next to the legacy
                RegionError failpoint queue)
- ``drain``     drain wakeup (scheduler loop, before a batch serves)

The client consults ``dispatch`` and ``transfer``; the ``build``,
``launch`` and ``drain`` seams are the device scheduler's (sched/).

Fault kinds:

- ``transient`` retryable: decided per (seed, seam, key, attempt), so a
                retry rolls fresh dice — the supervised drain recovers
                it through the Backoffer DEVICE_FAILED budget.
- ``poison``    deterministic per (seed, seam, key): every retry of the
                same program fails again — retrying never helps, the
                per-digest circuit breaker is the only way out.
- ``oom``       memory-exhaustion class (a CUDA OOM: torch's
                ``OutOfMemoryError``): decided per (seed, seam, key, attempt)
                like ``transient`` — a re-sized or solo retry may fit —
                but classified apart by the supervised drain: an OOM
                bumps the digest's memory correction
                (analysis/calibrate), demuxes fused launches to reduce
                width, and NEVER charges the poison circuit breaker
                (a healthy program that outgrew the budget is not a
                broken kernel).  ``is_oom_error`` also classifies REAL
                backend OOMs (``torch.cuda.OutOfMemoryError``) the same
                way, so the recovery path is CPU-testable via this seam.
"""

from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass
from typing import Optional

SEAMS = ("build", "launch", "transfer", "dispatch", "drain")

_MASK = (1 << 64) - 1


class InjectedFault(RuntimeError):
    """Base of every fault the plan raises; `transient` drives the
    supervised drain's retry-vs-isolate classification."""

    transient = False

    def __init__(self, seam: str, key=None):
        at = f" digest={key & _MASK:016x}" if isinstance(key, int) else ""
        super().__init__(f"injected {self.kind()} fault at seam "
                         f"'{seam}'{at} (faultline)")
        self.seam = seam
        self.key = key

    @classmethod
    def kind(cls) -> str:
        return "transient" if cls.transient else "poison"


class TransientFault(InjectedFault):
    """Retryable injected failure (store-unreachable / preempted-launch
    class): a fresh attempt may succeed."""
    transient = True


class PoisonFault(InjectedFault):
    """Deterministic injected failure (broken kernel / poisoned plan
    class): the same program fails on every retry."""
    transient = False


class MemoryFault(InjectedFault):
    """Injected device memory exhaustion (CUDA OOM
    class): the launch as sized did not fit.  Not retry-as-is worthy
    (the identical launch would OOM again) but also NOT poison — the
    supervised drain recovers it by shrinking the launch (fused-width
    demux, streamed batching, host fallback) and bumping the digest's
    memory correction, never by opening the circuit breaker."""
    transient = False

    @classmethod
    def kind(cls) -> str:
        return "oom"


_KIND_EXC = {"transient": TransientFault, "poison": PoisonFault,
             "oom": MemoryFault}

# substrings that mark a REAL backend launch failure as memory
# exhaustion: the JAX package's XLA markers, which also cover a CUDA
# OOM's text ("CUDA out of memory", and "out of memory", the CUDA error
# string of cudaErrorMemoryAllocation that a hand kernel's launcher
# reports, copr/cuda/build.raise_on)
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "Resource exhausted", "OOM when allocating")


def is_oom_error(e: BaseException) -> bool:
    """Classify a launch failure as device memory exhaustion: the
    injected MemoryFault, a ``torch.cuda.OutOfMemoryError`` (by type: the
    caching allocator could not serve an allocation, and the CUDA
    context stays usable), or a real backend error whose text carries an
    OOM marker.  A kernel build failure (``KernelBuildError``: nvcc's
    own text may mention memory) and every other launch failure (an
    illegal memory access, too many resources requested) are not OOMs:
    they leave no smaller launch to try, and an illegal access leaves
    the context unusable."""
    if isinstance(e, MemoryFault):
        return True
    if isinstance(e, InjectedFault):
        return False
    import torch

    from ..copr.cuda.build import KernelBuildError
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    if isinstance(e, KernelBuildError):
        return False
    text = f"{type(e).__name__}: {e}"
    return any(m in text for m in _OOM_MARKERS)


@dataclass(frozen=True)
class FaultRule:
    """One armed rule.  ``match`` filters by hex program digest
    substring ('' = any key, including unkeyed seams); ``times`` caps
    total injections (0 = unlimited) — the n-shot failpoint idiom."""
    seam: str            # one of SEAMS, or '*'
    kind: str            # 'transient' | 'poison'
    rate: float = 1.0    # injection probability (deterministic hash)
    match: str = ""      # hex-digest substring; keyed checks only
    times: int = 0       # fire at most N times; 0 = unlimited


def _mix(*vals: int) -> int:
    """splitmix64-style avalanche over the inputs: the deterministic
    dice (same idiom as copr/segment's key hash)."""
    x = 0x9E3779B97F4A7C15
    for v in vals:
        x ^= v & _MASK
        x = (x * 0xBF58476D1CE4E5B9) & _MASK
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) & _MASK
        x ^= x >> 31
    return x


def _seam_id(seam: str) -> int:
    return zlib.crc32(seam.encode())


class FaultPlan:
    """A set of armed FaultRules plus the seed and injection counters.
    Thread-safe; decisions are deterministic given (seed, call order
    per seam, keys)."""

    def __init__(self, rules, seed: int = 0):
        self.rules = tuple(rules)
        self.seed = int(seed)
        self._mu = threading.Lock()
        self._calls: dict = {}          # seam -> checks
        self._injected: dict = {}       # (seam, kind) -> fires
        self._times_left = {i: r.times for i, r in enumerate(self.rules)
                            if r.times > 0}

    # ---- spec parsing ------------------------------------------------ #

    @classmethod
    def parse(cls, spec: str) -> Optional["FaultPlan"]:
        """``seed=42,launch:transient:0.2,build:poison:1:match=ab12``
        -> FaultPlan; empty/blank spec -> None (unarmed)."""
        seed = 0
        rules = []
        for token in (spec or "").split(","):
            token = token.strip()
            if not token:
                continue
            if token.startswith("seed="):
                seed = int(token[5:])
                continue
            parts = token.split(":")
            if len(parts) < 2:
                raise ValueError(f"bad fault rule {token!r}: want "
                                 "seam:kind[:rate][:match=..][:times=..]")
            seam, kind = parts[0], parts[1]
            if seam not in SEAMS and seam != "*":
                raise ValueError(f"unknown fault seam {seam!r} "
                                 f"(one of {SEAMS} or '*')")
            if kind not in _KIND_EXC:
                raise ValueError(f"unknown fault kind {kind!r} "
                                 f"(one of {tuple(sorted(_KIND_EXC))})")
            rate, match, times = 1.0, "", 0
            for extra in parts[2:]:
                if extra.startswith("match="):
                    match = extra[6:]
                elif extra.startswith("times="):
                    times = int(extra[6:])
                else:
                    rate = float(extra)
            rules.append(FaultRule(seam, kind, rate, match, times))
        if not rules:
            return None
        return cls(rules, seed=seed)

    # ---- the seam check ---------------------------------------------- #

    def check(self, seam: str, key: Optional[int] = None) -> None:
        """Raise the armed fault for this (seam, key) attempt, or pass.
        `key` is the program digest where one exists (build/launch and
        keyed transfer checks); unkeyed seams only match rules without
        a `match` filter."""
        fault = None
        with self._mu:
            n = self._calls[seam] = self._calls.get(seam, 0) + 1
            for i, r in enumerate(self.rules):
                if r.seam != seam and r.seam != "*":
                    continue
                if r.match:
                    if key is None or \
                            r.match not in f"{key & _MASK:016x}":
                        continue
                left = self._times_left.get(i)
                if left is not None and left <= 0:
                    continue
                if r.rate < 1.0:
                    kv = (key or 0) & _MASK
                    if r.kind == "poison":
                        # keyed-only dice: the SAME key fails forever
                        u = _mix(self.seed, _seam_id(seam), kv)
                    else:
                        # attempt-counted dice (transient AND oom): a
                        # retry — or a re-sized/demuxed re-launch —
                        # rolls fresh
                        u = _mix(self.seed, _seam_id(seam), kv, n)
                    if u / 2.0 ** 64 >= r.rate:
                        continue
                if left is not None:
                    self._times_left[i] = left - 1
                k = (seam, r.kind)
                self._injected[k] = self._injected.get(k, 0) + 1
                fault = _KIND_EXC[r.kind](seam, key)
                break
        if fault is not None:
            from ..utils.metrics import global_registry
            global_registry().counter(
                "tidb_tpu_faults_injected_total",
                "faults injected by the armed FaultPlan",
                labels=("seam", "kind")).inc(seam=fault.seam,
                                             kind=fault.kind())
            # copscope: statement-thread seams (dispatch/transfer) mark
            # the injection on the active trace; drain-thread seams
            # have no context here — their injections surface through
            # the scheduler's retry/fail span error labels instead
            from ..obs.trace import current as _obs_current
            ctx = _obs_current()
            if ctx is not None:
                import time as _time
                now = _time.perf_counter_ns()
                ctx.add("fault.inject", now, now, seam=fault.seam,
                        kind=fault.kind())
            raise fault

    def backoff_rng(self):
        """Seeded jitter source for Backoffer under this plan: retry
        histories replay bit-identically (store/backoff rng seam)."""
        import random
        return random.Random(self.seed)

    def stats(self) -> dict:
        with self._mu:
            return {
                "seed": self.seed,
                "rules": [f"{r.seam}:{r.kind}:{r.rate}"
                          + (f":match={r.match}" if r.match else "")
                          + (f":times={r.times}" if r.times else "")
                          for r in self.rules],
                "checks": dict(sorted(self._calls.items())),
                "injected": {f"{s}:{k}": v for (s, k), v in
                             sorted(self._injected.items())},
                "total_injected": sum(self._injected.values()),
            }


# --------------------------------------------------------------------- #
# process-wide active plan (the scheduler/client seams consult this)
# --------------------------------------------------------------------- #

_ACTIVE: Optional[FaultPlan] = None
_ENV_CHECKED = False
_SPEC = ""                # last sysvar-installed spec (install_spec)
_MU = threading.Lock()


def install(plan: Optional[FaultPlan]) -> None:
    """Arm `plan` process-wide (tests / embedders); None disarms."""
    global _ACTIVE, _ENV_CHECKED, _SPEC
    with _MU:
        _ACTIVE = plan
        _ENV_CHECKED = True     # explicit install outranks the env
        _SPEC = ""


def clear() -> None:
    install(None)


def install_spec(spec: str) -> None:
    """Sysvar seam (tidb_tpu_faults): (re)arm from a spec string.  An
    empty spec only DISARMS a plan this same seam installed — it never
    clobbers a programmatic install() (tests arm directly while
    statements keep flowing)."""
    global _ACTIVE, _ENV_CHECKED, _SPEC
    spec = (spec or "").strip()
    with _MU:
        if spec == _SPEC:
            return
        if not spec:
            if _SPEC:               # only undo our own install
                _ACTIVE = None
                _SPEC = ""
            return
        _ACTIVE = FaultPlan.parse(spec)
        _ENV_CHECKED = True
        _SPEC = spec


def active() -> Optional[FaultPlan]:
    """The armed plan, if any; first call consults TIDB_TPU_FAULTS."""
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        with _MU:
            if not _ENV_CHECKED:
                _ENV_CHECKED = True
                spec = os.environ.get("TIDB_TPU_FAULTS", "")
                if spec:
                    _ACTIVE = FaultPlan.parse(spec)
    return _ACTIVE


def check(seam: str, key: Optional[int] = None) -> None:
    """Seam hook: no-op when unarmed (the common case — one None read)."""
    p = active()
    if p is not None:
        p.check(seam, key)


def stats() -> Optional[dict]:
    p = active()
    return p.stats() if p is not None else None


__all__ = ["FaultPlan", "FaultRule", "InjectedFault", "TransientFault",
           "PoisonFault", "MemoryFault", "is_oom_error", "SEAMS",
           "install", "install_spec", "clear", "active", "check",
           "stats"]

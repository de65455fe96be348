# ported from tidb_tpu/faults/breaker.py @ ba365f2
"""Per-program-digest circuit breaker for device launches.

Reference analog: tikv/client-go's region/store blacklisting inside the
copIterator retry loop — a store that keeps failing stops receiving
dispatches for a cooldown instead of burning every statement's retry
budget against it.  Here the failure domain is a compiled PROGRAM (the
scheduler's dag-digest key): a plan whose build/launch keeps crashing
the device is quarantined so repeat offenders fail fast with a
structured error — which the CopClient can turn into a host-oracle
fallback — instead of re-crashing the device under every waiter.

State machine (per digest):

    CLOSED --(N failures within window_s)--> OPEN
    OPEN   --(cooldown_s elapsed; next admit)--> HALF_OPEN (one probe)
    HALF_OPEN --probe success--> CLOSED
    HALF_OPEN --probe failure--> OPEN (cooldown restarts)

`admit` runs in the SUBMITTING thread (before anything queues or
traces), so a quarantined digest costs one dict lookup, not a device
crash.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

CLOSED = "CLOSED"
OPEN = "OPEN"
HALF_OPEN = "HALF_OPEN"

DEFAULT_THRESHOLD = 3        # failures within the window that trip OPEN
DEFAULT_WINDOW_S = 30.0      # failure-counting window
DEFAULT_COOLDOWN_S = 2.0     # OPEN dwell before the HALF_OPEN probe
# a HALF_OPEN probe that never reports back (submitter died between
# admit and launch) stops blocking new probes after this long
PROBE_TTL_S = 60.0


def digest_hex(digest: int) -> str:
    """Display form shared with the scheduler's device-time map."""
    return f"{digest & 0xffffffffffffffff:016x}"


class LaunchQuarantinedError(RuntimeError):
    """Structured fail-fast for a quarantined program digest: the
    breaker is OPEN (or a HALF_OPEN probe is already in flight), so
    this launch would re-crash the device.  Carries what a client needs
    to degrade gracefully or surface a useful error."""

    def __init__(self, digest: int, failures: int, retry_after_s: float):
        super().__init__(
            f"program {digest_hex(digest)} is quarantined after "
            f"{failures} launch failures (circuit breaker OPEN; "
            f"probe in {max(retry_after_s, 0.0):.2f}s)")
        self.digest = digest
        self.failures = failures
        self.retry_after_s = max(retry_after_s, 0.0)


class _Entry:
    __slots__ = ("state", "fail_times", "failures", "opened_at",
                 "probe_since", "trips")

    def __init__(self):
        self.state = CLOSED
        self.fail_times: list = []    # recent failure stamps (window)
        self.failures = 0             # lifetime launch failures
        self.opened_at = 0.0
        self.probe_since = 0.0        # nonzero = probe in flight
        self.trips = 0                # CLOSED->OPEN transitions


class CircuitBreaker:
    """Thread-safe per-digest breaker map (bounded).  `clock` is the
    test seam (defaults to time.monotonic)."""

    def __init__(self, threshold: int = DEFAULT_THRESHOLD,
                 window_s: float = DEFAULT_WINDOW_S,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 cap: int = 256, clock=time.monotonic):
        self.threshold = threshold
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self.cap = cap
        self.clock = clock
        self._mu = threading.Lock()
        self._entries: dict[int, _Entry] = {}

    # ---- admission (submitting thread) ------------------------------- #

    def admit(self, digest: int) -> None:
        """Pass, or raise LaunchQuarantinedError.  An OPEN entry past
        its cooldown transitions to HALF_OPEN and admits THIS caller as
        the single probe; concurrent submits keep failing fast until
        the probe reports back (or its TTL lapses)."""
        now = self.clock()
        with self._mu:
            e = self._entries.get(digest)
            if e is None or e.state == CLOSED:
                return
            if e.state == OPEN:
                wait = self.cooldown_s - (now - e.opened_at)
                if wait > 0:
                    raise LaunchQuarantinedError(digest, e.failures, wait)
                e.state = HALF_OPEN
                e.probe_since = now
                return                      # this caller is the probe
            # HALF_OPEN: one probe at a time
            if e.probe_since and now - e.probe_since < PROBE_TTL_S:
                raise LaunchQuarantinedError(
                    digest, e.failures,
                    PROBE_TTL_S - (now - e.probe_since))
            e.probe_since = now             # stale probe: take over

    def abort_probe(self, digest: int) -> None:
        """The admitted probe never reached a launch (queue overflow
        etc.): release the slot so the next submit may probe."""
        with self._mu:
            e = self._entries.get(digest)
            if e is not None and e.state == HALF_OPEN:
                e.probe_since = 0.0

    # ---- outcomes (drain thread) ------------------------------------- #

    def record_failure(self, digest: int) -> None:
        now = self.clock()
        with self._mu:
            e = self._entries.get(digest)
            if e is None:
                if len(self._entries) >= self.cap:
                    self._evict_closed()
                e = self._entries[digest] = _Entry()
            e.failures += 1
            if e.state == HALF_OPEN:
                # probe failed: quarantine again, cooldown restarts
                e.state = OPEN
                e.opened_at = now
                e.probe_since = 0.0
                return
            e.fail_times = [t for t in e.fail_times
                            if now - t <= self.window_s]
            e.fail_times.append(now)
            if e.state == CLOSED and \
                    len(e.fail_times) >= self.threshold:
                e.state = OPEN
                e.opened_at = now
                e.trips += 1

    def record_success(self, digest: int) -> None:
        with self._mu:
            e = self._entries.get(digest)
            if e is None:
                return
            if e.state == HALF_OPEN:
                e.state = CLOSED            # probe healed the circuit
                e.probe_since = 0.0
            if e.state == CLOSED:
                e.fail_times = []           # healthy launch resets count

    def _evict_closed(self) -> None:
        """Capped map: drop CLOSED entries first (with _mu held)."""
        for d in [d for d, e in self._entries.items()
                  if e.state == CLOSED][:max(len(self._entries) // 4, 1)]:
            del self._entries[d]
        while len(self._entries) >= self.cap:
            self._entries.pop(next(iter(self._entries)))

    # ---- introspection ----------------------------------------------- #

    def state(self, digest: int) -> str:
        with self._mu:
            e = self._entries.get(digest)
            return e.state if e is not None else CLOSED

    def snapshot(self, max_entries: int = 16) -> dict:
        """Non-trivial entries for /sched: digests with a tripped or
        failing breaker, hex-keyed like digest_device_ms."""
        now = self.clock()
        with self._mu:
            ents = [(d, e) for d, e in self._entries.items()
                    if e.state != CLOSED or e.failures]
            ents.sort(key=lambda de: (de[1].state == CLOSED,
                                      -de[1].failures))
            out = {}
            for d, e in ents[:max_entries]:
                ent = {"state": e.state, "failures": e.failures,
                       "trips": e.trips}
                if e.state == OPEN:
                    ent["probe_in_s"] = round(max(
                        self.cooldown_s - (now - e.opened_at), 0.0), 3)
                out[digest_hex(d)] = ent
            return out

    def reset(self, digest: Optional[int] = None) -> None:
        with self._mu:
            if digest is None:
                self._entries.clear()
            else:
                self._entries.pop(digest, None)


__all__ = ["CircuitBreaker", "LaunchQuarantinedError", "digest_hex",
           "CLOSED", "OPEN", "HALF_OPEN"]

# ported from tidb_tpu/rc/bucket.py @ 02e96d8
"""Per-group RU token bucket: burst, bounded overdraft, lazy refill.

Reference analog: the tikv-side resource_control token bucket the
tidb resource-group client debits against.  One bucket per resource
group, shared by every session in the group (the server is thread-per-
connection), so every operation takes the bucket's leaf lock.  The
bucket never sleeps and never calls out under its lock — blocking
throttles live in the controller/scheduler layers, which decide WHEN to
consult the bucket; the bucket only answers "can this debit be
covered?" and keeps monotonic-time refill state.

Debt model: the drain debits a task's priced RUs the moment it admits
the task into a launch (pre-launch, post-check), so balances can dip
below zero up to the configured overdraft — bounded post-paid debt,
like the reference's token client — and refill pays the debt down
before banking burst.
"""

from __future__ import annotations

import threading
import time

# burst window in seconds of refill the bucket may bank; BURSTABLE
# groups bank 10x (the pre-rc ResourceGroup burst semantics, kept)
BURST_S = 1.0
BURSTABLE_FACTOR = 10.0


class TokenBucket:
    """Thread-safe RU bucket.  ``rate`` <= 0 means unlimited: every
    cover check passes and debits are recorded but never throttle."""

    __slots__ = ("_rate", "_burst_s", "_tokens", "_last", "_mu",
                 "debited", "credited")

    def __init__(self, rate: float = 0.0, burstable: bool = False):
        self._mu = threading.Lock()
        self._rate = float(max(rate, 0.0))
        self._burst_s = BURST_S * (BURSTABLE_FACTOR if burstable else 1.0)
        self._tokens = self._cap()
        self._last = time.monotonic()
        self.debited = 0.0        # lifetime RUs debited (stats)
        self.credited = 0.0       # lifetime RUs credited back (stats)

    # -- configuration ------------------------------------------------ #

    def _cap(self) -> float:
        return self._rate * self._burst_s

    def set_limit(self, rate: float, burstable: bool) -> None:
        """ALTER RESOURCE GROUP: re-rate in place, keeping accumulated
        balance/debt (clamped into the new burst cap)."""
        with self._mu:
            self._refill_locked(time.monotonic())
            self._rate = float(max(rate, 0.0))
            self._burst_s = BURST_S * (BURSTABLE_FACTOR if burstable
                                       else 1.0)
            self._tokens = min(self._tokens, self._cap())

    @property
    def rate(self) -> float:
        return self._rate

    @property
    def limited(self) -> bool:
        return self._rate > 0

    # -- refill + balance --------------------------------------------- #

    def _refill_locked(self, now: float) -> None:
        if self._rate <= 0:
            return
        dt = now - self._last
        if dt > 0:
            self._tokens = min(self._tokens + dt * self._rate, self._cap())
        self._last = now

    @property
    def balance(self) -> float:
        """Current tokens (negative = debt), refreshed lazily."""
        with self._mu:
            self._refill_locked(time.monotonic())
            return self._tokens

    @property
    def debt(self) -> float:
        return max(0.0, -self.balance)

    # -- the three operations the control plane needs ------------------ #

    def can_cover(self, rus: float, overdraft: float = 0.0) -> bool:
        """May a debit of ``rus`` proceed without exceeding the bounded
        overdraft?  Pure check — the drain debits separately once it
        commits the task to a launch (single drain thread, so the
        check-then-debit pair cannot race with itself)."""
        if self._rate <= 0:
            return True
        with self._mu:
            self._refill_locked(time.monotonic())
            return self._tokens - rus >= -float(max(overdraft, 0.0))

    def debit(self, rus: float) -> None:
        """Unconditional debit (the caller already passed can_cover, or
        is taking sanctioned debt: cooldown double-charge, post-paid
        host fallback)."""
        with self._mu:
            self._refill_locked(time.monotonic())
            self._tokens -= float(rus)
            self.debited += float(rus)

    def credit(self, rus: float) -> None:
        """Refund (SWITCH_GROUP re-pricing moves a statement's debit to
        the target group).  Credits may exceed the burst cap briefly;
        the next refill clamps."""
        with self._mu:
            self._refill_locked(time.monotonic())
            self._tokens = min(self._tokens + float(rus), self._cap())
            self.credited += float(rus)

    def try_postpaid(self, rus: float) -> bool:
        """Legacy post-paid discipline for the host statement path: any
        positive balance admits the charge (possibly into debt); an
        empty bucket refuses, and the controller sleeps outside the
        lock.  True = debited."""
        if self._rate <= 0:
            return True
        with self._mu:
            self._refill_locked(time.monotonic())
            if self._tokens > 0:
                self._tokens -= float(rus)
                self.debited += float(rus)
                return True
            return False

    def deficit(self, rus: float) -> float:
        """RUs short of covering ``rus`` from a positive balance — the
        quantity the blocking host path converts into sleep time."""
        with self._mu:
            self._refill_locked(time.monotonic())
            return max(0.0, rus - self._tokens)

    def force_debit(self, rus: float) -> None:
        """Test/chaos seam: push the bucket into arbitrary debt without
        touching refill state (exhausting a group deterministically)."""
        with self._mu:
            self._tokens -= float(rus)


__all__ = ["TokenBucket", "BURST_S", "BURSTABLE_FACTOR"]

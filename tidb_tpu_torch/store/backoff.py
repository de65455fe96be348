# ported from tidb_tpu/store/backoff.py @ 9d319cb
"""Backoffer: typed exponential-backoff retry budgets.

Reference analog: tikv/client-go retry.Backoffer as used by
pkg/store/copr (coprocessor.go backoff on region errors, store
unreachable, etc.).  Each error KIND has its own base/cap growth curve;
the backoffer enforces a TOTAL sleep budget across all kinds — when the
budget is exhausted the original error surfaces with the attempt history
attached (the reference's `backoff timeout, takes too long` path).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field


class RetryBudgetExceeded(RuntimeError):
    def __init__(self, history: list, last: Exception):
        super().__init__(
            f"retry budget exhausted after {len(history)} attempts: {last}")
        self.history = history
        self.last = last


@dataclass(frozen=True)
class BackoffKind:
    name: str
    base_ms: float
    cap_ms: float


# the reference's config set (retry/backoff.go), trimmed to the error
# classes this engine can actually produce
REGION_MISS = BackoffKind("regionMiss", 2, 500)
STALE_EPOCH = BackoffKind("staleEpoch", 2, 500)
STORE_UNAVAILABLE = BackoffKind("storeUnavailable", 100, 2000)
DEVICE_BUSY = BackoffKind("deviceBusy", 20, 1000)
TXN_LOCK = BackoffKind("txnLock", 10, 1000)
# transient device-launch failure (faultline supervised drain): a
# compiled program's launch died in a retryable way — back off and
# re-launch under the statement budget (copIterator rpc-error analog)
DEVICE_FAILED = BackoffKind("deviceFailed", 10, 500)


@dataclass
class Backoffer:
    """One statement-scoped retry budget (max total sleep)."""
    max_sleep_ms: float = 5000.0
    slept_ms: float = 0.0
    attempts: dict = field(default_factory=dict)   # kind name -> count
    history: list = field(default_factory=list)
    sleep_fn: object = time.sleep      # test seam
    # jitter source: the global random module by default; inject a
    # seeded random.Random so retry histories replay bit-identically in
    # tests and under an armed FaultPlan (sleep_fn's twin seam)
    rng: object = random

    def backoff(self, kind: BackoffKind, err: Exception) -> None:
        """Sleep per the kind's curve, or raise RetryBudgetExceeded."""
        n = self.attempts.get(kind.name, 0)
        self.attempts[kind.name] = n + 1
        # exponential with equal-jitter, capped
        raw = min(kind.base_ms * (2 ** n), kind.cap_ms)
        ms = raw / 2 + self.rng.uniform(0, raw / 2)
        self.history.append((kind.name, round(ms, 2), str(err)))
        if self.slept_ms + ms > self.max_sleep_ms:
            raise RetryBudgetExceeded(self.history, err)
        self.slept_ms += ms
        self.sleep_fn(ms / 1000.0)


class RegionError(RuntimeError):
    """Retryable dispatch error (epoch-not-match / region-miss /
    store-unavailable analog); `kind` selects the backoff curve."""

    def __init__(self, kind: BackoffKind, msg: str = ""):
        super().__init__(msg or kind.name)
        self.kind = kind


__all__ = ["Backoffer", "BackoffKind", "RegionError",
           "RetryBudgetExceeded", "REGION_MISS", "STALE_EPOCH",
           "STORE_UNAVAILABLE", "DEVICE_BUSY", "DEVICE_FAILED",
           "TXN_LOCK"]

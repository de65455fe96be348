# ported from tidb_tpu/obs/hbm.py @ 02e96d8
"""copgauge: the live device-memory ledger the scheduler's drain reads.

Of the JAX package's ``obs/`` the port holds this one part: the
per-device ledger (``ledger_for``) that the drain credits at launch
admission (``launch_begin``), debits at finish (``launch_end``) and
feeds each launch's measured peak (``note_measured``).  On the card the
measured peak of a launch is ``torch.cuda.max_memory_allocated`` around
it, taken by the scheduler; ``device_memory_stats`` reads the card's
total memory, which the admission budget derives from (analysis/copcost
``mesh_hbm_budget``).  The CPU reports none.

The rest of ``obs/`` (the statement spans, the flight recorder, the
roofline store, the ``/hbm`` and ``/profile`` routes) comes with the
control and observability planes (ROADMAP.md, Queue 1 entry 12).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

# recent per-launch measured peaks kept for the stats (bounded ring)
MEASURED_RING = 64


def device_memory_stats(devices) -> Optional[dict]:
    """``bytes_limit``, the memory of the card behind ``devices`` (a tuple
    of torch devices), or None on the CPU, which reports nothing."""
    dev = devices[0] if devices else None
    if getattr(dev, "type", None) != "cuda":
        return None
    import torch
    return {"bytes_limit": int(
        torch.cuda.get_device_properties(dev).total_memory)}


class HbmLedger:
    """Live device-memory account of ONE device tuple (keyed by its
    fingerprint, like the scheduler registry): the bytes of the launches
    in flight (``launch_begin``/``launch_end``, the drain's static
    estimate of what a launch adds over its resident inputs) and the
    measured launch peaks (``note_measured``).  All mutation takes the
    leaf lock ``_mu``; balances are clamped at zero with a
    ``negative_events`` counter — bookkeeping drift surfaces as a
    diagnostic, never as a wedged account.  The JAX package's ledger
    also tracks the snapshot residents through the lifetime analysis's
    weakref registry (ROADMAP.md, Queue 1 entry 11) and reconciles with
    the device's stats for ``/hbm`` (entry 12)."""

    def __init__(self, fingerprint=None):
        self.fingerprint = fingerprint
        self._mu = threading.Lock()
        self.inflight_bytes = 0        # launches currently holding HBM
        self.watermark_bytes = 0       # high-water of in-flight + measured
        self.max_measured_bytes = 0    # largest per-launch measured peak
        self.last_measured_bytes = 0
        self.launches = 0              # launch_begin events (lifetime)
        self.measured_launches = 0     # launches with a measured peak
        self.negative_events = 0       # clamped would-be-negative balances
        self._measured_ring: deque = deque(maxlen=MEASURED_RING)
        from ..utils.metrics import global_registry
        reg = global_registry()
        self._m_resident = reg.gauge(
            "tidb_tpu_hbm_resident_bytes",
            "ledger-tracked device bytes of the launches in flight")
        self._m_watermark = reg.gauge(
            "tidb_tpu_hbm_watermark_bytes",
            "high-water of the ledger and the measured launch peaks")

    def launch_begin(self, nbytes: int) -> None:
        with self._mu:
            self.launches += 1
            if nbytes > 0:
                self.inflight_bytes += int(nbytes)
            if self.inflight_bytes > self.watermark_bytes:
                self.watermark_bytes = self.inflight_bytes
        self._publish()

    def launch_end(self, nbytes: int) -> None:
        with self._mu:
            if nbytes > 0:
                self.inflight_bytes -= int(nbytes)
                if self.inflight_bytes < 0:
                    self.negative_events += 1
                    self.inflight_bytes = 0
        self._publish()

    def note_measured(self, nbytes: int) -> None:
        """One launch's measured peak: feeds the watermark so it
        dominates every per-launch measurement by construction."""
        if nbytes <= 0:
            return
        with self._mu:
            self.measured_launches += 1
            self.last_measured_bytes = int(nbytes)
            self._measured_ring.append(int(nbytes))
            if nbytes > self.max_measured_bytes:
                self.max_measured_bytes = int(nbytes)
            if nbytes > self.watermark_bytes:
                self.watermark_bytes = int(nbytes)
        self._publish()

    def _publish(self) -> None:
        self._m_resident.set(self.inflight_bytes)
        self._m_watermark.set(self.watermark_bytes)

    def stats(self) -> dict:
        with self._mu:
            return {
                "inflight_bytes": self.inflight_bytes,
                "watermark_bytes": self.watermark_bytes,
                "max_measured_bytes": self.max_measured_bytes,
                "last_measured_bytes": self.last_measured_bytes,
                "launches": self.launches,
                "measured_launches": self.measured_launches,
                "negative_events": self.negative_events,
                "measured_recent": list(self._measured_ring)[-8:],
            }


# ------------------------------------------------------------------ #
# per-mesh registry (the scheduler_for discipline)
# ------------------------------------------------------------------ #

_LEDGERS: dict = {}
_LED_MU = threading.Lock()


def ledger_for(fingerprint) -> HbmLedger:
    """The (process-wide) ledger accounting one mesh's device memory,
    keyed by the mesh FINGERPRINT exactly like scheduler_for — every
    Domain over the same chips shares one account."""
    with _LED_MU:
        led = _LEDGERS.get(fingerprint)
        if led is None:
            led = _LEDGERS[fingerprint] = HbmLedger(fingerprint)
        return led


def all_ledgers() -> list:
    with _LED_MU:
        return list(_LEDGERS.values())


__all__ = ["HbmLedger", "ledger_for", "all_ledgers", "device_memory_stats",
           "MEASURED_RING"]

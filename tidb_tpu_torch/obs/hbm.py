# ported from tidb_tpu/obs/hbm.py @ 02e96d8
"""copgauge: the live device-memory ledger, its reconciliation with the
card's own memory counters, and the on-demand profiler capture.

Reference analog: the executor memory tracker tree of the reference
engine (util/memory Tracker feeding quota actions, PAPER.md) — per-query
memory is TRACKED while it is resident, not predicted once and
forgotten.  The per-device ledger (``ledger_for``) is credited with each
snapshot's resident tensors when they enter the snapshot cache
(``add_resident``, through ``analysis/lifetime.register_resident``, and
debited by the weakref's death callback), by the scheduler's drain at
launch admission (``launch_begin``: what the launch adds over its
resident inputs; a donating launch's priced peak already leaves out
its released inputs, so they are credited at dispatch), debited at
finish (``launch_end``) and fed each launch's measured peak
(``note_measured``: ``torch.cuda.max_memory_allocated`` around it, taken
by the scheduler).  ``reconcile`` compares the ledger with the card's
allocator at a bounded rate (``RECONCILE_MIN_S``), from the status
routes, never from the drain.  ``device_memory_stats`` is the one raw
device memory poll of the port (``torch.cuda.memory_stats`` and
``mem_get_info``); the admission budget (analysis/copcost
``mesh_hbm_budget``) derives from its ``bytes_limit``.  The CPU reports
none, and the ledger runs alone there.

The module also owns the ``/profile?ms=N`` capture gate (sysvar
``tidb_tpu_profile``): one ``torch.profiler`` capture at a time, CPU and
CUDA activities on the card, CPU alone on the CPU, exported as a Chrome
trace into the capture directory when its timer stops it.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from typing import Optional

# reconcile against the device's memory stats at most this often — the
# poll builds the allocator's stats and must NEVER ride the launch path
RECONCILE_MIN_S = 0.5
# recent per-launch measured peaks kept for the stats (bounded ring)
MEASURED_RING = 64
# /profile capture bounds (ms): a zero-length capture is useless, an
# unbounded one fills the disk with trace events
PROFILE_MIN_MS = 10
PROFILE_MAX_MS = 60_000
# the Chrome trace a capture exports into its directory
PROFILE_TRACE = "trace.json"


def device_memory_stats(devices) -> Optional[dict]:
    """Raw memory stats of the card behind ``devices`` (a tuple of torch
    devices), or None on the CPU, which reports nothing: ``bytes_limit``
    (the card's memory), ``bytes_free`` (``mem_get_info``), and the
    caching allocator's ``bytes_in_use``, ``peak_bytes_in_use`` and
    ``bytes_reserved`` (``memory_stats``)."""
    dev = devices[0] if devices else None
    if getattr(dev, "type", None) != "cuda":
        return None
    import torch
    free, total = torch.cuda.mem_get_info(dev)
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_limit": int(total), "bytes_free": int(free),
            "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0))}


class HbmLedger:
    """Live device-memory account of ONE device tuple (keyed by its
    fingerprint, like the scheduler registry): the snapshot residents
    (``add_resident``, debited by a weakref death callback), the bytes
    of the launches in flight (``launch_begin``/``launch_end``, the
    drain's static estimate of what a launch adds over its resident
    inputs) and the measured launch peaks (``note_measured``).  All
    mutation takes the leaf lock ``_mu``; the weakref death callback
    runs under it too.  Balances are clamped at zero with a ``negative_events``
    counter — bookkeeping drift surfaces as a diagnostic, never as a
    wedged account."""

    def __init__(self, fingerprint=None):
        self.fingerprint = fingerprint
        self._mu = threading.Lock()
        # id(weakref) -> (weakref, nbytes); the ref's death callback
        # debits the account.  Keyed by the REF's id, not the referent:
        # a weakref hashes through its referent, and a ref id can never
        # be recycled while the entry holds the ref alive.
        self._residents: dict = {}
        self.persistent_bytes = 0      # live snapshot-cache residents
        self.inflight_bytes = 0        # launches currently holding HBM
        self.watermark_bytes = 0       # high-water of resident + measured
        self.max_measured_bytes = 0    # largest per-launch measured peak
        self.last_measured_bytes = 0
        self.launches = 0              # launch_begin events (lifetime)
        self.measured_launches = 0     # launches with a measured peak
        self.registered = 0            # resident registrations (lifetime)
        self.unregistered = 0          # weakref deaths debited
        self.negative_events = 0       # clamped would-be-negative balances
        self._measured_ring: deque = deque(maxlen=MEASURED_RING)
        self._recon_ts = 0.0
        self._recon: Optional[dict] = None
        from ..utils.metrics import global_registry
        reg = global_registry()
        self._m_resident = reg.gauge(
            "tidb_tpu_hbm_resident_bytes",
            "ledger-tracked live device bytes (persistent residents "
            "+ in-flight launch footprints)")
        self._m_watermark = reg.gauge(
            "tidb_tpu_hbm_watermark_bytes",
            "high-water of ledger residency and measured launch peaks")

    # ---- persistent residents (the lifetime registry's events) ------ #

    def add_resident(self, token, nbytes: int) -> None:
        """One snapshot's device-resident tensors entered the cache:
        credit ``nbytes`` against a weakref on ``token`` (the counts
        tensor — the same registry token lifetime.register_resident
        uses) whose death callback debits the account."""
        if token is None or nbytes <= 0:
            return
        with self._mu:
            for r, _n in self._residents.values():
                if r() is token:
                    return          # same live object re-registered
            try:
                ref = weakref.ref(token, self._resident_dead)
            except TypeError:
                return
            self._residents[id(ref)] = (ref, int(nbytes))
            self.persistent_bytes += int(nbytes)
            self.registered += 1
            self._bump_watermark_locked()
        self._publish()

    def _resident_dead(self, ref) -> None:
        """Weakref death callback: the resident tensors were collected —
        the unregister half of the registry contract."""
        with self._mu:
            ent = self._residents.pop(id(ref), None)
            if ent is None:
                return
            self.persistent_bytes -= ent[1]
            self.unregistered += 1
            if self.persistent_bytes < 0:
                self.negative_events += 1
                self.persistent_bytes = 0
        self._publish()

    # ---- launch-scoped bytes (admission enter, finish leave) -------- #

    def launch_begin(self, nbytes: int) -> None:
        with self._mu:
            self.launches += 1
            if nbytes > 0:
                self.inflight_bytes += int(nbytes)
            self._bump_watermark_locked()
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

    def _bump_watermark_locked(self) -> None:
        live = self.persistent_bytes + self.inflight_bytes
        if live > self.watermark_bytes:
            self.watermark_bytes = live

    def _publish(self) -> None:
        self._m_resident.set(self.persistent_bytes + self.inflight_bytes)
        self._m_watermark.set(self.watermark_bytes)

    # ---- reconciliation (bounded poll, never the launch path) ------- #

    def reconcile(self, mesh, force: bool = False) -> Optional[dict]:
        """Compare the ledger against the card's own view where one
        exists.  Rate-limited to RECONCILE_MIN_S; called from status
        routes, NEVER from the drain.  Returns the last reconciliation
        record (None on the CPU).  The logical devices of ``mesh`` share
        one card, so its counters count once a physical device."""
        now = time.monotonic()
        with self._mu:
            due = force or (now - self._recon_ts >= RECONCILE_MIN_S)
            if due:
                self._recon_ts = now
        if due and mesh is not None:
            stats = device_memory_stats(mesh)
            if stats is not None:
                n_dev = len({(d.type, d.index) for d in mesh})
                in_use = stats["bytes_in_use"] * n_dev
                with self._mu:
                    live = self.persistent_bytes + self.inflight_bytes
                    self._recon = {
                        "device_bytes_in_use": in_use,
                        "ledger_bytes": live,
                        "drift_bytes": in_use - live,
                        "peak_bytes_in_use":
                            stats["peak_bytes_in_use"] * n_dev,
                        "bytes_limit": stats["bytes_limit"] * n_dev,
                    }
        with self._mu:
            return dict(self._recon) if self._recon is not None else None

    @property
    def resident_bytes(self) -> int:
        with self._mu:
            return self.persistent_bytes + self.inflight_bytes

    def residents(self) -> list:
        """[(nbytes, alive)] of tracked resident entries (diagnostics;
        dead entries cannot appear — the callback removed them)."""
        with self._mu:
            return [(n, r() is not None)
                    for r, n in self._residents.values()]

    def stats(self) -> dict:
        with self._mu:
            return {
                "persistent_bytes": self.persistent_bytes,
                "inflight_bytes": self.inflight_bytes,
                "resident_bytes": self.persistent_bytes
                + self.inflight_bytes,
                "residents": len(self._residents),
                "registered": self.registered,
                "unregistered": self.unregistered,
                "watermark_bytes": self.watermark_bytes,
                "max_measured_bytes": self.max_measured_bytes,
                "last_measured_bytes": self.last_measured_bytes,
                "launches": self.launches,
                "measured_launches": self.measured_launches,
                "negative_events": self.negative_events,
                "measured_recent": list(self._measured_ring)[-8:],
                "reconciled": self._recon,
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


def hbm_status() -> dict:
    """The ledger half of the ``/hbm`` status route."""
    leds = all_ledgers()
    return {
        "ledgers": [led.stats() for led in leds],
        "resident_bytes": sum(led.resident_bytes for led in leds),
        "watermark_bytes": max(
            (led.watermark_bytes for led in leds), default=0),
    }


# ------------------------------------------------------------------ #
# on-demand profiler capture (/profile?ms=N)
# ------------------------------------------------------------------ #

class ProfilerGate:
    """One-at-a-time ``torch.profiler`` capture.  ``start`` refuses
    while a capture is active (two profilers cannot run in one process);
    the capture runs on a thread of its own, which starts the profiler,
    holds it for ``ms`` and stops it, so start and stop share a thread.
    Stopping exports the Chrome trace (``PROFILE_TRACE``) into the
    capture directory; a failed stop still releases the gate."""

    def __init__(self):
        self._mu = threading.Lock()
        self.active = False
        self.dir = ""
        self.trace = ""
        self.captures = 0
        self.last_error = ""

    def start(self, ms: int, base_dir: str = "", cuda: bool = False) -> dict:
        """Start one capture of ``ms`` milliseconds into ``base_dir`` (a
        new temporary directory when empty); ``cuda`` records the card's
        activity beside the CPU's.  Answers ``started`` or ``refused``
        with the error."""
        ms = min(max(int(ms), PROFILE_MIN_MS), PROFILE_MAX_MS)
        with self._mu:
            if self.active:
                return {"refused": "a profiler capture is already "
                                   "active", "dir": self.dir}
            self.active = True
        try:
            import tempfile
            d = base_dir or tempfile.mkdtemp(prefix="tidb-tpu-profile-")
            os.makedirs(d, exist_ok=True)
        except OSError as e:
            return self._refuse(e)
        started = threading.Event()
        box: dict = {}
        t = threading.Thread(target=self._capture,
                             args=(ms, d, cuda, started, box),
                             name="profile-capture", daemon=True)
        t.start()
        started.wait()
        if "error" in box:
            return self._refuse(box["error"])
        with self._mu:
            self.dir = d
            self.trace = ""
            self.captures += 1
        return {"started": True, "dir": d, "ms": ms,
                "activities": box["activities"]}

    def _refuse(self, e: BaseException) -> dict:
        with self._mu:
            self.active = False
            self.last_error = f"{type(e).__name__}: {e}"
        return {"refused": f"profiler unavailable: {self.last_error}"}

    def _capture(self, ms: int, d: str, cuda: bool,
                 started: threading.Event, box: dict) -> None:
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 - capability probe: the
            # route answers `refused` with the error, never a 500
            box["error"] = e
            started.set()
            return
        box["activities"] = [a.name for a in acts]
        started.set()
        try:
            time.sleep(ms / 1000.0)
            prof.stop()
            path = os.path.join(d, PROFILE_TRACE)
            prof.export_chrome_trace(path)
            with self._mu:
                self.trace = path
        except Exception as e:  # noqa: BLE001 - a failed stop must
            # still release the gate or no capture could ever run again
            with self._mu:
                self.last_error = f"{type(e).__name__}: {e}"
        finally:
            with self._mu:
                self.active = False

    def stats(self) -> dict:
        with self._mu:
            return {"active": self.active, "dir": self.dir,
                    "trace": self.trace, "captures": self.captures,
                    "last_error": self.last_error}


_GATE: Optional[ProfilerGate] = None
_GATE_MU = threading.Lock()


def profiler_gate() -> ProfilerGate:
    global _GATE
    with _GATE_MU:
        if _GATE is None:
            _GATE = ProfilerGate()
        return _GATE


__all__ = ["HbmLedger", "ledger_for", "all_ledgers", "hbm_status",
           "device_memory_stats", "ProfilerGate", "profiler_gate",
           "RECONCILE_MIN_S", "MEASURED_RING", "PROFILE_TRACE"]

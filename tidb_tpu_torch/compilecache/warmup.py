# ported from tidb_tpu/compilecache/warmup.py @ 02e96d8
"""Boot-time warm replay of the manifest, before traffic.

A restarted server holding a populated cache directory replays every
manifest entry (MRU-first): an entry of this process's backend (torch,
card and kernel sources, analysis/compilekey ``backend_fingerprint``)
joins the program cache's capacity index, so the client's regrow and
paging loops enter at a capacity known to fit; an entry of another
backend is dropped.  The correction store's persisted payloads
(analysis/calibrate) are restored at the same time.  The replay runs OFF
the serving thread and THROUGH the admission queue at LOW priority
(weight 1.0, the resource-group LOW weight), as opaque tasks that never
coalesce or fuse, so a fat manifest can never starve live traffic.
"""

from __future__ import annotations

import threading

from .cache import compile_cache

# the warm replay's resource-group identity: weight 1.0 == PRIORITY LOW
# (rc/controller.PRIORITY_WEIGHTS), a distinct name so /sched shows it
WARM_GROUP = "copforge-warm"
WARM_WEIGHT = 1.0

# one replay per (process, cache_dir): reconfiguring to a new dir warms
# again, re-running a statement does not
_WARMED: set = set()
_WARM_MU = threading.Lock()


def warm_start(client=None, wait: bool = False) -> int:
    """Replay the manifest.  ``client`` (a CopClient) gives the backend
    and the admission queue; None = the CPU's backend, loaded inline.
    ``wait=True`` blocks until every entry replayed and returns how many
    were taken; otherwise a background thread replays and the count of
    entries scheduled comes back."""
    from ..analysis.calibrate import correction_store
    from ..analysis.compilekey import backend_fingerprint
    cache = compile_cache()
    m = cache.manifest
    if not cache.enable or m is None:
        return 0
    correction_store().sync_manifest()
    entries = [hx for hx, _meta in m.entries_mru()]
    if not entries:
        return 0
    devices = client.devices if client is not None else None
    backend = backend_fingerprint(devices)
    sched = client._scheduler() if client is not None else None

    def load_all() -> int:
        n = 0
        for hx in entries:
            if sched is None:
                n += bool(cache.load_warm(hx, backend))
                continue
            from ..sched import CopTask
            t = CopTask(fn=lambda hx=hx: cache.load_warm(hx, backend),
                        devices=devices, group=WARM_GROUP,
                        weight=WARM_WEIGHT)
            try:
                sched.submit(t)
                n += bool(t.wait())
            except Exception:   # noqa: BLE001 - a full queue skips that
                continue        # entry; the replay is best-effort
        return n

    if wait:
        return load_all()
    threading.Thread(target=load_all, name="copforge-warmup",
                     daemon=True).start()
    return len(entries)


def maybe_warm_start(client) -> None:
    """Idempotent boot hook (the session's sysvar plumbing calls it):
    the first statement after a cache directory is configured starts
    the background replay once per (process, dir)."""
    cache = compile_cache()
    if not cache.enable or not cache.cache_dir:
        return
    with _WARM_MU:
        if cache.cache_dir in _WARMED:
            return
        _WARMED.add(cache.cache_dir)
    warm_start(client)


def reset_warmed() -> None:
    """Test seam: forget which directories already replayed."""
    with _WARM_MU:
        _WARMED.clear()


def simulate_restart() -> None:
    """Restart-simulation seam: model a process death without exiting —
    drop every in-process program while the cache directory survives."""
    compile_cache().clear_pool()
    reset_warmed()


__all__ = ["warm_start", "maybe_warm_start", "reset_warmed",
           "simulate_restart", "WARM_GROUP", "WARM_WEIGHT"]

# ported from tidb_tpu/compilecache/cache.py @ 02e96d8
"""copforge: the program cache and its warm manifest.

The JAX package resolves every spmd program's executable through an AOT
compile cache: a warm-pool hit calls a held ``Compiled`` object, a disk
hit deserializes a persisted executable, a miss lowers and compiles.
On the card there is nothing to trace or compile per plan: a program is
a Python object over the hand-written kernels, which ``copr/cuda/
build.py`` builds once into ``_build/``.  So the port's "executable" is
the program object itself, and this cache memoizes program objects by
their restart-stable ``CompileKey`` (analysis/compilekey):

- ``resolve(key, build)`` returns the pooled program (a hit) or builds,
  pools and records it (a miss), with the JAX package's LRU bounded by
  pool bytes (``tidb_tpu_compile_warm_pool``; a program counts
  ``NOMINAL_PROGRAM_BYTES``, as the JAX package counts an executable its
  backend cannot serialize), its hit, miss and eviction counters, and
  the per-thread totals the scheduler's drain reads around a launch
  (``thread_snapshot``: a launch that built its program measured the
  build, not the program, and does not feed the calibration);
- with ``tidb_tpu_compile_cache_dir`` set, each miss is recorded in the
  directory's manifest (compilecache/manifest.py): the key parts and the
  capacity, by plan family; the correction store's payloads
  (analysis/calibrate) ride the same file.  ``warm_capacity`` reads the
  capacities back, also after a restart, and ``warm_start``
  (compilecache/warmup.py) replays the manifest;
- ``quarantine(digest)`` (the launch breaker opened on a program) purges
  the digest's manifest entries and corrections and refuses new records;
- with ``tidb_tpu_pd`` on and a cache directory, a miss claims its entry
  on the coordination store first (pd/registry), as the JAX package does
  before an AOT compile.

Serialized executables and CUDA-graph capture of a program are not part
of the port (ROADMAP.md, Queue 1 entry 10): a restarted process rebuilds
its program objects, which costs no compile.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from ..analysis.compilekey import CompileKey
from .manifest import DEFAULT_CAP_BYTES, WarmManifest

# pool accounting of one program object (it holds no device memory of
# its own: the kernels' libraries are shared)
NOMINAL_PROGRAM_BYTES = 64 << 10


class _Counters(threading.local):
    """Per-thread mirror of the build totals: the drain thread reads ITS
    OWN deltas around a launch, so other threads' resolves cannot
    pollute one launch's attribution."""

    def __init__(self):
        self.built_ns = 0
        self.misses = 0
        self.hits = 0


class CompileCache:
    """Process-wide program cache (one per process, like the metric
    registry): the pool is keyed by entry hex, so every caller over the
    same program shares one object."""

    def __init__(self):
        self.enable = os.environ.get(
            "TIDB_TPU_COMPILE_CACHE", "1") != "0"
        self.cache_dir = os.environ.get("TIDB_TPU_COMPILE_CACHE_DIR", "")
        self.pool_cap_bytes = DEFAULT_CAP_BYTES
        self._mu = threading.Lock()
        self._pool: OrderedDict[str, tuple] = OrderedDict()  # hex -> (prog, nbytes)
        self._pool_bytes = 0
        self._caps: dict[str, set] = {}    # family -> warm capacities
        self._quarantined: set = set()     # stable digests the breaker opened
        self._manifest: Optional[WarmManifest] = None
        self._tl = _Counters()
        self.hits = 0              # pool hits
        self.misses = 0            # programs built
        self.evictions = 0         # pool LRU evictions
        self.warm_loaded = 0       # manifest entries the warm replay took
        self.rejected = 0          # manifest entries of another backend
        self.build_ms_total = 0.0
        from ..utils.metrics import global_registry
        reg = global_registry()
        self._m_hits = reg.counter("tidb_tpu_compile_cache_hits",
                                   "program cache hits")
        self._m_miss = reg.counter("tidb_tpu_compile_cache_misses",
                                   "program cache misses (programs built)")
        self._m_bytes = reg.gauge("tidb_tpu_compile_cache_bytes",
                                  "program pool resident bytes")

    # ---- knobs (sysvars ride through the session's _exec_ctx) -------- #

    def configure(self, enable: Optional[bool] = None,
                  cache_dir: Optional[str] = None,
                  pool_bytes: Optional[int] = None) -> None:
        if enable is not None:
            self.enable = bool(enable)
        if cache_dir is not None and cache_dir != self.cache_dir:
            with self._mu:
                self.cache_dir = cache_dir
                self._manifest = None
        if pool_bytes is not None and pool_bytes >= 0:
            self.pool_cap_bytes = pool_bytes     # 0 = unbounded
            if self._manifest is not None:
                self._manifest.cap_bytes = self.pool_cap_bytes

    @property
    def manifest(self) -> Optional[WarmManifest]:
        if not self.cache_dir:
            return None
        with self._mu:
            if self._manifest is None:
                self._manifest = WarmManifest(self.cache_dir,
                                              self.pool_cap_bytes)
            return self._manifest

    # ---- attribution seam (the drain reads per-thread deltas) -------- #

    def thread_snapshot(self) -> tuple:
        t = self._tl
        return (t.built_ns, t.misses, t.hits)

    # ---- pool -------------------------------------------------------- #

    def _pool_put_locked(self, entry_hex: str, prog, nbytes: int) -> None:
        old = self._pool.pop(entry_hex, None)
        if old is not None:
            self._pool_bytes -= old[1]
        self._pool[entry_hex] = (prog, nbytes)
        self._pool_bytes += nbytes
        while self.pool_cap_bytes > 0 and \
                self._pool_bytes > self.pool_cap_bytes and \
                len(self._pool) > 1:
            _hx, (_prog, nb) = self._pool.popitem(last=False)
            self._pool_bytes -= nb
            self.evictions += 1
        self._m_bytes.set(self._pool_bytes)

    def _note_caps(self, key: CompileKey) -> None:
        if key.capacity:
            with self._mu:
                self._caps.setdefault(key.family, set()).add(key.capacity)

    def resolve(self, key: CompileKey, build: Callable[[], object]):
        """The program of ``key``: the pooled object, or ``build()``'s,
        pooled and recorded.  With the cache off, a fresh build."""
        if not self.enable:
            return build()
        entry_hex = key.entry_hex()
        with self._mu:
            hit = self._pool.get(entry_hex)
            if hit is not None:
                self._pool.move_to_end(entry_hex)
                self.hits += 1
                self._tl.hits += 1
        if hit is not None:
            self._m_hits.inc()
            return hit[0]
        # coplace (pd/registry): the cross-process build claim, where the
        # JAX package claims before its AOT compile — with a cache
        # directory only.  pd off or degraded => None and nothing
        # changes; a peer's live claim (False) is counted by the
        # registry and the port builds anyway: a build compiles nothing,
        # so waiting on the peer would only cost the statement
        claim = None
        if self.cache_dir:
            from ..pd import try_compile_claim
            claim = try_compile_claim(entry_hex)
        t0 = time.perf_counter_ns()
        try:
            prog = build()
        finally:
            if claim is True:
                from ..pd import release_compile_claim
                release_compile_claim(entry_hex)
        dt_ns = time.perf_counter_ns() - t0
        with self._mu:
            # a concurrent resolve of the same key may have won the race:
            # keep ITS object, so every caller shares one program
            won = self._pool.get(entry_hex)
            if won is not None:
                self._pool.move_to_end(entry_hex)
                self.hits += 1
                self._tl.hits += 1
                return won[0]
            self.misses += 1
            self.build_ms_total += dt_ns / 1e6
            self._tl.misses += 1
            self._tl.built_ns += dt_ns
            self._pool_put_locked(entry_hex, prog, NOMINAL_PROGRAM_BYTES)
            quarantined = key.digest in self._quarantined
        self._m_miss.inc()
        self._note_caps(key)
        m = self.manifest
        if m is not None:
            m.record(entry_hex, key.parts(), NOMINAL_PROGRAM_BYTES,
                     dt_ns / 1e6, quarantined=quarantined)
        return prog

    def warm_capacity(self, family: str, needed: int,
                      backend_fp: Optional[str] = None,
                      limit_factor: int = 4) -> Optional[int]:
        """Smallest warm capacity >= needed for this plan family, from the
        in-process pool and the manifest (its entries of ``backend_fp``,
        the caller's devices' fingerprint, when given):
        the regrow and paging loops round UP to a capacity whose program
        is already built.  Bounded: a warm buffer more than
        ``limit_factor`` x the need wastes more device memory than a
        build costs."""
        if not self.enable or needed <= 0:
            return None
        with self._mu:
            caps = set(self._caps.get(family, ()))
        m = self.manifest
        if m is not None:
            caps.update(m.capacities_for(family, backend_fp))
        good = [c for c in sorted(caps)
                if needed <= c <= needed * limit_factor]
        return good[0] if good else None

    # ---- quarantine (breaker -> manifest exclusion) ------------------ #

    def quarantine(self, digest: str) -> None:
        """The circuit breaker opened on this (stable) dag digest: purge
        its manifest entries and refuse new records, so a poisoned
        program cannot launder its quarantine through a restart's warm
        replay; its cost corrections (analysis/calibrate) drop too."""
        with self._mu:
            self._quarantined.add(digest)
        m = self.manifest
        if m is not None:
            m.purge_digest(digest)
        from ..analysis.calibrate import correction_store
        correction_store().purge(digest)

    def quarantine_report(self) -> dict:
        """Quarantined digests must have ZERO manifest presence."""
        with self._mu:
            quarantined = sorted(self._quarantined)
        m = self.manifest
        laundered = [d for d in quarantined
                     if m is not None and m.has_program(d)]
        return {"quarantined": len(quarantined),
                "laundered": len(laundered)}

    # ---- the warm replay --------------------------------------------- #

    def load_warm(self, entry_hex: str, backend_fp: str) -> bool:
        """Boot warm replay of ONE manifest entry: an entry of
        ``backend_fp`` (the replaying client's devices) joins the pool's
        capacity index (its program is rebuilt at first use, which
        compiles nothing); an entry of another
        backend (another torch, card or kernel source) is dropped from
        the manifest and counted in ``rejected``."""
        m = self.manifest
        meta = m.entry(entry_hex) if m is not None else None
        if meta is None:
            return False
        if meta.get("backend_fp") != backend_fp:
            m.drop(entry_hex)
            with self._mu:
                self.rejected += 1
            return False
        cap = int(meta.get("capacity", 0) or 0)
        with self._mu:
            if cap:
                self._caps.setdefault(meta.get("family", ""),
                                      set()).add(cap)
            self.warm_loaded += 1
        m.touch(entry_hex)
        return True

    def clear_pool(self) -> None:
        """Drop every in-process program (the restart seam: tests model a
        process death by clearing this; the manifest survives)."""
        with self._mu:
            self._pool.clear()
            self._pool_bytes = 0
            self._caps.clear()
            self._m_bytes.set(0)

    def stats(self) -> dict:
        with self._mu:
            out = {"enable": self.enable,
                   "cache_dir": self.cache_dir,
                   "pool_entries": len(self._pool),
                   "pool_bytes": self._pool_bytes,
                   "pool_cap_bytes": self.pool_cap_bytes,
                   "hits": self.hits, "misses": self.misses,
                   "warm_loaded": self.warm_loaded,
                   "rejected": self.rejected,
                   "evictions": self.evictions,
                   "build_ms": round(self.build_ms_total, 3)}
        m = self.manifest
        if m is not None:
            out["manifest"] = m.stats()
        return out


_CACHE: Optional[CompileCache] = None
_CACHE_MU = threading.Lock()


def compile_cache() -> CompileCache:
    global _CACHE
    with _CACHE_MU:
        if _CACHE is None:
            _CACHE = CompileCache()
        return _CACHE


def configure(enable=None, cache_dir=None, pool_bytes=None) -> None:
    compile_cache().configure(enable, cache_dir, pool_bytes)


__all__ = ["CompileCache", "compile_cache", "configure",
           "NOMINAL_PROGRAM_BYTES"]

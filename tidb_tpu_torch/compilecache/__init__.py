# ported from tidb_tpu/compilecache/__init__.py @ 02e96d8
"""copforge: the program cache and its warm manifest (cache.py): program
objects memoized by restart-stable variant keys, their key parts and
capacities persisted in a manifest that a restarted server replays
(warmup.py) through the admission queue at LOW priority."""

from .cache import CompileCache, compile_cache, configure
from .manifest import WarmManifest
from .warmup import (maybe_warm_start, reset_warmed, simulate_restart,
                     warm_start)

__all__ = ["CompileCache", "compile_cache", "configure", "WarmManifest",
           "warm_start", "maybe_warm_start", "reset_warmed",
           "simulate_restart"]

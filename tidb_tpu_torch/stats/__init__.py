# ported from tidb_tpu/stats/__init__.py @ 6298005
"""Statistics subsystem.

Reference analog: pkg/statistics/ (histogram.go:64 Histogram,
cmsketch.go:56/501 CMSketch+TopN, fmsketch.go:65 FMSketch) and
pkg/statistics/handle/ (load/save/cache, auto-analyze).  ANALYZE builds
every per-column statistic on the card (stats/build.py): one sort,
run-length encoding, grouped reductions and a TopN by sort, instead of
the reference's row-at-a-time sampling collectors.
"""

from .histogram import Histogram
from .sketch import CMSketch, FMSketch, TopN
from .handle import ColumnStats, StatsHandle, TableStats

__all__ = ["Histogram", "CMSketch", "FMSketch", "TopN", "ColumnStats",
           "TableStats", "StatsHandle"]

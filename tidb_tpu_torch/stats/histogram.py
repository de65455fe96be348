# ported from tidb_tpu/stats/histogram.py @ 6298005
"""Equal-depth histogram with range/point estimation.

Reference analog: pkg/statistics/histogram.go:64 (Histogram{Bounds,
Buckets[{Count,Repeat}]}) and pkg/planner/cardinality range estimation
(equalRowCount / betweenRowCount / outOfRangeRowCount).  Values live in the
column's order-preserving int64 encoding (see stats/build.py), so every
comparison here is plain integer compare regardless of SQL type.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Histogram:
    bounds: np.ndarray        # int64[n_buckets], upper bound of each bucket
    cum_counts: np.ndarray    # rows <= bounds[j] (cumulative)
    repeats: np.ndarray       # rows == bounds[j]
    ndv: int = 0
    null_count: int = 0
    min_val: int = None       # smallest value seen (lower bound of bucket 0)

    def __post_init__(self):
        # drop degenerate trailing buckets (empty table / few rows)
        keep = np.concatenate([[True], np.diff(self.cum_counts) > 0]) \
            if len(self.cum_counts) else np.array([], bool)
        self.bounds = self.bounds[keep]
        self.cum_counts = self.cum_counts[keep]
        self.repeats = self.repeats[keep]

    @property
    def total(self) -> int:
        return int(self.cum_counts[-1]) if len(self.cum_counts) else 0

    def _bucket_lo(self, j: int):
        """Inclusive lower value of bucket j (previous bound + 1)."""
        if j > 0:
            return int(self.bounds[j - 1]) + 1
        return int(self.min_val) if self.min_val is not None else None

    def less_row_count(self, v: int) -> float:
        """Estimated rows with value < v."""
        if not len(self.bounds) or self.total == 0:
            return 0.0
        j = int(np.searchsorted(self.bounds, v, side="left"))
        if j >= len(self.bounds):
            return float(self.total)
        lo_cum = int(self.cum_counts[j - 1]) if j > 0 else 0
        in_bucket = int(self.cum_counts[j]) - lo_cum
        ub, rep = int(self.bounds[j]), int(self.repeats[j])
        if v > ub:
            return float(self.cum_counts[j])
        if v == ub:
            return float(lo_cum + max(in_bucket - rep, 0))
        # linear interpolation inside the bucket body
        lo = self._bucket_lo(j)
        lo = lo if lo is not None else ub - 1
        width = max(ub - lo, 1)
        frac = min(max((v - lo) / width, 0.0), 1.0)
        return lo_cum + frac * max(in_bucket - rep, 0)

    def equal_row_count(self, v: int) -> float:
        if not len(self.bounds) or self.total == 0:
            return 0.0
        j = int(np.searchsorted(self.bounds, v, side="left"))
        if j >= len(self.bounds):
            return 0.0          # out of range
        if v == int(self.bounds[j]):
            return float(self.repeats[j])
        lo0 = self._bucket_lo(0)
        if j == 0 and lo0 is not None and v < lo0:
            return 0.0          # below the histogram's min value
        # in-bucket non-bound value: bucket_ndv-weighted average
        lo_cum = int(self.cum_counts[j - 1]) if j > 0 else 0
        in_bucket = int(self.cum_counts[j]) - lo_cum
        per_val = self.total / max(self.ndv, 1)
        return float(min(per_val, in_bucket))

    def range_row_count(self, low, low_incl: bool, high, high_incl: bool) -> float:
        """Estimated rows in the interval; None bound = unbounded."""
        hi = (self.less_row_count(high) + (self.equal_row_count(high)
              if high_incl else 0.0)) if high is not None else float(self.total)
        lo = (self.less_row_count(low) + (0.0 if low_incl
              else self.equal_row_count(low))) if low is not None else 0.0
        return max(hi - lo, 0.0)

# ported from tidb_tpu/stats/sketch.py @ 6298005
"""CM sketch, TopN, and KMV (FM-analog) NDV sketch.

Reference analog: pkg/statistics/cmsketch.go:56 (CMSketch), :501 (TopN),
fmsketch.go:65 (FMSketch).  The device kernel (stats/build.py) emits the
raw counter tables / minimum-hash sets; these classes wrap estimation and
cross-shard merge (merge = elementwise add / merged k-minimum — both are
`psum`-shaped reductions, so shard-parallel ANALYZE composes over the mesh
exactly like partial aggregation, SURVEY.md §2.10 P2).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .build import CM_DEPTH, CM_WIDTH, FM_MAPS


def _host_hash64(x: np.ndarray, seed: int) -> np.ndarray:
    h = (x.astype(np.uint64) + np.uint64(seed)) * np.uint64(0x9E3779B97F4A7C15)
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


@dataclass
class TopN:
    """Most-frequent values (encoded domain) -> exact counts."""
    values: dict[int, int] = field(default_factory=dict)

    def count_of(self, v: int):
        return self.values.get(int(v))

    def merge(self, other: "TopN") -> "TopN":
        out = dict(self.values)
        for v, c in other.values.items():
            out[v] = out.get(v, 0) + c
        top = sorted(out.items(), key=lambda kv: -kv[1])[:max(len(self.values),
                                                              len(other.values))]
        return TopN(dict(top))


@dataclass
class CMSketch:
    table: np.ndarray         # int64[CM_DEPTH, CM_WIDTH]

    def query(self, v: int) -> int:
        x = np.array([v], dtype=np.int64)
        est = None
        for d in range(CM_DEPTH):
            idx = int(_host_hash64(x, 0xABCD + d * 7919)[0] % CM_WIDTH)
            c = int(self.table[d, idx])
            est = c if est is None else min(est, c)
        return est or 0

    def merge(self, other: "CMSketch") -> "CMSketch":
        return CMSketch(self.table + other.table)


@dataclass
class FMSketch:
    """K-minimum-values NDV sketch over 64-bit hashes (mergeable)."""
    kmv: np.ndarray           # uint64[<=FM_MAPS], sorted ascending

    def ndv(self) -> int:
        k = len(self.kmv)
        if k == 0:
            return 0
        mx = np.uint64(0xFFFFFFFFFFFFFFFF)
        vals = self.kmv[self.kmv < mx]
        if len(vals) < FM_MAPS:
            return int(len(np.unique(vals)))   # saw everything
        kth = float(vals[-1]) / float(mx)
        return int((len(vals) - 1) / kth) if kth > 0 else len(vals)

    def merge(self, other: "FMSketch") -> "FMSketch":
        merged = np.unique(np.concatenate([self.kmv, other.kmv]))
        return FMSketch(merged[:FM_MAPS])

# ported from tidb_tpu/stats/handle.py @ 6298005
"""Stats handle: build, cache, and serve per-table statistics.

Reference analog: pkg/statistics/handle/ — stats cache keyed by table id,
modify-count tracking feeding auto-analyze (autoanalyze.go), and the
ANALYZE executor (pkg/executor/analyze*.go).  Build runs on the
handle's device (stats/build.py, ``device`` "cuda" unless the caller
asks for "cpu"); estimation is host-side pure math.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..chunk.column import Column
from ..types import dtypes as dt
from .build import build_column_stats, sortable_f64
from .histogram import Histogram
from .sketch import CMSketch, FMSketch, TopN

K = dt.TypeKind


def encode_value(col_type: dt.DataType, v, dictionary=None) -> Optional[int]:
    """Encode a python constant into the column's order-preserving int64
    domain (the same encoding stats/build.py applied to the data)."""
    if v is None:
        return None
    if col_type.kind == K.FLOAT64:
        return int(sortable_f64(np.array([float(v)], dtype=np.float64))[0])
    if col_type.kind == K.STRING:
        if dictionary is None:
            return None
        if isinstance(v, str):
            c = dictionary.code_of(v)
            return c if c >= 0 else dictionary.lower_bound(v)
        return int(v)
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


@dataclass
class ColumnStats:
    name: str
    hist: Histogram
    topn: TopN
    cms: CMSketch
    fms: FMSketch
    ndv: int
    null_count: int
    count: int

    def equal_rows(self, enc: int) -> float:
        c = self.topn.count_of(enc)
        if c is not None:
            return float(c)
        return self.hist.equal_row_count(enc)

    def range_rows(self, low, low_incl, high, high_incl) -> float:
        return self.hist.range_row_count(low, low_incl, high, high_incl)


@dataclass
class TableStats:
    table_id: int
    version: int               # analyze timestamp (ns)
    count: int                 # rows at analyze time
    delta_count: int = 0       # net row delta since analyze (+ins, -del)
    modify_count: int = 0      # total DML churn since analyze
    cols: dict = field(default_factory=dict)   # name(lower) -> ColumnStats

    @property
    def realtime_count(self) -> int:
        return max(self.count + self.delta_count, 0)

    def col(self, name: str) -> Optional[ColumnStats]:
        return self.cols.get(name.lower())


class StatsHandle:
    """Per-Domain stats cache (pkg/statistics/handle Handle analog)."""

    AUTO_ANALYZE_RATIO = 0.5       # tidb_auto_analyze_ratio default
    AUTO_ANALYZE_MIN_COUNT = 1000  # reference: autoAnalyzeMinCnt
    # above this row count ANALYZE samples instead of full-scanning
    # (reference: row_sampler.go ReservoirRowSampleCollector)
    SAMPLE_THRESHOLD = 2_000_000
    SAMPLE_TARGET = 200_000

    def __init__(self, device="cuda"):
        # the device the ANALYZE kernel runs on (the Domain's card)
        self.device = device
        self._cache: dict[int, TableStats] = {}
        self._lock = threading.Lock()
        self.auto_analyze_enabled = True
        # predicate-column tracking (tidb_enable_column_tracking /
        # column_stats_usage): which columns queries actually filter on
        self._pred_cols: dict[int, set] = {}
        # async stats load (handle/syncload analog): tables whose first
        # plan found no stats get analyzed in the background
        self._loading: set = set()

    # ------------------------------------------------------------ #

    @staticmethod
    def _key(table):
        # tables built outside the catalog (register_columns test path)
        # share table_id 0; fall back to object identity so they don't
        # collide in the cache
        return getattr(table, "table_id", 0) or id(table)

    def get(self, table) -> Optional[TableStats]:
        return self._cache.get(self._key(table))

    def note_modify(self, table, churn: int, delta: int | None = None):
        """Record DML: churn = rows touched; delta = net row-count change
        (defaults to +churn, i.e. INSERT; DELETE passes -n, UPDATE 0)."""
        ts = self.get(table)
        if ts is not None:
            ts.modify_count += int(churn)
            ts.delta_count += int(churn if delta is None else delta)

    def needs_auto_analyze(self, table) -> bool:
        if not self.auto_analyze_enabled:
            return False
        ts = self.get(table)
        n = table.num_rows
        if ts is None:
            return n >= self.AUTO_ANALYZE_MIN_COUNT
        if ts.realtime_count < self.AUTO_ANALYZE_MIN_COUNT:
            return False
        return abs(ts.modify_count) > self.AUTO_ANALYZE_RATIO * max(ts.count, 1)

    # ------------------------------------------------------------ #

    # -- predicate-column tracking + async load --------------------- #

    def note_predicate_columns(self, table, names) -> None:
        """Record columns that appeared in query predicates; ANALYZE
        TABLE ... PREDICATE COLUMNS restricts collection to this set
        (reference: column_stats_usage.go)."""
        if not names:
            return
        with self._lock:
            self._pred_cols.setdefault(self._key(table), set()).update(
                n.lower() for n in names)

    def predicate_columns(self, table) -> set:
        return set(self._pred_cols.get(self._key(table), ()))

    def request_load(self, table) -> bool:
        """Async stats load (handle/syncload analog): schedule a
        background ANALYZE for a planned-against table with no stats;
        the current plan proceeds on defaults.  Returns True if
        scheduled."""
        if not self.auto_analyze_enabled:
            return False
        key = self._key(table)
        with self._lock:
            if key in self._cache or key in self._loading:
                return False
            if getattr(table, "num_rows", 0) < self.AUTO_ANALYZE_MIN_COUNT:
                return False
            self._loading.add(key)

        def run():
            try:
                self.analyze_table(table)
            except Exception:
                pass
            finally:
                with self._lock:
                    self._loading.discard(key)

        threading.Thread(target=run, name="stats-async-load",
                         daemon=True).start()
        return True

    # ------------------------------------------------------------ #

    def analyze_table(self, table, n_buckets: int = 64,
                      n_top: int = 16, columns=None,
                      sample_rate: Optional[float] = None,
                      predicate_only: bool = False) -> TableStats:
        """ANALYZE TABLE: device-build stats for every analyzable column.

        Large tables sample (systematic row sample, scaled estimates with
        the Duj1 NDV estimator — row_sampler.go's role); `columns`
        restricts collection; `predicate_only` restricts to the tracked
        predicate columns (ANALYZE ... PREDICATE COLUMNS)."""
        snap = table.snapshot()
        cols = snap.columns
        n = len(cols[0]) if cols else 0
        want = None
        if predicate_only:
            want = self.predicate_columns(table)
            if not want and not columns:
                # nothing tracked yet: keep whatever stats exist (TiDB
                # analyzes nothing rather than erasing)
                return self.get(table) or TableStats(
                    table_id=self._key(table), version=time.time_ns(),
                    count=n)
        if columns:
            want = {c.lower() for c in columns} | (want or set())
        if sample_rate is None and n > self.SAMPLE_THRESHOLD:
            sample_rate = self.SAMPLE_TARGET / n
        idx = None
        scale = 1.0
        if n and sample_rate is not None and 0 < sample_rate < 1.0:
            m = max(int(n * sample_rate), 1)
            step = max(n // m, 1)
            rng = np.random.default_rng(n)
            idx = (np.arange(m) * step
                   + rng.integers(0, step, m)).clip(0, n - 1)
            scale = n / m
        ts = TableStats(table_id=self._key(table),
                        version=time.time_ns(), count=n)
        if want is not None:
            # column-restricted analyze MERGES into existing stats
            # (TiDB keeps unlisted columns' histograms)
            prev = self.get(table)
            if prev is not None:
                ts.cols.update(prev.cols)
        for name, col in zip(table.col_names, cols):
            if want is not None and name.lower() not in want:
                continue
            c = col.take(idx) if idx is not None else col
            cs = self._analyze_column(name, c, n_buckets, n_top,
                                      scale=scale)
            if cs is not None:
                ts.cols[name.lower()] = cs
        with self._lock:
            self._cache[ts.table_id] = ts
        # valueflow runtime half: stamp this ANALYZE's observed per-column
        # min/max watermarks so every subsequent launch can check its
        # plan's declared value intervals still contain reality (drift is
        # surfaced on /sched, never a wrong result)
        from ..analysis import valueflow
        valueflow.stamp_watermarks(ts)
        return ts

    def _analyze_column(self, name: str, col: Column, n_buckets: int,
                        n_top: int,
                        scale: float = 1.0) -> Optional[ColumnStats]:
        if len(col) == 0:
            empty = Histogram(np.array([], np.int64), np.array([], np.int64),
                              np.array([], np.int64))
            return ColumnStats(name, empty, TopN(),
                               CMSketch(np.zeros((4, 2048), np.int64)),
                               FMSketch(np.array([], np.uint64)),
                               0, 0, 0)
        raw = build_column_stats(col.data, col.validity, n_buckets, n_top,
                                 device=self.device)
        ndv = int(raw["ndv"])
        if scale > 1.0:
            # sampled build: scale counts, estimate full-table NDV with
            # the Duj1 estimator d / (1 - (1-q) f1/n) from the singleton
            # count (statistics/row_sampler.go calculateEstimateNDV)
            vals = col.data[col.validity]
            n_s = len(vals)
            if n_s:
                _u, cnts = np.unique(vals, return_counts=True)
                f1 = int((cnts == 1).sum())
                denom = 1.0 - (1.0 - 1.0 / scale) * f1 / n_s
                est = ndv / max(denom, 1e-3)
                ndv = int(round(min(max(est, ndv),
                                    int(raw["count"]) * scale)))
            raw = dict(raw)
            for k in ("cum_counts", "repeats", "top_counts", "cm"):
                raw[k] = np.round(raw[k] * scale).astype(np.int64)
            raw["count"] = np.int64(round(int(raw["count"]) * scale))
            raw["null_count"] = np.int64(
                round(int(raw["null_count"]) * scale))
        hist = Histogram(raw["bounds"], raw["cum_counts"], raw["repeats"],
                         ndv=ndv, null_count=int(raw["null_count"]),
                         min_val=(int(raw["min_val"])
                                  if int(raw["count"]) else None))
        # keep only TopN entries that are genuinely frequent (count > 1
        # and above the uniform expectation), like cmsketch.go TopN pruning
        tv, tc = raw["top_vals"], raw["top_counts"]
        uniform = max(int(raw["count"]) / max(ndv, 1), 1.0)
        topn = TopN({int(v): int(c) for v, c in zip(tv, tc)
                     if c > 0 and c >= uniform})
        return ColumnStats(name=name, hist=hist, topn=topn,
                           cms=CMSketch(raw["cm"]),
                           fms=FMSketch(raw["kmv"].astype(np.uint64)),
                           ndv=ndv, null_count=int(raw["null_count"]),
                           count=int(raw["count"]))

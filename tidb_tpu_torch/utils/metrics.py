# ported from tidb_tpu/utils/metrics.py @ 6233200
"""Metrics registry: counters, gauges, histograms + Prometheus text.

Reference analog: pkg/metrics (metrics.go RegisterMetrics; per-subsystem
counter/histogram vectors scraped from the status port).  A tiny
label-aware registry; updates take a per-metric lock (connection threads
bump concurrently — read-modify-write is not GIL-atomic).
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence


class Counter:
    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.values: dict[tuple, float] = {}
        self._mu = threading.Lock()

    def inc(self, n: float = 1, **labels):
        key = tuple(labels.get(ln, "") for ln in self.label_names)
        with self._mu:
            self.values[key] = self.values.get(key, 0) + n

    def get(self, **labels) -> float:
        key = tuple(labels.get(ln, "") for ln in self.label_names)
        return self.values.get(key, 0)


class Gauge(Counter):
    def set(self, v: float, **labels):
        key = tuple(labels.get(ln, "") for ln in self.label_names)
        with self._mu:
            self.values[key] = v

    def dec(self, n: float = 1, **labels):
        self.inc(-n, **labels)


class _HistSeries:
    """One (label-set) series of a Histogram: bucket counts + sum."""

    __slots__ = ("counts", "total", "n")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)
        self.total = 0.0
        self.n = 0


class Histogram:
    """Label-aware prometheus-text histogram (copscope ISSUE 13 grew
    labels + millisecond buckets + interpolated quantiles so the sched
    latency histograms — ``tidb_tpu_sched_{wait,launch,compile}_ms``
    and the per-strategy agg launch histogram — replace the ad-hoc
    p50/p99 rings in bench/status surfaces)."""

    DEFAULT_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5,
                       10, 60)
    # millisecond-scale latency buckets for the *_ms histograms: queue
    # waits sit in the 0.01-10ms band on a warm process, launches in the
    # 1-500ms band, compiles in the 100ms-10s band
    MS_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50,
                  100, 250, 500, 1000, 2500, 5000, 10000)

    def __init__(self, name: str, help_: str,
                 buckets: Optional[Sequence[float]] = None,
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self.label_names = tuple(label_names)
        self._series: dict[tuple, _HistSeries] = {}
        self._mu = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        return tuple(labels.get(ln, "") for ln in self.label_names)

    def observe(self, v: float, **labels):
        key = self._key(labels)
        with self._mu:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            s.counts[bisect.bisect_left(self.buckets, v)] += 1
            s.total += v
            s.n += 1

    # -- back-compat views over the unlabeled (or merged) series ------ #

    def _merged(self) -> _HistSeries:
        out = _HistSeries(len(self.buckets))
        with self._mu:
            for s in self._series.values():
                for i, c in enumerate(s.counts):
                    out.counts[i] += c
                out.total += s.total
                out.n += s.n
        return out

    @property
    def counts(self) -> list:
        return self._merged().counts

    @property
    def total(self) -> float:
        return self._merged().total

    @property
    def n(self) -> int:
        return self._merged().n

    def quantile(self, q: float, **labels) -> float:
        """Quantile estimate, linearly interpolated WITHIN the landing
        bucket (the old estimator snapped to bucket upper bounds, which
        made p50 of a tight distribution report the whole bucket).
        Without labels, merges every series."""
        if self.label_names and labels:
            with self._mu:
                s = self._series.get(self._key(labels))
            if s is None:
                return 0.0
            counts, n = list(s.counts), s.n
        else:
            m = self._merged()
            counts, n = m.counts, m.n
        if n == 0:
            return 0.0
        target = q * n
        acc = 0
        for i, c in enumerate(counts[:-1]):
            if acc + c >= target and c > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (target - acc) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            acc += c
        return self.buckets[-1]

    def series_items(self) -> list:
        """[(label_key_tuple, counts, total, n)] snapshot for render."""
        with self._mu:
            return [(key, list(s.counts), s.total, s.n)
                    for key, s in sorted(self._series.items())]


def escape_label(v) -> str:
    """Prometheus exposition-format label-value escaping: backslash,
    double quote, and newline MUST be escaped (in that order — the
    backslash first, or the other escapes double up) or the scrape
    line is invalid.  A program digest or strategy label containing
    ``"`` / ``\\`` previously emitted a broken exposition line."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self.metrics: dict[str, object] = {}

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_, labels))

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_, labels))

    def histogram(self, name: str, help_: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  labels: Sequence[str] = ()) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, help_, buckets, labels))

    def _get_or_make(self, name, make):
        with self._lock:
            m = self.metrics.get(name)
            if m is None:
                m = self.metrics[name] = make()
            return m

    def prometheus_text(self) -> str:
        out = []
        for name in sorted(self.metrics):
            m = self.metrics[name]
            if isinstance(m, Histogram):
                out.append(f"# TYPE {name} histogram")
                series = m.series_items()
                if not series:
                    series = [((), [0] * (len(m.buckets) + 1), 0.0, 0)]
                for key, counts, total, n in series:
                    base = ",".join(f'{ln}="{escape_label(kv)}"'
                                    for ln, kv
                                    in zip(m.label_names, key))
                    sep = "," if base else ""
                    acc = 0
                    for ub, c in zip(m.buckets, counts):
                        acc += c
                        out.append(f'{name}_bucket{{{base}{sep}le="{ub}"}}'
                                   f' {acc}')
                    out.append(f'{name}_bucket{{{base}{sep}le="+Inf"}} {n}')
                    lbl = f"{{{base}}}" if base else ""
                    out.append(f"{name}_sum{lbl} {total}")
                    out.append(f"{name}_count{lbl} {n}")
            else:
                kind = "gauge" if isinstance(m, Gauge) else "counter"
                out.append(f"# TYPE {name} {kind}")
                with m._mu:
                    values = dict(m.values)
                if not values:
                    out.append(f"{name} 0")
                for key, v in sorted(values.items()):
                    if m.label_names:
                        lbl = ",".join(f'{ln}="{escape_label(kv)}"'
                                       for ln, kv
                                       in zip(m.label_names, key))
                        out.append(f"{name}{{{lbl}}} {v}")
                    else:
                        out.append(f"{name} {v}")
        return "\n".join(out) + "\n"


_global: Optional[Registry] = None


def global_registry() -> Registry:
    global _global
    if _global is None:
        _global = Registry()
    return _global


__all__ = ["Registry", "Counter", "Gauge", "Histogram",
           "global_registry", "escape_label"]

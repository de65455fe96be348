# ported from tidb_tpu/planner/cascades/cost.py @ 1da0078
"""Cost model for the memo search.

Reference analog: pkg/planner/core/plan_cost_ver2.go — per-operator cost
formulas in abstract "row units", weighted so the *relative* choices the
search makes (hash vs merge vs index-lookup join, sort enforcer vs
order-providing child, DP join orders) match what the executors actually
measure on this engine.  Absolute values are meaningless by design, as in
the reference.
"""

from __future__ import annotations

import math

# per-row weights
HOST_ROW = 1.0          # host scan/filter/projection per row
DEV_ROW = 0.25          # device-fused per row (XLA fusion amortizes ops)
DEV_DISPATCH = 20_000.0  # fixed per-program dispatch+transfer overhead
BUILD_ROW = 1.8         # hash-table build per row
PROBE_ROW = 1.0         # hash probe per row
MERGE_ROW = 0.6         # sorted-merge advance per row
SORT_ROW = 0.45         # comparison-sort per row per log2(n)
LOOKUP_ROW = 14.0       # index lookup per probe row per log2(inner)
AGG_ROW = 1.4           # group-hash update per row
OUT_ROW = 0.3           # materializing one output row
TOPN_ROW = 0.8          # heap push per row


def log2(n: float) -> float:
    return math.log2(max(n, 2.0))


def scan_cost(rows: float, device_ok: bool) -> float:
    if device_ok:
        return DEV_DISPATCH + rows * DEV_ROW
    return rows * HOST_ROW


def sort_cost(rows: float) -> float:
    return rows * SORT_ROW * log2(rows)


def hash_join_cost(l_rows: float, r_rows: float, out_rows: float) -> float:
    return r_rows * BUILD_ROW + l_rows * PROBE_ROW + out_rows * OUT_ROW


def merge_join_cost(l_rows: float, r_rows: float, out_rows: float) -> float:
    return (sort_cost(l_rows) + sort_cost(r_rows)
            + (l_rows + r_rows) * MERGE_ROW + out_rows * OUT_ROW)


def inl_join_cost(outer_rows: float, inner_rows: float,
                  out_rows: float) -> float:
    return outer_rows * LOOKUP_ROW * log2(inner_rows) + out_rows * OUT_ROW


def agg_cost(in_rows: float, groups: float) -> float:
    return in_rows * AGG_ROW + groups * OUT_ROW


def topn_cost(in_rows: float, k: float) -> float:
    return in_rows * TOPN_ROW * log2(k)


__all__ = ["scan_cost", "sort_cost", "hash_join_cost", "merge_join_cost",
           "inl_join_cost", "agg_cost", "topn_cost", "log2"]

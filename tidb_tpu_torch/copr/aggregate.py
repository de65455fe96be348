# ported from tidb_tpu/copr/aggregate.py @ a9e9482
"""Aggregation partial-state merge + finalize (host side, numpy).

SCALAR/DENSE states arrive merged across the devices (parallel/spmd.py);
``merge_states`` folds per-shard state dicts with sums in object ints,
so (hi, lo) limb totals recombine exactly past int64, and ``finalize``
drops empty dense groups and decodes the mixed-radix group id back into
key columns.

Per-device group tables of the high-NDV strategies merge here too
(``merge_sorted_states``): each table is trimmed to its observed group
count, the tables are concatenated and re-grouped by true key equality
(``np.unique``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..chunk.column import Column, StringDict
from ..types import dtypes as dt
from . import dag as D

K = dt.TypeKind


@dataclass
class GroupKeyMeta:
    """How to decode one group key back into values."""
    dtype: dt.DataType
    size: int                      # dense domain size incl. the NULL slot
                                   # if nullable; 0 for high-NDV keys
    dictionary: Optional[StringDict] = None


_MERGE = {
    "count": "sum", "sum": "sum", "hi": "sum", "lo": "sum", "cnt": "sum",
    "min": "min", "max": "max", "__rows__": "sum",
}


def merge_field(name: str, a, b):
    how = _MERGE[name]
    if how == "sum":
        return a + b
    return np.minimum(a, b) if how == "min" else np.maximum(a, b)


def merge_states(states_list: Sequence[dict]) -> dict:
    """Merge per-shard partial states.  Sums are merged in object dtype
    so limb totals can't overflow int64 across many shards."""
    def promote(name, arr):
        arr = np.asarray(arr)
        if _MERGE[name] == "sum" and arr.dtype == np.int64:
            return arr.astype(object)
        return arr

    out: dict = {}
    for st in states_list:
        for key, val in st.items():
            if isinstance(val, dict):
                tgt = out.setdefault(key, {})
                for f, arr in val.items():
                    arr = promote(f, arr)
                    tgt[f] = arr if f not in tgt \
                        else merge_field(f, tgt[f], arr)
            else:
                arr = promote(key, val)
                out[key] = arr if key not in out \
                    else merge_field(key, out[key], arr)
    return out


def _np_key_code(val: np.ndarray, valid: np.ndarray,
                 dtype: dt.DataType) -> np.ndarray:
    """Bit-stable int64 representation of group-key values for host-side
    equality grouping: floats through the order-preserving bitcast, so
    NaN groups with NaN and -0.0 with +0.0 (SQL equality); uint64 on its
    bits; NULLs zeroed (the null flag column disambiguates)."""
    v = np.asarray(val)
    if dtype.is_float:
        f = v.astype(np.float64)
        f = np.where(f == 0, 0.0, f)
        b = np.ascontiguousarray(f).view(np.int64)
        c = np.where(b < 0, -(b + 1) + (-2 ** 63), b)
    else:
        c = v.astype(np.int64)
    return np.where(np.asarray(valid), c, 0)


def merge_sorted_states(agg: D.Aggregation,
                        per_dev: Sequence[dict]) -> dict:
    """Merge per-device group tables: trim each to its live group count,
    concatenate, and re-group by key equality (np.unique).  Sums merge in
    object ints (exact)."""
    k = len(agg.group_by)
    tables: list[dict] = []
    for st in per_dev:
        g = int(st["__ngroups__"])
        trimmed = {name: {f: np.asarray(a)[:g] for f, a in v.items()}
                   if isinstance(v, dict) else np.asarray(v)[:g]
                   for name, v in st.items() if name != "__ngroups__"}
        tables.append(trimmed)

    def cat(path):
        parts = []
        for t in tables:
            v = t
            for p in path:
                v = v[p]
            parts.append(v)
        return np.concatenate(parts) if parts else np.empty(0)

    mat = np.empty((len(cat(("__rows__",))), 2 * k), np.int64)
    key_vals, key_valids = [], []
    for j, e in enumerate(agg.group_by):
        val = cat((f"k{j}", "val"))
        valid = cat((f"k{j}", "valid")).astype(bool)
        key_vals.append(val)
        key_valids.append(valid)
        mat[:, 2 * j] = (~valid).astype(np.int64)
        mat[:, 2 * j + 1] = _np_key_code(val, valid, e.dtype)

    uniq, first_idx, inv = np.unique(mat, axis=0, return_index=True,
                                     return_inverse=True)
    inv = inv.reshape(-1)
    ng = len(uniq)

    def regroup(name, arr):
        how = _MERGE[name]
        arr = np.asarray(arr)
        if how == "sum":
            if arr.dtype == np.int64:
                arr = arr.astype(object)  # exact limb/count merge
            out = np.zeros(ng, dtype=arr.dtype)
            np.add.at(out, inv, arr)
            return out
        if arr.dtype.kind == "f":
            sentinel = np.inf if how == "min" else -np.inf
        else:
            info = np.iinfo(arr.dtype)  # sentinel in the array's dtype
            sentinel = info.max if how == "min" else info.min
        init = np.full(ng, sentinel, arr.dtype)
        (np.minimum if how == "min" else np.maximum).at(init, inv, arr)
        return init

    merged: dict = {"__rows__": regroup("__rows__", cat(("__rows__",)))}
    for j in range(k):
        merged[f"k{j}"] = {"val": key_vals[j][first_idx],
                           "valid": key_valids[j][first_idx]}
    for i in range(len(agg.aggs)):
        name = f"a{i}"
        merged[name] = {f: regroup(f, cat((name, f)))
                        for f in tables[0][name]} if tables else {}
    return merged


def finalize_sorted(agg: D.Aggregation, merged: dict,
                    key_meta: Sequence[GroupKeyMeta]
                    ) -> tuple[list[Column], list[Column]]:
    """(group_key_columns, agg_value_columns) of merged group tables."""
    key_cols = []
    for j, m in enumerate(key_meta):
        val = merged[f"k{j}"]["val"]
        valid = merged[f"k{j}"]["valid"]
        npdt = m.dtype.np_dtype()
        data = (np.array([int(x) for x in val], dtype=object)
                if npdt == object else val.astype(npdt))
        key_cols.append(Column(m.dtype, data, valid, m.dictionary))
    agg_cols = [_finalize_one(a, merged[f"a{i}"])
                for i, a in enumerate(agg.aggs)]
    return key_cols, agg_cols


def finalize(agg: D.Aggregation, merged: dict,
             key_meta: Sequence[GroupKeyMeta]
             ) -> tuple[list[Column], list[Column]]:
    """Turn merged SCALAR/DENSE states into (group_key_columns,
    agg_value_columns), dropping empty dense groups (occupancy 0)."""
    rows = np.asarray(merged["__rows__"])
    if agg.strategy == D.GroupStrategy.SCALAR:
        live = np.array([0])  # single pseudo-group; SQL returns 1 row
        rows = rows.reshape(1)
    else:
        live = np.nonzero(rows > 0)[0]

    key_cols = _decode_group_keys(live, key_meta) \
        if agg.strategy == D.GroupStrategy.DENSE else []

    agg_cols: list[Column] = []
    for i, a in enumerate(agg.aggs):
        st = {f: np.asarray(v).reshape(-1)[live]
              for f, v in merged[f"a{i}"].items()}
        agg_cols.append(_finalize_one(a, st))
    return key_cols, agg_cols


def _decode_group_keys(live: np.ndarray,
                       key_meta: Sequence[GroupKeyMeta]) -> list[Column]:
    """Invert the mixed-radix dense group id (exec._dense_group_ids)."""
    cols: list[Column] = []
    rem = live.astype(np.int64)
    strides = []
    s = 1
    for m in reversed(key_meta):
        strides.append(s)
        s *= m.size
    strides.reverse()
    for m, stride in zip(key_meta, strides):
        code = (rem // stride) % m.size
        if m.dtype.nullable:
            valid = code > 0
            code = np.maximum(code - 1, 0)
        else:
            valid = np.ones(len(code), bool)
        data = code.astype(m.dtype.np_dtype())
        cols.append(Column(m.dtype, data, valid, m.dictionary))
    return cols


def _finalize_one(a: D.AggDesc, st: dict) -> Column:
    n = len(next(iter(st.values())))
    out_t = a.out_dtype
    if a.func == D.AggFunc.COUNT:
        return Column(out_t, np.asarray(st["count"], np.int64),
                      np.ones(n, bool))
    cnt = np.asarray(st["cnt"], dtype=object)
    valid = (cnt > 0).astype(bool)
    if a.func == D.AggFunc.SUM:
        if "hi" in st:  # decimal limbs
            total = (st["hi"].astype(object) << 32) + st["lo"].astype(object)
            data = np.where(valid, total, 0)
        else:
            data = np.where(valid, st["sum"], 0)
        if out_t.kind != K.FLOAT64:
            _check_decimal_range(data, out_t.prec)
        if out_t.np_dtype() == object:
            data = np.array([int(x) for x in data], dtype=object)
        else:
            data = data.astype(out_t.np_dtype())
        return Column(out_t, data, valid)
    if a.func in (D.AggFunc.MIN, D.AggFunc.MAX):
        field = "min" if a.func == D.AggFunc.MIN else "max"
        data = np.where(valid, st[field], 0).astype(out_t.np_dtype())
        return Column(out_t, data, valid)
    raise NotImplementedError(a.func)


def _check_decimal_range(total: np.ndarray, prec: int) -> None:
    # MySQL raises ER_DATA_OUT_OF_RANGE when a decimal result exceeds its
    # declared precision
    if prec <= 0:
        prec = dt.DECIMAL_MAX_PRECISION
    lim = 10 ** prec
    bad = [int(t) for t in np.asarray(total).reshape(-1) if abs(int(t)) >= lim]
    if bad:
        raise OverflowError(
            f"DECIMAL sum out of range (> {prec} digits): {bad[0]}")


def sum_out_dtype(arg_t: dt.DataType) -> dt.DataType:
    """MySQL result type of SUM(arg): decimals widen by 22 digits,
    bounded to the 38-digit exact limb representation."""
    if arg_t.kind == K.DECIMAL:
        p = arg_t.prec if arg_t.prec > 0 else dt.DECIMAL64_MAX_PRECISION
        return dt.decimal_wide(p + 22, arg_t.scale)
    if arg_t.kind in (K.FLOAT32, K.FLOAT64):
        return dt.double()
    return dt.decimal_wide(dt.DECIMAL_MAX_PRECISION, 0)  # SUM(int)


__all__ = ["GroupKeyMeta", "merge_field", "merge_states", "finalize",
           "merge_sorted_states", "finalize_sorted", "sum_out_dtype"]

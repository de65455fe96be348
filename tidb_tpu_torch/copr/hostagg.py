# ported from tidb_tpu/copr/hostagg.py @ ba365f2
"""Host (CPU) execution of SORT/SEGMENT/SCATTER-strategy group-by
aggregation.

Per-platform engine choice (VERDICT r2 #2): the reference aggregates
high-NDV group-by with a CPU hash table (parallel HashAgg,
pkg/executor/aggregate/agg_hash_executor.go:94).  The TPU answer is the
device sort/radix-partition + segment-reduce programs
(copr/exec._agg_sort_states, copr/segment.py), but those programs
lowered to XLA-CPU measured 56x slower than numpy's sorting unique.  So
on a CPU mesh the JAX package's CopClient routes the whole aggregation
here: one np.unique (plus a stable argsort when any aggregate needs per-row
segment reduction) producing the exact same partial-state pytree the
device program emits, so merge/finalize stay one code path
(copr/aggregate.merge_sorted_states).

The hot shape — single non-nullable int64 key, COUNT(*) only — reduces to
exactly `np.unique(key, return_index, return_counts)`, i.e. the numpy
oracle itself.

In the port the CPU client keeps running the device programs through
the plain kernel versions (the parity tests reach the kernels that way);
this module serves the client's fault ladders (the host rung of the OOM
and quarantine ladders, store/client.py) and the store processes
(store/server.py), over the port's numpy ``Evaluator``
(expr/host_eval.py).  The partial states equal the JAX package's bit for
bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..expr.host_eval import Evaluator
from ..types import dtypes as dt
from . import dag as D
from .aggregate import _MERGE, _np_key_code, merge_states

K = dt.TypeKind


def _host_scan_chain(node: D.CopNode, snap,
                     allow_mask: bool = False,
                     rng: Optional[tuple] = None) -> Optional[tuple]:
    """Evaluate a TableScan[->Selection][->Projection] chain over the host
    snapshot columns.  Returns (cols, live_mask) where live_mask is None
    when rows were compacted; with allow_mask, HIGH-selectivity filters
    (>90% kept) skip the per-column compaction copies and return the
    boolean mask instead — the dense-agg consumer routes dead rows to a
    trim group, one pass instead of seven takes.  None = out of scope."""
    chain = []
    cur = node
    while True:
        chain.append(cur)
        if isinstance(cur, D.TableScan):
            break
        if isinstance(cur, (D.Selection, D.Projection, D.Expand)):
            cur = cur.child
            continue
        return None
    chain.reverse()

    ev = Evaluator(np)
    cols = None
    lo, hi = rng if rng is not None else (0, snap.num_rows)
    n = hi - lo
    live = None
    for op in chain:
        if isinstance(op, D.TableScan):
            cols = []
            for off in op.col_offsets:
                c = snap.columns[off]
                # narrow physical representation: the hardened evaluator
                # (expr/compile.py _iwiden/_cmp_fit) computes at logical
                # width where it matters; scans read 1-4 B/row
                phys = c.narrowed()
                data = phys if rng is None else phys[lo:hi]
                if c.all_valid():       # cached full-column reduce
                    valid = True
                elif rng is None:
                    valid = c.validity
                else:
                    v = c.validity[lo:hi]
                    valid = True if v.all() else v
                cols.append((data, valid))
        elif isinstance(op, D.Selection):
            memo: dict = {}
            keep = np.ones(n, bool) if live is None else live
            for cond in op.conditions:
                v, m = ev.eval(cond, cols, memo)
                v = np.broadcast_to(np.asarray(v), (n,))
                if v.dtype != bool:
                    v = v != 0
                if m is not True:
                    keep = keep & v & np.broadcast_to(np.asarray(m), (n,))
                else:
                    keep = keep & v
            nk = np.count_nonzero(keep)    # one reduce serves both checks
            if nk == n:
                continue
            if allow_mask and nk > 0.9 * n:
                live = keep
                continue
            idx = np.nonzero(keep)[0]
            cols = [(np.asarray(v)[idx] if np.ndim(v) else v,
                     m if m is True else m[idx]) for v, m in cols]
            n = len(idx)
            live = None
        elif isinstance(op, D.Expand):
            # rollup grouping sets: compact any pending mask first so the
            # replication multiplies only live rows, then np.tile
            if live is not None:
                idx = np.nonzero(live)[0]
                cols = [(np.asarray(v)[idx] if np.ndim(v) else v,
                         m if m is True else m[idx]) for v, m in cols]
                n = len(idx)
                live = None
            memo = {}
            L = len(op.keys)
            LV = op.levels
            keyvals = [ev.eval(k, cols, memo) for k in op.keys]
            out = []
            for v, m in cols:
                v = np.broadcast_to(np.asarray(v), (n,))
                out.append((np.tile(v, LV), True if m is True
                            else np.tile(np.broadcast_to(
                                np.asarray(m), (n,)), LV)))
            lvl = np.repeat(np.arange(LV, dtype=np.int64), n)
            for j, (v, m) in enumerate(keyvals):
                v = np.tile(np.broadcast_to(np.asarray(v), (n,)), LV)
                keep = (lvl + j) < L
                mv = keep if m is True else (
                    np.tile(np.broadcast_to(np.asarray(m), (n,)), LV) & keep)
                out.append((v, mv))
            out.append((lvl, True))
            cols = out
            n = n * LV
        else:  # Projection
            memo = {}
            out = []
            for e in op.exprs:
                v, m = ev.eval(e, cols, memo)
                out.append((np.broadcast_to(np.asarray(v), (n,)), m))
            cols = out
    return cols, live


def _group_codes(combined: np.ndarray, need_inv: bool):
    """(unique codes, per-group row counts int64, inverse|None).

    NDV-adaptive strategy (the reference picks hash vs stream agg from
    NDV; numpy's levers are different): when the observed code range is
    narrow relative to n, an O(n) histogram beats the O(n log n) sorting
    unique by 2-4x; otherwise fall back to np.unique.  The histogram runs
    in the native counting loop (native/hostops.cpp) when built — it
    reads the narrow physical key array directly, where np.bincount's
    mandatory bin/weight conversions cost 3-4x the compulsory traffic."""
    from . import nativeops
    n = len(combined)
    if n:
        if combined.dtype.itemsize < 4:
            # int8/int16 subtraction below could wrap (range may exceed
            # the narrow width); int32 always holds the shifted codes
            combined = combined.astype(np.int32)
        vmin = int(combined.min())
        vmax = int(combined.max())
        rng = vmax - vmin + 1
        if rng < (1 << 31) and rng <= max(2 * n, 1 << 22):
            cnts = nativeops.count_keys(combined, vmin, rng)
            if cnts is None:
                cnts = np.bincount(combined - vmin, minlength=rng)
            nz = np.flatnonzero(cnts)
            uniq = nz + vmin
            rows = cnts[nz].astype(np.int64)
            if not need_inv:
                return uniq, rows, None
            lookup = np.zeros(rng, np.int32)
            lookup[nz] = np.arange(len(nz), dtype=np.int32)
            inv = nativeops.gather_lookup(combined, vmin, lookup)
            if inv is None:
                inv = lookup[combined - vmin].astype(np.int64)
            return uniq, rows, inv
    if need_inv:
        uniq, inv, rows = np.unique(combined, return_inverse=True,
                                    return_counts=True)
        return uniq, rows.astype(np.int64), inv
    uniq, rows = np.unique(combined, return_counts=True)
    return uniq, rows.astype(np.int64), None


def host_rollup_agg(agg: D.Aggregation, snap) -> Optional[dict]:
    """Rollup fast path: Aggregation over an Expand whose group keys are
    exactly (expand key cols..., gid).

    Instead of replicating every row levels x (the literal Expand
    semantics, still the device program's shape), aggregate the BASE
    level once and derive each rollup level by re-aggregating the tiny
    group table — the classic sorted-rollup optimization (the reference's
    Expand feeds a single-pass hash agg; MySQL's filesort rollup rolls
    subtotals the same way).  Returns host_sort_agg-shaped states, or
    None when the DAG is not rollup-shaped."""
    ex = agg.child
    if not isinstance(ex, D.Expand):
        return None
    from ..expr.ir import ColumnRef
    n_base = len(D.output_dtypes(ex.child))
    L = len(ex.keys)
    gb = agg.group_by
    if len(gb) != L + 1 or ex.levels != L + 1:
        return None
    for j, g in enumerate(gb):
        if not (isinstance(g, ColumnRef) and g.index == n_base + j):
            return None
    # aggregate args must read only base columns
    for a in agg.aggs:
        if a.arg is not None and any(
                r.index >= n_base for r in _refs(a.arg)):
            return None
    base = D.Aggregation(ex.child, ex.keys, agg.aggs,
                         D.GroupStrategy.SORT,
                         group_capacity=agg.group_capacity)
    st0 = host_sort_agg(base, snap)
    if st0 is None:
        return None
    ng0 = int(st0["__ngroups__"])

    def level_states(lvl: int) -> dict:
        """Roll the base table up to keep the first L-lvl keys (every
        level derives independently from the base table st0)."""
        keep = L - lvl
        kv = [st0[f"k{j}"] for j in range(keep)]
        if keep:
            codes = [_np_key_code(np.asarray(k["val"]),
                                  np.asarray(k["valid"]), gb[j].dtype)
                     for j, k in enumerate(kv)]
            nulls = [~np.asarray(k["valid"]) for k in kv]
            mat = np.stack(codes + [nf.astype(np.int64) for nf in nulls],
                           axis=1)
            uniq, first, inv = np.unique(mat, axis=0, return_index=True,
                                         return_inverse=True)
            ng = len(uniq)
        else:
            first = np.zeros(1, np.int64) if ng0 else np.zeros(0, np.int64)
            inv = np.zeros(ng0, np.int64)
            ng = 1 if ng0 else 0

        def regroup(name, a):
            a = np.asarray(a)
            how = _MERGE[name]
            if how == "sum":
                out = np.zeros(ng, a.dtype)
                np.add.at(out, inv, a)       # exact at any magnitude
                return out
            neutral = (np.inf if how == "min" else -np.inf) \
                if a.dtype.kind == "f" else (
                    np.iinfo(a.dtype).max if how == "min"
                    else np.iinfo(a.dtype).min)
            out = np.full(ng, neutral, a.dtype)
            (np.minimum if how == "min" else np.maximum).at(out, inv, a)
            return out

        states: dict = {"__rows__": regroup("__rows__", st0["__rows__"])}
        for i in range(len(agg.aggs)):
            states[f"a{i}"] = {f: regroup(f, v)
                               for f, v in st0[f"a{i}"].items()}
        for j in range(L):
            if j < keep:
                states[f"k{j}"] = {
                    "val": np.asarray(st0[f"k{j}"]["val"])[first],
                    "valid": np.asarray(st0[f"k{j}"]["valid"])[first]}
            else:    # rolled key: NULL at this level
                z = np.zeros(ng, np.asarray(st0[f"k{j}"]["val"]).dtype)
                states[f"k{j}"] = {"val": z, "valid": np.zeros(ng, bool)}
        states[f"k{L}"] = {"val": np.full(ng, lvl, np.int64),
                           "valid": np.ones(ng, bool)}
        states["__ngroups__"] = np.int64(ng)
        return states

    parts = [None] * (L + 1)
    # level 0 is the base table itself plus the gid key
    lvl0: dict = {"__rows__": np.asarray(st0["__rows__"])}
    for i in range(len(agg.aggs)):
        lvl0[f"a{i}"] = {f: np.asarray(v)
                         for f, v in st0[f"a{i}"].items()}
    for j in range(L):
        lvl0[f"k{j}"] = {"val": np.asarray(st0[f"k{j}"]["val"]),
                         "valid": np.asarray(st0[f"k{j}"]["valid"])}
    lvl0[f"k{L}"] = {"val": np.zeros(ng0, np.int64),
                     "valid": np.ones(ng0, bool)}
    lvl0["__ngroups__"] = np.int64(ng0)
    parts[0] = lvl0
    for lvl in range(1, L + 1):
        parts[lvl] = level_states(lvl)

    out: dict = {"__ngroups__": np.int64(sum(int(p["__ngroups__"])
                                             for p in parts))}
    out["__rows__"] = np.concatenate([p["__rows__"] for p in parts])
    for i in range(len(agg.aggs)):
        out[f"a{i}"] = {f: np.concatenate([p[f"a{i}"][f] for p in parts])
                        for f in parts[0][f"a{i}"]}
    for j in range(L + 1):
        out[f"k{j}"] = {
            "val": np.concatenate([p[f"k{j}"]["val"] for p in parts]),
            "valid": np.concatenate([p[f"k{j}"]["valid"] for p in parts])}
    return out


def _refs(e):
    from ..expr.ir import ColumnRef, Func
    if isinstance(e, ColumnRef):
        yield e
    elif isinstance(e, Func):
        for a in e.args:
            yield from _refs(a)


def host_sort_agg(agg: D.Aggregation, snap) -> Optional[dict]:
    """SORT-strategy partial states over host columns, or None when the
    child DAG / aggregate set is outside this path's scope."""
    if not agg.group_by:
        return None
    if isinstance(agg.child, D.Expand):
        out = host_rollup_agg(agg, snap)
        if out is not None:
            return out
    if any(g.dtype.is_wide_decimal for g in agg.group_by):
        return None          # object keys: generic HostAgg groups them
    for a in agg.aggs:
        if a.func not in (D.AggFunc.COUNT, D.AggFunc.SUM, D.AggFunc.MIN,
                          D.AggFunc.MAX):
            return None
        if a.arg is not None and a.arg.dtype.is_wide_decimal:
            return None      # object values: exact python aggregation
    if snap.num_rows >= 2 ** 31 and any(
            a.func == D.AggFunc.SUM
            and a.arg.dtype.kind not in (K.FLOAT64, K.FLOAT32)
            for a in agg.aggs):
        # beyond the single-table limb-exact SUM bound: let the device
        # program split rows across shards instead of aborting
        return None
    chain = _host_scan_chain(agg.child, snap)
    if chain is None:
        return None
    cols, _live = chain
    n = len(cols[0][0]) if cols else 0

    ev = Evaluator(np)
    memo: dict = {}
    # canonical per-key (code, nullflag) in the device program's zeroing
    # semantics: NULLs zeroed + flagged, -0.0 groups with +0.0.
    # `valid is True` stays a sentinel — materializing np.ones(n) per
    # all-valid key cost two full passes on the rollup rung.
    key_vals, key_valids, key_codes = [], [], []
    for e in agg.group_by:
        v, m = ev.eval(e, cols, memo)
        v = np.broadcast_to(np.asarray(v), (n,))
        all_valid = m is True
        valid = True if all_valid else np.broadcast_to(np.asarray(m), (n,))
        vz = v if all_valid else np.where(valid, v, np.zeros((), v.dtype))
        if e.dtype.is_float:
            vz = np.where(vz == 0, np.zeros((), vz.dtype), vz)
        key_vals.append(vz)
        key_valids.append(valid)
        if all_valid and not e.dtype.is_float:
            # already canonical: ints/codes compare bit-stably.  Signed
            # narrow physical arrays pass through unwidened — the native
            # counting loop reads them at physical width
            code = vz if vz.dtype.kind == "i" else vz.astype(np.int64)
        else:
            code = _np_key_code(vz, np.asarray(valid), e.dtype)
        key_codes.append(code)

    # combine keys into one int id.  Fast path: direct mixed-radix
    # packing over per-key OBSERVED ranges — one linear pass per key, at
    # the narrowest width that holds the radix product (a 6-slot rollup
    # key domain packs in int16, not 8-byte temporaries).  The np.unique
    # factorization fallback costs a sort per key and dominated the
    # rollup rung ~40:1 before this path existed.
    combined = None
    if n and len(key_codes) >= 2:   # single-key ids pass through unshifted
        spans = []
        total = 1
        for code, valid in zip(key_codes, key_valids):
            vmin = int(code.min())
            vmax = int(code.max())
            allv = valid is True
            w = (vmax - vmin + 1) * (1 if allv else 2)
            spans.append((vmin, w, allv))
            total *= w
            if total >= 2 ** 62:
                break
        if total < 2 ** 62:
            # strict bounds: every per-key radix w divides total, so
            # total < 2**15 guarantees tgt(w) is representable too
            tgt = (np.int16 if total < 2 ** 15 else
                   np.int32 if total < 2 ** 31 else np.int64)
            combined = np.zeros(n, tgt)
            for (vmin, w, allv), code, valid in zip(spans, key_codes,
                                                    key_valids):
                np.multiply(combined, tgt(w), out=combined)
                if allv and vmin == 0:
                    np.add(combined, code, out=combined,
                           casting="unsafe")
                    continue
                # field = (code - vmin)[*2 + nullflag], computed one
                # width up from the code so the shift cannot wrap
                up = {1: np.int16, 2: np.int32}.get(
                    code.dtype.itemsize, np.int64)
                f = np.subtract(code, vmin, dtype=up)
                if not allv:
                    np.add(f, f, out=f)
                    np.add(f, ~valid, out=f, casting="unsafe")
                np.add(combined, f, out=combined, casting="unsafe")
    if combined is None:
        # pairwise factorized radices: a sort per key, but works for any
        # key domain (values stay < n^2 < 2^63)
        def _nf(j):
            kv = key_valids[j]
            return 0 if kv is True else (~kv).astype(np.int64)

        combined = key_codes[0]
        if key_valids[0] is not True:
            if combined.size and -2 ** 62 < int(combined.min()) \
                    and int(combined.max()) < 2 ** 62:
                combined = combined * np.int64(2) + _nf(0)
            else:
                u = np.unique(combined, return_inverse=True)[1]
                combined = u * np.int64(2) + _nf(0)
        for j in range(1, len(key_codes)):
            ua, inv_a = np.unique(combined, return_inverse=True)
            ub, inv_b = np.unique(key_codes[j], return_inverse=True)
            combined = inv_a.astype(np.int64) * np.int64(2 * len(ub)) \
                + inv_b.astype(np.int64) * 2 \
                + _nf(j)

    # per-row group ids are only needed beyond COUNT(*), and a group
    # representative row only when the key can't be decoded from its own
    # code (return_index forces a 4x slower stable argsort inside
    # np.unique, so avoid it entirely: representatives come from a
    # scatter of row ids through inv instead)
    k0 = agg.group_by[0]
    decodable_key = (len(agg.group_by) == 1 and key_valids[0] is True
                     and not k0.dtype.is_float)
    need_inv = (not decodable_key
                or any(not (a.func == D.AggFunc.COUNT and a.arg is None)
                       for a in agg.aggs))
    uniq, rows, inv = _group_codes(combined, need_inv)
    ng = len(uniq)

    states: dict = {"__ngroups__": np.int64(ng),
                    "__rows__": rows.astype(np.int64)}
    if decodable_key:
        # single non-null non-float key: the unique codes ARE the values
        states["k0"] = {"val": uniq.astype(key_vals[0].dtype),
                        "valid": np.ones(ng, bool)}
    else:
        # any row of a group yields the same (zeroed value, nullflag)
        rep = np.empty(ng, np.int64)
        rep[inv] = np.arange(n)
        for j, (vz, valid) in enumerate(zip(key_vals, key_valids)):
            states[f"k{j}"] = {"val": vz[rep],
                               "valid": (np.ones(ng, bool) if valid is True
                                         else valid[rep])}

    def seg_sum(vals):
        # bincount beats np.add.at ~10x; float64 weights are the natural
        # accumulator for float sums
        return np.bincount(inv, weights=vals,
                           minlength=ng)[:ng].astype(vals.dtype)

    for i, a in enumerate(agg.aggs):
        if a.func == D.AggFunc.COUNT and a.arg is None:
            states[f"a{i}"] = {"count": rows.astype(np.int64)}
            continue
        av, am = ev.eval(a.arg, cols, memo)
        av = np.broadcast_to(np.asarray(av), (n,))
        mask = (np.ones(n, bool) if am is True
                else np.broadcast_to(np.asarray(am), (n,)))
        cnt = np.bincount(inv[mask], minlength=ng).astype(np.int64)
        if a.func == D.AggFunc.COUNT:
            states[f"a{i}"] = {"count": cnt}
            continue
        if a.func == D.AggFunc.SUM:
            if a.arg.dtype.kind in (K.FLOAT64, K.FLOAT32):
                v = np.where(mask, av.astype(np.float64), 0.0)
                states[f"a{i}"] = {"sum": seg_sum(v), "cnt": cnt}
                continue
            if n >= 2 ** 31:
                raise OverflowError(
                    f"{n} rows exceed the 2^31 limb-exact SUM bound")
            v = np.where(mask, av, av.dtype.type(0) if hasattr(av, "dtype")
                         else 0)
            vmax = int(v.max()) if len(v) else 0
            vmin = int(v.min()) if len(v) else 0
            one_limb = 0 <= vmin and vmax < 2 ** 32
            if not one_limb and v.dtype != np.int64:
                v = v.astype(np.int64)
            hi, lo = _seg_sum_int(inv, v, ng, one_limb)
            states[f"a{i}"] = {"hi": hi, "lo": lo, "cnt": cnt}
            continue
        # MIN / MAX: neutral-fill invalid rows, segment-reduce in the
        # value's own dtype (uint64 must not be squeezed through int64)
        v = np.asarray(av)
        if v.dtype.kind == "f":
            v = v.astype(np.float64)
            neutral = np.inf if a.func == D.AggFunc.MIN else -np.inf
        else:
            if v.dtype.kind not in "iu":
                v = v.astype(np.int64)
            info = np.iinfo(v.dtype)
            neutral = info.max if a.func == D.AggFunc.MIN else info.min
        red = np.minimum if a.func == D.AggFunc.MIN else np.maximum
        v = np.where(mask, v, v.dtype.type(neutral))
        out = np.full(ng, neutral, v.dtype)
        red.at(out, inv, v)
        states[f"a{i}"] = {("min" if a.func == D.AggFunc.MIN else "max"):
                           out, "cnt": cnt}
    return states


_SEG_CHUNK = 1 << 20


def _seg_sum_int(gid: np.ndarray, v: np.ndarray, size: int,
                 one_limb: bool) -> tuple[np.ndarray, np.ndarray]:
    """Exact per-group (hi, lo) 32-bit-limb sums of int values via chunked
    np.bincount: each <=2^20-row chunk's float64 weight accumulation stays
    below 2^52 in magnitude (exact — float64 is exact for negative weights
    under the same bound, so the signed hi limb needs no bias), and chunk
    results accumulate in int64 — ~3x faster than np.add.at's scatter
    loop on this host.

    one_limb (all values in [0, 2^32)): `v` may be ANY int width — narrow
    physical columns feed bincount directly, skipping the astype and mask
    passes.  Two-limb: `v` must be int64."""
    lo = np.zeros(size, np.int64)
    hi = np.zeros(size, np.int64)
    for s in range(0, len(v), _SEG_CHUNK):
        g = gid[s:s + _SEG_CHUNK]
        vv = v[s:s + _SEG_CHUNK]
        if one_limb:
            lo += np.bincount(g, weights=vv,
                              minlength=size)[:size].astype(np.int64)
            continue
        lo += np.bincount(g, weights=vv & 0xFFFFFFFF,
                          minlength=size)[:size].astype(np.int64)
        # arithmetic shift: (v>>32)*2^32 + (v&0xFFFFFFFF) == v exactly,
        # including negatives; |hi| <= 2^31 so the chunk sum stays exact
        hi += np.bincount(g, weights=vv >> 32,
                          minlength=size)[:size].astype(np.int64)
    return hi, lo


_DENSE_CHUNK = 1 << 20


def host_dense_agg(agg: D.Aggregation, snap) -> Optional[dict]:
    """DENSE/SCALAR-strategy partial states over host columns (the CPU
    engine choice for Q1-shaped small-domain group-bys).

    Chunk-at-a-time (the reference executor\'s chunk discipline,
    executor.go Next-with-chunk): expression temporaries for a <=2^20-row
    chunk stay cache-hot, measured ~3x faster than full-width passes at
    SF=10 on a bandwidth-limited host.  Per-chunk partial states merge
    through the same merge_states path the device shards use.  None =
    out of scope."""
    for a in agg.aggs:
        if a.func not in (D.AggFunc.COUNT, D.AggFunc.SUM, D.AggFunc.MIN,
                          D.AggFunc.MAX):
            return None
        if a.arg is not None and a.arg.dtype.is_wide_decimal:
            return None      # object values: generic HostAgg path
    total = snap.num_rows
    ranges = [(lo, min(lo + _DENSE_CHUNK, total))
              for lo in range(0, total, _DENSE_CHUNK)] or [(0, 0)]
    out = []
    for rng in ranges:
        st = _dense_chunk_states(agg, snap, rng)
        if st is None:
            return None
        out.append(st)
    return out[0] if len(out) == 1 else merge_states(out)


def _dense_chunk_states(agg: D.Aggregation, snap, rng) -> Optional[dict]:
    chain = _host_scan_chain(agg.child, snap, allow_mask=True, rng=rng)
    if chain is None:
        return None
    cols, live = chain
    n = len(cols[0][0]) if cols else 0
    ev = Evaluator(np)
    memo: dict = {}

    if agg.strategy == D.GroupStrategy.DENSE:
        G = 1
        gid = np.zeros(n, np.int64)
        for e, size in zip(agg.group_by, agg.domain_sizes):
            v, m = ev.eval(e, cols, memo)
            v = np.broadcast_to(np.asarray(v), (n,)).astype(np.int64)
            if e.dtype.nullable:
                code = v + 1 if m is True else np.where(m, v + 1, 0)
            else:
                code = v
            gid = gid * int(size) + code
            G *= int(size)
    else:                                  # SCALAR
        G = 1
        gid = np.zeros(n, np.int64)

    if live is not None:
        # uncompacted high-selectivity filter: dead rows route to a trim
        # group past G (single pass instead of per-column takes)
        gid = np.where(live, gid, np.int64(G))
    full_cnt = np.bincount(gid, minlength=G + 1).astype(np.int64)
    rows = full_cnt[:G]
    states: dict = {"__rows__": rows}
    for i, a in enumerate(agg.aggs):
        if a.func == D.AggFunc.COUNT and a.arg is None:
            states[f"a{i}"] = {"count": rows}
            continue
        av, am = ev.eval(a.arg, cols, memo)
        av = np.broadcast_to(np.asarray(av), (n,))
        # dead (filtered) rows already route to the trim slot past G, so
        # only the aggregate's OWN null mask needs applying to values
        all_valid = am is True
        if all_valid:
            cnt = rows
            mask = None
        else:
            mask = np.broadcast_to(np.asarray(am), (n,))
            cnt = np.bincount(gid[mask],
                              minlength=G + 1)[:G].astype(np.int64)
        if a.func == D.AggFunc.COUNT:
            states[f"a{i}"] = {"count": cnt}
        elif a.func == D.AggFunc.SUM:
            if a.arg.dtype.kind in (K.FLOAT64, K.FLOAT32):
                v = av.astype(np.float64)
                if mask is not None:
                    v = np.where(mask, v, 0.0)
                out = np.bincount(gid, weights=v, minlength=G + 1)
                states[f"a{i}"] = {"sum": out[:G], "cnt": cnt}
            else:
                if n >= 2 ** 31:
                    return None        # past the limb-exact bound
                v = av
                if mask is not None:
                    v = np.where(mask, v, v.dtype.type(0))
                vmax = int(v.max()) if len(v) else 0
                vmin = int(v.min()) if len(v) else 0
                one_limb = 0 <= vmin and vmax < 2 ** 32
                if not one_limb and v.dtype != np.int64:
                    v = v.astype(np.int64)
                hi, lo = _seg_sum_int(gid, v, G + 1, one_limb)
                states[f"a{i}"] = {"hi": hi[:G], "lo": lo[:G],
                                   "cnt": cnt}
        else:
            v = np.asarray(av)
            if v.dtype.kind == "f":
                v = v.astype(np.float64)
                neutral = np.inf if a.func == D.AggFunc.MIN else -np.inf
            else:
                if v.dtype.kind not in "iu":
                    v = v.astype(np.int64)
                info = np.iinfo(v.dtype)
                neutral = (info.max if a.func == D.AggFunc.MIN
                           else info.min)
            if mask is not None:
                v = np.where(mask, v, v.dtype.type(neutral))
            out = np.full(G + 1, neutral, v.dtype)
            (np.minimum if a.func == D.AggFunc.MIN
             else np.maximum).at(out, gid, v)
            states[f"a{i}"] = {("min" if a.func == D.AggFunc.MIN
                                else "max"): out[:G], "cnt": cnt}
    return states


__all__ = ["host_sort_agg", "host_dense_agg"]

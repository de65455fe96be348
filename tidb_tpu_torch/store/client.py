# ported from tidb_tpu/store/client.py @ a9e9482
"""Coprocessor client: dispatches a pushed-down DAG to the devices and
merges what they return.

``execute_agg`` runs two routes of the JAX package's client:

- SCALAR and DENSE (``_execute_agg_once``): one launch of the device
  program, whose partial states merge across the devices on the card;
  one device-to-host transfer of the merged states; then
  ``merge_states`` and ``finalize`` on the host;
- the high-NDV SORT, SEGMENT and SCATTER strategies
  (``_execute_sort_agg``): for SEGMENT and SCATTER the key hash is
  computed once per statement and appended as a scan column (the prehash
  hoist); the per-device program runs at a state capacity (SORT's pow2
  ``group_capacity``, the radix strategies' pow2 ``num_buckets``) and is
  re-run at a larger one while a device observes more groups than that
  (the regrow loop), and the host merges the per-device group tables.

``execute_rows`` runs a row-returning DAG (Limit, TopN, a filtered
projection) with the paging loop of ``_execute_rows_once``: each device
compacts its live rows into a fixed row capacity, and the program is
re-run at a larger one while a device returns more rows than that; the
host concatenates each device's rows (``_assemble_rows``).  A TopN or
Limit root returns the union of the devices' first rows, for the caller
to re-trim, as the JAX package's does.

Both routes take ``aux_cols``, the build sides of a broadcast join
fused into the probe table's program (``copr/exec._exec_lookup_join``):
groups of tensors already on the card.  A program with an expanding
(m:n) join reports each device's true join output size, and the client
re-runs it at a larger join capacity while one exceeds it
(``_grown_join_dag``).

``execute_shuffle_agg`` and ``execute_shuffle_rows`` run the repartition
join (parallel/shuffle.py): both tables' scan chains, the hash exchange
between the logical devices, each device's build sort and join, then
the aggregation or the row compaction, re-run at larger exchange, join
or result capacities while a device reports more rows than one holds
(``_run_shuffle``).

On the CPU the client runs the same device programs through the plain
kernel versions; it has no host shortcut (the JAX package's CPU routes
to ``host_dense_agg`` and ``host_sort_agg``), no streaming, result
cache, warm-capacity cache, retries or fault ladders.  The device
windows raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from .. import EXCHANGE, unported
from ..chunk.column import Column
from ..copr import dag as D
from ..copr import radix
from ..copr.aggregate import (GroupKeyMeta, finalize, finalize_sorted,
                              merge_sorted_states, merge_states)
from ..copr.join import check_join_rows
from ..device import get_devices
from ..parallel.shuffle import ShardedShuffleJoinProgram, ShuffleCaps
from ..parallel.spmd import ShardedCopProgram
from .columnar import ColumnarSnapshot, _pow2_at_least

DEFAULT_GROUP_CAPACITY = 4096
INITIAL_SELECTIVITY = 4  # row capacity = max(rows/shards/4, 1024)
PAGE_FEEDBACK_CAP = 512


@dataclass
class CopResult:
    """Decoded result of one pushdown: agg groups."""
    columns: list[Column]
    key_columns: list[Column]


def _sync(devices) -> None:
    if devices[0].type == "cuda":
        torch.cuda.synchronize(devices[0])


class CopClient:
    """``device`` is ``"cuda"`` (the default) or ``"cpu"``;
    ``n_devices`` logical devices share it (see tidb_tpu_torch/device.py).

    ``timings`` holds the wall-clock seconds of the last ``execute_agg``
    or ``execute_rows`` by phase, each ended by a device synchronize:
    ``place``, ``device``, ``transfer``, then ``merge`` (aggregations)
    or ``assemble`` (rows); SEGMENT and SCATTER add ``hash``.  The
    high-NDV strategies also record ``buckets``, the per-device state
    capacity of each device program run (the last one final); the rows
    route records ``pages``, the row capacity of each run; a program
    with an expanding join records ``joins``, the join capacity of each
    run; the repartition join records ``shuffles``, the ``(left, right,
    out, rows)`` capacities of each run.  A broadcast join's executor
    adds ``build``, the seconds of its build side (its own plan, the
    sort of its keys and the copy to the card).

    ``join_fallbacks`` counts the broadcast joins whose executor took
    its host plan instead of the device program (an empty build side,
    or a chain level with an empty or duplicate-keyed build): the JAX
    package's own plan branches, counted so a run can show that a join
    meant for the card ran there."""

    def __init__(self, device="cuda", n_devices: int = 1):
        self.devices = get_devices(device, n_devices)
        self.timings: dict = {}
        # paging feedback: dag digest -> EWMA of the observed per-shard
        # live fraction, LRU-capped (digests embed predicate constants)
        self._page_feedback: OrderedDict[int, float] = OrderedDict()
        self.last_page_iters = 0
        self.join_fallbacks = 0

    def _place(self, snap: ColumnarSnapshot):
        self.timings = {}
        t0 = time.perf_counter()
        cols, counts = snap.device_cols(self.devices)
        _sync(self.devices)
        self.timings["place"] = time.perf_counter() - t0
        return cols, counts

    def execute_agg(self, agg: D.Aggregation, snap: ColumnarSnapshot,
                    key_meta: list[GroupKeyMeta], aux_cols=()) -> CopResult:
        """The aggregation's result columns.  ``aux_cols`` are the build
        sides of the broadcast joins fused into ``agg``'s program."""
        cols, counts = self._place(snap)
        if agg.strategy in D.HOST_MERGE_STRATEGIES:
            return self._execute_sort_agg(agg, cols, counts, key_meta,
                                          aux_cols)
        return self._execute_dense_agg(agg, cols, counts, key_meta,
                                       aux_cols)

    def _launch(self, dag, cols, counts, aux_cols, row_capacity: int = 0):
        """One run of ``dag``'s program over the devices: ``(out, grown)``,
        ``grown`` the DAG at a larger join capacity when an expanding
        join's output overflowed its capacity (``out`` is then stale),
        else None."""
        prog = ShardedCopProgram(dag, self.devices, row_capacity)
        out = prog(cols, counts, aux_cols)
        if not prog.has_extras:
            return out, None
        out, extras = out
        self.timings.setdefault("joins", []).append(
            D.find_expand_join(dag).out_capacity)
        return out, self._grown_join_dag(dag, extras)

    def _grown_join_dag(self, dag, extras):
        """The DAG rebuilt at a big enough join capacity when a device's
        expanding join overflowed it; None when it fits.  A device output
        past the reference's int32 join slots raises
        (``copr/join.check_join_rows``)."""
        need = int(extras["join_total"].max())
        check_join_rows(need)
        node = D.find_expand_join(dag)
        if node is not None and need > node.out_capacity:
            return D.rewrite_expand_capacity(dag, _pow2_at_least(need))
        return None

    def _execute_dense_agg(self, agg, cols, counts, key_meta,
                           aux_cols=()) -> CopResult:
        """One launch whose states merge across the devices on the card
        (re-run at a larger join capacity while an expanding join
        overflows), one transfer of the merged states, the host
        finalize."""
        t = self.timings
        t["device"] = 0.0
        for _ in range(8):
            t0 = time.perf_counter()
            out, grown = self._launch(agg, cols, counts, aux_cols)
            _sync(self.devices)
            t["device"] += time.perf_counter() - t0
            if grown is None:
                break
            agg = grown
        else:
            raise RuntimeError("join-capacity regrow did not converge")
        t1 = time.perf_counter()
        states = _to_numpy(out)
        t2 = time.perf_counter()
        merged = merge_states([states])
        key_cols, agg_cols = finalize(agg, merged, key_meta)
        t["transfer"] = t2 - t1
        t["merge"] = time.perf_counter() - t2
        return CopResult(agg_cols, key_cols)

    @staticmethod
    def _with_capacity(agg: D.Aggregation, cap: int) -> D.Aggregation:
        """The aggregation at a new per-device group-table capacity (the
        regrow knob): SORT sizes ``group_capacity``, SEGMENT and SCATTER
        their radix bucket space ``num_buckets``, each a power of two."""
        if agg.strategy in D.RADIX_STRATEGIES:
            return dataclasses.replace(agg, num_buckets=_pow2_at_least(cap))
        return dataclasses.replace(agg, group_capacity=_pow2_at_least(cap))

    @staticmethod
    def _split_devices(states) -> list:
        """Per-table numpy state dicts from states stacked on axis 0: one
        a device, more for a device whose batch ran in parts
        (parallel/spmd.py)."""
        host = _to_numpy(states)
        return [_index(host, d) for d in range(len(host["__ngroups__"]))]

    def _execute_sort_agg(self, agg, cols, counts, key_meta,
                          aux_cols=()) -> CopResult:
        """Per-device group tables (sort or partition, then segment
        reduce), regrown when a device sees more groups than the table
        holds (or an expanding join more rows than its capacity), then
        the host final merge."""
        t = self.timings
        t0 = time.perf_counter()
        pre = None if aux_cols else radix.prehash_plan(agg, len(cols))
        if pre is not None:
            hashed_dag, leaf_scan = pre
            hv = radix.HashProgram(leaf_scan, agg.group_by)(cols)
            cols = list(cols) + [(hv, None)]
            agg = hashed_dag
            _sync(self.devices)
            t["hash"] = time.perf_counter() - t0
        t["device"] = t["transfer"] = 0.0
        t["buckets"] = []
        cap = agg.state_capacity or DEFAULT_GROUP_CAPACITY
        for _ in range(10):
            sized = self._with_capacity(agg, cap)
            t["buckets"].append(sized.state_capacity)
            t0 = time.perf_counter()
            out, grown = self._launch(sized, cols, counts, aux_cols)
            _sync(self.devices)
            t1 = time.perf_counter()
            if grown is not None:
                t["device"] += t1 - t0
                agg = grown
                continue
            per_dev = self._split_devices(out)
            t["device"] += t1 - t0
            t["transfer"] += time.perf_counter() - t1
            true_ng = max(int(st["__ngroups__"]) for st in per_dev)
            if true_ng <= sized.state_capacity:
                break
            cap = _pow2_at_least(true_ng)
        else:
            raise RuntimeError("group-capacity regrow did not converge")
        t0 = time.perf_counter()
        merged = merge_sorted_states(sized, per_dev)
        key_cols, agg_cols = finalize_sorted(sized, merged, key_meta)
        t["merge"] = time.perf_counter() - t0
        return CopResult(agg_cols, key_cols)

    # ------------------------------------------------------------- #
    # row-returning programs
    # ------------------------------------------------------------- #

    def _initial_row_capacity(self, root: D.CopNode, fb_key: int,
                              per_shard: int) -> int:
        """``max(limit, 16)`` for a TopN or Limit root; else the page
        feedback's last observed live fraction with 50% headroom, or a
        quarter of a shard (``INITIAL_SELECTIVITY``), at least 1024."""
        if isinstance(root, (D.TopN, D.Limit)):
            return max(root.limit, 16)
        fb = self._page_feedback.get(fb_key)
        if fb is not None:
            return _pow2_at_least(
                max(int(per_shard * min(fb * 1.5, 1.0)) + 1, 256))
        return max(_pow2_at_least(
            max(per_shard // INITIAL_SELECTIVITY, 1)), 1024)

    def execute_rows(self, root: D.CopNode, snap: ColumnarSnapshot,
                     out_dtypes, dictionaries=None,
                     aux_cols=()) -> list[Column]:
        """The rows of a row-returning DAG, one ``Column`` per output,
        with the paging loop: re-run at a larger row capacity while a
        device returns more rows than the capacity holds (or an
        expanding join more rows than its capacity).  ``aux_cols`` as
        for ``execute_agg``."""
        cols, counts = self._place(snap)
        t = self.timings
        t["device"] = t["transfer"] = 0.0
        t["pages"] = []
        top = isinstance(root, (D.TopN, D.Limit))
        fb_key = D.dag_digest(root)
        per_shard = -(-snap.num_rows // max(snap.n_shards, 1)) \
            if snap.num_rows else 1
        cap = self._initial_row_capacity(root, fb_key, per_shard)
        for _ in range(10):
            t["pages"].append(cap)
            t0 = time.perf_counter()
            out, grown = self._launch(root, cols, counts, aux_cols, cap)
            _sync(self.devices)
            t1 = time.perf_counter()
            if grown is not None:
                t["device"] += t1 - t0
                root = grown
                continue
            out_cols, out_counts = out
            host_counts = out_counts.cpu().numpy()
            t["device"] += t1 - t0
            t["transfer"] += time.perf_counter() - t1
            if top or (host_counts <= cap).all():
                break
            cap = _pow2_at_least(int(host_counts.max()))
        else:
            raise RuntimeError("paging loop did not converge")
        self.last_page_iters = len(t["pages"])
        if not top and per_shard > 0:
            frac = float(host_counts.max()) / per_shard
            old = self._page_feedback.get(fb_key, frac)
            self._page_feedback[fb_key] = 0.5 * old + 0.5 * frac
            self._page_feedback.move_to_end(fb_key)
            while len(self._page_feedback) > PAGE_FEEDBACK_CAP:
                self._page_feedback.popitem(last=False)
        return self._assemble_rows(out_cols, host_counts, cap, out_dtypes,
                                   dictionaries)

    def _assemble_rows(self, out_cols, host_counts, cap, out_dtypes,
                       dictionaries) -> list[Column]:
        """Each device's first ``min(count, cap)`` rows, concatenated on
        the card, moved to the host in one copy a column and decoded into
        host Columns."""
        t = self.timings
        t0 = time.perf_counter()
        take = np.minimum(host_counts, cap)
        parts = [(torch.cat([v[d, :take[d]] for d in range(len(take))]),
                  torch.cat([m[d, :take[d]] for d in range(len(take))]))
                 for v, m in out_cols]
        host = [(v.cpu().numpy(), m.cpu().numpy()) for v, m in parts]
        t1 = time.perf_counter()
        t["transfer"] += t1 - t0
        result = []
        for j, (ty, (data, valid)) in enumerate(zip(out_dtypes, host)):
            dic = dictionaries.get(j) if dictionaries else None
            result.append(Column(ty, data.astype(ty.np_dtype()), valid, dic))
        t["assemble"] = time.perf_counter() - t1
        return result

    # ------------------------------------------------------------- #
    # the repartition (shuffle) join: parallel/shuffle.py
    # ------------------------------------------------------------- #

    def _shuffle_initial_caps(self, lsnap, rsnap, row_cap: int):
        """Expected send-bucket rows under a uniform hash with 2x
        headroom, the join output at twice a device's left rows; each
        grown from the reported true maxima on overflow."""
        n_dev = len(self.devices)
        lcap = _pow2_at_least(
            max(2 * lsnap.num_rows // max(n_dev * n_dev, 1) + 1, 1024))
        rcap = _pow2_at_least(
            max(2 * rsnap.num_rows // max(n_dev * n_dev, 1) + 1, 1024))
        ocap = _pow2_at_least(max(2 * lsnap.num_rows // n_dev + 1, 1024))
        return ShuffleCaps(lcap, rcap, ocap, row_cap)

    def _run_shuffle(self, spec: D.ShuffleJoinSpec, lsnap, rsnap, aux_cols,
                     row_cap: int = 0):
        """Run the shuffle program, regrowing whichever static capacity
        (exchange buckets, join output, group table, row output) the
        extras report as overflowed; returns ``(program, out)``."""
        self.timings = {}
        t = self.timings
        t0 = time.perf_counter()
        lcols, lcounts = lsnap.device_cols(self.devices)
        rcols, rcounts = rsnap.device_cols(self.devices)
        _sync(self.devices)
        t["place"] = time.perf_counter() - t0
        t["device"] = t["transfer"] = 0.0
        t["shuffles"] = []
        caps = self._shuffle_initial_caps(lsnap, rsnap, row_cap)
        agg = spec.top if isinstance(spec.top, D.Aggregation) else None
        if agg is not None and agg.strategy in D.HOST_MERGE_STRATEGIES \
                and not agg.state_capacity:
            spec = dataclasses.replace(spec, top=self._with_capacity(
                agg, DEFAULT_GROUP_CAPACITY))
        for _ in range(12):
            t["shuffles"].append(dataclasses.astuple(caps))
            prog = ShardedShuffleJoinProgram(spec, self.devices, caps)
            t0 = time.perf_counter()
            out, extras = prog(lcols, lcounts, rcols, rcounts, aux_cols)
            _sync(self.devices)
            t1 = time.perf_counter()
            extras = {k: v.cpu().numpy() for k, v in extras.items()}
            t["device"] += t1 - t0
            t["transfer"] += time.perf_counter() - t1
            grew = False
            need_l = int(extras["lmax"].max())
            if need_l > caps.left:
                caps = dataclasses.replace(caps,
                                           left=_pow2_at_least(need_l))
                grew = True
            need_r = int(extras["rmax"].max())
            if need_r > caps.right:
                caps = dataclasses.replace(caps,
                                           right=_pow2_at_least(need_r))
                grew = True
            need_j = int(extras["join_total"].max())
            if spec.kind in ("inner", "left"):
                check_join_rows(need_j)
                if need_j > caps.out:
                    caps = dataclasses.replace(caps,
                                               out=_pow2_at_least(need_j))
                    grew = True
            if grew:
                continue
            agg = spec.top if isinstance(spec.top, D.Aggregation) else None
            if agg is not None and agg.strategy in D.HOST_MERGE_STRATEGIES:
                true_ng = int(out["__ngroups__"].max())
                if true_ng > agg.state_capacity:
                    spec = dataclasses.replace(spec, top=self._with_capacity(
                        agg, _pow2_at_least(true_ng)))
                    continue
            if agg is None:
                counts = out[1].cpu().numpy()
                if (counts > caps.rows).any():
                    caps = dataclasses.replace(
                        caps, rows=_pow2_at_least(int(counts.max())))
                    continue
            return prog, out
        raise RuntimeError("shuffle capacity regrow did not converge")

    def execute_shuffle_agg(self, spec: D.ShuffleJoinSpec, lsnap, rsnap,
                            key_meta: list[GroupKeyMeta],
                            aux_cols=()) -> CopResult:
        """The aggregation over a repartition join of two tables."""
        prog, out = self._run_shuffle(spec, lsnap, rsnap, aux_cols)
        agg = prog.spec.top
        t = self.timings
        t0 = time.perf_counter()
        states = _to_numpy(out)
        t1 = time.perf_counter()
        t["transfer"] += t1 - t0
        if prog.host_merge:
            per_dev = [_index(states, d)
                       for d in range(len(states["__ngroups__"]))]
            merged = merge_sorted_states(agg, per_dev)
            key_cols, agg_cols = finalize_sorted(agg, merged, key_meta)
        else:
            key_cols, agg_cols = finalize(agg, merge_states([states]),
                                          key_meta)
        t["merge"] = time.perf_counter() - t1
        return CopResult(agg_cols, key_cols)

    def execute_shuffle_rows(self, spec: D.ShuffleJoinSpec, lsnap, rsnap,
                             out_dtypes, dictionaries=None,
                             aux_cols=()) -> list[Column]:
        """The rows of a row-returning chain over a repartition join of
        two tables."""
        n_dev = len(self.devices)
        if isinstance(spec.top, (D.TopN, D.Limit)):
            row_cap = max(spec.top.limit, 16)
        else:
            row_cap = _pow2_at_least(
                max(2 * lsnap.num_rows // max(n_dev, 1) + 1, 1024))
        prog, (out_cols, out_counts) = self._run_shuffle(
            spec, lsnap, rsnap, aux_cols, row_cap)
        return self._assemble_rows(out_cols, out_counts.cpu().numpy(),
                                   prog.caps.rows, out_dtypes, dictionaries)

    def execute_window(self, spec, snap, out_dtypes, dictionaries=None,
                       aux_cols=()):
        raise unported("device window functions", EXCHANGE)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _to_numpy(tree: dict) -> dict:
    """The state dict on the host, by one device-to-host copy: the
    leaves are packed as bytes into one buffer (widest dtype first, so
    every leaf stays aligned) and unpacked as views of the host copy."""
    leaves = sorted(_leaves(tree), key=lambda kv: -kv[1].element_size())
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for _, t in leaves])
    host = flat.cpu().numpy()
    out: dict = {}
    off = 0
    for path, t in leaves:
        nbytes = t.numel() * t.element_size()
        np_dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        arr = host[off:off + nbytes].view(np_dt).reshape(tuple(t.shape))
        off += nbytes
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def _index(tree, d: int):
    if isinstance(tree, dict):
        return {k: _index(v, d) for k, v in tree.items()}
    return tree[d]


__all__ = ["CopClient", "CopResult", "DEFAULT_GROUP_CAPACITY",
           "INITIAL_SELECTIVITY"]

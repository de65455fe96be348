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

On the CPU the client runs the same device programs through the plain
kernel versions; it has no host shortcut (the JAX package's CPU routes
to ``host_dense_agg`` and ``host_sort_agg``), no streaming, result
cache, warm-capacity cache, retries or fault ladders.  The fused
broadcast join (``aux_cols``), the shuffle joins and the device windows
raise ``NotImplementedError`` naming their ROADMAP.md items.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from .. import EXCHANGE, JOINS, unported
from ..chunk.column import Column
from ..copr import dag as D
from ..copr import radix
from ..copr.aggregate import (GroupKeyMeta, finalize, finalize_sorted,
                              merge_sorted_states, merge_states)
from ..device import get_devices
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
    route records ``pages``, the row capacity of each run."""

    def __init__(self, device="cuda", n_devices: int = 1):
        self.devices = get_devices(device, n_devices)
        self.timings: dict = {}
        # paging feedback: dag digest -> EWMA of the observed per-shard
        # live fraction, LRU-capped (digests embed predicate constants)
        self._page_feedback: OrderedDict[int, float] = OrderedDict()
        self.last_page_iters = 0

    def _place(self, snap: ColumnarSnapshot):
        self.timings = {}
        t0 = time.perf_counter()
        cols, counts = snap.device_cols(self.devices)
        _sync(self.devices)
        self.timings["place"] = time.perf_counter() - t0
        return cols, counts

    def execute_agg(self, agg: D.Aggregation, snap: ColumnarSnapshot,
                    key_meta: list[GroupKeyMeta], aux_cols=()) -> CopResult:
        """The aggregation's result columns.  ``aux_cols``, the build
        sides of a fused broadcast join, arrive with the joins' slice."""
        _no_aux(aux_cols)
        cols, counts = self._place(snap)
        if agg.strategy in D.HOST_MERGE_STRATEGIES:
            return self._execute_sort_agg(agg, cols, counts, key_meta)
        return self._execute_dense_agg(agg, cols, counts, key_meta)

    def _execute_dense_agg(self, agg, cols, counts, key_meta) -> CopResult:
        """One launch whose states merge across the devices on the card,
        one transfer of the merged states, the host finalize."""
        t = self.timings
        t0 = time.perf_counter()
        out = ShardedCopProgram(agg, self.devices)(cols, counts)
        _sync(self.devices)
        t1 = time.perf_counter()
        states = _to_numpy(out)
        t2 = time.perf_counter()
        merged = merge_states([states])
        key_cols, agg_cols = finalize(agg, merged, key_meta)
        t["device"], t["transfer"] = t1 - t0, t2 - t1
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

    def _execute_sort_agg(self, agg, cols, counts, key_meta) -> CopResult:
        """Per-device group tables (sort or partition, then segment
        reduce), regrown when a device sees more groups than the table
        holds, then the host final merge."""
        t = self.timings
        t0 = time.perf_counter()
        pre = radix.prehash_plan(agg, len(cols))
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
            out = ShardedCopProgram(sized, self.devices)(cols, counts)
            _sync(self.devices)
            t1 = time.perf_counter()
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
        device returns more rows than the capacity holds.  ``aux_cols``
        as for ``execute_agg``."""
        _no_aux(aux_cols)
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
            out_cols, out_counts = ShardedCopProgram(
                root, self.devices, row_capacity=cap)(cols, counts)
            _sync(self.devices)
            t1 = time.perf_counter()
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

    def execute_shuffle_agg(self, spec, lsnap, rsnap, key_meta):
        raise unported("the repartition (shuffle) join", EXCHANGE)

    def execute_shuffle_rows(self, spec, lsnap, rsnap, out_dtypes,
                             dictionaries=None):
        raise unported("the repartition (shuffle) join", EXCHANGE)

    def execute_window(self, spec, snap, out_dtypes, dictionaries=None,
                       aux_cols=()):
        raise unported("device window functions", EXCHANGE)


def _no_aux(aux_cols) -> None:
    if aux_cols:
        raise unported("the build sides of a fused broadcast join", JOINS)


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

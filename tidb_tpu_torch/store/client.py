# ported from tidb_tpu/store/client.py @ a9e9482
"""Coprocessor client: dispatches a pushed-down aggregation to the
devices and merges what they return.

``execute_agg`` runs two routes of the JAX package's client:

- SCALAR and DENSE (``_execute_agg_once``): one launch of the device
  program, whose partial states merge across the devices on the card;
  one device-to-host transfer of the merged states; then
  ``merge_states`` and ``finalize`` on the host;
- the high-NDV SCATTER strategy (``_execute_sort_agg``): the key hash
  is computed once per statement and appended as a scan column (the
  prehash hoist), the per-device program runs at a pow2 ``num_buckets``
  and is re-run at a larger one while a device observes more groups than
  that (the regrow loop), and the host merges the per-device group
  tables.

On the CPU the client runs the same device programs through the plain
kernel versions; it has no host shortcut (the JAX package's CPU route
to ``host_dense_agg``), no streaming, result cache, retries or fault
ladders.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import torch

from ..chunk.column import Column
from ..copr import dag as D
from ..copr import radix
from ..copr.aggregate import (GroupKeyMeta, finalize, finalize_sorted,
                              merge_sorted_states, merge_states)
from ..device import get_devices
from ..parallel.spmd import ShardedCopProgram
from .columnar import ColumnarSnapshot, _pow2_at_least

DEFAULT_GROUP_CAPACITY = 4096


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
    by phase (``place``, ``device``, ``transfer``, ``merge``; SCATTER
    adds ``hash``), each ended by a device synchronize; SCATTER also
    records ``buckets``: the bucket space of each device program run,
    the last one final."""

    def __init__(self, device="cuda", n_devices: int = 1):
        self.devices = get_devices(device, n_devices)
        self.timings: dict = {}

    def execute_agg(self, agg: D.Aggregation, snap: ColumnarSnapshot,
                    key_meta: list[GroupKeyMeta]) -> CopResult:
        dense = agg.strategy in (D.GroupStrategy.SCALAR,
                                 D.GroupStrategy.DENSE)
        if not dense and agg.strategy not in D.RADIX_STRATEGIES:
            raise NotImplementedError(
                f"the {agg.strategy.value.upper()} strategy arrives with a "
                "later slice of the port (ROADMAP.md, Queue 1)")
        self.timings = {}
        t0 = time.perf_counter()
        cols, counts = snap.device_cols(self.devices)
        _sync(self.devices)
        self.timings["place"] = time.perf_counter() - t0
        if dense:
            return self._execute_dense_agg(agg, cols, counts, key_meta)
        return self._execute_sort_agg(agg, cols, counts, key_meta)

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
        """The aggregation at a new pow2 bucket space (the regrow knob)."""
        return dataclasses.replace(agg, num_buckets=_pow2_at_least(cap))

    def _split_devices(self, states) -> list:
        """Per-device numpy state dicts from states stacked on axis 0."""
        host = _to_numpy(states)
        return [_index(host, d) for d in range(len(self.devices))]

    def _execute_sort_agg(self, agg, cols, counts, key_meta) -> CopResult:
        """Per-device partition + segment-reduce group tables, regrown
        when a device sees more groups than the bucket space, then the
        host final merge."""
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
            t["buckets"].append(sized.num_buckets)
            t0 = time.perf_counter()
            out = ShardedCopProgram(sized, self.devices)(cols, counts)
            _sync(self.devices)
            t1 = time.perf_counter()
            per_dev = self._split_devices(out)
            t["device"] += t1 - t0
            t["transfer"] += time.perf_counter() - t1
            true_ng = max(int(st["__ngroups__"]) for st in per_dev)
            if true_ng <= sized.num_buckets:
                break
            cap = _pow2_at_least(true_ng)
        else:
            raise RuntimeError("group-capacity regrow did not converge")
        t0 = time.perf_counter()
        merged = merge_sorted_states(sized, per_dev)
        key_cols, agg_cols = finalize_sorted(sized, merged, key_meta)
        t["merge"] = time.perf_counter() - t0
        return CopResult(agg_cols, key_cols)


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


__all__ = ["CopClient", "CopResult", "DEFAULT_GROUP_CAPACITY"]

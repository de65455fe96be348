# ported from tidb_tpu/parallel/spmd.py @ a9e9482
"""Coprocessor fan-out over the port's devices.

The JAX package runs one ``shard_map`` program over its mesh; the port
runs the same device function once per logical device, each over its
contiguous block of the stacked (S, C) shards, flattened into one batch
of S/D * C rows with a live-row mask.  Of the JAX program kinds these
are the two aggregation kinds and the rows kind:

- ``merge_kind == "psum"`` (SCALAR, DENSE): the devices' partial states
  merge on the card, field by field, as ``psum``/``pmin``/``pmax`` merge
  them over the mesh (``_collective_merge``), and one merged state dict
  comes back;
- ``merge_kind == "host"`` (SORT, SEGMENT, SCATTER): each device
  returns its own group table, stacked along a leading device axis for
  the client's host merge; a device batch past the sort's int32
  permutation (``ops/sort._MAX_ROWS`` rows) runs as consecutive parts
  under it, each part's table one more entry on that axis;
- ``kind == "rows"`` (a root that is not an Aggregation): each device
  runs the DAG and compacts its live rows into ``row_capacity`` slots
  (``copr/exec.compact``); the per-device ``(cols, count)`` come back
  stacked along a leading device axis, for the client's paging loop.

A DAG with a broadcast join (``LookupJoin``) reads its build sides as
``aux_cols`` groups: one copy on the card, read by every logical
device, as the JAX program's replicated ``P()`` input.  A program with
an expanding (m:n) join also returns the devices' extras, ``join_total``
stacked one a device as ``shard_map`` returns it, for the client's
regrow of the join capacity.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..copr import dag as D
from ..copr.aggregate import _MERGE
from ..copr import exec as _exec
from ..copr.exec import _exec_node, agg_states, compact
from ..expr.compile import Evaluator
from ..ops import sort as _sort
from ..types.dtypes import TypeKind as K


def _collective_merge(per_dev: Sequence[dict]) -> dict:
    """Merge the devices' partial-state dicts on the card: sum for the
    count/limb/sum fields, min and max for MIN/MAX (a NaN is kept)."""
    def go(name, arrs):
        g = torch.stack(arrs)
        how = _MERGE[name]
        if how == "sum":
            return g.sum(0, dtype=g.dtype)
        return _exec.minmax(g, how)

    out: dict = {}
    for k, v in per_dev[0].items():
        if isinstance(v, dict):
            out[k] = {f: go(f, [st[k][f] for st in per_dev]) for f in v}
        else:
            out[k] = go(k, [st[k] for st in per_dev])
    return out


def _flatten_block(cols, counts):
    """(S_local, C) blocks -> one (S_local*C,) batch + live-row mask."""
    s, c = cols[0][0].shape
    base_sel = (torch.arange(c, device=counts.device)[None, :]
                < counts[:, None]).reshape(-1)
    flat = [(v.reshape(-1), None if m is None else m.reshape(-1))
            for v, m in cols]
    return flat, base_sel


def _stack(trees: list):
    """Stack per-device outputs (state dicts, or the rows kind's
    ``(cols, count)``) leaf by leaf along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


class ShardedCopProgram:
    """The program over the devices: ``__call__(stacked_cols, counts,
    aux_cols)`` -> the merged partial states (``merge_kind == "psum"``),
    the per-device states with a leading device axis (``merge_kind ==
    "host"``), or for a row-returning DAG (``kind == "rows"``)
    ``([(data (D, cap), valid (D, cap)), ...], count (D,))``; with
    ``has_extras``, ``(that, extras)``, each extra stacked a device."""

    def __init__(self, dag_root: D.CopNode, devices: Sequence[torch.device],
                 row_capacity: int = 0):
        self.root = dag_root
        self.row_capacity = row_capacity
        self.agg = dag_root if isinstance(dag_root, D.Aggregation) else None
        self.kind = "agg" if self.agg is not None else "rows"
        self.devices = tuple(devices)
        self.host_merge = (self.agg is not None
                           and self.agg.strategy in D.HOST_MERGE_STRATEGIES)
        self.merge_kind = "host" if self.host_merge else "psum"
        # int/decimal SUMs produce (hi, lo) limb states whose summed merge
        # is int64-exact only below 2^31 global rows; float sums, counts,
        # host-merged (object-int) programs and proven-narrow SUMs (one
        # int64 word, with a whole-table no-wrap proof) are exempt
        self._limb_sums = self.agg is not None and any(
            a.func == D.AggFunc.SUM and a.arg is not None
            and a.arg.dtype.kind not in (K.FLOAT64, K.FLOAT32)
            and i not in self.agg.narrow_sums
            for i, a in enumerate(self.agg.aggs))
        self._psum_limb_fence = self._limb_sums and not self.host_merge
        # a program with an expanding join also returns the devices'
        # extras (the true join output size) for the client's regrow
        self.has_extras = D.find_expand_join(dag_root) is not None

    def _device_fn(self, cols, counts, device, aux):
        """The device's outputs as ``[(out, extras)]``: one entry, or one
        a part of a host-merged batch run in parts."""
        flat, base_sel = _flatten_block(cols, counts)
        flat = [(v, True if m is None else m) for v, m in flat]
        ev = Evaluator(device)
        if self.host_merge:
            runs = [agg_states(self.agg, part, sel, ev, aux)
                    for part, sel in self._row_parts(flat, base_sel)]
            return [(st, batch.extras) for st, batch in runs]
        if self.agg is not None:
            st, batch = agg_states(self.agg, flat, base_sel, ev, aux)
            return [(st, batch.extras)]
        batch = _exec_node(self.root, flat, base_sel, ev, aux)
        return [(compact(batch, self.row_capacity), batch.extras)]

    def _row_parts(self, flat, sel) -> list:
        """A host-merged aggregation's device batch as ``[(cols, sel)]``:
        itself, or past ``ops/sort._MAX_ROWS`` rows consecutive parts
        under it.  The limb SUMs' bound still holds for the whole
        batch, as in the JAX package, whose batch is one sort."""
        n, lim = sel.shape[0], _sort._MAX_ROWS
        if n <= lim:
            return [(flat, sel)]
        if self._limb_sums and n >= _exec.LIMB_SUM_ROWS:
            raise OverflowError(
                f"shard batch of {n} rows exceeds the 2^31 limb-exact "
                "SUM bound; use more/smaller shards")
        return [([(v[lo:lo + lim], m if m is True else m[lo:lo + lim])
                  for v, m in flat], sel[lo:lo + lim])
                for lo in range(0, n, lim)]

    def __call__(self, stacked_cols: Sequence, counts: torch.Tensor,
                 aux_cols: Sequence = ()):
        if self._psum_limb_fence and stacked_cols:
            s, c = stacked_cols[0][0].shape[:2]
            # the limb-exactness fence of the merge: summed (hi, lo) SUM
            # limbs stay int64-exact only while the global row capacity
            # is < 2^31 (see copr/exec._agg_lanes)
            if s * c >= 2 ** 31:
                raise OverflowError(
                    f"global capacity {s}x{c} exceeds the 2^31 limb-exact "
                    "SUM bound for the merge across devices")
        n_dev = len(self.devices)
        s = counts.shape[0]
        if s % n_dev:
            raise ValueError(f"{s} shards do not split over {n_dev} devices")
        per = s // n_dev
        aux = tuple(tuple((v, True if m is None else m) for v, m in grp)
                    for grp in aux_cols)
        runs = []
        for d, device in enumerate(self.devices):
            blk = slice(d * per, (d + 1) * per)
            cols = [(v[blk], None if m is None else m[blk])
                    for v, m in stacked_cols]
            runs += self._device_fn(cols, counts[blk], device, aux)
        outs = [out for out, _ in runs]
        out = _stack(outs) if self.agg is None or self.host_merge \
            else _collective_merge(outs)
        if self.has_extras:
            return out, {k: torch.stack([torch.as_tensor(ex[k])
                                         for _, ex in runs])
                         for k in runs[0][1]}
        return out


__all__ = ["ShardedCopProgram"]

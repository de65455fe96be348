# ported from tidb_tpu/parallel/window.py @ 6298005
"""Device window functions over the port's logical devices: a hash
repartition by PARTITION BY, one sort a device, then segment ops.

The JAX package runs it as one ``shard_map`` program; the port runs a
device function once a logical device (parallel/spmd.py), so the
program runs in three steps, each over every device:

1. each device's scan chain (``_exec_node``), its partition, order and
   argument values, and the routing key: an FNV-style combine of the
   partition keys (collisions only co-locate extra partitions);
2. the exchange (parallel/exchange.all_to_all_exchange): equal keys
   land together, so every partition is device-local;
3. each device's window: ONE stable multi-key sort of the rows it
   received by (dead, partition keys' null flag and sortable key, order
   keys', ``~key`` for DESC) on ``stable_argsort`` (ops/sort.py, the
   onesweep kernels on the card), then the window items from the
   partition and peer boundaries:
   - the partition and peer-group ids by a ``cumsum`` of the boundary
     rows, and each row's first row of its partition and of its peer
     group by one scatter of the boundary rows' positions and a gather
     (where the JAX program takes a ``cummax``: torch's CUDA cummax
     took 783 of a 953 ms program at 2^27 rows on an H100);
   - ``row_number``, ``rank`` and ``dense_rank`` from those;
   - whole-partition COUNT, SUM, AVG, MIN and MAX as ONE
     ``group_reduce_lanes`` call over every aggregate item (the
     hand-written ``group_reduce`` kernel on the card), the partition id
     as the gids, each table gathered back to its rows; a float SUM or
     AVG over 2^30 rows or more is reduced in chunks under that
     (``copr/exec._reduce_lanes``), as every aggregation's;
   then the rows compacted (``copr/exec.compact``).

The bucket capacity of the exchange is static; each device's largest
send bucket (``wmax``) and its dropped rows (``ovf``) come back in the
extras, for the client to regrow and re-run.  Output rows come a device,
in no particular order (SQL without ORDER BY).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..copr import dag as D
from ..copr.cuda.group_reduce import Lane
from ..copr.exec import (DeviceBatch, _ensure_array, _exec_node, _gather,
                         _reduce_lanes, _sel_array, compact)
from ..expr.compile import Evaluator, _f2i64
from ..ops.sort import stable_argsort
from ..ops.sortkeys import as_int64_bits, sortable_int64
from ..types import dtypes as dt
from .exchange import all_to_all_exchange
from .shuffle import _blocks
from .spmd import _flatten_block

K = dt.TypeKind

RANK_FUNCS = ("row_number", "rank", "dense_rank")
AGG_FUNCS = ("count", "sum", "min", "max", "avg")

# the routing combine of the JAX program, on int64 bits (an int64
# product and sum wrap as the uint64 ones do)
_FNV_PRIME = 1099511628211
_NULL_ROUTE = 0x9E3779B9


def _as_route_int(v: torch.Tensor) -> torch.Tensor:
    """``v.astype(int64)`` as XLA converts it: a float truncates and
    saturates (NaN to 0), a uint64 keeps its bits."""
    if v.dtype.is_floating_point:
        return _f2i64(v.to(torch.float64))
    return as_int64_bits(v).to(torch.int64)


def _key_operands(vals_masks, descs=None) -> list:
    """(null flag, sortable key) sort keys a value, MySQL's NULL order
    (first ASC, last DESC)."""
    ops = []
    for i, ((v, m), e) in enumerate(vals_masks):
        desc = descs[i] if descs is not None else False
        key = sortable_int64(v, e.dtype.is_float, e.dtype.kind == K.UINT64)
        if desc:
            key = ~key
        if m is True:
            nf = torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)
        else:
            nf = (~m if desc else m).to(torch.int32)
        ops += [nf, key]
    return ops


def _changed(ops, order, m_rows, dev) -> torch.Tensor:
    """Rows that differ from their predecessor on any sorted operand."""
    ch = torch.zeros(m_rows, dtype=torch.bool, device=dev)
    if ops:
        ch[0] = True
    for o in ops:
        s = o[order]
        ch[1:] |= s[1:] != s[:-1]
    return ch


def _first_of(flags: torch.Tensor, ids: torch.Tensor,
              iota: torch.Tensor) -> torch.Tensor:
    """Each row's index of the first row of its run: ``flags`` mark the
    runs' first rows and ``ids`` (``cumsum(flags) - 1``) number the runs;
    the other rows write to a sink slot past the table."""
    m = flags.shape[0]
    first = torch.zeros(m + 1, dtype=torch.int64, device=flags.device)
    first.index_put_((torch.where(flags, ids, m),), iota)
    return first[ids]


def _agg_lane_src(av: torch.Tensor, fname: str) -> tuple:
    """The lane kind and source of a SUM/AVG, MIN or MAX item over
    ``av``, the value the JAX program widens (``astype(int64)`` or
    ``astype(float64)``) read at a width ``group_reduce`` takes."""
    isf = av.dtype.is_floating_point
    how = "sum" if fname in ("sum", "avg") else fname
    if isf:
        return "f" + how, av
    if av.dtype == torch.uint64:
        av = as_int64_bits(av)
    elif av.dtype == torch.bool or (how != "sum" and av.dtype not in (
            torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)):
        av = av.to(torch.int64)
    return how, av


class ShardedWindowProgram:
    """The window program over the logical devices: ``__call__(cols,
    counts, aux_cols)`` -> ``((cols, counts), extras)``, each column
    ``(data (n_dev, m_rows), valid (n_dev, m_rows))`` of compacted rows,
    ``counts`` a device's rows, ``extras`` ``{"wmax", "ovf"}`` a
    device."""

    def __init__(self, spec: D.WindowShuffleSpec, devices: Sequence,
                 capacity: int):
        self.spec = spec
        self.devices = tuple(devices)
        self.capacity = capacity        # per-device per-bucket rows
        self.n_dev = len(self.devices)
        self.out_dtypes = (D.output_dtypes(spec.child)
                           + tuple(it[2] for it in spec.items))

    # -- step 1: a device's scan chain and send buffers ------------------ #

    def _side(self, ev, cols, counts, aux):
        spec = self.spec
        dev = ev.device
        flat, base_sel = _flatten_block(cols, counts)
        flat = [(v, True if m is None else m) for v, m in flat]
        batch = _exec_node(spec.child, flat, base_sel, ev, aux)
        n = len(batch.cols[0][0])
        live = _sel_array(batch.sel, n, dev)
        memo: dict = {}
        route = torch.zeros(n, dtype=torch.int64, device=dev)
        pk = []
        for e in spec.partition_keys:
            v, m = ev.eval(e, batch.cols, memo)
            v = _ensure_array(v, n, dev)
            pk.append((v, m))
            hv = _as_route_int(v)
            if m is not True:
                hv = torch.where(_sel_array(m, n, dev), hv, _NULL_ROUTE)
            route = route * _FNV_PRIME + hv
        ok = []
        for e, _desc in spec.order_keys:
            v, m = ev.eval(e, batch.cols, memo)
            ok.append((_ensure_array(v, n, dev), m))
        args = []
        for _f, arg, _t in spec.items:
            if arg is not None:
                v, m = ev.eval(arg, batch.cols, memo)
                args.append((_ensure_array(v, n, dev), m))
        send = [(_ensure_array(v, n, dev),
                 True if m is True else _sel_array(m, n, dev))
                for v, m in list(batch.cols) + pk + ok + args]
        return send, live, route, len(batch.cols)

    # -- step 3: a device's sort and window items ------------------------ #

    def _window(self, recv, rvalid, nc):
        spec = self.spec
        dev = rvalid.device
        m_rows = rvalid.shape[0]
        np_, no_ = len(spec.partition_keys), len(spec.order_keys)
        r_child = recv[:nc]
        r_pk = [(recv[nc + i], e) for i, e in enumerate(spec.partition_keys)]
        r_ok = [(recv[nc + np_ + i], e)
                for i, (e, _d) in enumerate(spec.order_keys)]
        r_args, j = [], nc + np_ + no_
        for _f, arg, _t in spec.items:
            if arg is None:
                r_args.append(None)
            else:
                r_args.append(recv[j])
                j += 1

        # ONE sort: dead rows last, then partitions, then order keys
        dead = (~rvalid).to(torch.int32)
        pk_ops = _key_operands(r_pk)
        ok_ops = _key_operands(r_ok, [d for _e, d in spec.order_keys])
        order = stable_argsort([dead] + pk_ops + ok_ops)
        valid_s = rvalid[order]
        iota = torch.arange(m_rows, dtype=torch.int64, device=dev)

        part_b = _changed(pk_ops, order, m_rows, dev)
        part_b[1:] |= (~valid_s[1:]) & valid_s[:-1]
        part_b[0] = True
        peer_b = part_b | _changed(ok_ops, order, m_rows, dev)
        seg = torch.cumsum(part_b.to(torch.int64), 0) - 1   # 0-based
        peer = torch.cumsum(peer_b.to(torch.int64), 0) - 1
        first_idx = _first_of(part_b, seg, iota)
        first_peer = _first_of(peer_b, peer, iota)

        # the whole-partition aggregates: one state table, every item's
        # lanes in one group_reduce_lanes call (chunked past the float
        # sums' 2^30 rows, as every aggregation's), the partition id as gid
        lanes, plan = [], []
        for (fname, arg, _t), rvm in zip(spec.items, r_args):
            if fname in RANK_FUNCS:
                plan.append(None)
                continue
            if arg is None:                       # COUNT(*)
                av, am = None, valid_s
            else:
                av = _gather(rvm[0], order)
                am = rvm[1][order] & valid_s
            ci = len(lanes)
            lanes.append(Lane("count", None, am))
            vi = None
            if fname != "count":
                kind, src = _agg_lane_src(av, fname)
                vi = len(lanes)
                lanes.append(Lane(kind, src, am))
            plan.append((ci, vi))
        tables = _reduce_lanes(seg, m_rows, lanes) if lanes else []

        out_items = []
        for (fname, arg, _t), p in zip(spec.items, plan):
            if fname == "row_number":
                out_items.append((iota - first_idx + 1, valid_s))
                continue
            if fname == "rank":
                out_items.append((first_peer - first_idx + 1, valid_s))
                continue
            if fname == "dense_rank":
                out_items.append((peer - peer[first_idx] + 1, valid_s))
                continue
            ci, vi = p
            cnt = tables[ci][seg]
            if fname == "count":
                out_items.append((cnt, valid_s))
                continue
            tab = tables[vi]
            if fname in ("sum", "avg"):
                tot = tab[seg]
                if fname == "avg":
                    val = tot.to(torch.float64) / cnt.clamp(min=1)
                    if arg.dtype.kind == K.DECIMAL:
                        # scaled-int decimal -> its real value, divided
                        # by a 0-d device tensor (a python float divisor
                        # is a reciprocal product on the card)
                        val = val / torch.tensor(
                            float(10 ** arg.dtype.scale),
                            dtype=torch.float64, device=dev)
                else:
                    val = tot
                out_items.append((val, valid_s & (cnt > 0)))
                continue
            z = tab.to(torch.float64 if tab.dtype.is_floating_point
                       else torch.int64)
            out_items.append((z[seg], valid_s & (cnt > 0)))

        out_cols = [(_gather(v, order), m[order] & valid_s)
                    for v, m in r_child]
        out_cols += out_items
        return compact(DeviceBatch(out_cols, valid_s), m_rows)

    def __call__(self, cols, counts, aux_cols=()):
        aux = tuple(tuple((v, True if m is None else m) for v, m in grp)
                    for grp in aux_cols)
        evs = [Evaluator(d) for d in self.devices]
        sides = [self._side(ev, c, k, aux) for ev, (c, k) in
                 zip(evs, _blocks(cols, counts, self.n_dev))]
        nc = sides[0][3]
        recv = all_to_all_exchange([s[:3] for s in sides], self.n_dev,
                                   self.capacity)
        del sides
        outs = [self._window(rc, rv, nc) for rc, rv, _o, _m in recv]
        packed = [(torch.stack([o[0][j][0] for o in outs]),
                   torch.stack([o[0][j][1] for o in outs]))
                  for j in range(len(outs[0][0]))]
        extras = {"wmax": torch.stack([r[3] for r in recv]),
                  "ovf": torch.stack([r[2] for r in recv])}
        return (packed, torch.stack([o[1] for o in outs])), extras


__all__ = ["ShardedWindowProgram", "RANK_FUNCS", "AGG_FUNCS"]

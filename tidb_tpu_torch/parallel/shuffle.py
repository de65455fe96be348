# ported from tidb_tpu/parallel/shuffle.py @ e08c981
"""Repartition (shuffle) hash join over the port's logical devices.

The JAX package runs the whole fragment graph

    scan(left)  -> filter -> exchange(hash k) --+
    scan(right) -> filter -> exchange(hash k) --+-- join -> top -> merge

as one ``shard_map`` program whose exchanges are ``lax.all_to_all``.  The
port runs a device function once a logical device (parallel/spmd.py),
so the program runs in three steps, each over every device:

1. each device's scan chains, join keys and send buckets of both sides
   (parallel/exchange.send_buckets);
2. the exchange: the stacked ``(src, dst, cap)`` buffers read as
   ``(dst, src, cap)`` (exchange.all_to_all);
3. each device's join of the partition it received: the build rows
   sorted by ``(dead, key)`` on ``stable_argsort`` (dead slots parked
   at INT64_MAX, so ``match_ranges``' ``n_live`` clamp keeps them out
   even past a live INT64_MAX key), ``match_ranges``, then
   ``gather_expand`` or the semi/anti mask, then the aggregation or the
   row compaction.

Capacities are static: the exchange buckets, the join output and the
group or row tables; every true size comes back in the extras
(``lmax``, ``rmax``, ``join_total``, one a device) for the client to
regrow and re-run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..copr import dag as D
from ..copr.exec import (LIMB_SUM_ROWS, DeviceBatch, _ensure_array,
                         _exec_node, _sel_array, agg_states, compact)
from ..copr.join import gather_expand, match_ranges
from ..expr.compile import Evaluator
from ..ops.sort import stable_argsort
from ..ops.sortkeys import INT64_MAX, as_int64_bits
from ..types.dtypes import TypeKind as K
from .exchange import all_to_all_exchange
from .spmd import _collective_merge, _flatten_block, _stack


@dataclass(frozen=True)
class ShuffleCaps:
    """Static capacities of one shuffle-join program (regrown by the
    client on overflow)."""
    left: int          # exchange send-bucket rows per (device, dest)
    right: int
    out: int           # join output rows per device
    rows: int = 0      # compacted result rows per device (rows kind only)


def _blocks(stacked_cols, counts, n_dev: int) -> list:
    """Each logical device's contiguous block of the stacked shards."""
    s = counts.shape[0]
    if s % n_dev:
        raise ValueError(f"{s} shards do not split over {n_dev} devices")
    per = s // n_dev
    return [([(v[d * per:(d + 1) * per],
               None if m is None else m[d * per:(d + 1) * per])
              for v, m in stacked_cols], counts[d * per:(d + 1) * per])
            for d in range(n_dev)]


class ShardedShuffleJoinProgram:
    """The repartition-join program over the logical devices.

    kind 'agg':  ``__call__`` -> (merged or per-device states, extras)
    kind 'rows': ``__call__`` -> ((cols, counts) per device, extras)
    extras: per-device ``{'lmax', 'rmax', 'join_total'}`` true sizes."""

    def __init__(self, spec: D.ShuffleJoinSpec, devices: Sequence,
                 caps: ShuffleCaps):
        self.spec = spec
        self.devices = tuple(devices)
        self.caps = caps
        self.n_dev = len(self.devices)
        self.agg = spec.top if isinstance(spec.top, D.Aggregation) else None
        self.kind = "agg" if self.agg is not None else "rows"
        self.host_merge = (self.agg is not None and self.agg.strategy
                           in D.HOST_MERGE_STRATEGIES)
        # the limb-exactness fence of spmd.py: an int/decimal SUM's (hi,
        # lo) limbs merge int64-exact only below 2^31 contributing rows
        self._psum_limb_fence = (
            self.agg is not None and not self.host_merge and any(
                a.func == D.AggFunc.SUM and a.arg is not None
                and a.arg.dtype.kind not in (K.FLOAT64, K.FLOAT32)
                for a in self.agg.aggs))

    def _side(self, chain, key_expr, cols, counts, aux, ev, drop_null_keys):
        """One device's scan chain and join key of one side, as the
        ``(cols, valid, keys)`` its exchange sends: the chain's columns
        and the key with its validity as the last column."""
        flat, base_sel = _flatten_block(cols, counts)
        flat = [(v, True if m is None else m) for v, m in flat]
        batch = _exec_node(chain, flat, base_sel, ev, aux)
        n = len(batch.cols[0][0]) if batch.cols else 0
        sel = _sel_array(batch.sel, n, ev.device)
        kv, km = ev.eval(key_expr, batch.cols, {})
        kv = as_int64_bits(_ensure_array(kv, n, ev.device)).to(torch.int64)
        key_ok = sel if km is True else (sel & _sel_array(km, n, ev.device))
        live = key_ok if drop_null_keys else sel
        send = [(_ensure_array(v, n, ev.device),
                 True if m is True else _sel_array(m, n, ev.device))
                for v, m in batch.cols]
        send.append((kv, key_ok))
        return send, live, torch.where(key_ok, kv, 0)

    def _exchange(self, sides, cap):
        """The exchange of one side: each device's ``(cols, valid,
        keys, key_ok, max_count)`` received."""
        recv = all_to_all_exchange(sides, self.n_dev, cap)
        return [(cols[:-1], valid, cols[-1][0], cols[-1][1], max_count)
                for cols, valid, _ovf, max_count in recv]

    def _join(self, ev, left, right):
        """One device's join of the partition it received: ``(joined
        batch, join_total)``."""
        spec, caps = self.spec, self.caps
        pcols, pvalid, pkeys, pkey_ok, _ = left
        bcols, bvalid, bkeys, bkey_ok, _ = right
        nb = bkeys.shape[0]
        dev = ev.device
        # the build partition sorted by (dead, key), ties in row order;
        # dead slots park at the end with an INT64_MAX fill
        bdead = (~(bvalid & bkey_ok)).to(torch.int32)
        perm = stable_argsort([bdead, bkeys])
        n_live = (nb - bdead.sum(dtype=torch.int64))
        skey = torch.where(torch.arange(nb, device=dev) < n_live,
                           bkeys[perm], INT64_MAX)
        probe_ok = pvalid & pkey_ok
        lo, _hi, cnt = match_ranges(skey, n_live, pkeys, probe_ok)
        if spec.kind in ("semi", "anti"):
            keep = (cnt > 0) if spec.kind == "semi" else (cnt == 0)
            sel = pvalid & keep
            return DeviceBatch(list(pcols), sel), sel.sum(dtype=torch.int64)
        out_cols, out_sel, total = gather_expand(
            list(pcols), pvalid, probe_ok, list(bcols), perm, lo, cnt,
            spec.kind, caps.out)
        return DeviceBatch(out_cols, out_sel), total

    def __call__(self, lcols, lcounts, rcols, rcounts, aux_cols=()):
        if self._psum_limb_fence and \
                self.n_dev * self.caps.out >= LIMB_SUM_ROWS:
            # every device may emit caps.out joined rows
            raise OverflowError(
                f"global join capacity {self.n_dev}x{self.caps.out} "
                "exceeds the 2^31 limb-exact SUM bound for the merge "
                "across devices")
        spec, caps = self.spec, self.caps
        aux = tuple(tuple((v, True if m is None else m) for v, m in grp)
                    for grp in aux_cols)
        evs = [Evaluator(d) for d in self.devices]
        # step 1: every device's scan chains and send buckets
        lsides, rsides = [], []
        for ev, (lc, lk), (rc, rk) in zip(
                evs, _blocks(lcols, lcounts, self.n_dev),
                _blocks(rcols, rcounts, self.n_dev)):
            lsides.append(self._side(
                spec.left, spec.left_key, lc, lk, aux, ev,
                drop_null_keys=spec.kind in ("inner", "semi")))
            rsides.append(self._side(
                spec.right, spec.right_key, rc, rk, aux, ev,
                drop_null_keys=True))
        # step 2: the exchanges
        lrecv = self._exchange(lsides, caps.left)
        rrecv = self._exchange(rsides, caps.right)
        del lsides, rsides
        # step 3: every device's join, then its aggregation or rows
        outs, totals = [], []
        for ev, left, right in zip(evs, lrecv, rrecv):
            joined, total = self._join(ev, left, right)
            totals.append(total)
            njoin = len(joined.cols[0][0]) if joined.cols else 0
            sel = _sel_array(joined.sel, njoin, ev.device)
            if self.agg is not None:
                states, _ = agg_states(self.agg, joined.cols, sel, ev, aux)
                outs.append(states)
            else:
                batch = _exec_node(spec.top, joined.cols, sel, ev, aux)
                outs.append(compact(batch, caps.rows))
        extras = {"lmax": torch.stack([r[4] for r in lrecv]),
                  "rmax": torch.stack([r[4] for r in rrecv]),
                  "join_total": torch.stack(totals)}
        if self.agg is not None and not self.host_merge:
            return _collective_merge(outs), extras
        return _stack(outs), extras


__all__ = ["ShuffleCaps", "ShardedShuffleJoinProgram"]

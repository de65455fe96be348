# ported from tidb_tpu/copr/radix.py @ a9e9482
"""SCATTER-strategy device group-by: multi-pass scatter radix partition
+ segment reduce.

Per device:

1. Group keys hash as in copr/segment.py (``key_hash``), or the hoisted
   ``prehashed`` column.  The top log2(B) + RADIX_RESIDUAL_BITS bits of
   the hash are the partition key over the pow2 ``num_buckets`` space
   (bucket id major, residual hash minor); dead rows take a tail key one
   bit above, so they sort last.
2. ``radix_passes(B)`` stable counting-sort passes order rows
   bucket-major, RADIX_BITS per pass, LSB digit first.  Two lowerings
   give the identical stable permutation:

   - the kernel path (``_partition_kernel``): each pass is the CUDA
     histogram + scatter pair of copr/cuda/radix_kernel.py, carrying the
     key through the pass;
   - the plain path (``_partition_plain``): RADIX_BITS 1-bit stable
     partitions per pass, each one cumsum and one scatter.

   A CUDA tensor always takes the kernel path and a CPU tensor the plain
   one; there is no switch.
3. The shared partition->states suffix of copr/segment.py detects
   segment boundaries and scatter-reduces into the (num_buckets,) state
   table; hash collisions split into duplicate partials merged on the
   host by true key, and ``__ngroups__`` drives the client's regrow.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.sortkeys import INT64_MAX
from ..types import dtypes as dt
from . import dag as D
from .segment import batch_hash, key_hash, shr64, states_from_partition


def _partition_plain(bid: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Stable LSD radix partition, one bit per subpass: the 1-bit
    counting sort's histogram and offsets are one cumsum, the reorder
    one scatter of the row permutation."""
    dev = bid.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if n == 0:
        return idx
    pos_iota = torch.arange(n, dtype=torch.int32, device=dev)
    for s in range(bits):
        b = (bid[idx] >> s) & 1
        zb = torch.cumsum(1 - b, 0, dtype=torch.int32)   # zeros so far, incl.
        # zeros keep order at offset 0; ones at offset total_zeros
        pos = torch.where(b == 0, zb - 1, zb[-1] + pos_iota - zb)
        nxt = torch.empty_like(idx)
        nxt[pos.to(torch.int64)] = idx
        idx = nxt
    return idx


def _partition_kernel(bid: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Stable LSD radix partition through the counting-sort kernels,
    RADIX_BITS-digit passes.  Each pass carries the partition key beside
    the row permutation, so the next pass reads its keys in order with no
    gather; ``counting_sort_pass`` handles a ragged last tile itself, so
    no padding key is needed.  The passes share one device error flag,
    read once after the last."""
    from .cuda import radix_kernel as rk
    key = bid.contiguous()
    idx = torch.arange(n, dtype=torch.int32, device=bid.device)
    err = rk.new_err(bid.device) if bid.device.type == "cuda" else None
    for p in range(-(-bits // D.RADIX_BITS)):
        key, idx = rk.counting_sort_pass(key, idx, p * D.RADIX_BITS, err)
    if err is not None:
        rk.read_err(err, "scatter_permutation")
    return idx


def partition_key(h: torch.Tensor, sel: torch.Tensor,
                  num_buckets: int) -> torch.Tensor:
    """int32 partition key: the top ``radix_key_bits(B) - 1`` bits of the
    int64-carried hash (a logical shift), dead rows at the tail key."""
    key_bits = D.radix_key_bits(num_buckets) - 1   # top bit = dead tail
    key = shr64(h, 64 - key_bits).to(torch.int32)
    return torch.where(sel, key, torch.tensor(1 << key_bits,
                                              dtype=torch.int32,
                                              device=h.device))


def scatter_permutation(h: torch.Tensor, sel: torch.Tensor,
                        num_buckets: int, n: int) -> torch.Tensor:
    """int32 row permutation ordering rows bucket-major over the pow2
    ``num_buckets`` space: the stable permutation of ``partition_key``,
    through the kernels on CUDA and the plain path on the CPU."""
    bits = D.radix_key_bits(num_buckets)
    key = partition_key(h, sel, num_buckets)
    if h.device.type == "cuda":
        return _partition_kernel(key, bits, n)
    return _partition_plain(key, bits, n)


def agg_scatter_states(agg: D.Aggregation, batch, ev, memo) -> dict:
    """SCATTER-strategy per-device partial states: multi-pass scatter
    radix partition + the shared segment-reduce suffix."""
    from .exec import _sel_array, group_keyinfo
    B = agg.num_buckets
    if B <= 0 or B & (B - 1):
        raise ValueError(f"SCATTER aggregation needs a power-of-two "
                         f"num_buckets, got {B}")
    if D.radix_passes(B) > D.MAX_RADIX_PASSES:
        raise ValueError(f"num_buckets {B} needs {D.radix_passes(B)} radix "
                         f"passes, more than {D.MAX_RADIX_PASSES}")
    n = len(batch.cols[0][0]) if batch.cols else 0
    sel = _sel_array(batch.sel, n, ev.device)

    keyinfo = group_keyinfo(agg, batch, ev, memo, n)
    h = batch_hash(agg, batch, keyinfo, n, ev.device)
    idx = scatter_permutation(h, sel, B, n).to(torch.int64)
    # boundary detection compares the full hash, dead rows parked high
    hv = torch.where(sel, h, torch.tensor(INT64_MAX, device=h.device))
    return states_from_partition(agg, batch, ev, keyinfo, hv[idx], idx,
                                 sel[idx], n)


# --------------------------------------------------------------------- #
# prehash hoist (regrow re-entries reuse the hashed keys)
# --------------------------------------------------------------------- #

def prehash_plan(agg: D.Aggregation, hash_offset: int):
    """If this radix-strategy aggregation can hoist its key hash, return
    ``(prehashed_dag, leaf_scan)``: the rebuilt dag whose leaf scan reads
    one extra int64 column at ``hash_offset`` (the stacked hash the
    client appends), plus the original leaf scan the hash program
    evaluates keys over; else None.  Hoistable: a plain
    TableScan(+Selection) chain."""
    if agg.strategy not in D.RADIX_STRATEGIES or agg.prehashed:
        return None
    chain = []
    cur = agg.child
    while isinstance(cur, D.Selection):
        chain.append(cur)
        cur = cur.child
    if not isinstance(cur, D.TableScan):
        return None
    new_scan = D.TableScan(cur.col_offsets + (hash_offset,),
                           cur.col_dtypes + (dt.bigint(False),))
    node: D.CopNode = new_scan
    for sel_node in reversed(chain):
        node = dataclasses.replace(sel_node, child=node)
    return dataclasses.replace(agg, child=node, prehashed=True), cur


class HashProgram:
    """The per-row key hash over the stacked scan columns, as int64 in
    the same (S, C) layout — run once per statement so every bucket-space
    regrow re-entry reuses it.  Dead and pad rows hash too (``sel`` masks
    them downstream), so the live counts are not needed."""

    def __init__(self, scan: D.TableScan, group_by: tuple):
        self.scan = scan
        # the keys-only dag naming what is hashed
        self.key_dag = D.Aggregation(scan, tuple(group_by), (),
                                     D.GroupStrategy.SCATTER, num_buckets=1)

    def __call__(self, cols) -> torch.Tensor:
        from ..expr.compile import Evaluator
        from .exec import DeviceBatch, group_keyinfo
        s, c = cols[0][0].shape
        flat = [(v.reshape(-1), True if m is None else m.reshape(-1))
                for v, m in cols]
        batch = DeviceBatch([flat[off] for off in self.scan.col_offsets],
                            True)
        dev = cols[0][0].device
        keyinfo = group_keyinfo(self.key_dag, batch, Evaluator(dev), {},
                                s * c)
        return key_hash(keyinfo, s * c, dev).reshape(s, c)


__all__ = ["agg_scatter_states", "scatter_permutation", "partition_key",
           "prehash_plan", "HashProgram"]

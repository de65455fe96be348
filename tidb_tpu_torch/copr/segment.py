# ported from tidb_tpu/copr/segment.py @ a9e9482
"""Key hash, the SEGMENT strategy, and the partition-to-states suffix of
the high-NDV strategies.

1. Group keys lower to canonical (zeroed value, null flag, order-
   preserving int64 code) triples (copr/exec.group_keyinfo).
2. The key tuple avalanche-hashes (the splitmix64 finalizer, folded per
   key) into one 64-bit word.  torch has no uint64 ``>>``, so the hash is
   carried as int64 with masked logical shifts; ``*`` and ``^`` wrap
   two's-complement, which gives the uint64 bits exactly.
3. SEGMENT (``agg_segment_states``) orders rows by the full hash with one
   single-key ``stable_argsort`` (ops/sort.py), dead rows parked at
   INT64_MAX; SCATTER (copr/radix.py) by a radix partition on its top
   bits; SORT (copr/exec.py) by the key tuple itself.
4. After the rows are permuted, segment boundaries fall where the hash
   (when there is one) or any true key code/null flag changes between
   adjacent live rows, so a 64-bit collision yields duplicate partial
   groups (merged by true key on the host), never a wrong merge.
5. Rows segment-reduce into a state table of the aggregation's
   ``state_capacity``, every lane in one ``group_reduce_lanes`` call;
   ``__ngroups__`` reports the observed segment
   count so the client can regrow the capacity and re-run on overflow.
"""

from __future__ import annotations

import torch

from ..ops.sort import stable_argsort
from ..ops.sortkeys import INT64_MAX, as_int64_bits
from . import dag as D


def _i64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


# splitmix64 finalizer constants (Steele et al.)
_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)

# calls of the avalanche key hash: tests pin that a bucket-space regrow
# sequence hashes the key tuple once (the hoisted hash program), not once
# per capacity re-entry
HASH_CALLS = [0]


def shr64(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 lanes read as uint64."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _finalize64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64 avalanche: every input bit reaches every output bit,
    so the top log2(B) bits are a uniform radix bucket id."""
    z = (z ^ shr64(z, 30)) * _MIX1
    z = (z ^ shr64(z, 27)) * _MIX2
    return z ^ shr64(z, 31)


def key_hash(keyinfo, n: int, device) -> torch.Tensor:
    """One 64-bit avalanche hash per row over the canonical key tuple,
    as int64.  NULL flags fold in, so a NULL key and a zero key land in
    different buckets with overwhelming probability."""
    HASH_CALLS[0] += 1
    h = torch.full((n,), _GOLDEN, dtype=torch.int64, device=device)
    for _vz, m, nullf, code in keyinfo:
        cu = code
        if m is not True:
            cu = cu + nullf.to(torch.int64) * _GOLDEN
        h = _finalize64(h ^ cu)
    return h


def batch_hash(agg: D.Aggregation, batch, keyinfo, n: int, device
               ) -> torch.Tensor:
    """Per-row int64 key hash: the hoisted last scan column when the
    aggregation is ``prehashed``, else freshly avalanched."""
    if agg.prehashed:
        return batch.cols[-1][0]
    return key_hash(keyinfo, n, device)


def states_from_partition(agg: D.Aggregation, batch, ev, keyinfo,
                          hv_s, idx, sel_s, n) -> dict:
    """Given rows permuted by ``idx`` so that equal keys are adjacent
    (with the permuted hash ``hv_s``, None for SORT, and live mask
    ``sel_s``), detect segment boundaries where the hash or any true key
    code/null flag changes and scatter-reduce each segment into a
    (state_capacity,) table.  Dead rows, and live rows of segments past
    the table, park at the sink slot (the capacity itself)."""
    from .cuda.group_reduce import Lane
    from .exec import _agg_lanes, _ensure_array, _gather, reduce_states
    B = agg.state_capacity
    dev = idx.device
    diff = torch.arange(n, device=dev) == 0
    if hv_s is not None:
        diff = diff | (hv_s != torch.roll(hv_s, 1))
    for _vz, m, nullf, code in keyinfo:
        cd_s = code[idx]
        diff = diff | (cd_s != torch.roll(cd_s, 1))
        if m is not True:
            nf_s = nullf[idx]
            diff = diff | (nf_s != torch.roll(nf_s, 1))
    newgrp = sel_s & diff
    gid = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    ngroups = newgrp.sum(dtype=torch.int64)
    gids = torch.where(sel_s & (gid < B), gid, B)

    def keep(src: torch.Tensor) -> torch.Tensor:
        bits = as_int64_bits(src)          # uint64 keys on their bits
        out = torch.zeros((B + 1,), dtype=bits.dtype, device=dev)
        out.index_put_((gids,), bits)
        return out[:B].view(src.dtype)

    keys: dict = {}
    for j, (vz, m, _nf, _cd) in enumerate(keyinfo):
        valid_src = (torch.ones(n, dtype=torch.bool, device=dev)
                     if m is True else m[idx])
        keys[f"k{j}"] = {"val": keep(_gather(vz, idx)),
                         "valid": keep(valid_src)}

    # aggregate over the permuted batch so arg rows line up with gids
    pcols = [(_gather(_ensure_array(v, n, dev), idx),
              True if m is True else m[idx]) for v, m in batch.cols]
    pmemo: dict = {}
    rows = Lane("count", None, sel_s)
    plan: dict = {"__rows__": rows}
    masks: dict = {}
    for i, a in enumerate(agg.aggs):
        if a.func == D.AggFunc.COUNT and a.arg is None:
            plan[f"a{i}"] = {"count": rows}
            continue
        av, am = ev.eval(a.arg, pcols, pmemo)
        plan[f"a{i}"] = _agg_lanes(a, av, am, sel_s, n, masks)
    tables = reduce_states(plan, gids, B)
    return {"__ngroups__": ngroups, "__rows__": tables.pop("__rows__"),
            **keys, **tables}


def agg_segment_states(agg: D.Aggregation, batch, ev, memo) -> dict:
    """SEGMENT-strategy per-device partial states: rows ordered by the
    full 64-bit key hash (bucket id = top bits, residual = low bits) with
    one single-key ``stable_argsort``, then the shared segment reduce
    into a (num_buckets,) group table."""
    from .exec import _sel_array, group_keyinfo
    B = agg.num_buckets
    if B <= 0 or B & (B - 1):
        raise ValueError(f"SEGMENT aggregation needs a power-of-two "
                         f"num_buckets, got {B}")
    n = len(batch.cols[0][0]) if batch.cols else 0
    sel = _sel_array(batch.sel, n, ev.device)
    keyinfo = group_keyinfo(agg, batch, ev, memo, n)
    hv = batch_hash(agg, batch, keyinfo, n, ev.device)
    # dead rows park at the tail; a live row hashing to INT64_MAX merely
    # interleaves with them, and its gids stay correct through sel_s
    hv = torch.where(sel, hv, torch.tensor(INT64_MAX, device=hv.device))
    idx = stable_argsort([hv])
    return states_from_partition(agg, batch, ev, keyinfo, hv[idx], idx,
                                 sel[idx], n)


__all__ = ["key_hash", "batch_hash", "states_from_partition",
           "agg_segment_states", "shr64", "HASH_CALLS"]

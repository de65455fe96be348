# ported from tidb_tpu/copr/join.py @ e08c981
"""Device-side m:n join expansion: sorted-range lookup + cumsum slots.

The build side stays SORTED by key, so a probe is two ``searchsorted``
calls (lo/hi) giving each probe row's match count, and output rows get
their slots from a cumsum: every step a dense vector op over a fixed
``out_capacity``, the true size returned for the client's regrow.

Dtypes: the JAX package's ``searchsorted`` gives int32, so its ``lo``,
``hi``, ``cnt``, slot cumsum and ``total`` are int32 and wrap past
2^31 - 1 output rows a device.  Here they are int64 (``torch.searchsorted``
and an integer ``torch.cumsum`` give int64), equal in value below that
bound; above it the client raises ``OverflowError`` (``check_join_rows``)
instead of running a join the reference would wrap.

Out-of-range gathers raise in torch where XLA clamps them, so every
gather index is clipped exactly where the JAX code clips it.
"""

from __future__ import annotations

import torch

from .exec import _gather

# output rows of one device's join: the reference's int32 slots wrap
# past this
MAX_JOIN_ROWS = 2 ** 31 - 1


def check_join_rows(need: int) -> None:
    """Raise ``OverflowError`` when one device's join output of ``need``
    rows passes the int32 slot range the JAX package computes it in."""
    if need > MAX_JOIN_ROWS:
        raise OverflowError(
            f"a device's join output of {need} rows exceeds the int32 "
            f"join slots ({MAX_JOIN_ROWS} rows) of the reference; use "
            "more devices")


def match_ranges(sorted_keys, n_live, probe_keys, probe_ok):
    """Per-probe-row match ranges against a sorted build-key array.

    sorted_keys: (B,) int64, live keys sorted ascending in the first
    ``n_live`` slots (the rest parked at INT64_MAX).  ``n_live``: a
    python int or a 0-d tensor.  probe_ok: bool mask (False = NULL/dead
    probe key: matches nothing).  Returns int64 ``(lo, hi, cnt)``;
    clamping lo/hi to n_live keeps the parked slots out of the ranges
    even when a live key equals INT64_MAX."""
    lo = torch.searchsorted(sorted_keys, probe_keys, side="left")
    hi = torch.searchsorted(sorted_keys, probe_keys, side="right")
    if isinstance(n_live, torch.Tensor):
        lo, hi = torch.minimum(lo, n_live), torch.minimum(hi, n_live)
    else:
        lo, hi = lo.clamp(max=n_live), hi.clamp(max=n_live)
    cnt = torch.where(probe_ok, hi - lo, 0)
    return lo, hi, cnt


def expand_slots(sel, cnt, kind: str, out_capacity: int):
    """Output slots of an inner/left expand join.

    sel: live probe rows; cnt: matches per probe row (0 where dead).
    Left joins give every live-but-unmatched probe row one
    null-extension slot.  Returns ``(probe_idx, offset, valid_out,
    is_ext, total)``: which probe row fills each of the
    ``out_capacity`` slots, its 0-based index into that row's match
    range, whether the slot holds a real row, whether it is a left
    join's null extension, and the true output size (0-d int64)."""
    n = cnt.shape[0]
    cnt_ext = torch.where(sel & (cnt == 0), 1, cnt) if kind == "left" \
        else cnt
    cum = torch.cumsum(cnt_ext, 0)
    starts = cum - cnt_ext
    total = cum[-1] if n else torch.zeros((), dtype=torch.int64,
                                          device=cnt.device)
    j = torch.arange(out_capacity, dtype=cum.dtype, device=cnt.device)
    pi = torch.searchsorted(cum, j, side="right").clamp(0, max(n - 1, 0))
    offset = j - starts[pi]
    valid_out = j < total
    is_ext = valid_out & (cnt[pi] == 0)
    return pi, offset, valid_out, is_ext, total


def gather_expand(batch_cols, sel, probe_key_ok, build_cols, perm,
                  lo, cnt, kind: str, out_capacity: int):
    """The expanded join output.

    batch_cols: probe ``[(value, mask | True)]``; build_cols likewise,
    row-aligned with ``perm``'s target space; perm: sorted order ->
    original build row; lo/cnt from ``match_ranges``.  Returns
    ``(out_cols, out_sel, total)``, out_cols = probe ++ build."""
    pi, offset, valid_out, is_ext, total = expand_slots(
        sel, cnt, kind, out_capacity)
    out_cols = []
    for v, m in batch_cols:
        out_cols.append((_gather(v, pi), True if m is True else m[pi]))
    b = perm.shape[0]
    brow = perm[(lo[pi] + offset).clamp(0, max(b - 1, 0))]
    bvalid_base = ~is_ext
    for v, m in build_cols:
        out_cols.append((_gather(v, brow), bvalid_base if m is True
                         else (m[brow] & bvalid_base)))
    return out_cols, valid_out, total


__all__ = ["match_ranges", "expand_slots", "gather_expand",
           "check_join_rows", "MAX_JOIN_ROWS"]

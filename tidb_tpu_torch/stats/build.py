# ported from tidb_tpu/stats/build.py @ 6298005
"""The ANALYZE kernel on the card.

For an int64-encoded column and its validity mask, one call computes:
count, null count, exact NDV, the equal-depth histogram (bounds,
cumulative counts, the repeats of each bound), the TopN (values and
counts), a 64-value KMV sketch of the distinct values' hashes, and a
4 x 2048 CM sketch.  The JAX package traces it as one XLA program
(``_stats_kernel``); the port runs it as eager torch ops on the
column's device around the hand-written kernels:

- the two-key sort (invalid rows last, then the value) on
  ``stable_argsort`` (ops/sort.py: the onesweep kernels on the card);
- the run counts and run maxima (``segment_sum``/``segment_max`` over
  the run ids) as one ``group_reduce_lanes`` table, and the CM counters
  (four hashed rows of scatter adds) as another, the hand-written
  ``group_reduce`` kernel on the card;
- TopN by a stable sort of the negated run counts, so that ties at the
  k-th place take the lowest run first, as ``lax.top_k`` does
  (``torch.topk`` promises no order for ties);
- the KMV minima by a sort of the unsigned hashes through their
  sign-flipped int64 bits;
- the rest (run boundaries, the bounds' binary search, the hashes) as
  eager torch ops.

The hashes are the splitmix64 finalizer in uint64, carried as int64
bits: products and sums wrap alike, and each right shift is an
arithmetic shift masked to the bits a logical one keeps (torch has no
uint64 ``>>``).  ``% 2048`` of an unsigned hash is ``& 2047``.

All dtypes reach the kernel as int64 in an order-preserving encoding
(ints, dates, times, decimals and dictionary codes already are; a
float64 goes through the sign-magnitude flip of ``sortable_f64``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..copr.cuda.group_reduce import Lane, group_reduce_lanes
from ..ops.sort import stable_argsort
from ..ops.sortkeys import INT64_MIN

FM_MAPS = 64          # fmsketch.go keeps one hash map; we keep 64 KMV-style
CM_DEPTH = 4          # cmsketch.go NewCMSketch(depth=..) default-ish
CM_WIDTH = 2048

_MASK64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    c &= _MASK64
    return c - (1 << 64) if c >= 1 << 63 else c


_M0 = _i64(0x9E3779B97F4A7C15)
_M1 = _i64(0xBF58476D1CE4E5B9)
_M2 = _i64(0x94D049BB133111EB)


def sortable_f64(a: np.ndarray) -> np.ndarray:
    """Map float64 to int64 preserving total order (NaN sorts last)."""
    i = a.view(np.int64).copy()
    i ^= (i >> 63) & np.int64(0x7FFFFFFFFFFFFFFF)
    return i


def unsortable_f64(i: int) -> float:
    v = np.int64(i)
    v ^= (v >> 63) & np.int64(0x7FFFFFFFFFFFFFFF)
    return float(np.array(v, dtype=np.int64).view(np.float64))


def _srl(h: torch.Tensor, k: int) -> torch.Tensor:
    """The uint64 ``h >> k`` of int64 bits: the arithmetic shift with
    the sign bits it copies masked off."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def _hash64(x: torch.Tensor, seed: int) -> torch.Tensor:
    """splitmix64 finalizer of int64 bits, as int64 bits."""
    h = (x + _i64(seed)) * _M0
    h = (h ^ _srl(h, 30)) * _M1
    h = (h ^ _srl(h, 27)) * _M2
    return h ^ _srl(h, 31)


def _searchsorted_left(arr: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(arr, q, side="left")`` step for step: its
    fixed ``ceil(log2(n + 1))`` halvings, so the result is the JAX
    package's even where ``arr`` is not sorted (a float column's keys
    past the ``2**62`` fill of its invalid rows)."""
    n = arr.shape[0]
    low = torch.zeros_like(q)
    high = torch.full_like(q, n)
    for _ in range(int(np.ceil(np.log2(n + 1)))):
        mid = (low + high) // 2
        left = q <= arr[mid.clamp(max=n - 1)]
        low, high = torch.where(left, low, mid), torch.where(left, mid, high)
    return high


def stats_kernel(x: torch.Tensor, valid: torch.Tensor, n_buckets: int,
                 n_top: int) -> dict:
    """The statistics of one int64 column ``x`` (n >= 1 rows) and its
    bool ``valid``, as tensors on their device (see the module
    docstring); the outputs of the JAX package's ``_stats_kernel``."""
    n = x.shape[0]
    dev = x.device
    nv = valid.sum(dtype=torch.int64)
    # two-key sort: invalid rows strictly after valid ones, values exact
    inv = (~valid).to(torch.int32)
    xs = x[stable_argsort([inv, x])]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    in_valid = pos < nv
    # run-length structure over the sorted valid region
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    boundary[1:] = xs[1:] != xs[:-1]
    ndv = (boundary & in_valid).sum(dtype=torch.int64)
    run_id = torch.cumsum(boundary, 0) - 1
    all_rows = torch.ones(n, dtype=torch.bool, device=dev)
    run_counts, run_vals = group_reduce_lanes(run_id, n, [
        Lane("count", None, in_valid),
        Lane("max", torch.where(in_valid, xs, -2 ** 62), all_rows)])
    # TopN: the largest run counts, ties lowest run first (lax.top_k);
    # tiny tables (fewer rows than n_top) pad with zero-count entries
    k = min(n_top, n)
    top_idx = stable_argsort([-run_counts])[:k]
    top_counts, top_vals = run_counts[top_idx], run_vals[top_idx]
    if k < n_top:
        pad = torch.zeros(n_top - k, dtype=torch.int64, device=dev)
        top_counts = torch.cat([top_counts, pad])
        top_vals = torch.cat([top_vals, pad])
    # equal-depth histogram: bound j at sorted position min((j+1)*size, nv)-1
    size = ((nv + n_buckets - 1) // n_buckets).clamp(min=1)
    ub_pos = torch.minimum(
        (torch.arange(n_buckets, dtype=torch.int64, device=dev) + 1) * size,
        nv) - 1
    bounds = xs[ub_pos.clamp(0, n - 1)]
    cum_counts = ub_pos + 1                      # rows <= bounds[j]
    # repeats of each bound = pos+1 - first position of that value
    xs_clean = torch.where(in_valid, xs, 2 ** 62)
    first_pos = _searchsorted_left(xs_clean, bounds)
    repeats = (cum_counts - first_pos).clamp(min=0)
    # KMV sketch: the FM_MAPS least hashes over the DISTINCT values (run
    # starts of the sorted column), unsigned order by the sign flip
    h = torch.where(boundary & in_valid, _hash64(xs, 0x5bd1e995), -1)
    flipped = h ^ INT64_MIN
    kmv = h[stable_argsort([flipped])[:FM_MAPS]].view(torch.uint64)
    # CM sketch: CM_DEPTH x CM_WIDTH counters, one table of all rows
    cm_gids = torch.cat([
        (_hash64(xs, 0xABCD + d * 7919) & (CM_WIDTH - 1)) + d * CM_WIDTH
        for d in range(CM_DEPTH)])
    (cm,) = group_reduce_lanes(cm_gids, CM_DEPTH * CM_WIDTH, [
        Lane("count", None, in_valid.repeat(CM_DEPTH))])
    return dict(count=nv, min_val=xs[0], null_count=n - nv, ndv=ndv,
                bounds=bounds, cum_counts=cum_counts, repeats=repeats,
                top_vals=top_vals, top_counts=top_counts, kmv=kmv,
                cm=cm.reshape(CM_DEPTH, CM_WIDTH))


def build_column_stats(data: np.ndarray, valid: np.ndarray,
                       n_buckets: int = 64, n_top: int = 16,
                       device="cuda") -> dict:
    """Run the ANALYZE kernel on ``device``; returns a plain-numpy dict."""
    if data.dtype == np.float64:
        enc = sortable_f64(data)
    else:
        enc = data.astype(np.int64, copy=False)
    x = torch.from_numpy(np.ascontiguousarray(enc)).to(device)
    v = torch.from_numpy(np.ascontiguousarray(valid, dtype=bool)).to(device)
    out = stats_kernel(x, v, int(n_buckets), int(n_top))
    return {k: t.cpu().numpy() for k, t in out.items()}


__all__ = ["FM_MAPS", "CM_DEPTH", "CM_WIDTH", "sortable_f64",
           "unsortable_f64", "stats_kernel", "build_column_stats"]

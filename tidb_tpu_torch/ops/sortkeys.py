# ported from tidb_tpu/ops/sortkeys.py @ a9e9482
"""Order-preserving int64 sort-key encodings: every orderable SQL value
maps to an int64 whose natural order equals SQL order, so the device
sorts (TopN, the SORT and SEGMENT group-bys) sort one int64 lane per key
(ops/sort.py)."""

from __future__ import annotations

import torch

INT64_MIN = -(2 ** 63)
INT64_MAX = 2 ** 63 - 1


def float_sortable(v: torch.Tensor) -> torch.Tensor:
    """Bijective IEEE754 double -> int64 with the same total order (the
    standard radix-sort transform; -NaN sorts lowest, +NaN highest).
    Positive floats keep their bit pattern; negative ones reverse their
    order: ``INT64_MIN - 1 - b``, computed as ``-(b + 1) + INT64_MIN`` to
    stay inside int64."""
    b = v.to(torch.float64).view(torch.int64)
    return torch.where(b < 0, -(b + 1) + INT64_MIN, b)


def as_int64_bits(val: torch.Tensor) -> torch.Tensor:
    """A uint64 tensor as the int64 tensor of the same bits (a view: torch
    has few uint64 kernels, and none for ``>>``, ``<`` or ``index_put_``
    on the CPU); any other tensor unchanged."""
    return val.view(torch.int64) if val.dtype == torch.uint64 else val


def sortable_int64(val: torch.Tensor, kind_is_float: bool,
                   kind_is_unsigned: bool = False) -> torch.Tensor:
    """Map a device value tensor to order-preserving int64."""
    if kind_is_float:
        return float_sortable(val)
    if kind_is_unsigned:
        # uint64 order as int64: add 2^63 (a sign-bit flip), on the bits
        return as_int64_bits(val).to(torch.int64) + INT64_MIN
    return val.to(torch.int64)


__all__ = ["float_sortable", "sortable_int64", "as_int64_bits",
           "INT64_MIN", "INT64_MAX"]

# ported from tidb_tpu/ops/sortkeys.py @ a9e9482
"""Order-preserving int64 sort-key encodings: every orderable SQL value
maps to an int64 whose natural order equals SQL order.  Signed integer
lanes (ints, decimals, dates, dict codes) only so far; float and
unsigned keys arrive with a later slice of the port (ROADMAP.md,
Queue 1)."""

from __future__ import annotations

import torch

INT64_MIN = -(2 ** 63)
INT64_MAX = 2 ** 63 - 1


def sortable_int64(val: torch.Tensor, kind_is_float: bool,
                   kind_is_unsigned: bool = False) -> torch.Tensor:
    """Map a device value tensor to order-preserving int64."""
    if kind_is_float or kind_is_unsigned:
        raise NotImplementedError(
            "float and BIGINT UNSIGNED keys arrive with a later slice of "
            "the port (ROADMAP.md, Queue 1)")
    return val.to(torch.int64)


__all__ = ["sortable_int64", "INT64_MIN", "INT64_MAX"]

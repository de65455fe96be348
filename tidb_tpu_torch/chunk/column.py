# ported from tidb_tpu/chunk/column.py @ a9e9482
"""Arrow-layout columnar data plane: ``Column`` and ``StringDict``.

A column is a dense numpy buffer plus a validity mask (True = non-NULL);
strings are codes into a sorted, order-preserving dictionary.  Host-only:
device placement happens in ``store/columnar.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..types import dtypes as dt


class StringDict:
    """Sorted, order-preserving string dictionary (code order == bin
    collation)."""

    __slots__ = ("values", "_index")

    def __init__(self, values: Sequence[str] = ()):
        self.values: list[str] = sorted(set(values))
        self._index = {v: i for i, v in enumerate(self.values)}

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, s: str) -> int:
        """Exact code, or -1 if absent."""
        return self._index.get(s, -1)

    def decode(self, code: int) -> str:
        return self.values[code]


@dataclass
class Column:
    """One column: dense representation + validity mask (True = non-NULL)."""

    dtype: dt.DataType
    data: np.ndarray
    validity: np.ndarray  # bool, same length as data
    dictionary: Optional[StringDict] = None

    def __post_init__(self):
        if self.data.ndim != 1 or self.validity.shape != self.data.shape:
            raise ValueError(
                f"column data {self.data.shape} and validity "
                f"{self.validity.shape} must be equal 1-d shapes")

    def __len__(self) -> int:
        return len(self.data)

    @classmethod
    def from_numpy(cls, dtype: dt.DataType, data: np.ndarray,
                   validity: Optional[np.ndarray] = None,
                   dictionary: Optional[StringDict] = None) -> "Column":
        if validity is None:
            validity = np.ones(len(data), dtype=bool)
        return cls(dtype, np.asarray(data, dtype=dtype.np_dtype()),
                   np.asarray(validity, dtype=bool), dictionary)

    def narrowed(self) -> np.ndarray:
        """Smallest-width int array holding exactly `data`'s values —
        the physical scan representation (frame-of-reference widths).
        The evaluator re-widens where the logical width matters
        (expr/compile.py ``_iwiden``).  Cached: columns are immutable."""
        ph = getattr(self, "_phys", None)
        if ph is not None:
            return ph
        d = self.data
        # only signed ints narrow: narrowing unsigned to signed would
        # break uint64 compare/arith semantics
        if d.dtype.kind != "i" or d.dtype.itemsize == 1 or not len(d):
            self._phys = d
            return d
        lo, hi = int(d.min()), int(d.max())
        for t in (np.int8, np.int16, np.int32):
            if np.dtype(t).itemsize >= d.dtype.itemsize:
                break
            ii = np.iinfo(t)
            if ii.min <= lo and hi <= ii.max:
                self._phys = d.astype(t)
                return self._phys
        self._phys = d
        return d


__all__ = ["StringDict", "Column"]

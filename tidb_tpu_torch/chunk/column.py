# ported from tidb_tpu/chunk/column.py @ 9d319cb
# (to_python's one-call decode of integers and floats: this port's)
"""Arrow-layout columnar data plane: Column / Chunk.

Reference analog: pkg/util/chunk/column.go:71-81 (Column{nullBitmap, offsets,
data}) and chunk.go — the unit of all data movement in the engine.  The TPU
rebuild keeps the same contract (dense fixed-width buffer + validity bitmap)
but stores the buffer as a numpy array ready for zero-copy device transfer,
and replaces variable-length string buffers with sorted-dictionary codes
(SURVEY.md §7): fixed-width on device, order-preserving for utf8mb4_bin.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence

import numpy as np

from ..types import dtypes as dt
from ..types import decimal as dec
from ..types import temporal as tmp


class StringDict:
    """Sorted, order-preserving string dictionary (code order == bin collation).

    Replaces the reference's var-len data+offsets string columns
    (chunk/column.go) and host-side collation compares (pkg/util/collate) —
    sortkeys are materialized once at encode time, device compares ints.
    """

    __slots__ = ("values", "_index", "_rank_cache")

    def __init__(self, values: Sequence[str] = ()):
        self.values: list[str] = sorted(set(values))
        self._index = {v: i for i, v in enumerate(self.values)}
        self._rank_cache: dict = {}   # collation -> collate.RankTable

    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, s: str) -> int:
        """Exact code, or -1 if absent."""
        return self._index.get(s, -1)

    def lower_bound(self, s: str) -> int:
        """Smallest code whose value >= s (for range predicates on strings)."""
        return bisect.bisect_left(self.values, s)

    def upper_bound(self, s: str) -> int:
        return bisect.bisect_right(self.values, s)

    def decode(self, code: int) -> str:
        return self.values[code]

    def encode_array(self, strings: Iterable[Optional[str]]) -> tuple[np.ndarray, np.ndarray]:
        codes = np.empty(len(strings), dtype=np.int32)  # type: ignore[arg-type]
        valid = np.ones(len(strings), dtype=bool)  # type: ignore[arg-type]
        for i, s in enumerate(strings):
            if s is None:
                codes[i] = 0
                valid[i] = False
            else:
                codes[i] = self._index[s]
        return codes, valid

    @classmethod
    def build(cls, strings: Iterable[Optional[str]]) -> "StringDict":
        return cls([s for s in strings if s is not None])


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

    # ------------------------------------------------------------------ #

    @classmethod
    def from_values(cls, dtype: dt.DataType, values: Sequence[Any],
                    dictionary: Optional[StringDict] = None) -> "Column":
        """Build from python values (None = NULL), encoding per dtype."""
        n = len(values)
        valid = np.array([v is not None for v in values], dtype=bool)
        kind = dtype.kind
        if kind == dt.TypeKind.STRING:
            d = dictionary or StringDict.build(values)
            codes, valid = d.encode_array(list(values))
            return cls(dtype, codes, valid, d)
        if kind == dt.TypeKind.VECTOR:
            out = np.empty(n, dtype=object)
            for i, v in enumerate(values):
                if v is None:
                    continue
                if isinstance(v, str):
                    out[i] = dt.parse_vector_text(v, dtype.prec)
                else:
                    arr = np.asarray(v, dtype=np.float32)
                    if dtype.prec > 0 and len(arr) != dtype.prec:
                        raise ValueError(
                            f"vector has {len(arr)} dimensions, "
                            f"expected {dtype.prec}")
                    out[i] = arr
            return cls(dtype, out, valid)
        out = np.zeros(n, dtype=dtype.np_dtype())
        for i, v in enumerate(values):
            if v is None:
                continue
            if kind == dt.TypeKind.DECIMAL:
                out[i] = dec.encode(v, dtype.scale)
            elif kind == dt.TypeKind.DATE:
                out[i] = v if isinstance(v, (int, np.integer)) else tmp.parse_date(str(v))
            elif kind == dt.TypeKind.DATETIME:
                out[i] = v if isinstance(v, (int, np.integer)) else tmp.parse_datetime(str(v))
            elif kind == dt.TypeKind.ENUM and not isinstance(v, (int, np.integer)):
                ix = dt.enum_index(dtype, str(v))
                if ix < 0:
                    raise ValueError(f"invalid ENUM value {v!r}")
                out[i] = ix
            elif kind == dt.TypeKind.SET and not isinstance(v, (int, np.integer)):
                m = dt.set_mask(dtype, str(v))
                if m < 0:
                    raise ValueError(f"invalid SET value {v!r}")
                out[i] = m
            else:
                out[i] = v
        return cls(dtype, out, valid)

    @classmethod
    def from_numpy(cls, dtype: dt.DataType, data: np.ndarray,
                   validity: Optional[np.ndarray] = None,
                   dictionary: Optional[StringDict] = None) -> "Column":
        if validity is None:
            validity = np.ones(len(data), dtype=bool)
        return cls(dtype, np.asarray(data, dtype=dtype.np_dtype()),
                   np.asarray(validity, dtype=bool), dictionary)

    # ------------------------------------------------------------------ #

    # the kinds whose values decode one by one (the rest are integers or
    # floats, decoded in one ``tolist``)
    _DECODED_KINDS = frozenset((
        dt.TypeKind.DECIMAL, dt.TypeKind.STRING, dt.TypeKind.DATE,
        dt.TypeKind.DATETIME, dt.TypeKind.ENUM, dt.TypeKind.SET,
        dt.TypeKind.VECTOR, dt.TypeKind.TIME))

    def to_python(self) -> list[Any]:
        """Decode to python values (None for NULLs) — result-set surface."""
        kind = self.dtype.kind
        if kind not in self._DECODED_KINDS and self.data.dtype.kind in (
                "f" if kind in (dt.TypeKind.FLOAT64, dt.TypeKind.FLOAT32)
                else "iu"):
            out = self.data.tolist()     # python ints / floats, as below
            for i in np.flatnonzero(~np.asarray(self.validity)).tolist():
                out[i] = None
            return out
        out: list[Any] = []
        for i in range(len(self.data)):
            if not self.validity[i]:
                out.append(None)
            elif kind == dt.TypeKind.DECIMAL:
                out.append(dec.decode(int(self.data[i]), self.dtype.scale))
            elif kind == dt.TypeKind.STRING:
                out.append(self.dictionary.decode(int(self.data[i])))
            elif kind == dt.TypeKind.DATE:
                out.append(tmp.days_to_date(int(self.data[i])))
            elif kind == dt.TypeKind.DATETIME:
                out.append(tmp.datetime_to_string(int(self.data[i])))
            elif kind in (dt.TypeKind.FLOAT64, dt.TypeKind.FLOAT32):
                out.append(float(self.data[i]))
            elif kind == dt.TypeKind.ENUM:
                ix = int(self.data[i])
                out.append(self.dtype.members[ix - 1]
                           if 1 <= ix <= len(self.dtype.members) else "")
            elif kind == dt.TypeKind.SET:
                m = int(self.data[i])
                out.append(",".join(
                    v for j, v in enumerate(self.dtype.members)
                    if m >> j & 1))
            elif kind == dt.TypeKind.VECTOR:
                out.append(dt.vector_to_text(self.data[i]))
            elif kind == dt.TypeKind.TIME:
                out.append(tmp.duration_to_string(int(self.data[i])))
            else:
                out.append(int(self.data[i]))
        return out

    def all_valid(self) -> bool:
        """Cached validity.all() — hot scan chains ask per chunk, and the
        reduce over millions of bools per column per chunk adds up."""
        av = getattr(self, "_all_valid", None)
        if av is None:
            av = self._all_valid = bool(self.validity.all())
        return av

    def narrowed(self) -> np.ndarray:
        """Smallest-width int array holding exactly `data`'s values —
        the physical scan representation (frame-of-reference encoding,
        the TiFlash compressed-column-store analog, SURVEY.md §2.8).
        Filters and H2D transfers then move 1-4 bytes/row instead of 8;
        the expression compiler re-widens where the logical (int64/
        decimal/temporal) width matters (expr/compile.py _iwiden).
        Cached: snapshots are immutable, so one min/max pass amortizes
        over every query against the epoch."""
        ph = getattr(self, "_phys", None)
        if ph is not None:
            return ph
        d = self.data
        # only signed ints narrow: narrowing unsigned to signed would
        # break the evaluator's uint64 compare/arith semantics
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

    def take(self, idx: np.ndarray) -> "Column":
        return Column(self.dtype, self.data[idx], self.validity[idx], self.dictionary)

    def slice(self, start: int, stop: int) -> "Column":
        col = Column(self.dtype, self.data[start:stop],
                     self.validity[start:stop], self.dictionary)
        # inherit the parent's narrow decision (and validity flag) so every
        # row-range view of one snapshot shares one physical width — stream
        # batches must all compile to the SAME program shape
        ph = getattr(self, "_phys", None)
        if ph is not None:
            col._phys = ph[start:stop]
        av = getattr(self, "_all_valid", None)
        if av:
            col._all_valid = True
        return col

    def pad_to(self, capacity: int) -> "Column":
        """Pad with NULL rows to a fixed capacity (static-shape batching —
        the TPU analog of the reference's 1024-row chunks,
        exec/executor.go MaxChunkSize)."""
        n = len(self.data)
        if n == capacity:
            return self
        assert n < capacity
        data = np.zeros(capacity, dtype=self.data.dtype)
        data[:n] = self.data
        valid = np.zeros(capacity, dtype=bool)
        valid[:n] = self.validity
        return Column(self.dtype, data, valid, self.dictionary)

    @classmethod
    def concat(cls, cols: Sequence["Column"]) -> "Column":
        assert cols
        # NOTE: assumes shared dictionary for string columns (true within a
        # table snapshot; see store/columnar.py).
        return cls(cols[0].dtype,
                   np.concatenate([c.data for c in cols]),
                   np.concatenate([c.validity for c in cols]),
                   cols[0].dictionary)


@dataclass
class Chunk:
    """A batch of rows as named columns (reference: chunk.Chunk)."""

    names: list[str]
    columns: list[Column]

    def __post_init__(self):
        assert len(self.names) == len(self.columns)
        if self.columns:
            n = len(self.columns[0])
            assert all(len(c) == n for c in self.columns)

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    def col(self, name: str) -> Column:
        return self.columns[self.names.index(name)]

    def to_rows(self) -> list[tuple]:
        cols = [c.to_python() for c in self.columns]
        return list(zip(*cols)) if cols else []

    def take(self, idx: np.ndarray) -> "Chunk":
        return Chunk(self.names, [c.take(idx) for c in self.columns])

    @classmethod
    def concat(cls, chunks: Sequence["Chunk"]) -> "Chunk":
        assert chunks
        names = chunks[0].names
        cols = [Column.concat([ch.columns[i] for ch in chunks])
                for i in range(len(names))]
        return cls(names, cols)


__all__ = ["StringDict", "Column", "Chunk"]

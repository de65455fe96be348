# ported from tidb_tpu/store/columnar.py @ a9e9482
"""Columnar shard store: the device-resident table representation.

A table snapshot is S shards of fixed capacity C, stacked as (S, C)
arrays at each column's narrow physical width (``Column.narrowed``),
with a per-shard live-row count instead of compaction.  ``device_cols``
places the stacks on the port's devices once and caches them, keyed by
the devices, the snapshot's epoch and its placement's epoch.  A snapshot
with a ``placement`` (store/placement.py; a catalog table's always has
one) stacks each device's shards in the order ``device_slots`` gives.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from .. import EXCHANGE, unported
from ..chunk.column import Column, StringDict
from ..types import dtypes as dt


def _pow2_at_least(n: int) -> int:
    c = 1
    while c < n:
        c <<= 1
    return c


@dataclass
class ColumnarSnapshot:
    """Immutable columnar snapshot of one table at an epoch."""
    names: list[str]
    dtypes: list[dt.DataType]
    columns: list[Column]              # full-length host columns
    epoch: int = 0
    n_shards: int = 8
    min_capacity: int = 1024
    # shard->store topology (store/placement.py); None = the even split
    placement: Any = None

    _device_cache: dict = field(default_factory=dict, repr=False)

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def dictionaries(self) -> dict[int, StringDict]:
        return {i: c.dictionary for i, c in enumerate(self.columns)
                if c.dictionary is not None}

    def _even_ranges(self) -> list:
        s = self.n_shards
        n = self.num_rows
        per = -(-n // s) if n else 0
        return [(min(i * per, n), min(i * per + per, n)) for i in range(s)]

    def _placement_ranges(self, n_dev: int) -> list:
        """Slot row-ranges in device order (D*K grid, K = max shards on
        any device; short devices pad with empty slots)."""
        per_dev = self.placement.device_slots(n_dev)
        k = max((len(lst) for lst in per_dev), default=1) or 1
        ranges = []
        for lst in per_dev:
            ranges += [(s.lo, s.hi) for s in lst]
            ranges += [(0, 0)] * (k - len(lst))
        return ranges

    def _stacked_ranges(self, ranges) -> tuple[list, np.ndarray]:
        cap = max(_pow2_at_least(max((hi - lo for lo, hi in ranges),
                                     default=0)), self.min_capacity)
        counts = np.array([hi - lo for lo, hi in ranges], np.int64)
        cols = []
        for c in self.columns:
            if c.data.dtype == object:
                # wide (19-65 digit) decimal: host-only object ints; the
                # slot only keeps TableScan offsets stable
                cols.append((np.zeros((len(ranges), cap), np.int8), None))
                continue
            phys = c.narrowed()
            data = np.zeros((len(ranges), cap), dtype=phys.dtype)
            valid = np.zeros((len(ranges), cap), dtype=bool)
            for i, (lo, hi) in enumerate(ranges):
                if hi > lo:
                    data[i, : hi - lo] = phys[lo:hi]
                    valid[i, : hi - lo] = c.validity[lo:hi]
            live = np.arange(cap)[None, :] < counts[:, None]
            all_valid = bool(valid[live].all())
            cols.append((data, None if all_valid else valid))
        return cols, counts

    def device_cols(self, devices: Sequence[torch.device]
                    ) -> tuple[list, torch.Tensor]:
        """Stacked ``[(data (S, C), valid (S, C) | None), ...]`` and the
        ``(S,)`` int64 live counts, on the devices' one physical device.
        S is padded with empty shards to a multiple of ``len(devices)``
        so every logical device gets an equal block of shards."""
        devices = tuple(devices)
        if len(set(devices)) != 1:
            raise unported("shards spread over several physical devices",
                           EXCHANGE)
        p_epoch = self.placement.epoch if self.placement is not None else -1
        key = (devices, self.epoch, p_epoch)
        if key in self._device_cache:
            return self._device_cache[key]
        n_dev = len(devices)
        host_cols, counts = self._stacked_ranges(
            self._even_ranges() if self.placement is None
            else self._placement_ranges(n_dev))
        s = len(counts)
        s_pad = -(-s // n_dev) * n_dev
        if s_pad != s:
            counts = np.concatenate([counts, np.zeros(s_pad - s, np.int64)])
            host_cols = [
                (np.concatenate([d, np.zeros((s_pad - s, d.shape[1]),
                                             d.dtype)]),
                 None if v is None else
                 np.concatenate([v, np.zeros((s_pad - s, v.shape[1]), bool)]))
                for d, v in host_cols]
        dev = devices[0]
        put = ([(torch.from_numpy(d).to(dev),
                 None if v is None else torch.from_numpy(v).to(dev))
                for d, v in host_cols],
               torch.from_numpy(counts).to(dev))
        self._device_cache.clear()     # one placement resident at a time
        self._device_cache[key] = put
        return put


def snapshot_from_columns(names: Sequence[str], cols: Sequence[Column],
                          n_shards: int = 8, epoch: int = 0,
                          min_capacity: int = 1024,
                          placement=None) -> ColumnarSnapshot:
    return ColumnarSnapshot(list(names), [c.dtype for c in cols], list(cols),
                            epoch=epoch, n_shards=n_shards,
                            min_capacity=min_capacity, placement=placement)


def snapshot_from_numpy(names: Sequence[str], specs: Sequence[dict],
                        n_shards: int = 8,
                        min_capacity: int = 1024) -> ColumnarSnapshot:
    """Build a snapshot from plain numpy column specs — the seam that
    carries a table made elsewhere (for example by the JAX package)
    into the port without importing it.  Each spec is a dict:

    - ``kind``: a ``TypeKind`` name (``"INT64"``, ``"DECIMAL"``, ...);
    - ``nullable`` (default True), ``prec`` and ``scale`` (default -1);
    - ``data``: the dense numpy buffer in device encoding;
    - ``validity``: bool array, True = non-NULL (default all valid);
    - ``dictionary``: the sorted string values of a STRING column."""
    cols = []
    for spec in specs:
        t = dt.DataType(dt.TypeKind[spec["kind"]],
                        bool(spec.get("nullable", True)),
                        int(spec.get("prec", -1)),
                        int(spec.get("scale", -1)))
        d = spec.get("dictionary")
        cols.append(Column.from_numpy(
            t, np.asarray(spec["data"]), spec.get("validity"),
            StringDict(d) if d is not None else None))
    return snapshot_from_columns(names, cols, n_shards=n_shards,
                                 min_capacity=min_capacity)


__all__ = ["ColumnarSnapshot", "snapshot_from_columns",
           "snapshot_from_numpy"]

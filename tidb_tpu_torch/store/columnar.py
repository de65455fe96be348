# ported from tidb_tpu/store/columnar.py @ a9e9482
"""Columnar shard store: the device-resident table representation.

A table snapshot is S shards of fixed capacity C, stacked as (S, C)
arrays at each column's narrow physical width (``Column.narrowed``),
with a per-shard live-row count instead of compaction.  ``device_cols``
places the stacks on the port's devices once and caches them, keyed by
the devices, the snapshot's epoch and its placement's epoch.  A snapshot
with a ``placement`` (store/placement.py; a catalog table's always has
one) stacks each device's shards in the order ``device_slots`` gives.

A snapshot bigger than the device memory the client may use streams
(``row_batches``: row-range ``view``s that share one program shape);
each batch is placed by ``device_put_uncached``, outside the cache.  On
a CUDA device that placement stacks the batch into pinned host memory
and queues non-blocking copies on the current stream, so the host can
stack the next batch while the card copies and reduces this one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

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


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


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

    def shard_layout(self) -> tuple[int, int, np.ndarray]:
        """(n_shards, capacity, counts[n_shards]) of the even split: the
        layout the cost model prices (analysis/copcost.snapshot_layout);
        capacity is a power of two, at least ``min_capacity``."""
        s = self.n_shards
        n = self.num_rows
        per = -(-n // s) if n else 0
        cap = max(_pow2_at_least(per), self.min_capacity)
        counts = np.minimum(np.maximum(n - np.arange(s) * per, 0), per)
        return s, cap, counts.astype(np.int64)

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

    def _stacked_ranges(self, ranges, empty=np.empty
                        ) -> tuple[list, np.ndarray]:
        """The (S, C) stacks of ``ranges``, one shard a range, each slot
        past a shard's rows zeroed; ``empty`` ((shape, dtype) -> an
        uninitialized array) makes the buffers."""
        cap = max(_pow2_at_least(max((hi - lo for lo, hi in ranges),
                                     default=0)), self.min_capacity)
        counts = np.array([hi - lo for lo, hi in ranges], np.int64)
        cols = []
        for c in self.columns:
            if c.data.dtype == object:
                # wide (19-65 digit) decimal: host-only object ints; the
                # slot only keeps TableScan offsets stable
                z = empty((len(ranges), cap), np.int8)
                z[...] = 0
                cols.append((z, None))
                continue
            phys = c.narrowed()
            data = empty((len(ranges), cap), phys.dtype)
            valid = empty((len(ranges), cap), bool)
            for i, (lo, hi) in enumerate(ranges):
                n = max(hi - lo, 0)
                data[i, :n] = phys[lo:hi]
                valid[i, :n] = c.validity[lo:hi]
                data[i, n:] = 0
                valid[i, n:] = False
            live = np.arange(cap)[None, :] < counts[:, None]
            all_valid = bool(valid[live].all())
            cols.append((data, None if all_valid else valid))
        return cols, counts

    def _host_stacks(self, n_dev: int, empty=np.empty
                     ) -> tuple[list, np.ndarray]:
        """The host stacks of this snapshot on ``n_dev`` logical devices:
        S padded with empty shards to a multiple of ``n_dev``, so every
        logical device gets an equal block of shards."""
        ranges = (self._even_ranges() if self.placement is None
                  else self._placement_ranges(n_dev))
        ranges = ranges + [(0, 0)] * (-len(ranges) % n_dev)
        return self._stacked_ranges(ranges, empty)

    @staticmethod
    def _one_device(devices) -> torch.device:
        if len(set(devices)) != 1:
            raise unported("shards spread over several physical devices",
                           EXCHANGE)
        return devices[0]

    def device_cols(self, devices: Sequence[torch.device]
                    ) -> tuple[list, torch.Tensor]:
        """Stacked ``[(data (S, C), valid (S, C) | None), ...]`` and the
        ``(S,)`` int64 live counts, on the devices' one physical device.
        S is padded with empty shards to a multiple of ``len(devices)``
        so every logical device gets an equal block of shards."""
        devices = tuple(devices)
        dev = self._one_device(devices)
        p_epoch = self.placement.epoch if self.placement is not None else -1
        key = (devices, self.epoch, p_epoch)
        if key in self._device_cache:
            return self._device_cache[key]
        host_cols, counts = self._host_stacks(len(devices))
        put = ([(torch.from_numpy(d).to(dev),
                 None if v is None else torch.from_numpy(v).to(dev))
                for d, v in host_cols],
               torch.from_numpy(counts).to(dev))
        self._device_cache.clear()     # one placement resident at a time
        self._device_cache[key] = put
        # lifetime contract (analysis/lifetime): these tensors are
        # PERSISTENT — reused across queries and pages — so a donating
        # launch over them is rejected at sched admission before any
        # launch.  The registration also credits the live memory ledger
        # (obs/hbm) with the resident footprint — tensor METADATA only,
        # never a device sync — and the ledger's weakref death callback
        # debits it when the cache entry is collected.
        from ..analysis.lifetime import register_resident
        from ..sched.task import mesh_fingerprint
        nbytes = sum(_nbytes(d) + (_nbytes(v) if v is not None else 0)
                     for d, v in put[0]) + _nbytes(put[1])
        register_resident(put[1], nbytes=nbytes,
                          fingerprint=mesh_fingerprint(devices))
        return put

    def device_put_uncached(self, devices: Sequence[torch.device],
                            record: Optional[dict] = None
                            ) -> tuple[list, torch.Tensor]:
        """A placement like ``device_cols`` that never enters the resident
        cache: the streaming path (rows >> device memory) places one
        batch at a time and lets it free once its program consumed it
        (SURVEY.md §5.7 paging analog).

        On a CUDA device each stack is built in pinned host memory and
        copied with ``non_blocking=True`` on the current stream, where the
        batch's kernels run after the copies: the call returns once the
        copies are queued.  The pinned buffers return to torch's
        pinned-memory cache only once their copies are done.

        ``record``, when given, receives ``stack_s``, the seconds of the
        host stacking, and on a CUDA device ``h2d``, two timing events on
        the stream around the copies."""
        devices = tuple(devices)
        dev = self._one_device(devices)
        record = {} if record is None else record
        t0 = time.perf_counter()
        if dev.type != "cuda":
            host_cols, counts = self._host_stacks(len(devices))
            record["stack_s"] = time.perf_counter() - t0
            return ([(torch.from_numpy(d).to(dev),
                      None if v is None else torch.from_numpy(v).to(dev))
                     for d, v in host_cols],
                    torch.from_numpy(counts).to(dev))
        pinned: dict = {}

        def empty(shape, dtype):
            dtype = np.dtype(dtype)
            buf = torch.empty(int(np.prod(shape)) * dtype.itemsize,
                              dtype=torch.uint8, pin_memory=True)
            arr = buf.numpy().view(dtype).reshape(shape)
            pinned[id(arr)] = buf
            return arr

        host_cols, counts = self._host_stacks(len(devices), empty)
        record["stack_s"] = time.perf_counter() - t0

        def put(arr):
            t_dtype = torch.from_numpy(arr[:0]).dtype
            return (pinned[id(arr)].to(dev, non_blocking=True)
                    .view(t_dtype).view(arr.shape))

        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record(torch.cuda.current_stream(dev))
        cols = [(put(d), None if v is None else put(v))
                for d, v in host_cols]
        dev_counts = torch.from_numpy(counts).pin_memory().to(
            dev, non_blocking=True)
        events[1].record(torch.cuda.current_stream(dev))
        record["h2d"] = events
        return cols, dev_counts

    # ---------------- streaming batches (rows >> device memory) ------ #

    def device_bytes(self) -> int:
        """Stacked device footprint: S x capacity x (itemsize + validity),
        at the narrow physical width actually placed on device."""
        s, cap, _ = self.shard_layout()
        return s * cap * sum(c.narrowed().dtype.itemsize + 1
                             for c in self.columns)

    def view(self, lo: int, hi: int,
             min_capacity: int = 0) -> "ColumnarSnapshot":
        """Zero-copy row-range view (same shard count; forced capacity so
        every batch of a stream compiles to ONE program shape)."""
        return ColumnarSnapshot(
            self.names, self.dtypes,
            [c.slice(lo, hi) for c in self.columns], epoch=self.epoch,
            n_shards=self.n_shards,
            min_capacity=max(min_capacity, self.min_capacity))

    def row_batches(self, max_bytes: int) -> Optional[list]:
        """Split into row-range views whose device footprint fits
        max_bytes, or None when the whole snapshot already fits."""
        if max_bytes <= 0 or self.device_bytes() <= max_bytes or \
                not self.num_rows:
            return None
        # device_bytes() above already narrowed every column, so views
        # sliced off here inherit one shared physical width per column
        per_row = sum(c.narrowed().dtype.itemsize + 1 for c in self.columns)
        # pow2 capacity rounding can inflate a batch up to 2x: size for it
        rows = max(int(max_bytes // (2 * per_row)), self.n_shards)
        per_shard_cap = max(_pow2_at_least(-(-rows // self.n_shards)),
                            self.min_capacity)
        rows = per_shard_cap * self.n_shards
        return [self.view(lo, min(lo + rows, self.num_rows), per_shard_cap)
                for lo in range(0, self.num_rows, rows)]


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

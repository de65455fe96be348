# ported from tidb_tpu/utils/rowcontainer.py @ 9d319cb
"""Disk-backed chunk container + external (spilling) algorithms.

Reference analog: pkg/util/chunk/row_container.go + chunk_in_disk.go (the
spill containers) and the per-operator spill paths (sortexec
parallel_sort_spill_helper.go, aggregate/agg_spill.go,
join/hash_join_spill.go) — SURVEY.md §5.7.  Partitions are written as
compressed .npz files (dense numpy buffers — the same buffers the device
path zero-copies, so spill/restore is cheap and exact).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import numpy as np


class SpilledPartition:
    """One partition of columns on disk."""

    def __init__(self, path: str, dtypes, dictionaries):
        self.path = path
        self.dtypes = dtypes
        self.dictionaries = dictionaries

    @classmethod
    def write(cls, tmpdir: str, tag: str, columns) -> "SpilledPartition":
        arrays = {}
        for i, c in enumerate(columns):
            arrays[f"d{i}"] = c.data
            arrays[f"v{i}"] = c.validity
        path = os.path.join(tmpdir, f"{tag}.npz")
        np.savez(path, **arrays)
        return cls(path, [c.dtype for c in columns],
                   [c.dictionary for c in columns])

    def read(self):
        from ..chunk.column import Column
        with np.load(self.path, allow_pickle=False) as z:
            return [Column(t, z[f"d{i}"], z[f"v{i}"], d)
                    for i, (t, d) in enumerate(zip(self.dtypes,
                                                   self.dictionaries))]

    def delete(self):
        try:
            os.unlink(self.path)
        except OSError:
            pass


def partition_to_disk(columns, part_of: np.ndarray, n_parts: int,
                      tmpdir: str, tag: str):
    """Split rows by partition id, spill each partition; returns the list
    of SpilledPartitions (empty partitions omitted, index kept)."""
    parts = []
    for p in range(n_parts):
        idx = np.nonzero(part_of == p)[0]
        if len(idx) == 0:
            parts.append(None)
            continue
        parts.append(SpilledPartition.write(
            tmpdir, f"{tag}-{p}", [c.take(idx) for c in columns]))
    return parts


def external_sort_index(ranks, tmpdir: str, block_rows: int) -> np.ndarray:
    """Row order for lexsort(ranks) computed run-at-a-time: each block is
    sorted independently (bounded working set) and spilled as raw .npy
    files; the k-way merge streams the runs back through memory-mapped
    views, so peak RAM stays O(block) + the output index, never the full
    rank matrix (sortexec/multi_way_merge.go analog)."""
    n = len(ranks[0]) if ranks else 0
    if n == 0:
        return np.arange(0)
    nk = len(ranks)
    runs = []     # list of per-run dirs holding k0..k{nk-1}.npy + idx.npy
    for start in range(0, n, block_rows):
        sl = slice(start, min(start + block_rows, n))
        blk = [r[sl] for r in ranks]
        order = np.lexsort(tuple(reversed(blk)))
        rd = os.path.join(tmpdir, f"run-{len(runs)}")
        os.makedirs(rd)
        for i, k in enumerate(blk):
            np.save(os.path.join(rd, f"k{i}.npy"), k[order])
        np.save(os.path.join(rd, "idx.npy"),
                np.arange(sl.start, sl.stop, dtype=np.int64)[order])
        runs.append(rd)
    if len(runs) == 1:
        return np.load(os.path.join(runs[0], "idx.npy"))
    # k-way merge over memmapped runs (OS pages blocks in and out)
    import heapq
    keys = [[np.load(os.path.join(rd, f"k{i}.npy"), mmap_mode="r")
             for i in range(nk)] for rd in runs]
    idxs = [np.load(os.path.join(rd, "idx.npy"), mmap_mode="r")
            for rd in runs]
    heap = [(tuple(k[0].item() for k in keys[r]), r)
            for r in range(len(runs)) if len(idxs[r])]
    heapq.heapify(heap)
    out = np.empty(n, np.int64)
    pos = [0] * len(runs)
    w = 0
    while heap:
        _, r = heapq.heappop(heap)
        out[w] = idxs[r][pos[r]]
        w += 1
        pos[r] += 1
        if pos[r] < len(idxs[r]):
            heapq.heappush(
                heap, (tuple(k[pos[r]].item() for k in keys[r]), r))
    return out


class SortedRun:
    """One sorted run on disk: row columns + the sort-rank matrix, both in
    sorted order, stored as raw .npy files so the merge can memory-map
    them (sortexec/parallel_sort_spill_helper.go run analog).  Unlike
    external_sort_index, the run carries the ROWS — the producer may drop
    its input chunks after spilling (streaming sort)."""

    def __init__(self, path: str, n: int, nk: int, dtypes, dicts):
        self.path = path
        self.n = n
        self.nk = nk
        self.dtypes = dtypes
        self.dicts = dicts

    @classmethod
    def write(cls, tmpdir: str, tag: str, columns, ranks) -> "SortedRun":
        order = np.lexsort(tuple(reversed(ranks)))
        rd = os.path.join(tmpdir, tag)
        os.makedirs(rd)
        for i, c in enumerate(columns):
            np.save(os.path.join(rd, f"d{i}.npy"), c.data[order])
            np.save(os.path.join(rd, f"v{i}.npy"), c.validity[order])
        for j, k in enumerate(ranks):
            np.save(os.path.join(rd, f"k{j}.npy"), k[order])
        return cls(rd, len(order), len(ranks),
                   [c.dtype for c in columns],
                   [c.dictionary for c in columns])

    def open(self):
        """(rank memmaps, [(data, validity) memmaps])."""
        ks = [np.load(os.path.join(self.path, f"k{j}.npy"), mmap_mode="r")
              for j in range(self.nk)]
        cs = [(np.load(os.path.join(self.path, f"d{i}.npy"), mmap_mode="r"),
               np.load(os.path.join(self.path, f"v{i}.npy"), mmap_mode="r"))
              for i in range(len(self.dtypes))]
        return ks, cs


def merge_sorted_runs(runs, out_rows: int):
    """Streaming k-way merge of SortedRuns: yields lists of Columns of up
    to out_rows rows in globally sorted order.  Peak RAM is O(out_rows)
    plus the OS page cache over the memmapped runs — the keep-order
    streaming-merge seam (sortexec/multi_way_merge.go,
    distsql SelectResult keep-order merge analog)."""
    import heapq

    from ..chunk.column import Column

    if not runs:
        return
    opened = [r.open() for r in runs]
    dtypes, dicts = runs[0].dtypes, runs[0].dicts
    heap = [(tuple(k[0].item() for k in opened[r][0]), r)
            for r in range(len(runs)) if runs[r].n]
    heapq.heapify(heap)
    pos = [0] * len(runs)
    rid_buf: list[int] = []
    pos_buf: list[int] = []

    def gather():
        rid = np.asarray(rid_buf, np.int64)
        p = np.asarray(pos_buf, np.int64)
        cols = []
        for i, t in enumerate(dtypes):
            out = np.empty(len(rid), opened[0][1][i][0].dtype)
            val = np.empty(len(rid), bool)
            for r in set(rid_buf):
                m = rid == r
                out[m] = opened[r][1][i][0][p[m]]
                val[m] = opened[r][1][i][1][p[m]]
            cols.append(Column(t, out, val, dicts[i]))
        rid_buf.clear()
        pos_buf.clear()
        return cols

    while heap:
        _, r = heapq.heappop(heap)
        rid_buf.append(r)
        pos_buf.append(pos[r])
        pos[r] += 1
        if pos[r] < runs[r].n:
            heapq.heappush(
                heap, (tuple(k[pos[r]].item() for k in opened[r][0]), r))
        if len(rid_buf) >= out_rows:
            yield gather()
    if rid_buf:
        yield gather()


def spill_dir() -> tempfile.TemporaryDirectory:
    return tempfile.TemporaryDirectory(prefix="tidb-tpu-spill-")

# ported from tidb_tpu/tools/external_sort.py @ f844701
"""Global sort on external storage.

Reference analog: pkg/lightning/backend/external (merge.go, the one-file
writers) — the TB-scale sort that ADD INDEX / IMPORT INTO use when data
exceeds memory: encode to KV pairs, spill SORTED RUNS to external
storage, then k-way merge-read the runs in key order so ingestion sees a
single sorted stream.

"External storage" here is a pluggable directory (the S3/GCS seam of the
reference's storage.ExternalStorage): runs are independent files with a
footer of (count, min_key, max_key) statistics, so a merge plan can
re-shard by key range — the multi-node story of the reference's merge
step (subtask per range) maps onto DXF subtasks.
"""

from __future__ import annotations

import heapq
import os
import struct
from typing import Iterable, Iterator, Optional, Tuple

KV = Tuple[bytes, bytes]

_MAGIC = b"XSRT1\n"


_TAIL = b"XSRTEND1"


class RunWriter:
    """One sorted run file: length-prefixed (key, value) records in key
    order, closed by a STATS FOOTER (count, min_key, max_key) readable in
    O(1) from the file tail — the external/onefile writer's statistics
    that a merge planner splits key ranges from."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self.count = 0
        self.min_key: Optional[bytes] = None
        self.max_key: Optional[bytes] = None

    def write_sorted(self, pairs: Iterable[KV]) -> None:
        last = None
        for k, v in pairs:
            if last is not None and k < last:
                raise ValueError("run records must arrive in key order")
            last = k
            self._f.write(struct.pack("<II", len(k), len(v)))
            self._f.write(k)
            self._f.write(v)
            if self.min_key is None:
                self.min_key = k
            self.max_key = k
            self.count += 1

    def close(self) -> None:
        mn = self.min_key or b""
        mx = self.max_key or b""
        footer = struct.pack("<QII", self.count, len(mn), len(mx)) + mn + mx
        self._f.write(footer)
        self._f.write(struct.pack("<I", len(footer)))
        self._f.write(_TAIL)
        self._f.close()


def run_stats(path: str) -> tuple:
    """(count, min_key, max_key) from the footer — O(1), no data scan."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(size - len(_TAIL) - 4)
        flen_raw = f.read(4)
        if f.read(len(_TAIL)) != _TAIL:
            raise ValueError(f"{path}: missing sorted-run footer")
        flen = struct.unpack("<I", flen_raw)[0]
        f.seek(size - len(_TAIL) - 4 - flen)
        footer = f.read(flen)
    count, lmn, lmx = struct.unpack("<QII", footer[:16])
    mn = footer[16:16 + lmn]
    mx = footer[16 + lmn:16 + lmn + lmx]
    return count, (mn if lmn else None), (mx if lmx else None)


def _payload_end(path: str) -> int:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(size - len(_TAIL) - 4)
        flen = struct.unpack("<I", f.read(4))[0]
    return size - len(_TAIL) - 4 - flen


def read_run(path: str, start: Optional[bytes] = None,
             end: Optional[bytes] = None) -> Iterator[KV]:
    """Stream one run in key order, optionally clipped to [start, end)."""
    stop = _payload_end(path)
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a sorted-run file")
        while f.tell() < stop:
            lk, lv = struct.unpack("<II", f.read(8))
            k = f.read(lk)
            v = f.read(lv)
            if end is not None and k >= end:
                return
            if start is None or k >= start:
                yield k, v


class ExternalSorter:
    """Accumulate unsorted KV pairs, spill sorted runs at the memory
    budget, and merge-read everything in key order.

    The run directory is the external-storage seam: runs survive the
    process, so an interrupted import resumes by re-merging existing
    runs (checkpoint discipline of backend/external)."""

    def __init__(self, run_dir: str, mem_budget_bytes: int = 64 << 20):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.mem_budget = max(int(mem_budget_bytes), 1 << 16)
        self._buf: list[KV] = []
        self._buf_bytes = 0
        self.runs: list[str] = sorted(
            os.path.join(run_dir, f) for f in os.listdir(run_dir)
            if f.endswith(".run"))

    def add(self, key: bytes, value: bytes) -> None:
        self._buf.append((key, value))
        self._buf_bytes += len(key) + len(value) + 16
        if self._buf_bytes >= self.mem_budget:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        self._buf.sort(key=lambda kv: kv[0])
        path = os.path.join(self.run_dir, f"{len(self.runs):06d}.run")
        w = RunWriter(path + ".tmp")
        w.write_sorted(self._buf)
        w.close()
        os.replace(path + ".tmp", path)
        self.runs.append(path)
        self._buf = []
        self._buf_bytes = 0

    def merged(self, start: Optional[bytes] = None,
               end: Optional[bytes] = None) -> Iterator[KV]:
        """K-way merge over all runs (merge.go MergeOverlappingFiles
        analog), optionally clipped to a key range — the unit a DXF
        subtask would own."""
        self.flush()
        streams = [read_run(p, start, end) for p in self.runs]
        yield from heapq.merge(*streams, key=lambda kv: kv[0])

    def stats(self) -> list[tuple]:
        """(path, count, min_key, max_key) per run, read from each run's
        footer in O(1) — the statistics a merge planner splits key ranges
        from."""
        return [(p,) + run_stats(p) for p in self.runs]

    def cleanup(self) -> None:
        for p in self.runs:
            try:
                os.remove(p)
            except OSError:
                pass
        self.runs = []


__all__ = ["ExternalSorter", "RunWriter", "read_run", "run_stats"]

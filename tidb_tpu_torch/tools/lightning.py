# ported from tidb_tpu/tools/lightning.py @ f844701
"""Lightning analog: bulk CSV import via pre-sorted KV batch ingest.

Reference: lightning/ + pkg/lightning (87k LoC) — reads source files,
encodes rows to KV pairs, sorts, and ingests SSTs directly into the
store (local backend), bypassing the SQL write path; checkpoints let an
interrupted import resume; duplicate detection reports conflicting keys.

Here: parse CSV with a worker pool (chunked by byte ranges like
mydump's region split), encode rows + index entries with the production
codecs, sort each engine batch by key, ingest through large KV txns,
checkpoint per chunk, and run a post-import duplicate check on unique
keyspaces (errors mirror lightning's conflict detection).
"""

from __future__ import annotations

import csv
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..session.codec_io import encode_table_row

CHUNK_ROWS = 4096        # one checkpointed ingest unit (region/SST analog)


def _to_value(raw: str, t):
    """CSV field -> python value in the column's type (shared by both
    import paths so NULL/number coercion can never diverge)."""
    if raw == "\\N" or raw == "":
        return None
    if t.is_integer:
        return int(raw)
    if t.is_float:
        return float(raw)
    return raw


def import_csv(domain, db: str, table: str, path: str,
               threads: int = 4, has_header: bool = True,
               checkpoint_path: Optional[str] = None) -> int:
    """Bulk-load a CSV file into an existing (empty or non-empty) table.
    Returns rows imported.  Resumes from `checkpoint_path` if given."""
    tbl = domain.catalog.get_table(db, table)
    if tbl.kv is None:
        raise ValueError("bulk import needs a KV-backed table")
    with open(path, newline="") as f:
        reader = csv.reader(f)
        rows = list(reader)
    if has_header:
        if rows and [c.strip().lower() for c in rows[0]] == \
                [c.lower() for c in tbl.col_names]:
            rows = rows[1:]
        elif rows:
            rows = rows[1:]
    # checkpoint: chunks already ingested (lightning/checkpoints analog)
    done: set[int] = set()
    if checkpoint_path and os.path.exists(checkpoint_path):
        done = set(json.load(open(checkpoint_path)))

    chunks = [(ci, rows[off:off + CHUNK_ROWS])
              for ci, off in enumerate(range(0, len(rows), CHUNK_ROWS))]
    # pre-assign handle ranges per chunk so parallel encode is determinate
    # (allocation under the table's autoid lock)
    with tbl._alloc_mu:
        starts = {}
        h = tbl._next_handle
        for ci, chunk in chunks:
            starts[ci] = h
            h += len(chunk)
        tbl._next_handle = h

    to_value = _to_value

    def ingest_chunk(arg) -> int:
        ci, chunk = arg
        if ci in done:
            return 0
        # hold the schema gate across the chunk: a concurrent online DDL
        # transition (or its rollback wipe) must not interleave with this
        # ingest, and index entries are written only for indexes whose F1
        # state accepts writes ('none'/'delete only' must NOT receive
        # inserts — mirrors catalog._write_index_entries)
        with tbl.schema_gate.read():
            pairs = []
            handle = starts[ci]
            for raw in chunk:
                if len(raw) != len(tbl.col_names):
                    raise ValueError(
                        f"row width {len(raw)} != {len(tbl.col_names)} "
                        f"columns: {raw!r}")
                vals = tuple(to_value(c, t)
                             for c, t in zip(raw, tbl.col_types))
                for i, t in enumerate(tbl.col_types):
                    if vals[i] is None and not t.nullable:
                        raise ValueError(
                            f"NULL in NOT NULL column {tbl.col_names[i]!r}")
                handle += 1
                pairs.append(encode_table_row(tbl.table_id, handle, vals,
                                              tbl.col_types))
                for ix in tbl.writable_indexes():
                    pairs.append(tbl._index_entry(ix, vals, handle))
            pairs.sort(key=lambda kv: kv[0])   # sorted ingest (SST build)
            txn = tbl.kv.begin()
            for k, v in pairs:
                txn.put(k, v)
            txn.commit()
        return len(chunk)

    total = 0
    with ThreadPoolExecutor(max_workers=max(threads, 1),
                            thread_name_prefix="lightning") as pool:
        for (ci, _), n in zip(chunks, pool.map(ingest_chunk, chunks)):
            total += n
            done.add(ci)
            if checkpoint_path:
                with open(checkpoint_path + ".tmp", "w") as f:
                    json.dump(sorted(done), f)
                os.replace(checkpoint_path + ".tmp", checkpoint_path)
    tbl._invalidate()
    _duplicate_check(tbl)
    return total


def _duplicate_check(tbl):
    """Post-import conflict detection on unique indexes (lightning's
    duplicate resolution surface, backend/local duplicate detector)."""
    from ..session.catalog import DuplicateKeyError
    from ..store.codec import index_prefix, index_prefix_end
    ts = tbl.kv.alloc_ts()
    for ix in tbl.indexes:
        if not ix.unique:
            continue
        # unique index: one key per distinct column tuple — a second row
        # with the same tuple overwrote the first entry, so compare counts
        n_entries = sum(1 for _ in tbl.kv.scan(
            index_prefix(tbl.table_id, ix.index_id),
            index_prefix_end(tbl.table_id, ix.index_id), ts))
        n_rows = tbl.snapshot().num_rows
        if n_entries != n_rows:
            raise DuplicateKeyError(
                f"import produced {n_rows - n_entries} duplicate(s) on "
                f"unique index {ix.name!r} of {tbl.name!r}")


def global_sort_import(domain, db: str, table: str, path: str,
                       run_dir: str, mem_budget_bytes: int = 64 << 20,
                       has_header: bool = True,
                       ingest_batch: int = 8192) -> int:
    """Bulk import through GLOBAL SORT on external storage (the
    lightning external backend, pkg/lightning/backend/external): stream
    the source, encode record + index KV pairs, spill sorted runs to
    `run_dir` under a memory budget, then k-way-merge the runs and
    ingest one fully KEY-ORDERED stream — the path that scales past RAM
    where import_csv materializes the file.

    `run_dir` must be empty/fresh: a partial previous attempt's runs are
    an incomplete encode, so resuming from them would silently drop data
    (re-run imports re-encode from the source instead).  Handle ranges
    reserve in blocks under the table's allocation lock, so concurrent
    INSERTs can never collide with imported rows."""
    import csv as _csv

    from .external_sort import ExternalSorter

    tbl = domain.catalog.get_table(db, table)
    if tbl.kv is None:
        raise ValueError("bulk import needs a KV-backed table")
    sorter = ExternalSorter(run_dir, mem_budget_bytes)
    if sorter.runs:
        raise ValueError(
            f"run_dir {run_dir!r} already holds sorted runs from an "
            "earlier attempt; use a fresh directory (a partial encode "
            "must not be mistaken for the whole source)")

    HBLOCK = 65536
    block_next, block_end = 0, 0

    def next_handle() -> int:
        nonlocal block_next, block_end
        if block_next >= block_end:
            with tbl._alloc_mu:
                block_next = tbl._next_handle + 1
                tbl._next_handle += HBLOCK
            block_end = block_next + HBLOCK
        h = block_next
        block_next += 1
        return h

    n_rows = 0
    with tbl.schema_gate.read():
        with open(path, newline="") as f:
            reader = _csv.reader(f)
            first = True
            for raw in reader:
                if first:
                    first = False
                    if has_header:
                        continue
                if not raw:
                    continue
                if len(raw) != len(tbl.col_names):
                    raise ValueError(
                        f"row width {len(raw)} != {len(tbl.col_names)} "
                        f"columns: {raw!r}")
                vals = tuple(_to_value(c, t)
                             for c, t in zip(raw, tbl.col_types))
                for i, t in enumerate(tbl.col_types):
                    if vals[i] is None and not t.nullable:
                        raise ValueError(
                            "NULL in NOT NULL column "
                            f"{tbl.col_names[i]!r}")
                h = next_handle()
                n_rows += 1
                k, v = encode_table_row(tbl.table_id, h, vals,
                                        tbl.col_types)
                sorter.add(k, v)
                for ix in tbl.writable_indexes():
                    ik, iv = tbl._index_entry(ix, vals, h)
                    sorter.add(ik, iv)
        sorter.flush()
        # merge-read every run in key order, ingest in batches
        txn = tbl.kv.begin()
        in_batch = 0
        for k, v in sorter.merged():
            txn.put(k, v)
            in_batch += 1
            if in_batch >= ingest_batch:
                txn.commit()
                txn = tbl.kv.begin()
                in_batch = 0
        txn.commit()
    sorter.cleanup()
    tbl._invalidate()
    _duplicate_check(tbl)
    return n_rows


__all__ = ["import_csv", "global_sort_import"]

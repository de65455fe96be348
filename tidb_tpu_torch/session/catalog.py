# ported from tidb_tpu/session/catalog.py @ 3951242
# (the port frees a snapshot's placement on the card when a write
# invalidates it: TableInfo._invalidate)
"""Catalog + table storage.

Reference analog: pkg/meta (catalog) + pkg/infoschema (cached schema) +
the TiKV-row-store/TiFlash-columnar split: writes land in a host-side row
buffer (the row store / membuffer analog), reads columnarize lazily into a
ColumnarSnapshot whose epoch bumps on every write — the raft-learner
columnarization role of TiFlash (SURVEY.md §7 hard part #6).  When the C++
KV engine lands, the row buffer moves behind the MVCC store and snapshots
carry read timestamps.
"""

from __future__ import annotations

import contextvars
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..chunk.column import Column, StringDict
from ..store.columnar import ColumnarSnapshot, snapshot_from_columns
from ..types import dtypes as dt

# per-session temporary-table overlay: {(db, name): TableInfo}, installed
# by Session.execute for the duration of each statement
TEMP_TABLES: contextvars.ContextVar = contextvars.ContextVar(
    "temp_tables", default=None)

K = dt.TypeKind


class CatalogError(ValueError):
    pass


class DuplicateKeyError(CatalogError):
    """MySQL error 1062 analog."""


@dataclass
class IndexInfo:
    """Secondary (or PRIMARY) index metadata (reference: meta/model
    IndexInfo)."""
    name: str
    index_id: int
    columns: list[str]
    unique: bool = False
    # online-DDL visibility state (F1 states, ddl/index.go:880): round-1
    # indexes are created synchronously straight to 'public'
    state: str = "public"


TYPE_MAP = {
    "BIGINT": dt.bigint, "INT": dt.bigint, "INTEGER": dt.bigint,
    "SMALLINT": dt.bigint, "TINYINT": dt.bigint, "MEDIUMINT": dt.bigint,
    "DOUBLE": dt.double, "REAL": dt.double, "FLOAT": dt.double,
    "DATE": dt.date, "DATETIME": dt.datetime, "TIMESTAMP": dt.datetime,
    "TIME": dt.time,
    "VARCHAR": dt.varchar, "CHAR": dt.varchar, "TEXT": dt.varchar,
    "STRING": dt.varchar,
    # JSON columns store normalized text (dict-encoded like VARCHAR); the
    # JSON_* builtins evaluate per-distinct-value over the dictionary
    "JSON": dt.varchar,
}


def type_from_sql(name: str, prec: int, scale: int, not_null: bool,
                  collation: str = "", members: tuple = ()) -> dt.DataType:
    base = name.split(" ")[0]
    unsigned = "UNSIGNED" in name
    if base in ("DECIMAL", "NUMERIC"):
        p = prec if prec > 0 else 10
        s = scale if scale >= 0 else 0
        return dt.decimal(p, s, nullable=not not_null)
    if base == "ENUM":
        return dt.enum_type(members, nullable=not not_null)
    if base == "SET":
        try:
            return dt.set_type(members, nullable=not not_null)
        except ValueError as e:
            raise CatalogError(str(e))
    if base == "BIT":
        return dt.bit(prec if prec > 0 else 1, nullable=not not_null)
    if base == "VECTOR":
        if prec > 16000:
            raise CatalogError("vector dimension cannot exceed 16000")
        return dt.vector(prec if prec > 0 else -1, nullable=not not_null)
    fn = TYPE_MAP.get(base)
    if fn is None:
        raise CatalogError(f"unsupported column type {name}")
    t = fn(nullable=not not_null)
    if unsigned and t.kind == K.INT64:
        t = dt.ubigint(nullable=not not_null)
    if collation and t.kind == K.STRING:
        from dataclasses import replace
        t = replace(t, collation=collation)
    return t


@dataclass(eq=False)  # identity semantics: tables are stateful singletons
class TableInfo:
    """One table: schema + KV-backed row store + cached columnar snapshot.

    Two storage modes:
    - KV mode (default when a store is attached): rows live in the native
      MVCC engine under record keys t{id}_r{handle} (SURVEY.md §A.2);
      writes go through percolator transactions; snapshots scan at a read
      ts and decode once into columns.
    - bulk mode (register_columns): pre-built columns bypass the row store
      — the TiFlash-style bulk-load path used by benchmarks.
    """
    name: str
    col_names: list[str]
    col_types: list[dt.DataType]
    primary_key: list[str] = field(default_factory=list)
    auto_inc_col: Optional[str] = None
    table_id: int = 0
    kv: Any = None                              # store.kv.KVStore

    indexes: list[IndexInfo] = field(default_factory=list)

    _base_cols: Optional[list[Column]] = None   # bulk-registered columns
    _pending: list = field(default_factory=list)  # bulk-mode write buffer
    _snapshot: Optional[ColumnarSnapshot] = None
    _epoch: int = 0
    # per-table schema version for MDL + commit-time validation
    # (infoschema version as seen by this table's DDL transitions)
    schema_ver: int = 0
    _auto_inc: int = 0
    _next_handle: int = 0
    _next_index_id: int = 0
    n_shards: int = 8
    # row TTL (pkg/ttl): rows with ttl_col older than now-interval expire
    ttl_col: Optional[str] = None
    ttl_interval_sec: int = 0
    ttl_enable: bool = True
    # table partitioning (sql/ast.PartitionSpec | None); partitions are
    # logical row sets over one store — pruning skips whole partitions at
    # scan time (rule_partition_processor.go analog)
    partition: Any = None
    _part_snap_cache: Any = None   # (epoch, ids) -> sub-snapshot
    # foreign keys THIS table declares (child side): list of
    # ast.ForeignKeyDef; parent resolution through _fk_resolver
    # (set by the session at CREATE TABLE — planner/core/foreign_key.go)
    foreign_keys: list = field(default_factory=list)
    _fk_resolver: Any = None       # (table_name) -> TableInfo
    # centralized autoid service (session/autoid.py): when bound, auto-inc
    # values come from batched RANGES the service persists; None keeps the
    # local counter (pre-service tables, tests)
    _autoid: Any = None
    _ai_cache_end: int = 0         # exclusive end of the fetched range
    # schema gate: writers hold read side per statement; online-DDL state
    # transitions take the write side to drain in-flight writers (the F1
    # schema-lease wait analog, utils/rwlock.py)
    schema_gate: Any = None

    _alloc_mu: Any = None
    # generated columns: [(col_index, compiled IR over the table schema)],
    # computed on every write path (table/column.go generated-column eval)
    generated_cols: list = field(default_factory=list)
    # catalog-on-KV write-through (session/meta.py): called after every
    # schema mutation so the persisted TableInfo stays current
    _meta_hook: Any = None
    # set when loaded from persisted metadata: handle/auto-inc counters
    # recover from the data on first write (MySQL max+1 restart semantics)
    _needs_counter_recovery: bool = False

    def __post_init__(self):
        import threading
        if self.schema_gate is None:
            from ..utils.rwlock import RWLock
            self.schema_gate = RWLock()
        if self._alloc_mu is None:
            self._alloc_mu = threading.Lock()

    # ---------------- index helpers ---------------- #

    def index_by_name(self, name: str) -> Optional[IndexInfo]:
        for ix in self.indexes:
            if ix.name.lower() == name.lower():
                return ix
        return None

    def _index_cols(self, ix: IndexInfo) -> list[int]:
        return [self.col_names.index(c) for c in ix.columns]

    def _index_entry(self, ix: IndexInfo, row: tuple, handle: int):
        from ..store.codec import encode_index_entry
        offs = self._index_cols(ix)
        vals = [row[i] for i in offs]
        types = [self.col_types[i] for i in offs]
        return encode_index_entry(self.table_id, ix.index_id, vals, types,
                                  handle, ix.unique)

    def _put_index_entry(self, txn, ix: IndexInfo, row: tuple, handle: int):
        """Write one index entry, enforcing uniqueness (shared by the
        insert path and CREATE INDEX backfill)."""
        key, val = self._index_entry(ix, row, handle)
        if ix.unique and val and txn.get(key) is not None:
            raise DuplicateKeyError(
                f"Duplicate entry for key '{self.name}.{ix.name}'")
        txn.put(key, val)

    def writable_indexes(self):
        """F1 online-DDL contract (ddl/index.go): an index in 'none' or
        'delete only' does not receive new entries from inserts.  Single
        source of truth for every write path (DML, backfill, bulk import)."""
        return [ix for ix in self.indexes
                if ix.state not in ("none", "delete only")]

    def _write_index_entries(self, txn, row: tuple, handle: int):
        for ix in self.writable_indexes():
            self._put_index_entry(txn, ix, row, handle)

    def _delete_index_entries(self, txn, row: tuple, handle: int):
        for ix in self.indexes:
            if ix.state == "none":
                continue
            key, _ = self._index_entry(ix, row, handle)
            txn.delete(key)

    def create_index(self, name: str, columns: list[str], unique: bool,
                     if_not_exists: bool = False) -> IndexInfo:
        """Create + synchronously backfill a secondary index (the round-1
        stand-in for the online-DDL write-reorg backfill)."""
        if self.index_by_name(name) is not None:
            if if_not_exists:
                return self.index_by_name(name)
            raise CatalogError(f"index {name!r} already exists")
        for c in columns:
            if c not in self.col_names:
                raise CatalogError(f"unknown column {c!r} in index {name!r}")
        if self.kv is None:
            raise CatalogError(
                "indexes require a KV-backed table (bulk-loaded snapshots "
                "are scan-only)")
        self._next_index_id += 1
        ix = IndexInfo(name, self._next_index_id, list(columns), unique)
        # backfill existing rows before publishing
        from .codec_io import scan_table_rows
        ts = self.kv.alloc_ts()
        handles, rows = scan_table_rows(self.kv, self.table_id, ts,
                                        self.col_types)
        txn = self.kv.begin()
        try:
            for h, r in zip(handles, rows):
                self._put_index_entry(txn, ix, tuple(r), int(h))
            txn.commit()
        except Exception:
            txn.rollback()
            raise
        self.indexes.append(ix)
        self._persist_meta()
        return ix

    def _persist_meta(self):
        if self._meta_hook is not None:
            self._meta_hook()

    def drop_index(self, name: str, if_exists: bool = False):
        ix = self.index_by_name(name)
        if ix is None:
            if if_exists:
                return
            raise CatalogError(f"unknown index {name!r}")
        from ..store.codec import index_prefix, index_prefix_end
        txn = self.kv.begin()
        for k, _ in self.kv.scan(index_prefix(self.table_id, ix.index_id),
                                 index_prefix_end(self.table_id, ix.index_id),
                                 txn.start_ts):
            txn.delete(k)
        txn.commit()
        self.indexes.remove(ix)
        self._persist_meta()

    # ---------------- write path ---------------- #

    def _prepare_insert(self, rows: list[tuple]) -> tuple[list[tuple], int]:
        """Validate + canonicalize rows and allocate handles/auto-inc."""
        for r in rows:
            if len(r) != len(self.col_names):
                raise CatalogError(
                    f"column count mismatch: got {len(r)}, want {len(self.col_names)}")
        fixed = []
        ai_idx = (self.col_names.index(self.auto_inc_col)
                  if self.auto_inc_col else -1)
        self._recover_counters()
        with self._alloc_mu:
            # handle/auto-inc allocation is a critical section: concurrent
            # inserters hold the schema gate's READ side together, so the
            # counters need their own lock (autoid allocator analog)
            for r in rows:
                r = list(r)
                if ai_idx >= 0 and r[ai_idx] is None:
                    if self._autoid is not None \
                            and self._auto_inc >= self._ai_cache_end:
                        # range exhausted: fetch the next batch from the
                        # centralized service (autoid_service analog)
                        start, end = self._autoid.alloc_range(
                            self.table_id, at_least=self._auto_inc)
                        self._auto_inc, self._ai_cache_end = start, end
                    self._auto_inc += 1
                    r[ai_idx] = self._auto_inc
                elif ai_idx >= 0 and isinstance(r[ai_idx], int):
                    if r[ai_idx] > self._auto_inc:
                        self._auto_inc = r[ai_idx]
                        if self._autoid is not None \
                                and r[ai_idx] >= self._ai_cache_end:
                            self._autoid.bump(self.table_id, r[ai_idx])
                            self._ai_cache_end = max(self._ai_cache_end,
                                                     r[ai_idx])
                for i, t in enumerate(self.col_types):
                    if r[i] is None and not t.nullable:
                        raise CatalogError(
                            f"column {self.col_names[i]!r} cannot be null")
                    r[i] = canon_write_value(t, r[i], self.col_names[i])
                fixed.append(tuple(r))
            first_handle = self._next_handle + 1
            self._next_handle += len(fixed)
        return fixed, first_handle

    def _insert_fixed(self, t, fixed: list[tuple], first_handle: int):
        """Write prepared rows into an open txn. Caller holds the schema
        gate's read side.  Uniqueness is PRE-checked for the WHOLE batch
        (including intra-batch duplicates) before any buffered write, so a
        DuplicateKeyError leaves the txn clean — statement atomicity
        inside an explicit transaction."""
        from .codec_io import encode_table_row
        uix = [ix for ix in self.writable_indexes() if ix.unique]
        seen: set = set()
        for j, r in enumerate(fixed):
            for ix in uix:
                key, val = self._index_entry(ix, r, first_handle + j)
                if not val:
                    continue        # NULL-containing keys never conflict
                if key in seen or t.get(key) is not None:
                    raise DuplicateKeyError(
                        f"Duplicate entry for key '{self.name}.{ix.name}'")
                seen.add(key)
        for j, r in enumerate(fixed):
            h = first_handle + j
            key, val = encode_table_row(self.table_id, h, r, self.col_types)
            t.put(key, val)
            self._write_index_entries(t, r, h)

    def _fk_check_rows(self, fixed: list) -> None:
        """Child-side FK validation: every non-NULL FK value must exist in
        the parent's referenced column (reads the parent's committed
        snapshot — executor/fktest parent-exists check).  NULL FK values
        always pass (MySQL semantics)."""
        if not self.foreign_keys or self._fk_resolver is None or not fixed:
            return
        for fk in self.foreign_keys:
            ci = self.col_names.index(fk.column)
            vals = [r[ci] for r in fixed if r[ci] is not None]
            if not vals:
                continue
            parent = self._fk_resolver(fk.ref_table)
            snap = parent.snapshot()
            pci = parent.col_names.index(fk.ref_column)
            pcol = snap.columns[pci]
            have = pcol.data[pcol.validity]
            if parent is self:
                # self-referential: rows earlier in this batch also count
                kci = self.col_names.index(fk.ref_column)
                batch_keys = np.array(
                    [r[kci] for r in fixed if r[kci] is not None],
                    dtype=np.int64) if any(
                        r[kci] is not None for r in fixed) else \
                    np.empty(0, np.int64)
                have = np.concatenate([have.astype(np.int64), batch_keys])
            missing = ~np.isin(np.array(vals, dtype=np.int64),
                               have.astype(np.int64))
            if missing.any():
                bad = np.array(vals)[missing][0]
                raise CatalogError(
                    "Cannot add or update a child row: a foreign key "
                    f"constraint fails (`{self.name}`.`{fk.column}` -> "
                    f"`{fk.ref_table}`.`{fk.ref_column}`, value {bad})")

    def _apply_generated(self, rows: list) -> list:
        """Compute generated-column values for a write batch, vectorized
        through the expression engine (columns built from the python-level
        row values, results decoded back)."""
        if not self.generated_cols or not rows:
            return rows
        from ..executor.physical import ResultChunk, _eval_to_column
        rows = [list(r) for r in rows]
        cols = [Column.from_values(t, [r[i] for r in rows])
                for i, t in enumerate(self.col_types)]
        chunk = ResultChunk(list(self.col_names), cols)
        for idx, ir in self.generated_cols:
            out = _eval_to_column(ir, chunk)
            vals = out.to_python()
            for j, r in enumerate(rows):
                r[idx] = vals[j]
            # later generated columns may reference this one
            chunk.columns[idx] = Column.from_values(self.col_types[idx],
                                                    vals)
        return [tuple(r) for r in rows]

    def insert_rows(self, rows: list[tuple], txn=None) -> int:
        rows = self._apply_generated(rows)
        fixed, first_handle = self._prepare_insert(rows)
        self._fk_check_rows(fixed)
        if self.partition is not None and self.partition.kind == "range" \
                and self.partition.parts[-1][1] is not None and fixed:
            ci = self.col_names.index(self.partition.column)
            hi = self.partition.parts[-1][1]
            for r in fixed:
                if r[ci] is not None and int(r[ci]) >= hi:
                    raise CatalogError(
                        f"Table has no partition for value {int(r[ci])}")
        if self.kv is not None:
            own = txn is None
            with self.schema_gate.read():
                t = txn or self.kv.begin()
                try:
                    self._insert_fixed(t, fixed, first_handle)
                    if own:
                        t.commit()
                except Exception:
                    if own:
                        t.rollback()
                    raise
        else:
            self._pending.extend(fixed)
        self._invalidate()
        return len(fixed)

    def replace_rows(self, rows: list[tuple], txn=None) -> int:
        """REPLACE INTO semantics (executor/replace.go analog): per row,
        delete every existing row that conflicts on a public unique index,
        then insert.  Returns deleted + inserted (MySQL affected-rows
        counting).  Rows process in order, so later rows replace earlier
        ones within one batch."""
        from ..store.codec import decode_index_handle, decode_row, record_key
        uix = [ix for ix in self.indexes
               if ix.unique and ix.state == "public"]
        if self.kv is None:
            raise CatalogError("REPLACE requires the KV row store")
        affected = 0
        own = txn is None
        with self.schema_gate.read():
            t = txn or self.kv.begin()
            try:
                for r in rows:
                    fixed, fh = self._prepare_insert([r])
                    canon = fixed[0]
                    for ix in uix:
                        offs = self._index_cols(ix)
                        if any(canon[i] is None for i in offs):
                            continue     # NULL unique keys never conflict
                        key, _ = self._index_entry(ix, canon, 0)
                        got = t.get(key)
                        if got is None:
                            continue
                        h = decode_index_handle(key, got)
                        rk = record_key(self.table_id, h)
                        data = t.get(rk)
                        if data is None:
                            continue
                        old = tuple(decode_row(data, self.col_types))
                        self._delete_index_entries(t, old, h)
                        t.delete(rk)
                        affected += 1
                    self._insert_fixed(t, fixed, fh)
                    affected += 1
                if own:
                    t.commit()
            except Exception:
                if own:
                    t.rollback()
                raise
        self._invalidate()
        return affected

    def update_rows(self, handles, old_rows, new_rows, txn=None) -> int:
        """Rewrite specific rows IN PLACE (stable handles) through the row
        store — the UpdateExec analog.  Inside an explicit transaction the
        caller's txn buffers the writes (and, in pessimistic mode, locks
        each record key at DML time via Txn.put)."""
        from .codec_io import encode_table_row
        new_rows = self._apply_generated(new_rows)
        self._fk_check_rows(new_rows)
        new_rows = [tuple(canon_write_value(t_, v, n)
                          for t_, v, n in zip(self.col_types, r,
                                              self.col_names))
                    for r in new_rows]
        own = txn is None
        with self.schema_gate.read():
            t = txn or self.kv.begin()
            try:
                for h, old, new in zip(handles, old_rows, new_rows):
                    self._delete_index_entries(t, old, int(h))
                    key, val = encode_table_row(self.table_id, int(h), new,
                                                self.col_types)
                    t.put(key, val)
                    self._write_index_entries(t, new, int(h))
                if own:
                    t.commit()
            except Exception:
                if own:
                    t.rollback()
                raise
        self._invalidate()
        return len(handles)

    def delete_handles(self, drop_handles, txn=None) -> int:
        """Delete rows by STABLE row-store handle — immune to snapshot
        re-ordering between mask computation and the delete (the FK
        cascade path interleaves deletes across tables).  Inside an
        explicit transaction the caller\'s txn buffers the deletes
        (DeleteExec: statement writes ride the membuffer and roll back
        with the transaction)."""
        if self.kv is None:
            raise CatalogError("handle deletes need the KV row store")
        self.snapshot()                      # (re)bind _snapshot_handles
        drop = np.asarray(sorted(drop_handles), dtype=np.int64)
        keep = ~np.isin(np.asarray(self._snapshot_handles, dtype=np.int64),
                        drop)
        return self.delete_where(keep, txn=txn)

    def delete_where(self, keep_mask: np.ndarray, txn=None) -> int:
        """Delete rows where ~keep_mask (aligned with snapshot row order)."""
        snap = self.snapshot()
        idx = np.nonzero(keep_mask)[0]
        deleted = snap.num_rows - len(idx)
        if self.kv is not None:
            handles = self._snapshot_handles
            with self.schema_gate.read():
                return self._delete_rows_locked(snap, keep_mask, handles,
                                                deleted, txn=txn)
        else:
            self._base_cols = [c.take(idx) for c in snap.columns]
        self._invalidate()
        return deleted

    def _delete_rows_locked(self, snap, keep_mask, handles, deleted,
                            txn=None) -> int:
        own = txn is None
        t = txn or self.kv.begin()
        from ..store.codec import record_key
        drop = np.nonzero(~np.asarray(keep_mask))[0]
        # materialize ONLY the dropped rows for index-entry removal
        drop_rows = None
        if self.indexes and len(drop):
            dropped = [c.take(drop) for c in snap.columns]
            drop_rows = list(zip(*[c.to_python() for c in dropped]))
        try:
            for j, i in enumerate(drop):
                h = int(handles[i])
                t.delete(record_key(self.table_id, h))
                if drop_rows is not None:
                    self._delete_index_entries(
                        t, tuple(plainify(v) for v in drop_rows[j]), h)
            if own:
                t.commit()
        except Exception:
            if own:
                t.rollback()
            raise
        self._invalidate()
        return deleted

    def replace_columns(self, cols: list[Column]) -> None:
        """Full rewrite (UPDATE path, round 1)."""
        if self.kv is not None:
            # rewrite through the row store in ONE txn so a failed rewrite
            # (e.g. a duplicate-key error on re-insert) leaves the table
            # untouched, keeping MVCC history coherent
            t = self.kv.begin()
            from ..store.codec import (index_prefix, index_prefix_end,
                                       record_prefix, record_prefix_end)
            for k, _ in self.kv.scan(record_prefix(self.table_id),
                                     record_prefix_end(self.table_id),
                                     t.start_ts):
                t.delete(k)
            for k, _ in self.kv.scan(index_prefix(self.table_id),
                                     index_prefix_end(self.table_id),
                                     t.start_ts):
                t.delete(k)
            self._base_cols = None
            rows = list(zip(*[c.to_python() for c in cols])) if cols and len(cols[0]) else []
            try:
                self.insert_rows([tuple(plainify(v) for v in r)
                                  for r in rows], txn=t)
                t.commit()
            except Exception:
                t.rollback()
                raise
            finally:
                self._invalidate()
            return
        self._base_cols = cols
        self._invalidate()

    def truncate(self) -> int:
        n = 0
        if self.kv is not None:
            t = self.kv.begin()
            from ..store.codec import (index_prefix, index_prefix_end,
                                       record_prefix, record_prefix_end)
            for k, _ in self.kv.scan(record_prefix(self.table_id),
                                     record_prefix_end(self.table_id),
                                     t.start_ts):
                t.delete(k)
                n += 1
            for k, _ in self.kv.scan(index_prefix(self.table_id),
                                     index_prefix_end(self.table_id),
                                     t.start_ts):
                t.delete(k)
            t.commit()
        elif self._base_cols or self._pending:
            n = (len(self._base_cols[0]) if self._base_cols else 0) + len(self._pending)
        self._base_cols = None
        self._pending = []
        self._invalidate()
        return n

    def _recover_counters(self):
        """After a restart, resume handle/auto-inc allocation above the
        persisted data (AUTO_INCREMENT = max+1, autoid allocator analog)."""
        if not self._needs_counter_recovery:
            return
        with self._alloc_mu:
            if not self._needs_counter_recovery:
                return
            self._needs_counter_recovery = False
            if self.kv is None:
                return
            snap = self.snapshot()
            handles = self._snapshot_handles
            if handles is not None and len(handles):
                self._next_handle = max(self._next_handle,
                                        int(np.max(handles)))
            if self.auto_inc_col is not None and snap.num_rows:
                c = snap.columns[self.col_names.index(self.auto_inc_col)]
                live = c.data[c.validity]
                if len(live):
                    self._auto_inc = max(self._auto_inc, int(np.max(live)))

    def register_columns(self, cols: list[Column]):
        """Bulk load pre-built columns (benchmarks; TiFlash bulk ingest
        analog) — bypasses the row store."""
        self._base_cols = cols
        self._pending = []
        self.kv = None
        self._invalidate()

    def _invalidate(self):
        old, self._snapshot = self._snapshot, None
        self._epoch += 1
        if old is not None:
            # the port frees the old epoch's placement on the card at
            # once, so a write/read round holds one placement of the
            # table, not one per write until the old snapshot is freed
            old._device_cache.clear()

    def split_regions(self, n_shards: int) -> None:
        """Re-shard the table's scan fan-out (SPLIT TABLE ... REGIONS n,
        the region-split analog): the next snapshot carries the new shard
        count and a bumped epoch, so device programs re-fan-out — the
        same invalidation path a real region split takes through the
        region cache."""
        if not 1 <= n_shards <= 4096:
            raise CatalogError("REGIONS must be between 1 and 4096")
        self.n_shards = int(n_shards)
        self._invalidate()

    # ---------------- read path (columnarize) ---------------- #

    @property
    def num_rows(self) -> int:
        if self._snapshot is not None:
            return self._snapshot.num_rows
        if self.kv is None:
            base = len(self._base_cols[0]) if self._base_cols else 0
            return base + len(self._pending)
        return self.snapshot().num_rows

    _placement_excluded: Any = None    # store exclusions survive epochs

    def snapshot(self) -> ColumnarSnapshot:
        if self._snapshot is not None:
            return self._snapshot
        cols = self._columnarize()
        from ..store.placement import Placement
        n = len(cols[0]) if cols else 0
        placement = Placement.even(n, self.n_shards)
        if self._placement_excluded:
            # re-place shards away from stores excluded in prior epochs
            # (the region cache remembers dead stores across refreshes)
            for st in sorted(self._placement_excluded):
                placement.exclude_store(st)
        placement.on_change = self._note_placement
        self._snapshot = snapshot_from_columns(
            self.col_names, cols, n_shards=self.n_shards, epoch=self._epoch,
            placement=placement)
        return self._snapshot

    def _note_placement(self, placement) -> None:
        self._placement_excluded = set(placement.excluded)

    def snapshot_at(self, ts: int) -> ColumnarSnapshot:
        """Historical snapshot at an MVCC read ts (stale read,
        sessiontxn/staleread): columnarizes the row store as of `ts`,
        uncached (one-shot reads; GC may reclaim very old versions)."""
        if self.kv is None:
            raise CatalogError("snapshot_at needs the KV row store")
        from .codec_io import scan_table_rows
        _handles, rows = scan_table_rows(self.kv, self.table_id, int(ts),
                                         self.col_types)
        cols = [Column.from_values(t, [r[i] for r in rows])
                for i, t in enumerate(self.col_types)]
        return snapshot_from_columns(self.col_names, cols,
                                     n_shards=self.n_shards,
                                     epoch=-int(ts))

    # ---------------- partitioning (logical row sets) ---------------- #

    def partition_names(self) -> list[str]:
        return [p[0] for p in self.partition.parts] if self.partition else []

    def _partition_index(self, col: Column) -> "np.ndarray":
        """Per-row partition id for the partition column (model:
        rule_partition_processor.go partition locating).  NULL routes to
        partition 0 (MySQL: lowest RANGE partition / hash bucket 0)."""
        v = col.data.astype(np.int64)
        spec = self.partition
        if spec.kind == "hash":
            pid = np.abs(v) % np.int64(spec.num)
        else:
            bounds = np.array([b for _, b in spec.parts if b is not None],
                              np.int64)
            pid = np.searchsorted(bounds, v, side="right")
            # beyond the last finite bound: MAXVALUE partition if present,
            # else clamp (insert-time validation rejects such rows)
            pid = np.minimum(pid, len(spec.parts) - 1)
        return np.where(col.validity, pid, 0)

    def check_partition_rows(self, col: Column) -> None:
        """RANGE without MAXVALUE rejects out-of-range rows
        (ER_NO_PARTITION_FOR_GIVEN_VALUE)."""
        spec = self.partition
        if spec is None or spec.kind != "range" or \
                spec.parts[-1][1] is None:
            return
        hi = spec.parts[-1][1]
        bad = col.data[col.validity & (col.data >= hi)]
        if len(bad):
            raise CatalogError(
                f"Table has no partition for value {int(bad[0])}")

    def partition_snapshot(self, ids) -> ColumnarSnapshot:
        """Snapshot restricted to the given partition ids (pruned scan)."""
        snap = self.snapshot()
        if self.partition is None or ids is None:
            return snap
        ids = tuple(sorted(set(ids)))
        if ids == tuple(range(len(self.partition.parts))):
            return snap
        if self._part_snap_cache and \
                self._part_snap_cache[0] == (snap.epoch, ids):
            return self._part_snap_cache[1]
        col = snap.columns[self.col_names.index(self.partition.column)]
        pid = self._partition_index(col)
        idx = np.nonzero(np.isin(pid, np.array(ids, np.int64)))[0]
        sub = snapshot_from_columns(
            self.col_names, [c.take(idx) for c in snap.columns],
            n_shards=self.n_shards, epoch=snap.epoch)
        self._part_snap_cache = ((snap.epoch, ids), sub)
        return sub

    _snapshot_handles: Any = None

    def _columnarize(self) -> list[Column]:
        if self.kv is not None:
            from .codec_io import scan_table_rows
            ts = self.kv.alloc_ts()
            handles, rows = scan_table_rows(self.kv, self.table_id, ts,
                                            self.col_types)
            self._snapshot_handles = handles
            return [Column.from_values(t, [r[i] for r in rows])
                    for i, t in enumerate(self.col_types)]
        if self._pending:
            self._base_cols = self._columnarize_append(self._pending)
            self._pending = []
        return self._base_cols or [Column.from_values(t, [])
                                   for t in self.col_types]

    def _columnarize_append(self, new_rows: list[tuple]) -> list[Column]:
        base = self._base_cols or [
            Column.from_values(t, []) for t in self.col_types]
        out = []
        for i, t in enumerate(self.col_types):
            vals = [r[i] for r in new_rows]
            if t.kind == K.STRING:
                old = base[i]
                old_vals = old.to_python() if len(old) else []
                d = StringDict.build(list(old_vals) + vals)
                out.append(Column.from_values(t, list(old_vals) + vals, d))
            else:
                newc = Column.from_values(t, vals)
                out.append(Column.concat([base[i], newc]) if len(base[i])
                           else newc)
        return out


def canon_write_value(t: dt.DataType, v, col_name: str = ""):
    """Canonicalize one value at the WRITE boundary (insert/update/import):
    ENUM/SET string literals become ordinal/bitmask ints (pkg/types
    ParseEnum/ParseSet analog)."""
    if v is None or not isinstance(v, str):
        return v
    if t.kind == K.ENUM:
        ix = dt.enum_index(t, v)
        if ix < 0:
            raise CatalogError(f"invalid ENUM value {v!r} for {col_name!r}")
        return ix
    if t.kind == K.SET:
        m = dt.set_mask(t, v)
        if m < 0:
            raise CatalogError(f"invalid SET value {v!r} for {col_name!r}")
        return m
    return v


def plainify(v):
    """Normalize result-surface values (Decimal/date) back to plain
    encodable python values — shared by INSERT-SELECT and UPDATE paths."""
    import decimal as pydec
    import datetime as pydt
    if isinstance(v, pydec.Decimal):
        return str(v)
    if isinstance(v, pydt.date):
        return v.isoformat()
    return v


@dataclass
class ViewInfo:
    """A stored view: column names + the defining SELECT kept as SQL text,
    re-planned at every expansion so base-table schema changes flow
    through (meta/model ViewInfo analog; parser.y CreateViewStmt)."""
    name: str
    columns: list            # [] = inherit the select's output names
    select_sql: str


class SequenceInfo:
    """A sequence object: batched, KV-persisted value allocation.

    Reference analog: pkg/ddl/sequence.go + the meta sequence value key —
    NEXTVAL allocates from an in-memory cache of `cache` values and
    persists only the batch high-water mark, so a restart skips to the
    next batch boundary instead of repeating values (the autoid
    discipline).  LASTVAL is per-session (keyed by connection id)."""

    META_PREFIX = b"m_seq_"

    def __init__(self, name: str, db: str, start: int = 1,
                 increment: int = 1, min_value: Optional[int] = None,
                 max_value: Optional[int] = None, cache: int = 1000,
                 cycle: bool = False, kv=None):
        if increment == 0:
            raise CatalogError("sequence INCREMENT must be nonzero")
        self.name = name
        self.db = db
        self.increment = increment
        self.min_value = min_value if min_value is not None else \
            (1 if increment > 0 else -(2 ** 63) + 1)
        self.max_value = max_value if max_value is not None else \
            (2 ** 63 - 1 if increment > 0 else -1)
        self.start = start
        self.cache = max(cache, 1)
        self.cycle = cycle
        self.kv = kv
        self._mu = threading.Lock()
        self._next = start            # next value to hand out
        self._cache_end = start       # first value NOT covered by the batch
        self._lastval: dict[int, int] = {}    # conn_id -> last value
        self._restore()

    def _meta_key(self) -> bytes:
        return self.META_PREFIX + f"{self.db}.{self.name}".encode()

    def _purge_value_key(self):
        """Delete the persisted batch high-water mark: a dropped-and-
        recreated sequence must restart, not resume (sequence.go drop).
        Failures propagate — a silent miss would re-enable stale
        resumption with no diagnostic."""
        if self.kv is None:
            return
        txn = self.kv.begin()
        txn.delete(self._meta_key())
        txn.commit()

    def _restore(self):
        if self.kv is None:
            return
        ts = self.kv.alloc_ts()
        end = self._meta_key() + b"\x00"
        for k, v in self.kv.scan(self._meta_key(), end, ts):
            self._next = self._cache_end = int(v.decode())

    def _persist(self, value: int):
        if self.kv is None:
            return
        txn = self.kv.begin()
        txn.put(self._meta_key(), str(value).encode())
        txn.commit()

    def next_value(self, conn_id: int = 0) -> int:
        with self._mu:
            if self.increment > 0 and self._next > self.max_value or \
                    self.increment < 0 and self._next < self.min_value:
                if not self.cycle:
                    raise CatalogError(
                        f"sequence {self.name!r} has run out")
                self._next = (self.min_value if self.increment > 0
                              else self.max_value)
                self._cache_end = self._next
            if (self._next - self._cache_end) * (1 if self.increment > 0
                                                 else -1) >= 0:
                # batch exhausted (or first use): reserve the next batch
                new_end = self._next + self.increment * self.cache
                self._persist(new_end)
                self._cache_end = new_end
            v = self._next
            self._next += self.increment
            self._lastval[conn_id] = v
            return v

    def last_value(self, conn_id: int = 0) -> Optional[int]:
        with self._mu:
            return self._lastval.get(conn_id)

    def set_value(self, value: int, conn_id: int = 0) -> Optional[int]:
        """SETVAL: only moves the sequence FORWARD; a value at or below
        the current position is ignored and returns None/NULL (TiDB/
        MariaDB semantics — issued values must stay unique)."""
        with self._mu:
            if (value - self._next) * (1 if self.increment > 0
                                       else -1) < 0:
                return None
            self._next = value + self.increment
            self._persist(self._next + self.increment * self.cache)
            self._cache_end = self._next + self.increment * self.cache
            return value


class Catalog:
    """In-memory catalog of databases/tables (infoschema analog).

    information_schema / performance_schema resolve to virtual memtables
    (infoschema/__init__.py) bound to the owning Domain."""

    def __init__(self):
        self.databases: dict[str, dict[str, TableInfo]] = {"test": {},
                                                           "mysql": {}}
        # views per db: name -> ViewInfo (planner expands at reference
        # time, logical_plan_builder BuildDataSourceFromView analog)
        self.views: dict[str, dict[str, "ViewInfo"]] = {}
        # sequences: (db, name) -> SequenceInfo (ddl/sequence.go analog)
        self.sequences: dict[tuple, "SequenceInfo"] = {}
        self.domain = None       # set by Domain.__init__ (memtable binding)

    def create_database(self, name: str, if_not_exists=False):
        from ..infoschema import is_system_db
        if is_system_db(name):
            raise CatalogError(f"database {name!r} is a system database")
        if name in self.databases:
            if if_not_exists:
                return
            raise CatalogError(f"database {name!r} exists")
        self.databases[name] = {}

    def drop_database(self, name: str, if_exists=False):
        if name not in self.databases:
            if if_exists:
                return
            raise CatalogError(f"unknown database {name!r}")
        del self.databases[name]
        for key in [k for k in self.sequences if k[0] == name]:
            self.sequences[key]._purge_value_key()
            del self.sequences[key]

    def create_table(self, db: str, tbl: TableInfo, if_not_exists=False):
        d = self._db(db)
        if tbl.name in d:
            if if_not_exists:
                return
            raise CatalogError(f"table {tbl.name!r} exists")
        d[tbl.name] = tbl

    def drop_table(self, db: str, name: str, if_exists=False):
        d = self._db(db)
        if name not in d:
            if if_exists:
                return
            raise CatalogError(f"unknown table {name!r}")
        del d[name]

    def get_table(self, db: str, name: str) -> TableInfo:
        from ..infoschema import get_memtable, is_system_db
        if is_system_db(db):
            mt = get_memtable(db, name)
            mt.domain = self.domain
            return mt
        # session temporary tables shadow permanent ones (reference:
        # infoschema local temporary table overlay, temptable pkg)
        tmp = TEMP_TABLES.get()
        if tmp is not None:
            t = tmp.get((db, name))
            if t is not None:
                return t
        d = self._db(db)
        if name not in d:
            raise CatalogError(f"table {db}.{name} doesn't exist")
        return d[name]

    def _db(self, db: str) -> dict:
        from ..infoschema import is_system_db
        if is_system_db(db):
            raise CatalogError(f"database {db!r} is a system database")
        if db not in self.databases:
            raise CatalogError(f"unknown database {db!r}")
        return self.databases[db]

    # ---------------- sequences ---------------- #

    def create_sequence(self, db: str, seq: "SequenceInfo",
                        if_not_exists=False):
        self._db(db)      # existence check
        key = (db, seq.name)
        if key in self.sequences:
            if if_not_exists:
                return
            raise CatalogError(f"sequence {seq.name!r} exists")
        self.sequences[key] = seq

    def drop_sequence(self, db: str, name: str, if_exists=False):
        if (db, name) not in self.sequences:
            if if_exists:
                return
            raise CatalogError(f"unknown sequence {name!r}")
        self.sequences[(db, name)]._purge_value_key()
        del self.sequences[(db, name)]

    def get_sequence(self, db: str, name: str) -> "SequenceInfo":
        seq = self.sequences.get((db, name))
        if seq is None:
            raise CatalogError(f"table {db}.{name} doesn't exist")
        return seq

    # ---------------- views ---------------- #

    def create_view(self, db: str, view: "ViewInfo",
                    or_replace: bool = False):
        d = self._db(db)            # existence/system-db validation
        if view.name in d:
            raise CatalogError(f"table {view.name!r} exists")
        vs = self.views.setdefault(db, {})
        if view.name in vs and not or_replace:
            raise CatalogError(f"view {view.name!r} exists")
        vs[view.name] = view

    def drop_view(self, db: str, name: str, if_exists=False):
        vs = self.views.get(db, {})
        if name not in vs:
            if if_exists:
                return
            raise CatalogError(f"unknown view {db}.{name}")
        del vs[name]

    def get_view(self, db: str, name: str) -> Optional["ViewInfo"]:
        return self.views.get(db, {}).get(name)


__all__ = ["Catalog", "TableInfo", "IndexInfo", "CatalogError",
           "DuplicateKeyError", "type_from_sql"]

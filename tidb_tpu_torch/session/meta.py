# ported from tidb_tpu/session/meta.py @ 3951242
"""Catalog-on-KV: schema metadata persisted in the MVCC store.

Reference analog: pkg/meta (meta.go:78) — the catalog lives under the `m`
key prefix in the same transactional KV store as the data, so schema and
rows share one durability story and survive restarts together.  Keys:

    m\\0db\\0<db>              -> "1" (database existence)
    m\\0tbl\\0<db>\\0<name>    -> JSON-encoded TableInfo

The in-memory Catalog (infoschema analog) stays the read path; this module
is the write-through + recovery layer.
"""

from __future__ import annotations

import json
from typing import Optional

from ..types import dtypes as dt
from .catalog import Catalog, IndexInfo, TableInfo

M_DB = b"m\x00db\x00"
M_TBL = b"m\x00tbl\x00"
M_SEQ = b"m\x00seq\x00"     # sequence definitions (values live at m_seq_)
M_MAXID = b"m\x00maxid"     # high-water table id incl. dropped tables


def db_key(db: str) -> bytes:
    return M_DB + db.encode()


def table_key(db: str, name: str) -> bytes:
    return M_TBL + db.encode() + b"\x00" + name.encode()


def _enc_type(t: dt.DataType) -> dict:
    out = {"k": t.kind.name, "n": t.nullable, "p": t.prec, "s": t.scale}
    if t.collation != "binary":
        out["c"] = t.collation
    if t.members:
        out["m"] = list(t.members)
    return out


def _dec_type(d: dict) -> dt.DataType:
    return dt.DataType(dt.TypeKind[d["k"]], d["n"], d["p"], d["s"],
                       collation=d.get("c", "binary"),
                       members=tuple(d.get("m", ())))


def encode_table(tbl: TableInfo) -> bytes:
    return json.dumps({
        "name": tbl.name,
        "cols": tbl.col_names,
        "types": [_enc_type(t) for t in tbl.col_types],
        "pk": tbl.primary_key,
        "auto_inc_col": tbl.auto_inc_col,
        "table_id": tbl.table_id,
        "indexes": [{"name": ix.name, "id": ix.index_id,
                     "cols": ix.columns, "unique": ix.unique,
                     "state": ix.state} for ix in tbl.indexes],
        "next_index_id": tbl._next_index_id,
        "n_shards": tbl.n_shards,
        "ttl": [tbl.ttl_col, tbl.ttl_interval_sec, tbl.ttl_enable],
        # generated columns: compiled IR pickled (internal format; the
        # IR is a frozen dataclass tree over stable dtypes)
        "gen": [[i, __import__("base64").b64encode(
                     __import__("pickle").dumps(ir)).decode()]
                for i, ir in getattr(tbl, "generated_cols", [])],
    }).encode()


def decode_table(data: bytes, kv) -> TableInfo:
    d = json.loads(data)
    tbl = TableInfo(d["name"], list(d["cols"]),
                    [_dec_type(t) for t in d["types"]],
                    primary_key=list(d["pk"]),
                    auto_inc_col=d["auto_inc_col"],
                    table_id=d["table_id"], kv=kv)
    tbl.indexes = [IndexInfo(ix["name"], ix["id"], list(ix["cols"]),
                             ix["unique"], ix["state"])
                   for ix in d["indexes"]]
    tbl._next_index_id = d["next_index_id"]
    tbl.n_shards = d["n_shards"]
    tbl.ttl_col, tbl.ttl_interval_sec, tbl.ttl_enable = d["ttl"]
    if d.get("gen"):
        import base64
        import pickle
        tbl.generated_cols = [(i, pickle.loads(base64.b64decode(b)))
                              for i, b in d["gen"]]
    # handle/auto-inc counters recover lazily from the data on first
    # write (MySQL restart semantics: AUTO_INCREMENT resumes at max+1)
    tbl._needs_counter_recovery = True
    return tbl


class MetaStore:
    """Write-through schema persistence attached to a Catalog."""

    def __init__(self, kv):
        self.kv = kv

    def _put(self, key: bytes, value: Optional[bytes]):
        txn = self.kv.begin()
        if value is None:
            txn.delete(key)
        else:
            txn.put(key, value)
        txn.commit()

    def save_db(self, db: str):
        self._put(db_key(db), b"1")

    def drop_db(self, db: str, tables: list):
        txn = self.kv.begin()
        txn.delete(db_key(db))
        for t in tables:
            txn.delete(table_key(db, t.name if isinstance(t, TableInfo)
                                 else t))
        # drop the database's sequence definitions (value keys are purged
        # by Catalog.drop_database via SequenceInfo._purge_value_key)
        pre = M_SEQ + db.encode() + b"\x00"
        for k, _ in self.kv.scan(pre, pre + b"\xff", txn.start_ts):
            txn.delete(k)
        txn.commit()
        for t in tables:
            if isinstance(t, TableInfo):
                self._purge_table_data(t)

    def save_table(self, db: str, tbl: TableInfo):
        self._put(table_key(db, tbl.name), encode_table(tbl))

    def drop_table(self, db: str, name: str,
                   tbl: Optional[TableInfo] = None):
        self._put(table_key(db, name), None)
        if tbl is not None:
            self._purge_table_data(tbl)

    def _purge_table_data(self, tbl: TableInfo):
        """Delete the dropped table's record+index key range (the
        reference's delete-range GC task) and remember its id so the
        allocator never hands the range out again."""
        self.note_table_id(tbl.table_id)
        if tbl.kv is not self.kv or tbl.table_id <= 0:
            return
        from ..store.codec import encode_int_key
        lo = b"t" + encode_int_key(tbl.table_id)
        hi = lo + b"\xff"
        txn = self.kv.begin()
        for k, _ in self.kv.scan(lo, hi, txn.start_ts):
            txn.delete(k)
        txn.commit()

    def note_table_id(self, tid: int):
        cur = self.load_max_dropped_id()
        if tid > cur:
            self._put(M_MAXID, str(tid).encode())

    def load_max_dropped_id(self) -> int:
        v = self.kv.get(M_MAXID, self.kv.alloc_ts())
        return int(v) if v else 0

    def save_sequence(self, db: str, seq) -> None:
        self._put(M_SEQ + db.encode() + b"\x00" + seq.name.encode(),
                  json.dumps({
                      "name": seq.name, "start": seq.start,
                      "increment": seq.increment,
                      "min_value": seq.min_value,
                      "max_value": seq.max_value,
                      "cache": seq.cache, "cycle": seq.cycle}).encode())

    def drop_sequence(self, db: str, name: str) -> None:
        self._put(M_SEQ + db.encode() + b"\x00" + name.encode(), None)

    def load_catalog(self, catalog: Catalog) -> int:
        """Rebuild the in-memory catalog from KV at startup (infoschema
        load at domain init, domain.go:146 analog).  Returns #tables."""
        ts = self.kv.alloc_ts()
        for k, _v in self.kv.scan(M_DB, M_DB + b"\xff", ts):
            db = k[len(M_DB):].decode()
            if db not in catalog.databases:
                catalog.databases[db] = {}
        n = 0
        for k, v in self.kv.scan(M_TBL, M_TBL + b"\xff", ts):
            db, _name = k[len(M_TBL):].decode().split("\x00", 1)
            tbl = decode_table(v, self.kv)
            catalog.databases.setdefault(db, {})[tbl.name] = tbl
            tbl._meta_hook = (lambda t=tbl, d=db: self.save_table(d, t))
            n += 1
        from .catalog import SequenceInfo
        for k, v in self.kv.scan(M_SEQ, M_SEQ + b"\xff", ts):
            db, _name = k[len(M_SEQ):].decode().split("\x00", 1)
            d = json.loads(v)
            seq = SequenceInfo(d["name"], db, start=d["start"],
                               increment=d["increment"],
                               min_value=d["min_value"],
                               max_value=d["max_value"], cache=d["cache"],
                               cycle=d["cycle"], kv=self.kv)
            catalog.sequences[(db, seq.name)] = seq
        return n


def attach(catalog: Catalog, kv) -> MetaStore:
    """Wire write-through persistence into the catalog's mutation paths."""
    meta = MetaStore(kv)
    catalog._meta = meta

    orig_create_db = catalog.create_database
    orig_drop_db = catalog.drop_database
    orig_create = catalog.create_table
    orig_drop = catalog.drop_table

    def create_database(name, if_not_exists=False):
        orig_create_db(name, if_not_exists)
        meta.save_db(name)

    def drop_database(name, if_exists=False):
        tables = list(catalog.databases.get(name, {}).values())
        orig_drop_db(name, if_exists)
        meta.drop_db(name, tables)

    def create_table(db, tbl, if_not_exists=False):
        orig_create(db, tbl, if_not_exists)
        if catalog.databases.get(db, {}).get(tbl.name) is tbl:
            tbl._meta_hook = (lambda t=tbl, d=db: meta.save_table(d, t))
            meta.save_table(db, tbl)

    def drop_table(db, name, if_exists=False):
        tbl = catalog.databases.get(db, {}).get(name)
        orig_drop(db, name, if_exists)
        if tbl is not None:
            meta.drop_table(db, name, tbl)

    orig_create_seq = catalog.create_sequence
    orig_drop_seq = catalog.drop_sequence

    def create_sequence(db, seq, if_not_exists=False):
        orig_create_seq(db, seq, if_not_exists)
        if catalog.sequences.get((db, seq.name)) is seq:
            meta.save_sequence(db, seq)

    def drop_sequence(db, name, if_exists=False):
        existed = (db, name) in catalog.sequences
        orig_drop_seq(db, name, if_exists)
        if existed:
            meta.drop_sequence(db, name)

    catalog.create_database = create_database
    catalog.drop_database = drop_database
    catalog.create_table = create_table
    catalog.drop_table = drop_table
    catalog.create_sequence = create_sequence
    catalog.drop_sequence = drop_sequence
    return meta


__all__ = ["MetaStore", "attach", "encode_table", "decode_table"]

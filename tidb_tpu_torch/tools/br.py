# ported from tidb_tpu/tools/br.py @ f096667
"""BR analog: physical snapshot backup & restore with checkpointing.

Reference: br/pkg (113.7k LoC) — snapshot backup exports each table's KV
range as SST files at one backup ts plus a backupmeta manifest; restore
ingests the files and recreates schemas; an interrupted run resumes from
its checkpoint (br/pkg/checkpoint).  Here: one raw KV dump file per
table (sorted key/value pairs at the backup ts — the SST stand-in), a
JSON backupmeta with schemas + ts, and a checkpoint file listing
finished tables so backup/restore resume midway.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

from ..store.codec import (encode_int_key, index_prefix, index_prefix_end,
                           record_prefix, record_prefix_end)

META_FILE = "backupmeta.json"
CKPT_FILE = "checkpoint.json"


def _table_meta(tbl) -> dict:
    return {
        "name": tbl.name, "table_id": tbl.table_id,
        "col_names": list(tbl.col_names),
        "col_types": [_type_meta(t) for t in tbl.col_types],
        "primary_key": list(tbl.primary_key),
        "auto_inc_col": tbl.auto_inc_col,
        "auto_inc": tbl._auto_inc, "next_handle": tbl._next_handle,
        "indexes": [{"name": ix.name, "index_id": ix.index_id,
                     "columns": ix.columns, "unique": ix.unique}
                    for ix in tbl.indexes if ix.state == "public"],
    }


def _type_meta(t) -> dict:
    return {"kind": t.kind.name, "nullable": t.nullable, "prec": t.prec,
            "scale": t.scale}


def _type_from_meta(m):
    from ..types import dtypes as dt
    return dt.DataType(dt.TypeKind[m["kind"]], m["nullable"], m["prec"],
                       m["scale"])


def _write_kvs(path: str, pairs) -> int:
    n = 0
    with open(path + ".tmp", "wb") as f:
        for k, v in pairs:
            f.write(struct.pack("<I", len(k)) + k)
            f.write(struct.pack("<I", len(v)) + v)
            n += 1
    os.replace(path + ".tmp", path)   # atomic publish (SST upload analog)
    return n


def _read_kvs(path: str):
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (kl,) = struct.unpack_from("<I", data, off); off += 4
        k = data[off:off + kl]; off += kl
        (vl,) = struct.unpack_from("<I", data, off); off += 4
        v = data[off:off + vl]; off += vl
        yield k, v


def _load_ckpt(out_dir: str) -> set:
    p = os.path.join(out_dir, CKPT_FILE)
    if os.path.exists(p):
        return set(json.load(open(p)))
    return set()


def _save_ckpt(out_dir: str, done: set):
    p = os.path.join(out_dir, CKPT_FILE)
    with open(p + ".tmp", "w") as f:
        json.dump(sorted(done), f)
    os.replace(p + ".tmp", p)


def backup(domain, db: str, out_dir: str) -> dict:
    """Snapshot backup of `db` into out_dir; resumable via checkpoint.
    Returns {table: kv_pair_count}."""
    os.makedirs(out_dir, exist_ok=True)
    tables = domain.catalog.databases.get(db)
    if tables is None:
        raise ValueError(f"unknown database {db!r}")
    meta_path = os.path.join(out_dir, META_FILE)
    if os.path.exists(meta_path):
        meta = json.load(open(meta_path))
        backup_ts = meta["backup_ts"]       # resume: keep the original ts
    else:
        backup_ts = domain.kv.alloc_ts()
        meta = {"db": db, "backup_ts": backup_ts,
                "tables": {n: _table_meta(t) for n, t in tables.items()
                           if t.kv is not None}}
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=1)
    done = _load_ckpt(out_dir)
    counts = {}
    ranges: dict[str, list] = {}
    for name, rng in _table_ranges(meta):
        ranges.setdefault(name, []).append(rng)
    for name in sorted(meta["tables"]):
        if name in done:
            continue
        pairs = []
        for lo, hi in ranges[name]:
            pairs += list(domain.kv.scan(lo, hi, backup_ts))
        counts[name] = _write_kvs(
            os.path.join(out_dir, f"{db}.{name}.kv"), pairs)
        done.add(name)
        _save_ckpt(out_dir, done)
    return counts


def restore(domain, out_dir: str, db: Optional[str] = None,
            batch: int = 512) -> dict:
    """Restore a backup into `domain` (schemas + data).  `db` overrides
    the target database name.  Returns {table: kv_pair_count}."""
    from ..session.catalog import IndexInfo, TableInfo
    meta = json.load(open(os.path.join(out_dir, META_FILE)))
    target_db = db or meta["db"]
    if target_db not in domain.catalog.databases:
        domain.catalog.create_database(target_db)
    counts = {}
    for name, tm in sorted(meta["tables"].items()):
        # fresh table id: restored keys are rewritten to the new id (BR's
        # table-id rewrite rule, br/pkg/restore)
        new_id = domain.alloc_table_id()
        tbl = TableInfo(
            tm["name"], list(tm["col_names"]),
            [_type_from_meta(m) for m in tm["col_types"]],
            list(tm["primary_key"]), tm["auto_inc_col"],
            table_id=new_id, kv=domain.kv)
        tbl._auto_inc = tm["auto_inc"]
        tbl._next_handle = tm["next_handle"]
        for ixm in tm["indexes"]:
            tbl.indexes.append(IndexInfo(ixm["name"], ixm["index_id"],
                                         list(ixm["columns"]),
                                         ixm["unique"]))
            tbl._next_index_id = max(tbl._next_index_id, ixm["index_id"])
        domain.catalog.create_table(target_db, tbl)
        old_prefix = b"t" + encode_int_key(tm["table_id"])
        new_prefix = b"t" + encode_int_key(new_id)
        pairs = list(_read_kvs(os.path.join(out_dir,
                                            f"{meta['db']}.{name}.kv")))
        n = 0
        for off in range(0, len(pairs), batch):
            txn = domain.kv.begin()
            for k, v in pairs[off:off + batch]:
                assert k.startswith(old_prefix)
                txn.put(new_prefix + k[len(old_prefix):], v)
                n += 1
            txn.commit()
        tbl._invalidate()
        counts[name] = n
    return counts


# ------------------------------------------------------------------ #
# log backup + PITR (br/pkg/streamhelper + restore point-in-time analog)
# ------------------------------------------------------------------ #

STREAM_FILE = "stream.json"


def _table_ranges(meta):
    for name, tm in sorted(meta["tables"].items()):
        tid = tm["table_id"]
        yield name, (record_prefix(tid), record_prefix_end(tid))
        yield name, (index_prefix(tid), index_prefix_end(tid))


def _scan_all(kv, meta, ts) -> dict:
    out: dict[bytes, bytes] = {}
    for _name, (lo, hi) in _table_ranges(meta):
        for k, v in kv.scan(lo, hi, ts):
            out[k] = v
    return out


def log_backup_start(domain, db: str, out_dir: str) -> dict:
    """Begin a PITR-capable backup stream: a base snapshot backup plus
    stream bookkeeping.  Subsequent log_backup_tick() calls append
    incremental change chunks (the log-backup task analog: RPO = tick
    interval; each chunk carries the new values and tombstones of every
    key that changed since the previous checkpoint ts)."""
    counts = backup(domain, db, out_dir)
    meta = json.load(open(os.path.join(out_dir, META_FILE)))
    _save_stream(out_dir, {"last_ts": meta["backup_ts"],
                           "increments": []})
    return counts


def _save_stream(out_dir: str, state: dict) -> None:
    spath = os.path.join(out_dir, STREAM_FILE)
    with open(spath + ".tmp", "w") as f:
        json.dump(state, f)
    os.replace(spath + ".tmp", spath)    # atomic: crash can't corrupt


def log_backup_tick(domain, out_dir: str) -> int:
    """Archive one incremental chunk: every key whose value changed (or
    that was deleted) between the stream's checkpoint ts and now.
    Returns the number of changed keys.  Restorable to any tick ts.

    Cost note: the diff is computed from two full snapshot scans, so a
    tick is O(database), not O(churn) — acceptable at this engine's
    scale; the upgrade path is a native-engine version-range scan
    (commit_ts in (last_ts, new_ts]), which the MVCC store already has
    the data for."""
    meta = json.load(open(os.path.join(out_dir, META_FILE)))
    spath = os.path.join(out_dir, STREAM_FILE)
    state = json.load(open(spath))
    new_ts = domain.kv.alloc_ts()
    old = _scan_all(domain.kv, meta, state["last_ts"])
    new = _scan_all(domain.kv, meta, new_ts)
    changes = []
    for k, v in new.items():
        if old.get(k) != v:
            changes.append((b"P" + k, v))           # put/update
    for k in old:
        if k not in new:
            changes.append((b"D" + k, b""))          # tombstone
    if changes:
        _write_kvs(os.path.join(out_dir, f"inc-{new_ts}.kv"), changes)
        state["increments"].append(new_ts)
    state["last_ts"] = new_ts
    _save_stream(out_dir, state)
    return len(changes)


def restore_pitr(domain, out_dir: str, restore_ts: Optional[int] = None,
                 db: Optional[str] = None) -> dict:
    """Point-in-time restore: base snapshot + every incremental chunk
    with ts <= restore_ts (default: all), with the same table-id rewrite
    as snapshot restore."""
    meta = json.load(open(os.path.join(out_dir, META_FILE)))
    state = json.load(open(os.path.join(out_dir, STREAM_FILE)))
    if restore_ts is not None and restore_ts < meta["backup_ts"]:
        raise ValueError(
            f"restore_ts {restore_ts} predates the base backup "
            f"({meta['backup_ts']}); no data exists before it")
    counts = restore(domain, out_dir, db=db)
    target_db = db or meta["db"]
    # old table id -> new prefix mapping from the freshly restored tables
    remap = {}
    for name, tm in meta["tables"].items():
        tbl = domain.catalog.get_table(target_db, name)
        remap[tm["table_id"]] = (b"t" + encode_int_key(tm["table_id"]),
                                 b"t" + encode_int_key(tbl.table_id), tbl)
    applied = 0
    for ts in sorted(state["increments"]):
        if restore_ts is not None and ts > restore_ts:
            break
        txn = domain.kv.begin()
        for tag_k, v in _read_kvs(os.path.join(out_dir, f"inc-{ts}.kv")):
            tag, k = tag_k[:1], tag_k[1:]
            for old_p, new_p, _tbl in remap.values():
                if k.startswith(old_p):
                    nk = new_p + k[len(old_p):]
                    if tag == b"P":
                        txn.put(nk, v)
                    else:
                        txn.delete(nk)
                    applied += 1
                    break
        txn.commit()
    for _old, _new, tbl in remap.values():
        tbl._invalidate()
        tbl._needs_counter_recovery = True   # handles may have grown
        tbl._recover_counters()
    counts["_incremental_keys"] = applied
    return counts


__all__ = ["backup", "restore", "log_backup_start", "log_backup_tick",
           "restore_pitr"]

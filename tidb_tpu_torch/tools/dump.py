# ported from tidb_tpu/tools/dump.py @ f12d972
"""Dumpling analog: parallel logical export with a consistent snapshot.

Reference: dumpling/ (12.8k LoC) — exports schema + data as SQL or CSV,
one file set per table, all tables read at ONE snapshot ts so the dump
is transactionally consistent; N worker threads export tables in
parallel (dumpling's per-table goroutines + chunked files).
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..session.codec_io import scan_table_rows
from ..sql.bind import sql_literal


def _create_table_sql(tbl) -> str:
    cols = []
    for n, t in zip(tbl.col_names, tbl.col_types):
        line = f"  `{n}` {_sql_type(t)}"
        if not t.nullable:
            line += " NOT NULL"
        if tbl.auto_inc_col == n:
            line += " AUTO_INCREMENT"
        cols.append(line)
    if tbl.primary_key:
        cols.append("  PRIMARY KEY (" +
                    ", ".join(f"`{c}`" for c in tbl.primary_key) + ")")
    for ix in tbl.indexes:
        if ix.name == "PRIMARY" or ix.state != "public":
            continue
        kind = "UNIQUE KEY" if ix.unique else "KEY"
        cols.append(f"  {kind} `{ix.name}` (" +
                    ", ".join(f"`{c}`" for c in ix.columns) + ")")
    return (f"CREATE TABLE `{tbl.name}` (\n" + ",\n".join(cols) + "\n);")


def _sql_type(t) -> str:
    from ..types import dtypes as dt
    K = dt.TypeKind
    return {
        K.INT64: "bigint", K.UINT64: "bigint unsigned", K.FLOAT64: "double",
        K.FLOAT32: "float", K.STRING: "varchar(255)", K.DATE: "date",
        K.DATETIME: "datetime", K.TIME: "time",
    }.get(t.kind, f"decimal({max(t.prec, 1)},{max(t.scale, 0)})"
          if t.kind == K.DECIMAL else "varchar(255)")


def dump_database(domain, db: str, out_dir: str, fmt: str = "sql",
                  threads: int = 4, rows_per_stmt: int = 200) -> dict:
    """Export all tables of `db`; returns {table: row_count}.

    Layout mirrors dumpling: {db}-schema-create.sql, {db}.{t}-schema.sql,
    {db}.{t}.{000000000}.sql|csv.
    """
    os.makedirs(out_dir, exist_ok=True)
    tables = domain.catalog.databases.get(db)
    if tables is None:
        raise ValueError(f"unknown database {db!r}")
    with open(os.path.join(out_dir, f"{db}-schema-create.sql"), "w") as f:
        f.write(f"CREATE DATABASE IF NOT EXISTS `{db}`;\n")
    # ONE snapshot ts for every table = consistent dump
    ts = domain.kv.alloc_ts()
    counts: dict[str, int] = {}

    def dump_table(name: str) -> tuple[str, int]:
        tbl = tables[name]
        with open(os.path.join(out_dir, f"{db}.{name}-schema.sql"), "w") as f:
            f.write(_create_table_sql(tbl) + "\n")
        if tbl.kv is not None:
            # decode_row already yields dump-ready values (decimals and
            # temporals as strings)
            _, rows = scan_table_rows(tbl.kv, tbl.table_id, ts,
                                      tbl.col_types)
        else:
            snap = tbl.snapshot()
            rows = list(zip(*[c.to_python() for c in snap.columns])) \
                if snap.num_rows else []
        path = os.path.join(out_dir, f"{db}.{name}.000000000.{fmt}")
        if fmt == "csv":
            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(tbl.col_names)
                for r in rows:
                    w.writerow(["\\N" if v is None else v for v in r])
        else:
            with open(path, "w") as f:
                for off in range(0, len(rows), rows_per_stmt):
                    chunk = rows[off:off + rows_per_stmt]
                    vals = ",\n".join(
                        "(" + ",".join(sql_literal(v) for v in r) + ")"
                        for r in chunk)
                    f.write(f"INSERT INTO `{name}` VALUES\n{vals};\n")
        return name, len(rows)

    with ThreadPoolExecutor(max_workers=max(threads, 1),
                            thread_name_prefix="dump") as pool:
        for name, n in pool.map(dump_table, sorted(tables)):
            counts[name] = n
    return counts


__all__ = ["dump_database"]

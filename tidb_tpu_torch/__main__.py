# ported from tidb_tpu/__main__.py @ 6233200
"""CLI entry point: server + ecosystem tools in one binary.

Reference analog: cmd/tidb-server/main.go (serve) plus the separate
Dumpling / Lightning binaries (SURVEY.md §2.8) — subcommands of
`python -m tidb_tpu_torch`:

  serve      start the MySQL wire server + HTTP status API
  dump       logical export from a running server (dumpling)
  import     CSV load into a running server over the wire (lightning's
             tidb backend mode)

``serve --device`` chooses the device of the server's Domain: ``cuda``
(the default, one H100) or ``cpu``.  Asking for ``cuda`` where torch
finds no GPU exits non-zero with the Domain's error before a port is
bound.  ``serve`` starts the Domain's background workers
(``Domain.start_background``: the GC worker's timer, TTL, the
auto-analyze sweep and the workload repository), as the JAX package's
does; a ``--config`` file's ``[variables]`` with ``tidb_tpu_pd = 1`` and
one ``tidb_tpu_pd_dir`` joins several ``serve`` processes on one card to
one coordination plane (pd/).  The JAX package's embedded tools
(BR-style backup/restore, the direct-ingest import) are not ported.
"""

from __future__ import annotations

import argparse
import sys


def _domain(args=None):
    from .session.session import Domain
    device = getattr(args, "device", None) or "cuda"
    data_dir = getattr(args, "data_dir", None)
    if data_dir:
        return Domain(device, data_dir=data_dir,
                      sync=bool(getattr(args, "sync_wal", False)))
    return Domain(device)


def cmd_serve(args) -> int:
    import time
    from .config import apply_to_domain, load_config
    from .server import MySQLServer, StatusServer
    cfg = load_config(getattr(args, "config", None))
    # precedence: explicit CLI flag > config file > built-in default
    # (argparse defaults are None sentinels so an explicit flag at its
    # default value still wins)
    if args.host is None:
        args.host = cfg.host
    if args.port is None:
        args.port = cfg.port
    if args.status_port is None:
        args.status_port = cfg.status_port
    if getattr(args, "data_dir", None) is None:
        args.data_dir = cfg.data_dir
    if not getattr(args, "sync_wal", False):
        args.sync_wal = cfg.sync_wal
    try:
        dom = _domain(args)
    except (RuntimeError, ValueError) as e:   # no GPU for --device cuda
        print(f"tidb-tpu: {e}", file=sys.stderr, flush=True)
        return 1
    apply_to_domain(cfg, dom)
    dom.start_background()
    srv = MySQLServer(dom, host=args.host, port=args.port)
    port = srv.start()
    st = StatusServer(dom, host=args.host, port=args.status_port)
    sport = st.start()
    print(f"tidb-tpu server listening on {args.host}:{port} "
          f"(status :{sport})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("shutting down...", flush=True)
        srv.close()
        st.close()
        dom.close()
    return 0


def cmd_dump(args) -> int:
    """Wire-based logical export from a RUNNING server (how dumpling
    actually operates; the embedded snapshot-consistent variant is
    tools.dump_database)."""
    import csv
    import os
    from .server.client import Client
    from .sql.bind import sql_literal
    os.makedirs(args.out, exist_ok=True)
    c = Client(args.host, args.port, user=args.user,
               password=args.password, db=args.db)
    tables = [r[0] for r in c.query("show tables")]
    total = 0
    for t in tables:
        cols = [r[0] for r in c.query(f"show columns from {t}")]
        rows = c.query(f"select * from {t}")
        total += len(rows)
        path = os.path.join(args.out, f"{args.db}.{t}.000000000.{args.format}")
        if args.format == "csv":
            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(cols)
                for r in rows:
                    w.writerow(["\\N" if v is None else v for v in r])
        else:
            with open(path, "w") as f:
                for off in range(0, len(rows), 200):
                    chunk = rows[off:off + 200]
                    vals = ",\n".join(
                        "(" + ",".join(sql_literal(v) for v in r) + ")"
                        for r in chunk)
                    if chunk:
                        f.write(f"INSERT INTO `{t}` VALUES\n{vals};\n")
    c.close()
    print(f"dumped {total} rows from {len(tables)} tables to {args.out}")
    return 0


def cmd_import(args) -> int:
    """Wire-based CSV load (lightning's 'tidb' backend: batched INSERTs
    through the SQL path; the direct-KV local backend is the embedded
    tools.lightning.import_csv)."""
    import csv
    from .server.client import Client
    from .sql.bind import sql_literal
    c = Client(args.host, args.port, user=args.user,
               password=args.password, db=args.db)
    with open(args.file, newline="") as f:
        rows = list(csv.reader(f))
    if rows:
        rows = rows[1:]  # header
    total = 0
    for off in range(0, len(rows), args.batch):
        chunk = rows[off:off + args.batch]
        vals = ",".join(
            "(" + ",".join("NULL" if v in ("", "\\N") else sql_literal(v)
                           for v in r) + ")"
            for r in chunk)
        c.execute(f"insert into {args.table} values {vals}")
        total += len(chunk)
    c.close()
    print(f"imported {total} rows into {args.db}.{args.table}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tidb_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser(
        "serve", help="run the MySQL wire server",
        description="Start the MySQL wire server and the HTTP status API "
                    "over one Domain on --device.  The Domain's background "
                    "workers (GC timer, TTL, auto-analyze sweep) are not "
                    "started: the port has none yet (ROADMAP.md, Queue 1 "
                    "entry 13).")
    s.add_argument("--host", default=None)
    s.add_argument("--port", type=int, default=None)
    s.add_argument("--status-port", type=int, default=None)
    s.add_argument("--config", default=None,
                   help="TOML config file (pkg/config analog)")
    s.add_argument("--data-dir", default=None,
                   help="durable storage dir (WAL + catalog-on-KV); "
                        "omit for in-memory")
    s.add_argument("--sync-wal", action="store_true",
                   help="fdatasync every commit record")
    s.add_argument("--device", default="cuda",
                   help="device of the server's Domain: cuda (the "
                        "default; fails without a GPU) or cpu")
    s.set_defaults(fn=cmd_serve)

    d = sub.add_parser("dump", help="logical export from a running "
                                    "server (dumpling)")
    d.add_argument("--host", default="127.0.0.1")
    d.add_argument("--port", type=int, default=4000)
    d.add_argument("--user", default="root")
    d.add_argument("--password", default="")
    d.add_argument("--db", default="test")
    d.add_argument("--out", required=True)
    d.add_argument("--format", choices=("sql", "csv"), default="sql")
    d.set_defaults(fn=cmd_dump)

    i = sub.add_parser("import", help="CSV load into a running server "
                                      "(lightning tidb-backend mode)")
    i.add_argument("--host", default="127.0.0.1")
    i.add_argument("--port", type=int, default=4000)
    i.add_argument("--user", default="root")
    i.add_argument("--password", default="")
    i.add_argument("--db", default="test")
    i.add_argument("--table", required=True)
    i.add_argument("--file", required=True)
    i.add_argument("--batch", type=int, default=200)
    i.set_defaults(fn=cmd_import)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

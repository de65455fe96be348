# ported from tidb_tpu/store/server.py @ ba365f2
"""Store server: the coprocessor engine behind a socket.

Reference analog: a unistore/TiKV store process — a region server that
holds replicas and executes coprocessor DAGs shipped from the SQL layer
(pkg/store/mockstore/unistore/tikv/server.go:45
Coprocessor(), cophandler/cop_handler.go handleCopDAGRequest).  The TPU
build's SQL layer fuses shard programs on the device; THIS process is the
remote-store role of the same contract: it stores replicated columnar
tables, executes serialized DAGs over requested row ranges with the host
engines, and returns PARTIAL aggregation states (the psum-seam contract,
copr/aggregate.py) or row columns for the client to merge.

Run: ``python -m tidb_tpu_torch.store.server [--port 0]`` — prints
``PORT <n>`` on stdout once listening.  In the port, as in the JAX
package, a store process is the host role: it aggregates with the numpy
engines of copr/hostagg and never touches a device (store/remote.py
starts it with ``CUDA_VISIBLE_DEVICES=""``).

Protocol (store/rpc.py frames; one request -> one response):
  ("load", table, epoch, names, dtypes, columns)      -> ("ok",)
  ("exec_agg", table, epoch, dag, ranges)             -> ("states", st)
  ("exec_rows", table, epoch, dag, ranges, dtypes)    -> ("rows", cols)
  ("ping",)                                           -> ("pong",)
  ("fail_after", k)    [failpoint: exit before the k-th next response]
Stale ``epoch`` returns ("err", "stale_epoch", have_epoch) — the client
re-ships the table (region-epoch-not-match analog).
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading

import numpy as np

from .rpc import recv_msg, send_msg


class StoreEngine:
    """In-process state of one store: replicated tables + executors."""

    def __init__(self):
        self.tables: dict = {}      # name -> (epoch, snapshot)
        self.mu = threading.Lock()
        self.requests_served = 0

    # ---------------- table replication ---------------- #

    def load(self, table: str, epoch: int, names, dtypes, columns):
        from .columnar import ColumnarSnapshot
        snap = ColumnarSnapshot(list(names), list(dtypes), list(columns),
                                epoch=epoch, n_shards=1)
        with self.mu:
            self.tables[table] = (epoch, snap)

    def _snap_for(self, table: str, epoch: int, ranges):
        from ..chunk.column import Column
        from .columnar import ColumnarSnapshot
        with self.mu:
            ent = self.tables.get(table)
        if ent is None:
            return None, ("err", "no_table", table)
        have, snap = ent
        if have != epoch:
            return None, ("err", "stale_epoch", have)
        if ranges is None or [tuple(r) for r in ranges] == \
                [(0, snap.num_rows)]:
            return snap, None
        cols = []
        for c in snap.columns:
            parts = [c.slice(lo, hi) for lo, hi in ranges]
            cols.append(parts[0] if len(parts) == 1
                        else Column.concat(parts))
        sub = ColumnarSnapshot(snap.names, snap.dtypes, cols,
                               epoch=epoch, n_shards=1)
        return sub, None

    # ---------------- executors ---------------- #

    def exec_agg(self, table: str, epoch: int, agg, ranges):
        from ..copr import dag as D
        from ..copr.hostagg import host_dense_agg, host_sort_agg
        snap, err = self._snap_for(table, epoch, ranges)
        if err is not None:
            return err
        if agg.strategy in D.HOST_MERGE_STRATEGIES:
            st = host_sort_agg(agg, snap)
        else:
            st = host_dense_agg(agg, snap)
        if st is None:
            return ("err", "unsupported", "agg outside host-engine scope")
        return ("states", st)

    def exec_rows(self, table: str, epoch: int, dag, ranges, out_dtypes):
        from ..chunk.column import Column
        from ..copr import dag as D
        from ..copr.hostagg import _host_scan_chain
        snap, err = self._snap_for(table, epoch, ranges)
        if err is not None:
            return err
        root = dag
        topn = None
        limit = None
        if isinstance(root, D.TopN):
            topn, root = root, root.child
        elif isinstance(root, D.Limit):
            limit, root = root.limit, root.child
        chain = _host_scan_chain(root, snap)
        if chain is None:
            return ("err", "unsupported", "row plan outside scan-chain scope")
        cols, live = chain
        n = len(cols[0][0]) if cols else 0
        if live is not None:
            idx = np.nonzero(live)[0]
            cols = [(np.asarray(v)[idx] if np.ndim(v) else v,
                     m if m is True else np.asarray(m)[idx])
                    for v, m in cols]
            n = len(idx)
        if topn is not None:
            keep = _topn_indices(topn, cols, n)
            cols = [(np.asarray(np.broadcast_to(v, (n,)))[keep],
                     m if m is True else np.asarray(m)[keep])
                    for v, m in cols]
            n = len(keep)
        elif limit is not None:
            cols = [(np.asarray(np.broadcast_to(v, (n,)))[:limit],
                     m if m is True else np.asarray(m)[:limit])
                    for v, m in cols]
            n = min(n, limit)
        out = []
        for (v, m), t in zip(cols, out_dtypes):
            v = np.broadcast_to(np.asarray(v), (n,))
            valid = (np.ones(n, bool) if m is True
                     else np.broadcast_to(np.asarray(m), (n,)).copy())
            out.append(Column(t, v.astype(t.np_dtype())
                              if v.dtype != object else v, valid))
        return ("rows", out)


def _topn_indices(topn, cols, n: int) -> np.ndarray:
    """Per-store TopN candidates: rank-sort (uint-safe, MySQL NULL
    ordering — first ASC, last DESC) and trim; the SQL-layer caller
    re-trims the cross-store union (cophandler/topn.go discipline)."""
    from ..expr.host_eval import eval_expr
    keys = topn.sort_keys or ((topn.sort_key, topn.desc),)
    lex = []
    for e, desc in reversed(list(keys)):
        v, m = eval_expr(np, e, cols)
        v = np.broadcast_to(np.asarray(v), (n,))
        valid = (np.ones(n, bool) if m is True
                 else np.broadcast_to(np.asarray(m), (n,)))
        _, ranks = np.unique(v, return_inverse=True)
        ranks = ranks.astype(np.int64) + 1
        if desc:
            ranks = -ranks
        lex.append(np.where(valid, ranks, 0))
    order = np.lexsort(tuple(lex)) if lex else np.arange(n)
    return order[:topn.limit]


class CatalogStoreEngine(StoreEngine):
    """TiDB-as-coprocessor (executor/coprocessor.go:57): the SQL process
    itself serves coprocessor requests over its OWN catalog tables — a
    peer ships a DAG naming "db.table" and gets partial states / rows
    back, exactly as from a store process.  Snapshots resolve live from
    the catalog; epoch -1 means "latest" (the response carries the
    snapshot epoch the execution bound)."""

    def __init__(self, domain):
        super().__init__()
        self.domain = domain

    def _snap_for(self, table: str, epoch: int, ranges):
        from ..chunk.column import Column
        from .columnar import ColumnarSnapshot
        db, _, name = table.partition(".")
        if not name:
            db, name = "test", db
        try:
            tbl = self.domain.catalog.get_table(db, name)
        except Exception:
            return super()._snap_for(table, epoch, ranges)
        snap = tbl.snapshot()
        if epoch not in (-1, snap.epoch):
            return None, ("err", "stale_epoch", snap.epoch)
        if ranges is None:
            return snap, None
        cols = []
        for c in snap.columns:
            parts = [c.slice(lo, hi) for lo, hi in ranges]
            cols.append(parts[0] if len(parts) == 1
                        else Column.concat(parts))
        return ColumnarSnapshot(snap.names, snap.dtypes, cols,
                                epoch=snap.epoch, n_shards=1), None


def serve_coprocessor(domain, port: int = 0) -> int:
    """Expose this SQL process as a coprocessor endpoint on 127.0.0.1;
    returns the bound port.  Runs the accept loop on a daemon thread."""
    eng = CatalogStoreEngine(domain)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(16)
    bound = srv.getsockname()[1]

    def accept_loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=_handle_conn, args=(eng, conn),
                             daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True,
                     name="coprocessor-endpoint").start()
    domain._copr_endpoint = (srv, bound)
    return bound


def _handle_conn(eng: StoreEngine, conn) -> None:
    try:
        while True:
            msg = recv_msg(conn)
            op = msg[0]
            if op == "ping":
                resp = ("pong", eng.requests_served)
            elif op == "load":
                eng.load(*msg[1:])
                resp = ("ok",)
            elif op == "exec_agg":
                resp = eng.exec_agg(*msg[1:])
            elif op == "exec_rows":
                resp = eng.exec_rows(*msg[1:])
            else:
                resp = ("err", "bad_op", op)
            eng.requests_served += 1
            send_msg(conn, resp)
    except (ConnectionError, OSError):
        pass
    finally:
        conn.close()


def _dxf_backfill(table_id, index_id, unique, offs, col_types, rows):
    """DXF taskexecutor role (disttask framework worker): compute the
    index KV entries for one backfill subtask.  The owner ships
    (handle, encoded row) pairs and commits the returned entries — the
    reference's ingest-mode split (workers encode, the owner ingests,
    backfilling_dist_scheduler.go)."""
    from .codec import decode_row, encode_index_entry
    entries = []
    for h, rv in rows:
        row = decode_row(rv, col_types)
        vals = [row[i] for i in offs]
        types = [col_types[i] for i in offs]
        k, v = encode_index_entry(table_id, index_id, vals, types,
                                  int(h), unique)
        entries.append((int(h), k, v))
    return ("entries", entries)


def serve(port: int = 0):
    eng = StoreEngine()
    fail_after = [None]    # failpoint: exit before the k-th next response
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(16)
    print(f"PORT {srv.getsockname()[1]}", flush=True)

    def handle(conn):
        try:
            while True:
                msg = recv_msg(conn)
                op = msg[0]
                if fail_after[0] is not None:
                    fail_after[0] -= 1
                    if fail_after[0] <= 0:
                        os._exit(17)   # simulated store crash mid-query
                if op == "ping":
                    resp = ("pong", eng.requests_served)
                elif op == "load":
                    eng.load(*msg[1:])
                    resp = ("ok",)
                elif op == "exec_agg":
                    resp = eng.exec_agg(*msg[1:])
                elif op == "exec_rows":
                    resp = eng.exec_rows(*msg[1:])
                elif op == "dxf_backfill":
                    resp = _dxf_backfill(*msg[1:])
                elif op == "fail_after":
                    fail_after[0] = int(msg[1])
                    resp = ("ok",)
                else:
                    resp = ("err", "bad_op", op)
                eng.requests_served += 1
                send_msg(conn, resp)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    while True:
        conn, _ = srv.accept()
        threading.Thread(target=handle, args=(conn,), daemon=True).start()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    serve(args.port)


if __name__ == "__main__":
    sys.exit(main())

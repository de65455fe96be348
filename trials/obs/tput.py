"""Statements/s of warm TPC-H Q6 for the tidb_tpu_torch package found in
DIR, with ``tidb_tpu_trace`` on and off in turns, on one card: one
connection x 80 calls and four connections x 20 calls (chip_smoke.py's
phases 14 and 16e), over the MySQL wire and through in-process
Sessions.  Compare two versions in one call, each in its own process,
in turns (parent, change, change, parent):

    python trials/obs/tput.py DIR LABEL [--sf 10] [--rounds 5]
        [--variant nosummary,notiming] [--profile OUT]

A round runs every (path, trace) setting once; each line gives a
setting's median and its values over the rounds.  ``--variant
nosummary`` stubs ``StmtSummary.record`` and ``notiming`` the
scheduler's launch timing events, to split the observing cost (the
change only: a parent without them is left as it is).  ``--profile``
writes the in-process one-connection run's hottest functions (cProfile,
the statement's thread) to OUT.  Unpack a parent with ``git archive
<sha> tidb_tpu_torch | tar -x -C chip_check/parent``.
"""
import argparse
import cProfile
import io
import pstats
import statistics
import sys
import threading
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("label")
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--variant", default="")
    ap.add_argument("--profile", metavar="OUT")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, args.dir)
    import torch

    import tidb_tpu_torch
    from tidb_tpu_torch.server.client import Client
    from tidb_tpu_torch.server.mysql_server import MySQLServer
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store import client as C
    from tidb_tpu_torch.testing import tpch
    on_card = args.device == "cuda"
    if on_card:
        from tidb_tpu_torch.copr.cuda import build as kb
        from tidb_tpu_torch.copr.cuda import group_reduce as gr
        from tidb_tpu_torch.copr.cuda import onesweep as os1
        from tidb_tpu_torch.copr.cuda import radix_kernel as rk
        kb.build_all([m.LIBRARY.src for m in (rk, gr, os1)])
    if "nosummary" in args.variant:
        from tidb_tpu_torch.utils import stmtsummary
        stmtsummary.StmtSummary.record = lambda self, *a, **k: False
    if "notiming" in args.variant:
        from tidb_tpu_torch.sched import scheduler
        scheduler.DeviceScheduler._device_mark = staticmethod(
            lambda lead: None)
    C.RESULT_CACHE_ENTRIES = 0
    t0 = time.perf_counter()
    data = tpch.gen_lineitem(args.sf, seed=0, columns=[
        "l_quantity", "l_extendedprice", "l_discount", "l_shipdate"])
    sess = tpch.sql_session({"lineitem": data}, device=args.device)
    q6 = tpch.SQL_QUERIES["Q6"]
    want = sess.execute(q6).rows
    for _ in range(20):
        assert sess.execute(q6).rows == want
    print(f"tput {args.label}: setup_s={time.perf_counter() - t0:.1f}",
          flush=True)
    srv = MySQLServer(sess.domain, host="127.0.0.1", port=0)
    port = srv.start()
    wire = Client("127.0.0.1", port, db="test").query(q6)

    def local(trace):
        s = Session(sess.domain)
        s.execute(f"set tidb_tpu_trace = {trace}")
        return lambda: s.execute(q6).rows == want

    def remote(trace):
        cl = Client("127.0.0.1", port, db="test")
        cl.query(f"set tidb_tpu_trace = {trace}")
        return lambda: cl.query(q6) == wire
    paths = {"session": local, "wire": remote}
    conns = {(p, t, n): [paths[p](t) for _ in range(n)]
             for p in paths for t in (1, 0) for n in (1, 4)}

    def tput(stmts, calls):
        bad = []

        def run(stmt):
            for _ in range(calls):
                if not stmt():
                    bad.append(1)
        ths = [threading.Thread(target=run, args=(s,)) for s in stmts]
        t0 = time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        assert not bad, "a result differs"
        return len(stmts) * calls / (time.perf_counter() - t0)
    got: dict = {k: [] for k in conns}
    for _ in range(args.rounds):
        for (p, t, n), stmts in conns.items():
            got[p, t, n].append(tput(stmts, 80 // n))
    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    for (p, t, n), vals in got.items():
        print(f"tput {args.label} {args.variant or 'default'} path={p} "
              f"trace={t} conns={n} stmts_per_s="
              f"{statistics.median(vals):.1f} "
              f"{[round(v, 1) for v in vals]} sf={args.sf} card={card} "
              f"pkg={tidb_tpu_torch.__file__}", flush=True)
    if args.profile:
        stmt = conns["session", 1, 1][0]
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(80):
            stmt()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(30)
        with open(args.profile, "w") as f:
            f.write(out.getvalue())
    srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

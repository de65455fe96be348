"""Run chip_smoke.py's coordination-and-background phase (19) alone on
the GPU, after building the kernels: the quick way to iterate on pd/,
the timers, TTL, auto-analyze, DXF and the advisor on the card.

    python trials/pd/phase19.py [--main-sf 10] [--serve-sf 0.01]

It generates phase 7's lineitem columns at ``--main-sf`` (seed 0, the
columns ``chip_smoke.Q_COLS``), places them through a session and
ANALYZEs them as phases 12a and 13c do, so its numbers are phase 19's
of a full run at the same scale (a full run's Domain holds more tables
and more statement history).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--main-sf", type=float, default=10.0)
    ap.add_argument("--serve-sf", type=float, default=cs.SERVE_PD_SF)
    args = ap.parse_args()
    cs.SERVE_PD_SF = args.serve_sf
    import torch
    from tidb_tpu_torch.copr.cuda import group_reduce as gr
    from tidb_tpu_torch.copr.cuda import onesweep as os1
    from tidb_tpu_torch.copr.cuda import radix_kernel as rk
    from tidb_tpu_torch.store import client as client_mod
    from tidb_tpu_torch.testing import tpch
    print(torch.cuda.get_device_name(0), cs.nvidia_smi())
    client_mod.RESULT_CACHE_ENTRIES = 0
    cs.build_phase(rk, gr, os1)
    t0 = time.perf_counter()
    main_data = tpch.gen_lineitem(args.main_sf, seed=0, columns=cs.Q_COLS)
    print(f"data: lineitem sf={args.main_sf} rows={len(main_data[1][0])} "
          f"gen_s={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    sess = tpch.sql_session({"lineitem": main_data}, device="cuda")
    sess.execute("select count(*) from lineitem")       # placed, as 12a
    sess.execute("analyze table lineitem")               # as 13c
    for name in ("Q1", "Q6"):
        sess.execute(tpch.SQL_QUERIES[name])
    print(f"placement and analyze s={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    # phase 7's checked answers, which the phases after it take
    main_res = {q: cs.main_oracle(q, *main_data) for q in ("Q1", "Q6")}
    cs.pd_phase(gr, os1, sess, main_data, main_res)
    print(f"phase 19 s={time.perf_counter() - t0:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

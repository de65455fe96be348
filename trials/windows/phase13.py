"""Run chip_smoke.py's windows-and-statistics phase (13) alone on the GPU,
after building the kernels: the quick way to iterate on the window
program, ANALYZE and the strategy choice.

    python trials/windows/phase13.py [--main-sf 10] [--s4-sf 1]

It generates phase 7's lineitem columns at ``--main-sf`` (seed 0, the
columns ``chip_smoke.Q_COLS``) and places them through a session as
phase 12a does, and phase 8's at ``--s4-sf`` (``chip_smoke.SQL_COLS``),
so its numbers are phase 13's of a full run at the same scales.
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
    ap.add_argument("--s4-sf", type=float, default=1.0)
    args = ap.parse_args()
    import torch
    from tidb_tpu_torch.copr.cuda import group_reduce as gr
    from tidb_tpu_torch.copr.cuda import onesweep as os1
    from tidb_tpu_torch.copr.cuda import radix_kernel as rk
    from tidb_tpu_torch.ops import sort as S
    from tidb_tpu_torch.testing import tpch
    print(torch.cuda.get_device_name(0), cs.nvidia_smi())
    cs.build_phase(rk, gr, os1)
    t0 = time.perf_counter()
    main_data = tpch.gen_lineitem(args.main_sf, seed=0, columns=cs.Q_COLS)
    s4_data = tpch.gen_lineitem(args.s4_sf, seed=0, columns=cs.SQL_COLS)
    print(f"data: lineitem sf={args.main_sf} rows={len(main_data[1][0])} "
          f"s4 sf={args.s4_sf} rows={len(s4_data[1][0])} "
          f"gen_s={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    sess = tpch.sql_session({"lineitem": main_data}, device="cuda")
    sess.execute("select count(*) from lineitem")       # placed, as 12a
    print(f"placement s={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    cs.window_stats_phase(torch, gr, os1, S, sess, main_data, s4_data)
    print(f"phase 13 s={time.perf_counter() - t0:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

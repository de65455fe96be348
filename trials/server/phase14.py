"""Run chip_smoke.py's server phase (14) alone on the GPU, after
building the kernels: the quick way to iterate on the wire server.

    python trials/server/phase14.py [--main-sf 10]

It generates phase 7's lineitem columns at ``--main-sf`` (seed 0, the
columns ``chip_smoke.Q_COLS``) and places them through a session as
phase 12a does, so its numbers are phase 14's of a full run at the
same scale; Q1's and Q6's rows are checked against their numpy
oracles (phase 9's check) without phase 7's DAG-level results.
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
    sess = tpch.sql_session({"lineitem": main_data}, device="cuda")
    sess.execute("select count(*) from lineitem")       # placed, as 12a
    print(f"data and placement s={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    cs.server_phase(torch, gr, os1, S, sess, main_data, {})
    print(f"phase 14 s={time.perf_counter() - t0:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run chip_smoke.py's SELECT-surface phase (12) alone on the GPU, after
building the kernels: the quick way to iterate on the device lanes,
rollup and the 22 TPC-H statements.

    python trials/select/phase12.py [--main-sf 10] [--tpch-sf 0.01]

It generates phase 7's lineitem columns at ``--main-sf`` itself (seed 0,
the columns ``chip_smoke.Q_COLS``), so its numbers are phase 12's of a
full run at the same scales.
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
    ap.add_argument("--tpch-sf", type=float, default=cs.TPCH_SF)
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
    print(f"data: lineitem sf={args.main_sf} rows={len(main_data[1][0])} "
          f"gen_s={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    cs.select_phase(torch, gr, os1, S, main_data, args.main_sf, args.tpch_sf)
    print(f"phase 12 s={time.perf_counter() - t0:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

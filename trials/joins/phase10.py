"""Run chip_smoke.py's join phase (10) alone on the GPU, after building
the kernels: the quick way to iterate on the join path.

    python trials/joins/phase10.py [--main-sf 10] [--s4-sf 1]

It generates phase 7's and phase 9's lineitem columns itself (seed 0),
so its numbers are phase 10's of a full run.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    print(f"gen_s={time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    cs.join_phase(torch, gr, os1, S, main_data, args.main_sf, s4_data,
                  args.s4_sf)
    print(f"phase 10 s={time.perf_counter() - t0:.2f}")
    subprocess.run(["nvidia-smi", "--query-gpu=memory.used,memory.total",
                    "--format=csv"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())

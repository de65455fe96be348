"""Run chip_smoke.py's tools-and-cascades phase (20) alone on the GPU,
after building the kernels: the quick way to iterate on tools/ and
planner/cascades/ on the card.

    python trials/tools/phase20.py [--sf 0.1]

Phase 20 makes its own Domain and tables, so its numbers are those of a
full run at the same scale (a full run reaches it with the card's
memory and the host's caches warmer).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=cs.TOOLS_SF)
    args = ap.parse_args()
    cs.TOOLS_SF = args.sf
    import torch
    from tidb_tpu_torch.copr.cuda import group_reduce as gr
    from tidb_tpu_torch.copr.cuda import onesweep as os1
    from tidb_tpu_torch.copr.cuda import radix_kernel as rk
    from tidb_tpu_torch.store import client as client_mod
    print(torch.cuda.get_device_name(0), cs.nvidia_smi())
    client_mod.RESULT_CACHE_ENTRIES = 0
    cs.build_phase(rk, gr, os1)
    t0 = time.perf_counter()
    launched = cs.tools_phase(gr, os1)
    print(f"phase 20 s={time.perf_counter() - t0:.2f} "
          f"group_reduce={launched}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

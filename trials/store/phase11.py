"""Run chip_smoke.py's store phase (11) alone on the GPU, after building
the kernels: the quick way to iterate on the row store's path.

    python trials/store/phase11.py

Its numbers are phase 11's of a full run (the phase makes its own data).
"""

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    from tidb_tpu_torch.copr.cuda import group_reduce as gr
    from tidb_tpu_torch.copr.cuda import onesweep as os1
    from tidb_tpu_torch.copr.cuda import radix_kernel as rk
    from tidb_tpu_torch.ops import sort as S
    print(torch.cuda.get_device_name(0), cs.nvidia_smi())
    cs.build_phase(rk, gr, os1)
    t0 = time.perf_counter()
    cs.store_phase(torch, gr, os1, S)
    print(f"phase 11 s={time.perf_counter() - t0:.2f}")
    subprocess.run(["nvidia-smi", "--query-gpu=memory.used,memory.total",
                    "--format=csv"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())

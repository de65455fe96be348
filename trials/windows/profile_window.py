"""Where a window statement's device time goes: one statement of
chip_smoke.py's phase 13 over the SF=10 lineitem under torch.profiler,
its CUDA time by kernel.

    python trials/windows/profile_window.py [--main-sf 10] [--name NAME]

``NAME`` is one of ``chip_smoke.WINDOW_SQL``'s lineitem statements
(default "rank a mode": ~24,000 rows kept, the program at 2^27 rows).
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
    ap.add_argument("--name", default="rank a mode")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tidb_tpu_torch.copr.cuda import group_reduce as gr
    from tidb_tpu_torch.copr.cuda import onesweep as os1
    from tidb_tpu_torch.copr.cuda import radix_kernel as rk
    from tidb_tpu_torch.testing import tpch
    print(torch.cuda.get_device_name(0), cs.nvidia_smi())
    cs.build_phase(rk, gr, os1)
    data = tpch.gen_lineitem(args.main_sf, seed=0, columns=cs.Q_COLS)
    sess = tpch.sql_session({"lineitem": data}, device="cuda")
    sql = next(q for n, q, _w in cs.WINDOW_SQL if n == args.name)
    sess.execute(sql)                                  # placed, warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.execute(sql)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = prof.key_averages()
    # the kernels' own rows (an operator's row repeats its kernels' time)
    dev_us = sum(e.self_device_time_total for e in ev
                 if e.device_type == DeviceType.CUDA)
    print(f"{args.name}: wall_ms={wall * 1e3:.3f} "
          f"device_ms={dev_us / 1e3:.3f} "
          f"idle_share={1 - dev_us / 1e3 / (wall * 1e3):.3f}")
    print(ev.table(sort_by="self_device_time_total", row_limit=25,
                   max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())

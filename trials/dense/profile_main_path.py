"""Where the device time of the DENSE/SCALAR main path goes, on one GPU.

    python trials/dense/profile_main_path.py            # SF=10
    python trials/dense/profile_main_path.py --sf 1

Builds TPC-H lineitem at ``--sf`` (the nine columns Q1, Q6 and Q19
read), places it on the card, runs each query once to warm up, then
once more under ``torch.profiler``.  Prints, per query, the wall time,
the device time summed over the kernels and copies, the device's idle
share of the wall time, and the kernels by device time, the
``group_reduce`` kernels apart from the evaluator's torch kernels.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def device_us(evt) -> float:
    """Device time of a device-side event (a kernel, a copy or a set),
    0 for the host-side operators that launched them."""
    from torch.autograd import DeviceType
    if getattr(evt, "device_type", None) != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    from tidb_tpu_torch.store import CopClient, snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    print(torch.cuda.get_device_name(0), "|", cs.nvidia_smi())
    names, cols = gen_lineitem(args.sf, seed=0, columns=cs.Q_COLS)
    snap = snapshot_from_columns(names, cols)
    client = CopClient("cuda")
    for which in cs.MAIN_QUERIES:
        agg, meta = cs.build_main_query(which, names, cols)
        client.execute_agg(agg, snap, meta)          # warm: places once
        torch.cuda.synchronize()
        cold_ms = client.timings["device"] * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            client.execute_agg(agg, snap, meta)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = [(device_us(e), e.key, e.count) for e in prof.key_averages()
                if device_us(e) > 0]
        busy = sum(r[0] for r in rows)
        gr_us = sum(r[0] for r in rows if "group_reduce" in r[1])
        t = client.timings
        print(f"{which}: wall_ms={wall_us / 1e3:.3f} "
              f"device_ms={t['device'] * 1e3:.3f} "
              f"first_run_device_ms={cold_ms:.3f} "
              f"kernel_and_copy_ms={busy / 1e3:.3f} "
              f"idle_share={1 - busy / wall_us:.3f} "
              f"group_reduce_ms={gr_us / 1e3:.3f} "
              f"group_reduce_share={gr_us / max(busy, 1e-9):.3f} "
              f"device_kernels={sum(r[2] for r in rows)}")
        for us, key, count in sorted(rows, reverse=True)[:args.top]:
            print(f"  {us / 1e3:9.3f} ms {count:5d}x {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

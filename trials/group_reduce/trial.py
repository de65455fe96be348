"""Design trials of group_reduce's small-G path at TPC-H Q1's shape.

    python trials/group_reduce/trial.py            # 67,108,864 rows
    python trials/group_reduce/trial.py --rows 1000000

Builds ``q1_variants.cu`` (three designs with the lanes fixed at compile
time: a staged tile with one-hot registers, a table a warp with peers by
``__match_any_sync``, a private table a thread; and the last in the repo
kernel's lane-major order, with and without run-time columns) and times
each, and the repo's ``group_reduce_lanes`` (the private-table design
with the lanes decoded at run time), on Q1's nine lanes: G = 12, int32
gids, one bool mask, int8 quantity, int32 price and two int64 products.
Two gid distributions: Q1's (``chip_smoke.q1_lane_inputs``: four of the
twelve slots, shares 24.7/24.7/49.3/1.3%) and uniform over the twelve.
Each result is held against ``group_reduce_lanes_plain``; times are
CUDA-event medians with the L2 flushed, taken in turns (each design,
then the same in reverse order).  The repo kernel is also timed on
growing parts of the lane set, and its device time split by kernel
(torch.profiler) from the host's enqueue time.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SRC = Path(__file__).with_name("q1_variants.cu")
VARIANTS = ("staged one-hot", "warp tables", "private, fixed lanes",
            "private, fixed lanes, lane-major",
            "private, fixed lanes, lane-major, run-time columns")


def build():
    from tidb_tpu_torch.copr.cuda import build as kb
    out = kb.BUILD_DIR / "libq1_variants.so"
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([kb.nvcc(), *kb.NVCC_FLAGS, "-o", str(out), str(SRC)],
                       capture_output=True, text=True)
    print(r.stdout + r.stderr)
    if r.returncode:
        raise SystemExit("nvcc failed")
    lib = ctypes.CDLL(str(out))
    p = ctypes.c_void_p
    lib.q1_variant.argtypes = [ctypes.c_int, p, p, p, p, p, p,
                               ctypes.c_longlong, p, p]
    lib.q1_variant.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=cs.MAIN_ROWS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    from tidb_tpu_torch.copr.cuda import group_reduce as gr
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), "|", cs.nvidia_smi())
    lib = build()
    from tidb_tpu_torch.copr.cuda import build as kb
    gr.LIBRARY.get()
    for ln in (x for log in kb.BUILD_LOG for x in log.splitlines()):
        if "registers" in ln or "spill" in ln or "entry function" in ln:
            print("group_reduce.cu ptxas:", ln.strip())
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    n = args.rows
    for dist in ("Q1", "uniform"):
        gid, mask, qty, price, dp, ch = cs.q1_lane_inputs(torch, dev, n,
                                                          dist)
        lanes = cs.limb_lanes(gr, mask, [qty, price, dp, ch])
        want = torch.stack(gr.group_reduce_lanes_plain(gid, 12, lanes))
        table = torch.empty(9 * 12, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def variant(k):
            rc = lib.q1_variant(k, gid.data_ptr(), mask.data_ptr(),
                                qty.data_ptr(), price.data_ptr(),
                                dp.data_ptr(), ch.data_ptr(), n,
                                table.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"variant {k}: CUDA error {rc}")
        runs = {name: (lambda k=k: variant(k))
                for k, name in enumerate(VARIANTS)}
        runs["repo kernel"] = lambda: gr.group_reduce_lanes(gid, 12, lanes)
        for name, fn in runs.items():
            out = fn()
            got = torch.stack(out) if name == "repo kernel" \
                else table.reshape(9, 12)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want), f"{name} ({dist}) != plain")
        times = {name: [] for name in runs}
        order = list(runs) + list(reversed(runs))
        for name in order:
            times[name].append(cs.cuda_ms(torch, runs[name], flush=flush))
        # the repo call apart: device time by kernel, and the host's
        # enqueue time of one call
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            runs["repo kernel"]()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                print(f"trial q1 [{dist} gids] repo call, device: {e.key} "
                      f"us={dev_us:.1f} count={e.count}")
        t0 = time.perf_counter()
        for _ in range(20):
            runs["repo kernel"]()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        print(f"trial q1 [{dist} gids] repo call, host enqueue ms="
              f"{host_ms:.4f}")
        # the repo kernel on growing parts of the lane set: the step's
        # own cost, then each source's
        parts = {"count": lanes[:1], "+ch": lanes[:1] + lanes[7:9],
                 "+dp+ch": lanes[:1] + lanes[5:9],
                 "+price+dp+ch": lanes[:1] + lanes[3:9]}
        for name, part in parts.items():
            ms = cs.cuda_ms(torch, lambda: gr.group_reduce_lanes(
                gid, 12, part), flush=flush)
            print(f"trial q1 [{dist} gids] repo kernel, lanes {name} "
                  f"({len(part)}): ms={ms:.4f}")
        nbytes = n * (4 + 1 + 1 + 4 + 8 + 8) + 9 * 12 * 8
        b_ms, _ = cs.bound_ms(nbytes, 0)
        for name, ts in times.items():
            ms = min(ts)
            print(f"trial q1 [{dist} gids] {name}: n={n} ms={ms:.4f} "
                  f"(turns {' '.join(f'{t:.4f}' for t in ts)}) "
                  f"bound_ms={b_ms:.4f} of_bound={b_ms / ms:.3f} exact=True")
        del gid, mask, qty, price, dp, ch, want
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where ``stable_argsort``'s time goes beyond its kernels (GPU).

    python trials/sort/argsort_overhead.py

At 8,388,608 rows (one SF=1 device batch), on a uniform 64-bit key (8
passes) and a 23-bit key (3 passes), times by CUDA events as
chip_smoke.py does (inputs flushed from the L2 before each sample):

- ``kernels``: the C entry alone (workspace memset, histogram, passes)
  on buffers allocated beforehand;
- ``onesweep_sort``: its Python wrapper (checks, allocations, the error
  flag's read);
- ``plan_passes``: the ``aminmax`` of the key and its host read;
- ``stable_argsort``: the whole call;

then one ``stable_argsort`` under ``torch.profiler``: the device time of
each kernel and copy, and the device's idle share of the call.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs                                   # noqa: E402
from tidb_tpu_torch.copr.cuda import build as kb          # noqa: E402
from tidb_tpu_torch.copr.cuda import onesweep as os1      # noqa: E402
from tidb_tpu_torch.copr.cuda import radix_kernel as rk   # noqa: E402
from tidb_tpu_torch.ops import sort as S                  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi())
    n = cs.KERNEL_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    keys = {"uniform 64-bit": torch.randint(
        -(1 << 63), (1 << 63) - 1, (n,), generator=gen, device=dev,
        dtype=torch.int64),
        "23-bit": torch.randint(0, 1 << 23, (n,), generator=gen,
                                device=dev, dtype=torch.int64)}
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    lib = os1.LIBRARY.get()
    val = torch.arange(n, dtype=torch.int32, device=dev)
    bufs = [torch.empty_like(keys["uniform 64-bit"]), torch.empty_like(val),
            torch.empty_like(keys["uniform 64-bit"]), torch.empty_like(val)]
    err = rk.new_err(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, key in keys.items():
        passes = S.plan_passes([key])[0]
        ws = torch.empty(-(-lib.radix_onesweep64_workspace_bytes(n, passes)
                           // 8), dtype=torch.int64, device=dev)

        def c_call():
            kb.raise_on(lib.radix_onesweep64_sort(
                key.data_ptr(), val.data_ptr(), bufs[0].data_ptr(),
                bufs[1].data_ptr(), bufs[2].data_ptr(), bufs[3].data_ptr(), 0,
                n, passes, ws.data_ptr(), err.data_ptr(), 0, stream, None),
                "sort")
        t = {
            "kernels": cs.cuda_ms(torch, c_call, flush=flush),
            "onesweep_sort": cs.cuda_ms(torch, lambda: os1.onesweep_sort(
                key, val, passes), flush=flush),
            "plan_passes": cs.cuda_ms(torch, lambda: S.plan_passes([key]),
                                      flush=flush),
            "stable_argsort": cs.cuda_ms(torch, lambda: S.stable_argsort(
                [key]), flush=flush),
        }
        print(f"overhead [{name}]: n={n} passes={passes} " + " ".join(
            f"{k}_ms={v:.4f}" for k, v in t.items()))
        flush.zero_()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            S.stable_argsort([key])
            end.record()
            torch.cuda.synchronize()
        wall = start.elapsed_time(end)
        dev_us = 0.0
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0.0) or getattr(
                ev, "cuda_time_total", 0.0)
            if us and ev.device_type == torch.autograd.DeviceType.CUDA:
                dev_us += us
                print(f"  device [{name}] {ev.key[:60]}: count={ev.count} "
                      f"us={us:.1f}")
        print(f"profile [{name}]: window_ms={wall:.4f} "
              f"device_ms={dev_us / 1e3:.4f} "
              f"idle_share={1 - dev_us / 1e3 / wall:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

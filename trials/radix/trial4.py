"""Design trial 4 of radix_kernel.cu: the histogram at tile 8192 by one
shared atomic a row (8, 16 or 4 warps a block) against byte counters a
lane with no atomics (4, 2 or 8 warps), on n = 8,388,608 uniform keys and
the tail-key skew, each checked against the port's plain histogram.  Run
on a GPU from the repo root:

    python trials/radix/trial4.py
"""
import ctypes, os, subprocess, sys, statistics
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "../..")))
import torch
from tidb_tpu_torch.copr.cuda import radix_kernel as rk
here = os.path.dirname(os.path.abspath(__file__))
so = os.path.join(here, "libtrial4.so")
r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, os.path.join(here, "trial4.cu")],
                   capture_output=True, text=True)
for ln in (r.stdout + r.stderr).splitlines():
    if "registers" in ln or "Compiling entry" in ln or "error" in ln:
        print(ln.strip())
assert r.returncode == 0
lib = ctypes.CDLL(so)
P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
lib.hist_launch.argtypes = [I32, P, P, I64, I32, P]
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
dev = torch.device("cuda", 0)
n = 8_388_608
flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
st = torch.cuda.current_stream().cuda_stream
def ms(fn, reps=15):
    t = []
    for i in range(reps + 1):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); torch.cuda.synchronize()
        if i: t.append(a.elapsed_time(b))
    return statistics.median(t)
g = torch.Generator(device=dev); g.manual_seed(1)
for dist in ("uniform", "tail skew"):
    key = torch.randint(0, 1 << 30, (n,), generator=g, device=dev, dtype=torch.int32)
    if dist == "tail skew":
        key[torch.rand(n, generator=g, device=dev) >= 0.715] = 1 << 30
    for shift in (0, 24):
        want = rk.radix_hist_plain(key, shift, tile=8192)
        h = torch.empty_like(want)
        for v in range(6):
            h.zero_()
            assert lib.hist_launch(v, key.data_ptr(), h.data_ptr(), n, shift, st) == 0
            ok = torch.equal(h, want)
            t = ms(lambda: lib.hist_launch(v, key.data_ptr(), h.data_ptr(), n, shift, st))
            print(f"hist v{v} [{dist} shift={shift}] exact={ok} ms={t:.4f}")
        err = rk.new_err(dev)
        print(f"radix_kernel.cu radix_hist [{dist} shift={shift}] ms={ms(lambda: rk.launch_hist(key, shift, h, err)):.4f}")

"""Design trial 1 of radix_kernel.cu, at a 4096-row tile: the histogram
with a warp match (8 ballots or __match_any_sync) before one atomic a
digit group, against one shared atomic a row (per-warp, block-wide or two
copies a warp); the scatter's rank by ballots, __match_any_sync or a
shared atomicOr, at 8 or 16 warps.  n = 8,388,608 uniform keys and the
tail-key skew, shifts 0 and 24, each checked against the port's plain
versions.  Run on a GPU from the repo root:

    python trials/radix/trial.py
"""
import ctypes, os, subprocess, sys, statistics
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "../..")))
import torch
from tidb_tpu_torch.copr.cuda import radix_kernel as rk
here = os.path.dirname(os.path.abspath(__file__))
so = os.path.join(here, "libtrial.so")
r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, os.path.join(here, "trial.cu")],
                   capture_output=True, text=True)
for ln in (r.stdout + r.stderr).splitlines():
    if "registers" in ln or "Compiling entry" in ln or "spill" in ln or "error" in ln:
        print(ln.strip())
assert r.returncode == 0
lib = ctypes.CDLL(so)
P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
lib.hist_launch.argtypes = [I32, P, P, I64, I32, P]
lib.scatter_launch.argtypes = [I32, P, P, P, P, P, I64, I32, P]
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
    val = torch.arange(n, dtype=torch.int32, device=dev)
    for shift in (0, 24):
        want_h = rk.radix_hist_plain(key, shift, tile=4096)
        offs = rk.exclusive_offsets(want_h)
        want_k, want_v = rk.radix_scatter_plain(key, val, offs, shift, tile=4096)
        h = torch.empty_like(want_h)
        for v in range(5):
            h.zero_()
            assert lib.hist_launch(v, key.data_ptr(), h.data_ptr(), n, shift, st) == 0
            ok = torch.equal(h, want_h)
            t = ms(lambda: lib.hist_launch(v, key.data_ptr(), h.data_ptr(), n, shift, st))
            print(f"hist v{v} [{dist} shift={shift}] exact={ok} ms={t:.4f}")
        ko, vo = torch.empty_like(key), torch.empty_like(val)
        for v in range(10):
            ko.zero_(); vo.zero_()
            rc = lib.scatter_launch(v, key.data_ptr(), val.data_ptr(), offs.data_ptr(), ko.data_ptr(), vo.data_ptr(), n, shift, st)
            assert rc == 0, rc
            ok = torch.equal(ko, want_k) and torch.equal(vo, want_v)
            t = ms(lambda: lib.scatter_launch(v, key.data_ptr(), val.data_ptr(), offs.data_ptr(), ko.data_ptr(), vo.data_ptr(), n, shift, st))
            print(f"scatter v{v} [{dist} shift={shift}] exact={ok} ms={t:.4f}")

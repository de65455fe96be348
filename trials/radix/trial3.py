"""Design trial 3 of radix_kernel.cu: where the permutation scatter's
time goes at tile 8192 (full; digit packed with the rank; without the
write-out; load and linear write only) and tiles 4096 and 16384.  The
cut-down variants are not exact by design.  Run on a GPU from the repo
root:

    python trials/radix/trial3.py
"""
import ctypes, os, subprocess, sys, statistics
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "../..")))
import torch
from tidb_tpu_torch.copr.cuda import radix_kernel as rk
here = os.path.dirname(os.path.abspath(__file__))
so = os.path.join(here, "libtrial3.so")
r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, os.path.join(here, "trial3.cu")],
                   capture_output=True, text=True)
for ln in (r.stdout + r.stderr).splitlines():
    if "registers" in ln or "Compiling entry" in ln or "error" in ln:
        print(ln.strip())
assert r.returncode == 0
lib = ctypes.CDLL(so)
P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
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
        ref = {}
        for tile in (4096, 8192, 16384):
            o = rk.exclusive_offsets(rk.radix_hist_plain(key, shift, tile=tile))
            ref[tile] = (o, rk.radix_scatter_plain(key, val, o, shift, tile=tile))
        ko, vo = torch.empty_like(key), torch.empty_like(val)
        for v in range(7):
            tile = lib.variant_tile(v)
            o = ref[tile][0]
            ko.zero_(); vo.zero_()
            assert lib.scatter_launch(v, key.data_ptr(), val.data_ptr(), o.data_ptr(), ko.data_ptr(), vo.data_ptr(), n, shift, st) == 0
            ok = torch.equal(ko, ref[tile][1][0]) and torch.equal(vo, ref[tile][1][1])
            t = ms(lambda: lib.scatter_launch(v, key.data_ptr(), val.data_ptr(), o.data_ptr(), ko.data_ptr(), vo.data_ptr(), n, shift, st))
            print(f"scatter v{v} tile={tile} [{dist} shift={shift}] exact={ok} ms={t:.4f}")

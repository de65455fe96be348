"""Design trial 2 of radix_kernel.cu: the histogram by shared atomics
against byte counters a lane, and the scatter through a 16-bit
permutation of the tile, at tiles 4096 and 8192 and 8 to 32 warps.
Needs trial.cu beside it (the reorder scatter it is timed against).
Run on a GPU from the repo root:

    python trials/radix/trial2.py
"""
import ctypes, os, subprocess, sys, statistics
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "../..")))
import torch
from tidb_tpu_torch.copr.cuda import radix_kernel as rk
here = os.path.dirname(os.path.abspath(__file__))
def build(name):
    so = os.path.join(here, f"lib{name}.so")
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, os.path.join(here, f"{name}.cu")],
                       capture_output=True, text=True)
    for ln in (r.stdout + r.stderr).splitlines():
        if "registers" in ln or "Compiling entry" in ln or "spill" in ln or "error" in ln:
            print(ln.strip())
    assert r.returncode == 0
    return ctypes.CDLL(so)
P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
lib = build("trial2")
lib.hist_launch.argtypes = [I32, P, P, I64, I32, P]
lib.scatter_launch.argtypes = [I32, P, P, P, P, P, I64, I32, P]
lib.variant_tile.argtypes = [I32, I32]
old = build("trial")
old.scatter_launch.argtypes = [I32, P, P, P, P, P, I64, I32, P]
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
    for shift in (0, 8, 24):
        ref = {}
        for tile in (4096, 8192):
            h = rk.radix_hist_plain(key, shift, tile=tile)
            o = rk.exclusive_offsets(h)
            ref[tile] = (h, o, rk.radix_scatter_plain(key, val, o, shift, tile=tile))
        for v in range(4):
            tile = lib.variant_tile(v, 1)
            h = torch.empty_like(ref[tile][0])
            assert lib.hist_launch(v, key.data_ptr(), h.data_ptr(), n, shift, st) == 0
            ok = torch.equal(h, ref[tile][0])
            t = ms(lambda: lib.hist_launch(v, key.data_ptr(), h.data_ptr(), n, shift, st))
            print(f"hist v{v} tile={tile} [{dist} shift={shift}] exact={ok} ms={t:.4f}")
        ko, vo = torch.empty_like(key), torch.empty_like(val)
        for v in range(5):
            tile = lib.variant_tile(v, 0)
            o = ref[tile][1]
            ko.zero_(); vo.zero_()
            assert lib.scatter_launch(v, key.data_ptr(), val.data_ptr(), o.data_ptr(), ko.data_ptr(), vo.data_ptr(), n, shift, st) == 0
            ok = torch.equal(ko, ref[tile][2][0]) and torch.equal(vo, ref[tile][2][1])
            t = ms(lambda: lib.scatter_launch(v, key.data_ptr(), val.data_ptr(), o.data_ptr(), ko.data_ptr(), vo.data_ptr(), n, shift, st))
            print(f"scatter perm v{v} tile={tile} [{dist} shift={shift}] exact={ok} ms={t:.4f}")
        o = ref[4096][1]
        t = ms(lambda: old.scatter_launch(0, key.data_ptr(), val.data_ptr(), o.data_ptr(), ko.data_ptr(), vo.data_ptr(), n, shift, st))
        print(f"scatter reorder (trial v0) tile=4096 [{dist} shift={shift}] ms={t:.4f}")

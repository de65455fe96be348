"""Design trial of the onesweep pass: tile, threads and grid (GPU).

    python trials/sort/onesweep_tile.py

Builds ``tidb_tpu_torch/copr/cuda/onesweep.cu`` as it is (an 8192-row
tile, 512 threads, one block a tile: 135,208 bytes of shared memory,
one block an SM) and variants of ``trials/sort/onesweep_variants.cu``
(the same source with design switches) with its ``OS_TILE`` /
``OS_THREADS`` / ``OS_PERSISTENT`` / ``OS_PREFETCH`` defaults rewritten
in a copy, all with one ``nvcc`` each started together:

- 8192 rows, 512 threads, a persistent grid (one resident block an SM
  loops over tiles);
- the same, staging its next tile with cp.async while it sorts this one
  (two staging buffers, 225,320 bytes);
- 4096 rows, 256 threads (69,672 bytes, three blocks an SM), one block a
  tile, and the same with a persistent grid;
- 4096 rows, 512 threads (two blocks an SM).

Each variant's whole sort of one key (``radix_onesweep64_sort``: the
workspace memset, the histogram, 8 passes) is held exactly against the
per-pass sort (``radix_kernel.counting_sort_pass`` chained) on a uniform
64-bit key, on SEGMENT's dead rows at INT64_MAX and on one value
everywhere, at 8,388,608 rows (one SF=1 device batch).  Then each is
timed on the uniform key, in turns (the variants in order, then in
reverse), by CUDA events as chip_smoke.py times the kernels: the whole
sort, and one pass at shift 0 with its workspace zeroed outside the
timed window.
"""

import ctypes
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs                                   # noqa: E402
from tidb_tpu_torch.copr.cuda import build as kb          # noqa: E402
from tidb_tpu_torch.copr.cuda import onesweep as os1      # noqa: E402
from tidb_tpu_torch.copr.cuda import radix_kernel as rk   # noqa: E402

VARIANTS_SRC = Path(__file__).with_name("onesweep_variants.cu")

# (name, tile, threads, persistent, prefetch); the first is the kernel
# source as it is
VARIANTS = [("8192x512", 8192, 512, 0, 0),
            ("8192x512 persistent", 8192, 512, 1, 0),
            ("8192x512 prefetch", 8192, 512, 1, 1),
            ("4096x256", 4096, 256, 0, 0),
            ("4096x256 persistent", 4096, 256, 1, 0),
            ("4096x512", 4096, 512, 0, 0)]


def variant_source(tile: int, threads: int, persistent: int,
                   prefetch: int) -> Path:
    src = VARIANTS_SRC.read_text()
    for name, v in (("OS_TILE", tile), ("OS_THREADS", threads),
                    ("OS_PERSISTENT", persistent), ("OS_PREFETCH", prefetch)):
        src, k = re.subn(rf"#define {name} \d+", f"#define {name} {v}", src)
        assert k == 1, name
    out = kb.BUILD_DIR / (f"onesweep_{tile}_{threads}_{persistent}_"
                          f"{prefetch}.cu")
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.onesweep_tile_rows.restype = i32
    lib.onesweep_smem_bytes.restype = i32
    lib.radix_onesweep64_workspace_bytes.argtypes = [i64, i32]
    lib.radix_onesweep64_workspace_bytes.restype = i64
    lib.radix_onesweep64_launch.argtypes = [p, p, p, p, p, p, p, i64, i32,
                                            i32, p, i32, p, p]
    lib.radix_onesweep64_launch.restype = i32
    lib.radix_onesweep64_sort.argtypes = [p, p, p, p, p, p, p, i64, i32, p,
                                          p, i32, p, p]
    lib.radix_onesweep64_sort.restype = i32
    return lib


class Variant:
    """One built variant with its buffers for n rows."""

    def __init__(self, name, path, key, val):
        self.name = name
        self.lib = declare(ctypes.CDLL(str(path)))
        n = key.numel()
        self.key, self.val, self.n = key, val, n
        self.bufs = [torch.empty_like(key), torch.empty_like(val),
                     torch.empty_like(key), torch.empty_like(val)]
        nbytes = self.lib.radix_onesweep64_workspace_bytes(n, 8)
        self.ws = torch.empty(-(-nbytes // 8), dtype=torch.int64,
                              device=key.device)
        self.err = rk.new_err(key.device)
        self.stream = torch.cuda.current_stream(key.device).cuda_stream
        self.tile = self.lib.onesweep_tile_rows()
        self.hist = os1.radix_hist_all64(key, 8)
        self.status = torch.zeros(rk.n_tiles(n, self.tile) * 256,
                                  dtype=torch.int64, device=key.device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=key.device)

    def sort(self, key=None, passes=8):
        key = self.key if key is None else key
        ka, va, kb_, vb = self.bufs
        kb.raise_on(self.lib.radix_onesweep64_sort(
            key.data_ptr(), self.val.data_ptr(), ka.data_ptr(),
            va.data_ptr(), kb_.data_ptr(), vb.data_ptr(), 0, self.n, passes,
            self.ws.data_ptr(), self.err.data_ptr(), 0, self.stream, None),
            "sort")
        return va if passes % 2 else vb

    def zero(self):
        self.status.zero_()
        self.counter.zero_()

    def one_pass(self):
        ka, va = self.bufs[:2]
        kb.raise_on(self.lib.radix_onesweep64_launch(
            self.key.data_ptr(), self.val.data_ptr(), self.hist[0].data_ptr(),
            self.status.data_ptr(), self.counter.data_ptr(), ka.data_ptr(),
            va.data_ptr(), self.n, 0, 1, self.err.data_ptr(), 0,
            self.stream, None), "pass")


def per_pass_sort(key, val, passes):
    k, v = key, val
    for p in range(passes):
        k, v = rk.counting_sort_pass(k, v, 8 * p)
    return v


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
        dtype=torch.int64)}
    dead = keys["uniform 64-bit"].clone()
    dead[torch.rand(n, generator=gen, device=dev) < 0.285] = (1 << 63) - 1
    keys["dead rows"] = dead
    keys["one value"] = torch.full((n,), -0x2A5A5A5A5A5A5A5A,
                                   dtype=torch.int64, device=dev)
    val = torch.arange(n, dtype=torch.int32, device=dev)
    paths = [os1._SRC] + [variant_source(*v[1:]) for v in VARIANTS[1:]]
    sos = kb.build_all(paths)
    for log in kb.BUILD_LOG:
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln:
                print("ptxas:", ln.strip())
    variants = [Variant(name, so, keys["uniform 64-bit"], val)
                for (name, *_), so in zip(VARIANTS, sos)]
    want = {k: per_pass_sort(key, val, 8) for k, key in keys.items()}
    for v in variants:
        for kname, key in keys.items():
            got = v.sort(key)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want[kname]),
                     f"{v.name} [{kname}] != the per-pass sort")
        cs.check(int(v.err.item()) == 0, f"{v.name}: error flag")
        print(f"variant {v.name}: tile={v.tile} "
              f"smem={v.lib.onesweep_smem_bytes()} exact=True")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    times = {v.name: {"sort": [], "pass": []} for v in variants}
    for v in variants + variants[::-1]:
        times[v.name]["sort"].append(cs.cuda_ms(torch, v.sort, flush=flush))
        times[v.name]["pass"].append(cs.cuda_ms(torch, v.one_pass,
                                                flush=flush, prep=v.zero))
    b_sort, _ = cs.bound_ms((8 + 24 * 8 - 8) * n, 8 * n)
    b_pass, _ = cs.bound_ms(24 * n, n)
    for name, t in times.items():
        print(f"trial {name}: n={n} sort_8_passes_ms={t['sort']} "
              f"bound_ms={b_sort:.4f} pass_ms={t['pass']} "
              f"pass_bound_ms={b_pass:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

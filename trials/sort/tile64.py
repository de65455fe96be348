"""Tile trial of the int64 counting-sort kernels (GPU).

    python trials/sort/tile64.py

Builds ``tidb_tpu_torch/copr/cuda/radix_kernel.cu`` as it is
(``KERNEL_TILE`` 8192: the int64 scatter's shared memory takes 132,128
bytes, one block an SM) and a copy at a 4096-row tile (74,784 bytes,
three blocks an SM by shared memory), checks each variant's int64
histogram and scatter against the plain versions at its tile, and times
both at 8,388,608 rows (one SF=1 device batch) on a uniform 64-bit key,
in turns (4096, 8192, 8192, 4096), by CUDA events as chip_smoke.py
times the kernels.
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
from tidb_tpu_torch.copr.cuda import radix_kernel as rk   # noqa: E402


def variant_source(tile: int) -> Path:
    """The kernel source with its tile set to ``tile`` and the asserts of
    the scatter's shared-memory sizes dropped."""
    src = rk._SRC.read_text()
    src = re.sub(r"#define KERNEL_TILE \d+", f"#define KERNEL_TILE {tile}",
                 src)
    src = re.sub(r"static_assert\(sizeof\(ScatterSmem<[^;]*;", "", src)
    out = kb.BUILD_DIR / f"radix_kernel_tile_{tile}.cu"
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(kb.build_all([path])[0]))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.radix_hist64_launch.argtypes = [p, p, i64, i32, p, i32, p]
    lib.radix_scatter64_launch.argtypes = [p, p, p, p, p, i64, i32, p, i32,
                                           p]
    lib.radix_hist64_launch.restype = lib.radix_scatter64_launch.restype = i32
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi())
    n = cs.KERNEL_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    key = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=gen,
                        device=dev, dtype=torch.int64)
    val = torch.arange(n, dtype=torch.int32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    err = rk.new_err(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    runs = {}
    for tile in (4096, 8192, 8192, 4096):
        lib = load(rk._SRC if tile == rk.KERNEL_TILE
                   else variant_source(tile))
        hist = torch.empty((rk.n_tiles(n, tile), rk.N_DIGITS),
                           dtype=torch.int32, device=dev)
        k2, v2 = torch.empty_like(key), torch.empty_like(val)

        def h():
            kb.raise_on(lib.radix_hist64_launch(
                key.data_ptr(), hist.data_ptr(), n, 0, err.data_ptr(), 0,
                stream), "radix_hist64")
        h()
        offs = rk.exclusive_offsets(hist)

        def sc():
            kb.raise_on(lib.radix_scatter64_launch(
                key.data_ptr(), val.data_ptr(), offs.data_ptr(),
                k2.data_ptr(), v2.data_ptr(), n, 0, err.data_ptr(), 0,
                stream), "radix_scatter64")
        sc()
        torch.cuda.synchronize()
        cs.check(torch.equal(hist, rk.radix_hist_plain(key, 0, tile=tile)),
                 f"tile {tile}: hist != plain")
        want = rk.radix_scatter_plain(key, val, offs, 0, tile=tile)
        cs.check(torch.equal(k2, want[0]) and torch.equal(v2, want[1]),
                 f"tile {tile}: scatter != plain")
        cs.check(int(err.item()) == 0, f"tile {tile}: error flag")
        hm = cs.cuda_ms(torch, h, flush=flush)
        sm = cs.cuda_ms(torch, sc, flush=flush)
        runs.setdefault(tile, []).append((hm, sm))
        print(f"tile64 {tile}: n={n} exact=True radix_hist64_ms={hm:.4f} "
              f"radix_scatter64_ms={sm:.4f}")
    for tile, r in runs.items():
        print(f"tile64 {tile} mean of {len(r)}: "
              f"radix_hist64_ms={sum(x for x, _ in r) / len(r):.4f} "
              f"radix_scatter64_ms={sum(y for _, y in r) / len(r):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

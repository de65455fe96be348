# ported from tidb_tpu/copr/pallas/radix_kernel.py @ a9e9482
# (the passes of the stable multi-key lax.sort at tidb_tpu/copr/exec.py:340
# and :579 and tidb_tpu/copr/segment.py:178, as ops/sort.py lowers it)
"""The onesweep LSD radix sort of one int64 key, with int32 values.

Two hand-written CUDA kernels (``onesweep.cu``, built for sm_90a at
first use by ``build.py``):

- ``radix_hist_all64(key, passes)``: the ``(passes, 256)`` int32 global
  histograms of the key's digits at shifts 0, 8, .., 8 (passes - 1), in
  one read of the key;
- ``radix_onesweep64(key, val, hist_p, shift, store_key)``: one stable
  counting-sort pass, ``(key_out, val_out)`` (``key_out`` None without
  ``store_key``): row i goes to ``excl_scan(hist_p)[d] + prefix(t, d) +
  rank``, where d is its digit, t its tile, ``prefix(t, d)`` the rows of
  digit d in tiles before t (the kernel's decoupled look-back) and rank
  its stable rank among its tile's rows of digit d.  This is the offset
  ``radix_kernel.exclusive_offsets`` gives, so the pass equals
  ``radix_kernel.counting_sort_pass`` on int64 keys bit for bit.

``onesweep_sort(key, val, passes, err, wide)`` is what ``ops/sort.py``
calls a key: on a CUDA tensor one C call (a memset of the workspace, the
histogram, the passes; the last pass stores no keys), on a CPU tensor
the plain versions below.  It returns the values after the passes, as
int64 for the sort's last key (``wide``); ``val`` None stands for the
row indices, which the first pass makes itself on the card.

Digits are taken as in ``radix_kernel.py``'s int64 instantiation: from
the key with its sign bit flipped, so unsigned digit order is signed key
order.  On a CUDA tensor each wrapper launches its kernel or raises; on
a CPU tensor it runs its plain PyTorch version:

- ``radix_hist_all64_plain``: a one-hot count of each digit over the
  whole key;
- ``onesweep_offsets_plain``: the digit bases from the exclusive scan of
  a pass's histogram plus each tile's prefix over earlier tiles, walked
  tile by tile as the look-back walks them;
- ``radix_onesweep64_plain``: a stable pass that places each row at that
  offset plus its stable rank among its tile's rows of its digit.

A position outside ``[0, n)`` (a histogram that does not describe the
key) is reported: through the device error flag of ``radix_kernel``
(bit 1, read by ``read_err``) on the card, as a ValueError on the CPU.
``LAUNCHES`` counts each kernel's launches as the C launchers report
them: each adds one to a host counter where it issues a launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import radix_kernel as rk
from .build import Library, count_launches, raise_on, stream_of

KERNEL_TILE = 8192          # rows a tile of the pass (checked at load)
MAX_PASSES = 8              # digits of an int64 key
N_DIGITS = rk.N_DIGITS

LAUNCHES = {"radix_hist_all64": 0, "radix_onesweep64": 0}

_SRC = Path(__file__).with_name("onesweep.cu")
_MAX_ROWS = 2 ** 31 - 1     # positions and prefixes are int32 values

# rows per chunk of the plain histogram's one-hot: bounds its peak memory
# (rows x 256 bools) whatever n is
_PLAIN_CHUNK_ROWS = 1 << 16


# --------------------------------------------------------------------- #
# build and load
# --------------------------------------------------------------------- #

def _setup(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    cnt = ctypes.POINTER(ctypes.c_int)
    lib.onesweep_tile_rows.argtypes = []
    lib.onesweep_tile_rows.restype = i32
    lib.onesweep_smem_bytes.argtypes = []
    lib.onesweep_smem_bytes.restype = i32
    lib.radix_onesweep64_workspace_bytes.argtypes = [i64, i32]
    lib.radix_onesweep64_workspace_bytes.restype = i64
    lib.radix_hist_all64_launch.argtypes = [p, p, i64, i32, i32, p, cnt]
    lib.radix_hist_all64_launch.restype = i32
    lib.radix_onesweep64_launch.argtypes = [p, p, p, p, p, p, p, i64, i32,
                                            i32, p, i32, p, cnt]
    lib.radix_onesweep64_launch.restype = i32
    lib.radix_onesweep64_sort.argtypes = [p, p, p, p, p, p, p, i64, i32, p,
                                          p, i32, p, cnt]
    lib.radix_onesweep64_sort.restype = i32
    if lib.onesweep_tile_rows() != KERNEL_TILE:
        raise RuntimeError(f"onesweep.cu tile {lib.onesweep_tile_rows()} "
                           f"!= KERNEL_TILE {KERNEL_TILE}")


LIBRARY = Library(_SRC, _setup)


def status_words(n: int) -> int:
    """Look-back status words of one pass: one a (tile, digit)."""
    return rk.n_tiles(n, KERNEL_TILE) * N_DIGITS


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _counter(k: int = 1) -> ctypes.Array:
    """``k`` host ints at 0, which the C launchers add their issued
    launches to."""
    return (ctypes.c_int * k)()


def launch_hist_all(key: torch.Tensor, passes: int,
                    hist: torch.Tensor) -> int:
    """Launch ``radix_hist_all64_kernel`` into a zeroed ``hist`` on
    validated CUDA tensors; returns the launches C issued (no count
    here: the wrappers count)."""
    launched = _counter()
    raise_on(LIBRARY.get().radix_hist_all64_launch(
        key.data_ptr(), hist.data_ptr(), key.numel(), passes,
        key.device.index, stream_of(key), launched), "radix_hist_all64")
    return launched[0]


def launch_pass(key: torch.Tensor, val: torch.Tensor, hist_p: torch.Tensor,
                status: torch.Tensor, counter: torch.Tensor, shift: int,
                key_out: torch.Tensor | None, val_out: torch.Tensor,
                err: torch.Tensor) -> int:
    """Launch ``radix_onesweep64_kernel`` on validated CUDA tensors;
    ``status`` (``status_words(n)`` int64) and ``counter`` (one int32)
    must be zeroed; ``key_out`` None stores no keys.  Returns the
    launches C issued."""
    launched = _counter()
    raise_on(LIBRARY.get().radix_onesweep64_launch(
        key.data_ptr(), val.data_ptr(), hist_p.data_ptr(),
        status.data_ptr(), counter.data_ptr(), _ptr(key_out),
        val_out.data_ptr(), key.numel(), shift, int(key_out is not None),
        err.data_ptr(), key.device.index, stream_of(key), launched),
        "radix_onesweep64")
    return launched[0]


# --------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------- #

def _check_key_val(key, val) -> None:
    rk._check("key", key, dtypes=(torch.int64,))
    rk._check("val", val, (key.numel(),), key.device)
    if key.numel() > _MAX_ROWS:
        raise ValueError(f"{key.numel()} rows exceed the int32 values")


def _check_passes(passes) -> None:
    if isinstance(passes, bool) or not isinstance(passes, int) \
            or not 0 <= passes <= MAX_PASSES:
        raise ValueError(f"passes must be an int in [0, {MAX_PASSES}], got "
                         f"{passes!r}")


def _check_shift(shift) -> None:
    if isinstance(shift, bool) or not isinstance(shift, int) \
            or shift not in range(0, 64, 8):
        raise ValueError(f"shift must be a multiple of 8 in [0, 64), got "
                         f"{shift!r}")


# --------------------------------------------------------------------- #
# the wrappers
# --------------------------------------------------------------------- #

def radix_hist_all64(key: torch.Tensor, passes: int) -> torch.Tensor:
    """(passes, 256) int32: row p counts the digits of ``key`` at shift
    8 p over all its rows."""
    rk._check("key", key, dtypes=(torch.int64,))
    _check_passes(passes)
    if key.device.type == "cpu":
        return radix_hist_all64_plain(key, passes)
    hist = torch.zeros((passes, N_DIGITS), dtype=torch.int32,
                       device=key.device)
    if key.numel() == 0 or passes == 0:
        return hist
    count_launches(LAUNCHES, "radix_hist_all64",
                   launch_hist_all(key, passes, hist))
    return hist


def radix_onesweep64(key: torch.Tensor, val: torch.Tensor,
                     hist_p: torch.Tensor, shift: int,
                     store_key: bool = True
                     ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """One stable counting-sort pass of int64 ``key`` and int32 ``val``
    by the digit at ``shift``, given that digit's global histogram
    ``hist_p`` (256 int32); returns ``(key_out, val_out)``, ``key_out``
    None unless ``store_key``."""
    _check_key_val(key, val)
    rk._check("hist_p", hist_p, (N_DIGITS,), key.device)
    _check_shift(shift)
    if key.device.type == "cpu":
        return radix_onesweep64_plain(key, val, hist_p, shift, store_key)
    n = key.numel()
    key_out = torch.empty_like(key) if store_key else None
    val_out = torch.empty_like(val)
    if n == 0:
        return key_out, val_out
    status = torch.zeros(status_words(n), dtype=torch.int64,
                         device=key.device)
    counter = torch.zeros(1, dtype=torch.int32, device=key.device)
    err = rk.new_err(key.device)
    count_launches(LAUNCHES, "radix_onesweep64", launch_pass(
        key, val, hist_p, status, counter, shift, key_out, val_out, err))
    rk.read_err(err, "radix_onesweep64")
    return key_out, val_out


def onesweep_sort(key: torch.Tensor, val: torch.Tensor | None, passes: int,
                  err: torch.Tensor | None = None,
                  wide: bool = False) -> torch.Tensor:
    """The int32 values after ``passes`` stable passes of int64 ``key``
    (shifts 0, 8, ..), as int64 if ``wide``; ``val`` None stands for the
    row indices.  The keys ride between passes and the last pass stores
    none.  On CUDA one C call: a memset of the workspace, one
    ``radix_hist_all64`` launch and ``passes`` ``radix_onesweep64``
    launches, the first making the row indices itself and the last
    writing int64 values if ``wide``; given a device flag ``err``
    (``radix_kernel.new_err``) the launches report into it and the
    caller reads it, else it is read here."""
    rk._check("key", key, dtypes=(torch.int64,))
    n, dev = key.numel(), key.device
    if val is not None:
        rk._check("val", val, (n,), dev)
    if n > _MAX_ROWS:
        raise ValueError(f"{n} rows exceed the int32 values")
    _check_passes(passes)
    if val is None and (passes == 0 or n == 0 or dev.type == "cpu"):
        val = torch.arange(n, dtype=torch.int32, device=dev)
    if passes == 0 or n == 0:
        return val.to(torch.int64) if wide else val.clone()
    if dev.type == "cpu":
        hist = radix_hist_all64_plain(key, passes)
        for p in range(passes):
            key, val = radix_onesweep64_plain(key, val, hist[p], 8 * p,
                                              store_key=p + 1 < passes)
        return val.to(torch.int64) if wide else val
    lib = LIBRARY.get()
    flag = rk.new_err(dev) if err is None else err
    # pass p writes pair A (even p) or B, the last its int64 output if wide
    outs = ["ab"[p & 1] for p in range(passes - 1 if wide else passes)]
    key_a = torch.empty_like(key) if passes >= 2 else None
    key_b = torch.empty_like(key) if passes >= 3 else None
    val_a, val_b = (torch.empty(n, dtype=torch.int32, device=dev)
                    if x in outs else None for x in "ab")
    out64 = torch.empty(n, dtype=torch.int64, device=dev) if wide else None
    nbytes = lib.radix_onesweep64_workspace_bytes(n, passes)
    ws = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=dev)
    launched = _counter(2)            # histogram, passes
    rc = lib.radix_onesweep64_sort(
        key.data_ptr(), _ptr(val), _ptr(key_a), _ptr(val_a), _ptr(key_b),
        _ptr(val_b), _ptr(out64), n, passes, ws.data_ptr(), flag.data_ptr(),
        dev.index, stream_of(key), launched)
    count_launches(LAUNCHES, "radix_hist_all64", launched[0])
    count_launches(LAUNCHES, "radix_onesweep64", launched[1])
    raise_on(rc, "radix_onesweep64_sort")
    if err is None:
        rk.read_err(flag, "onesweep_sort")
    if wide:
        return out64
    return val_a if passes % 2 else val_b


# --------------------------------------------------------------------- #
# plain PyTorch versions (the CPU path and the on-card reference)
# --------------------------------------------------------------------- #

def radix_hist_all64_plain(key: torch.Tensor, passes: int) -> torch.Tensor:
    """Each pass's digits compared one-hot against the 256 digits and
    summed over the whole key, in chunks of rows."""
    digits = torch.arange(N_DIGITS, dtype=torch.int64, device=key.device)
    out = torch.zeros((passes, N_DIGITS), dtype=torch.int32,
                      device=key.device)
    for r0 in range(0, key.numel(), _PLAIN_CHUNK_ROWS):
        chunk = key[r0:r0 + _PLAIN_CHUNK_ROWS]
        for p in range(passes):
            d = rk.digits_plain(chunk, 8 * p)
            out[p] += (d[:, None] == digits).sum(0, dtype=torch.int32)
    return out


def onesweep_offsets_plain(tile_hist: torch.Tensor,
                           hist_p: torch.Tensor) -> torch.Tensor:
    """(n_tiles, 256) int64 destinations of each (tile, digit)'s first
    row: the digit's base, the exclusive scan of the pass's histogram
    ``hist_p``, plus the digit's rows in earlier tiles, summed tile by
    tile as the look-back walks back to the previous inclusive prefix."""
    hist_p = hist_p.to(torch.int64)
    base = torch.cumsum(hist_p, 0) - hist_p
    out = torch.empty(tile_hist.shape, dtype=torch.int64,
                      device=tile_hist.device)
    prefix = torch.zeros(N_DIGITS, dtype=torch.int64, device=base.device)
    for t in range(tile_hist.shape[0]):
        out[t] = base + prefix           # tile t - 1's inclusive prefix
        prefix = prefix + tile_hist[t]
    return out


def _tile_ranks(d: torch.Tensor, tile: int) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(tile, digit) cell of each row, ``tile * 256 + digit``, and the
    row's stable rank among the rows of its cell."""
    n = d.numel()
    rows = torch.arange(n, dtype=torch.int64, device=d.device)
    cell = (rows // tile) * N_DIGITS + d
    order = torch.sort(cell, stable=True).indices
    sorted_cell = cell[order]
    first = torch.ones(n, dtype=torch.bool, device=d.device)
    first[1:] = sorted_cell[1:] != sorted_cell[:-1]
    run_start = torch.cummax(torch.where(first, rows, 0), 0).values
    rank = torch.empty_like(rows)
    rank[order] = rows - run_start
    return cell, rank


def radix_onesweep64_plain(key: torch.Tensor, val: torch.Tensor,
                           hist_p: torch.Tensor, shift: int,
                           store_key: bool = True, tile: int = KERNEL_TILE
                           ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Each row placed at ``onesweep_offsets_plain``'s offset of its
    (tile, digit) plus its stable rank among that cell's rows."""
    n = key.numel()
    key_out = torch.empty_like(key) if store_key else None
    val_out = torch.empty_like(val)
    if n == 0:
        return key_out, val_out
    d = rk.digits_plain(key, shift)
    cell, rank = _tile_ranks(d, tile)
    tile_hist = torch.bincount(cell,
                               minlength=rk.n_tiles(n, tile) * N_DIGITS)
    off = onesweep_offsets_plain(tile_hist.view(-1, N_DIGITS), hist_p)
    pos = off.view(-1)[cell] + rank
    if int(pos.min()) < 0 or int(pos.max()) >= n:
        raise ValueError("radix_onesweep64: offsets place a row outside "
                         "[0, n)")
    if store_key:
        key_out[pos] = key
    val_out[pos] = val
    return key_out, val_out


__all__ = ["KERNEL_TILE", "MAX_PASSES", "LAUNCHES", "LIBRARY",
           "radix_hist_all64", "radix_onesweep64", "onesweep_sort",
           "launch_hist_all", "launch_pass", "status_words",
           "radix_hist_all64_plain", "onesweep_offsets_plain",
           "radix_onesweep64_plain"]

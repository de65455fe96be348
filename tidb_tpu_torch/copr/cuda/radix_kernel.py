# ported from tidb_tpu/copr/pallas/radix_kernel.py @ a9e9482
"""One stable counting-sort pass: the SCATTER radix partition's, and the
pass under the port's stable multi-key sort (``ops/sort.py``).

Two hand-written CUDA kernels (``radix_kernel.cu``, built for sm_90a at
first use) replace the JAX package's Pallas TPU kernels.  The key is
carried through the pass: each kernel takes the key and the pass's
``shift`` and computes the digit itself.  Each kernel has two
instantiations, chosen by the key's dtype:

- int32 keys, the partition key's domain ``[0, 2^31)`` (a negative key
  is reported); the digit is ``(key >> shift) & 255``, ``shift < 32``;
- int64 keys, any value, ordered as signed: the digit is taken from the
  key with its sign bit flipped, ``((key ^ INT64_MIN) >> shift) & 255``
  read as unsigned, ``shift < 64``.

The values are int32 for both.

- ``radix_hist(key, shift)``: the per-tile digit histogram,
  ``(n_ktiles, 256)`` int32, one row per ``KERNEL_TILE``-row tile;
- ``radix_scatter(key, val, off, shift)``: ``(key_out, val_out)``, each
  row's key and value stored at ``off[tile, digit] + (stable rank of the
  row among its tile's rows of that digit)``.

``counting_sort_pass(key, val, shift)`` chains them with an exclusive
cumsum over the counts flattened digit-major (a tile's digit-d rows land
after every earlier tile's digit-d rows: stability across tiles), so
composing passes LSB digit first gives the stable LSD radix sort of the
full key, the keys in sorted order coming out beside the values.

The kernels' tile (8192 rows, both key types) is a constant of the
``.cu`` checked at load; the TPU kernels' tile ``TILE`` (512) stays the
geometry of the JAX package.
The plain versions take ``tile=`` so that they can be held against the
Pallas kernels at 512: with ``key = dig`` and ``shift = 0`` they compute
what the TPU kernels compute.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain PyTorch version below.  The kernels report a
bad key or a position outside ``[0, n)`` through a device error flag:
the single-call wrappers read it after their launches, and
``counting_sort_pass(..., err=flag)`` leaves it to the caller, so that a
sort of several passes reads it once (``read_err``).  ``LAUNCHES``
counts the kernel launches of each wrapper, by instantiation
(``radix_hist``/``radix_scatter`` for int32 keys,
``radix_hist64``/``radix_scatter64`` for int64 keys).

The shared library is built and loaded by ``build.py`` (nvcc for
sm_90a into ``tidb_tpu_torch/_build/``, named by the hash of the
source, bound with ctypes).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import dag as D
from .build import Library, raise_on, stream_of

TILE = D.RADIX_TILE
KERNEL_TILE = 8192
N_DIGITS = 1 << D.RADIX_BITS
INT64_MIN = -(2 ** 63)

LAUNCHES = {"radix_hist": 0, "radix_scatter": 0, "radix_hist64": 0,
            "radix_scatter64": 0}

_SRC = Path(__file__).with_name("radix_kernel.cu")

# rows per chunk of the plain versions' one-hot: bounds their peak
# memory (rows x 256 int32) to 128 MiB whatever n is
_PLAIN_CHUNK_ROWS = 1 << 17

_KEY_BITS = {torch.int32: 32, torch.int64: 64}


# --------------------------------------------------------------------- #
# build and load
# --------------------------------------------------------------------- #

def _setup(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.radix_kernel_tile.argtypes = []
    lib.radix_kernel_tile.restype = i32
    for fn in (lib.radix_hist_launch, lib.radix_hist64_launch):
        fn.argtypes = [p, p, i64, i32, p, i32, p]
        fn.restype = i32
    for fn in (lib.radix_scatter_launch, lib.radix_scatter64_launch):
        fn.argtypes = [p, p, p, p, p, i64, i32, p, i32, p]
        fn.restype = i32
    if lib.radix_kernel_tile() != KERNEL_TILE:
        raise RuntimeError(f"radix_kernel.cu tile {lib.radix_kernel_tile()} "
                           f"!= KERNEL_TILE {KERNEL_TILE}")


LIBRARY = Library(_SRC, _setup)


def _wide(key: torch.Tensor) -> bool:
    return key.dtype == torch.int64


def launch_hist(key: torch.Tensor, shift: int, hist: torch.Tensor,
                err: torch.Tensor) -> None:
    """Launch ``radix_hist_kernel`` of ``key``'s dtype on validated CUDA
    tensors (no count, no error read-back: the wrappers below do
    both)."""
    lib = LIBRARY.get()
    fn = lib.radix_hist64_launch if _wide(key) else lib.radix_hist_launch
    raise_on(fn(key.data_ptr(), hist.data_ptr(), key.numel(), shift,
                err.data_ptr(), key.device.index, stream_of(key)),
             "radix_hist")


def launch_scatter(key: torch.Tensor, val: torch.Tensor, off: torch.Tensor,
                   shift: int, key_out: torch.Tensor, val_out: torch.Tensor,
                   err: torch.Tensor) -> None:
    """Launch ``radix_scatter_kernel`` of ``key``'s dtype on validated
    CUDA tensors."""
    lib = LIBRARY.get()
    fn = (lib.radix_scatter64_launch if _wide(key)
          else lib.radix_scatter_launch)
    raise_on(fn(key.data_ptr(), val.data_ptr(), off.data_ptr(),
                key_out.data_ptr(), val_out.data_ptr(), key.numel(), shift,
                err.data_ptr(), key.device.index, stream_of(key)),
             "radix_scatter")


def _count(name: str, key: torch.Tensor) -> None:
    LAUNCHES[name + ("64" if _wide(key) else "")] += 1


# --------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------- #

def n_tiles(n: int, tile: int = KERNEL_TILE) -> int:
    return -(-n // tile)


def _check(name: str, t, shape: tuple | None = None, device=None,
           dtypes=(torch.int32,)) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes`` and
    of ``shape`` (any 1-d shape when None) on ``device`` (CUDA or CPU
    when None)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be "
                        f"{' or '.join(str(d) for d in dtypes)}, "
                        f"got {t.dtype}")
    if shape is None and t.dim() != 1:
        raise ValueError(f"{name} must be 1-d, got shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} lies on unsupported device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")


def _check_key(key) -> None:
    _check("key", key, dtypes=(torch.int32, torch.int64))


def _check_shift(shift, key: torch.Tensor) -> None:
    bits = _KEY_BITS[key.dtype]
    if isinstance(shift, bool) or not isinstance(shift, int) \
            or not 0 <= shift < bits:
        raise ValueError(f"shift must be an int in [0, {bits}) for "
                         f"{key.dtype} keys, got {shift!r}")


def _check_keys_cpu(key: torch.Tensor) -> None:
    if not _wide(key) and key.numel() and int(key.min()) < 0:
        raise ValueError("key outside [0, 2^31)")


def new_err(device: torch.device) -> torch.Tensor:
    """A zeroed device error flag for ``counting_sort_pass(err=...)``."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def read_err(err: torch.Tensor, name: str) -> None:
    """Raise if a launch that shared ``err`` reported a bad input (one
    host sync)."""
    code = int(err.item())
    if code & 1:
        raise ValueError(f"{name}: key outside [0, 2^31)")
    if code & 2:
        raise ValueError(f"{name}: offsets place a row outside [0, n)")


# --------------------------------------------------------------------- #
# the wrappers
# --------------------------------------------------------------------- #

def radix_hist(key: torch.Tensor, shift: int) -> torch.Tensor:
    """(n_ktiles, 256) int32 counts of the digits of ``key`` at ``shift``
    in each kernel tile."""
    _check_key(key)
    _check_shift(shift, key)
    if key.device.type == "cpu":
        _check_keys_cpu(key)
        return radix_hist_plain(key, shift)
    hist = torch.empty((n_tiles(key.numel()), N_DIGITS),
                       dtype=torch.int32, device=key.device)
    if key.numel() == 0:
        return hist
    err = new_err(key.device)
    launch_hist(key, shift, hist, err)
    _count("radix_hist", key)
    read_err(err, "radix_hist")
    return hist


def _scatter_cuda(key, val, off, shift, err):
    key_out = torch.empty_like(key)
    val_out = torch.empty_like(val)
    launch_scatter(key, val, off, shift, key_out, val_out, err)
    _count("radix_scatter", key)
    return key_out, val_out


def radix_scatter(key: torch.Tensor, val: torch.Tensor, off: torch.Tensor,
                  shift: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reorder ``key`` and ``val`` by the digit of ``key`` given the
    per-tile digit base offsets ``off`` (n_ktiles, 256): row i of tile t
    with digit d goes to ``off[t, d] + rank``.  Returns
    ``(key_out, val_out)``."""
    _check_key(key)
    n = key.numel()
    _check("val", val, (n,), key.device)
    _check("off", off, (n_tiles(n), N_DIGITS), key.device)
    _check_shift(shift, key)
    if key.device.type == "cpu":
        _check_keys_cpu(key)
        return radix_scatter_plain(key, val, off, shift)
    if n == 0:
        return key.clone(), val.clone()
    err = new_err(key.device)
    out = _scatter_cuda(key, val, off, shift, err)
    read_err(err, "radix_scatter")
    return out


def exclusive_offsets(hist: torch.Tensor) -> torch.Tensor:
    """Per-(tile, digit) base offsets: an exclusive cumsum over the
    counts flattened digit-major, so digit d's tile t base counts every
    smaller digit and digit d's earlier tiles."""
    flat = hist.t().reshape(-1)
    offs = torch.cumsum(flat, 0, dtype=torch.int32) - flat
    return offs.reshape(N_DIGITS, hist.shape[0]).t().contiguous()


def counting_sort_pass(key: torch.Tensor, val: torch.Tensor, shift: int,
                       err: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One stable counting-sort pass: reorder ``key`` (int32 or int64)
    and int32 ``val`` by the digit of ``key`` at ``shift``, keeping
    order within equal digits; returns ``(key_out, val_out)``.  Any row
    count; the last tile may be ragged.  On CUDA, given a device flag
    ``err`` (``new_err``), the launches report into it and the caller
    reads it (``read_err``); without one, the flag is read here."""
    _check_key(key)
    _check("val", val, (key.numel(),), key.device)
    _check_shift(shift, key)
    if key.device.type == "cpu":
        _check_keys_cpu(key)
        return counting_sort_pass_plain(key, val, shift)
    n = key.numel()
    if n == 0:
        return key.clone(), val.clone()
    flag = new_err(key.device) if err is None else err
    hist = torch.empty((n_tiles(n), N_DIGITS),
                       dtype=torch.int32, device=key.device)
    launch_hist(key, shift, hist, flag)
    _count("radix_hist", key)
    out = _scatter_cuda(key, val, exclusive_offsets(hist), shift, flag)
    if err is None:
        read_err(flag, "counting_sort_pass")
    return out


# --------------------------------------------------------------------- #
# plain PyTorch versions (the CPU path and the on-card reference)
# --------------------------------------------------------------------- #

def _unsigned_order(key: torch.Tensor) -> torch.Tensor:
    """The key whose bits, read as unsigned, order as ``key`` does: an
    int64 key with its sign bit flipped (int32 keys are non-negative)."""
    return key ^ INT64_MIN if _wide(key) else key


def digits_plain(key: torch.Tensor, shift: int) -> torch.Tensor:
    """The digit of each key at ``shift``, as the kernels compute it.
    An arithmetic shift fills in copies of the sign bit only above bit
    63 - shift >= 7, which the mask drops."""
    return (_unsigned_order(key) >> shift) & (N_DIGITS - 1)


def _tiled_digits(key: torch.Tensor, shift: int, tile: int) -> torch.Tensor:
    """The digits of ``key``, padded with N_DIGITS (a digit no row has)
    to whole tiles, viewed (n_tiles, tile)."""
    d = digits_plain(key, shift)
    pad = n_tiles(key.numel(), tile) * tile - key.numel()
    if pad:
        d = torch.cat([d, d.new_full((pad,), N_DIGITS)])
    return d.view(-1, tile)


def _chunk_tiles(tile: int) -> int:
    return max(1, _PLAIN_CHUNK_ROWS // tile)


def radix_hist_plain(key: torch.Tensor, shift: int,
                     tile: int = KERNEL_TILE) -> torch.Tensor:
    """The TPU kernel's own formulation: a one-hot compare of each tile's
    digits against the 256 digits, summed over the tile."""
    d = _tiled_digits(key, shift, tile)
    digits = torch.arange(N_DIGITS, dtype=d.dtype, device=key.device)
    out = torch.empty((d.shape[0], N_DIGITS), dtype=torch.int32,
                      device=key.device)
    step = _chunk_tiles(tile)
    for t0 in range(0, d.shape[0], step):
        blk = d[t0:t0 + step]
        out[t0:t0 + blk.shape[0]] = (blk[:, :, None] == digits).sum(
            1, dtype=torch.int32)
    return out


def radix_scatter_plain(key: torch.Tensor, val: torch.Tensor,
                        off: torch.Tensor, shift: int,
                        tile: int = KERNEL_TILE
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's own formulation: stable within-tile ranks from an
    exclusive cumsum of the tile's one-hot down the tile; the key moves
    with its value."""
    n = key.numel()
    d = _tiled_digits(key, shift, tile)
    flat_key = torch.cat([key, key.new_zeros(d.numel() - n)])
    flat_val = torch.cat([val, val.new_zeros(d.numel() - n)])
    digits = torch.arange(N_DIGITS, dtype=d.dtype, device=key.device)
    key_out = torch.empty_like(key)
    val_out = torch.empty_like(val)
    step = _chunk_tiles(tile)
    for t0 in range(0, d.shape[0], step):
        blk = d[t0:t0 + step]
        oh = (blk[:, :, None] == digits).to(torch.int32)
        rank = torch.cumsum(oh, 1, dtype=torch.int32) - oh
        within = (rank * oh).sum(2, dtype=torch.int32)
        base = off[t0:t0 + blk.shape[0]].gather(
            1, blk.clamp(max=N_DIGITS - 1).to(torch.int64))
        live = (blk < N_DIGITS).reshape(-1)
        pos = (base + within).reshape(-1)[live].to(torch.int64)
        if pos.numel() and (int(pos.min()) < 0 or int(pos.max()) >= n):
            raise ValueError("radix_scatter: offsets place a row outside "
                             "[0, n)")
        rows = slice(t0 * tile, (t0 + blk.shape[0]) * tile)
        key_out[pos] = flat_key[rows][live]
        val_out[pos] = flat_val[rows][live]
    return key_out, val_out


def counting_sort_pass_plain(key: torch.Tensor, val: torch.Tensor,
                             shift: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The same stable pass as RADIX_BITS 1-bit stable partitions over
    bits ``shift ..`` of the key in unsigned order, LSB first: a 1-bit
    counting sort is one cumsum (zeros keep their order at offset 0,
    ones at offset total_zeros) and one scatter."""
    n = key.numel()
    if n == 0:
        return key.clone(), val.clone()
    iota = torch.arange(n, dtype=torch.int32, device=key.device)
    k, v = key, val
    for s in range(shift, min(shift + D.RADIX_BITS, _KEY_BITS[key.dtype])):
        b = ((_unsigned_order(k) >> s) & 1).to(torch.int32)
        zb = torch.cumsum(1 - b, 0, dtype=torch.int32)  # zeros so far, incl.
        pos = torch.where(b == 0, zb - 1, zb[-1] + iota - zb).to(torch.int64)
        nk = torch.empty_like(k)
        nk[pos] = k
        nv = torch.empty_like(v)
        nv[pos] = v
        k, v = nk, nv
    return k, v


__all__ = ["TILE", "KERNEL_TILE", "N_DIGITS", "LAUNCHES",
           "radix_hist", "radix_scatter", "counting_sort_pass",
           "exclusive_offsets", "new_err", "read_err", "digits_plain", "radix_hist_plain", "radix_scatter_plain",
           "counting_sort_pass_plain"]

# ported from tidb_tpu/copr/exec.py @ a9e9482
"""The masked grouped reduction of the aggregation paths: ``_reduce``.

In the JAX package, ``copr/exec.py::_reduce`` is traced into the fused
XLA program of a scan: a one-hot compare on the TPU for up to 64 groups,
a scatter beyond.  Here it is one hand-written CUDA kernel,
``group_reduce.cu`` (built for sm_90a at first use by ``build.py``),
and its plain PyTorch version.

``group_reduce(vals, mask, gids, G, how)``:

- ``vals``: (n,) int8/16/32/64, uint8, float32 or float64;
- ``mask``: (n,) bool, the rows that take part;
- ``gids``: (n,) int32 or int64 in ``[0, G]``, or None (then G = 1);
  rows whose gid lies outside ``[0, G)`` are dropped, so ``G`` itself
  serves the callers as a sink slot for dead rows;
- ``how``: ``"sum"``, ``"min"`` or ``"max"``.

It returns the (G,) table in ``vals``' dtype; a slot no row reaches
holds the neutral (0, the dtype's max or min, +-inf for floats).
Integer sums wrap as the dtype does; float min/max propagate NaN.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version.  The kernel takes int64 or float64
values: the wrapper widens narrower ones on the card and narrows the
result back, which is exact for min/max and for the wrap of a sum.
Float sums on the card accumulate in fixed point (see the .cu), so they
are the same bits on every launch and agree with the plain version's
double-precision sum within rounding.  ``LAUNCHES["group_reduce"]``
counts the wrapper's kernel launches (one a call).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .build import Library, raise_on, stream_of

LAUNCHES = {"group_reduce": 0}

REG_SLOTS = 16            # G up to this: a table in registers
SMEM_SLOTS = 4096         # G up to this: a table in shared memory
MAX_FLOAT_SUM_ROWS = 1 << 30   # exact limb sums of the float-sum lanes

_SRC = Path(__file__).with_name("group_reduce.cu")
_HOWS = ("sum", "min", "max")
_INTS = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)
_FLOATS = (torch.float32, torch.float64)
# the kernel's kinds: (value family, how) -> kind
_KIND = {("int", "sum"): 0, ("int", "min"): 1, ("int", "max"): 2,
         ("float", "min"): 3, ("float", "max"): 4, ("float", "sum"): 5}


def _setup(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.group_reduce_reg_slots.argtypes = []
    lib.group_reduce_reg_slots.restype = i32
    lib.group_reduce_smem_slots.argtypes = []
    lib.group_reduce_smem_slots.restype = i32
    lib.group_reduce_launch.argtypes = [p, p, p, i32, i64, i64, i32, p, p,
                                        p, p, i32, p]
    lib.group_reduce_launch.restype = i32
    if (lib.group_reduce_reg_slots(), lib.group_reduce_smem_slots()) \
            != (REG_SLOTS, SMEM_SLOTS):
        raise RuntimeError("group_reduce.cu slot limits differ from "
                           "group_reduce.py")


LIBRARY = Library(_SRC, _setup)


def table_mode(G: int) -> str:
    """Where the kernel keeps a G-slot table: ``registers``,
    ``shared`` or ``global`` (device memory only)."""
    if G <= REG_SLOTS:
        return "registers"
    return "shared" if G <= SMEM_SLOTS else "global"


def neutral(dtype: torch.dtype, how: str):
    """The value of a slot no row reaches."""
    if how == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if how == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if how == "min" else info.min


# --------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------- #

def _check(vals, mask, gids, G, how) -> None:
    if not isinstance(vals, torch.Tensor) or vals.dim() != 1:
        raise ValueError("vals must be a 1-d tensor")
    if vals.dtype not in _INTS + _FLOATS:
        raise TypeError(f"vals of dtype {vals.dtype} are not reduced")
    if vals.device.type not in ("cuda", "cpu"):
        raise ValueError(f"vals lie on unsupported device {vals.device}")
    n = vals.shape[0]
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool \
            or tuple(mask.shape) != (n,) or mask.device != vals.device:
        raise ValueError(f"mask must be a ({n},) bool tensor on "
                         f"{vals.device}")
    if gids is None:
        if G != 1:
            raise ValueError("a reduction without gids has G = 1")
    elif not isinstance(gids, torch.Tensor) \
            or gids.dtype not in (torch.int32, torch.int64) \
            or tuple(gids.shape) != (n,) or gids.device != vals.device:
        raise ValueError(f"gids must be a ({n},) int32/int64 tensor on "
                         f"{vals.device}")
    if isinstance(G, bool) or not isinstance(G, int) or G < 1:
        raise ValueError(f"G must be an int >= 1, got {G!r}")
    if how not in _HOWS:
        raise ValueError(f"how must be one of {_HOWS}, got {how!r}")
    if how == "sum" and vals.dtype in _FLOATS and n >= MAX_FLOAT_SUM_ROWS:
        raise ValueError(f"a float sum over {n} rows exceeds the "
                         f"{MAX_FLOAT_SUM_ROWS} rows of its exact limbs")


# --------------------------------------------------------------------- #
# the wrapper
# --------------------------------------------------------------------- #

def group_reduce(vals: torch.Tensor, mask: torch.Tensor, gids, G: int,
                 how: str) -> torch.Tensor:
    """The (G,) masked grouped ``how``-reduction of ``vals`` by ``gids``
    (see the module docstring)."""
    _check(vals, mask, gids, G, how)
    if vals.device.type == "cpu":
        return group_reduce_plain(vals, mask, gids, G, how)
    return _group_reduce_cuda(vals, mask, gids, G, how)


def _group_reduce_cuda(vals, mask, gids, G, how) -> torch.Tensor:
    dev = vals.device
    fam = "float" if vals.dtype.is_floating_point else "int"
    wide = vals.to(torch.float64 if fam == "float" else torch.int64)
    wide = wide.contiguous()
    mask = mask.contiguous()
    kind = _KIND[(fam, how)]
    lanes = 3 if kind == 5 else 1
    table = torch.empty(lanes * G, dtype=torch.int64, device=dev)
    flags = torch.empty(G, dtype=torch.int32, device=dev) if kind == 5 \
        else None
    mx = torch.empty(1, dtype=torch.int64, device=dev) if kind == 5 else None
    out = torch.empty(G, dtype=torch.float64, device=dev) if fam == "float" \
        else None
    if gids is not None:
        gids = gids.contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()
    raise_on(LIBRARY.get().group_reduce_launch(
        wide.data_ptr(), mask.data_ptr(), ptr(gids),
        0 if gids is None else gids.element_size(), wide.numel(), G, kind,
        table.data_ptr(), ptr(flags), ptr(mx), ptr(out), dev.index,
        stream_of(wide)), "group_reduce")
    LAUNCHES["group_reduce"] += 1
    if fam == "float":
        res = out
    elif how == "sum" or vals.dtype == torch.int64:
        res = table[:G]
    else:
        # an empty min/max slot holds the int64 neutral: narrow's instead
        info = torch.iinfo(vals.dtype)
        res = table[:G].clamp(info.min, info.max)
    return res if res.dtype == vals.dtype else res.to(vals.dtype)


# --------------------------------------------------------------------- #
# the plain PyTorch version (the CPU path and the on-card reference)
# --------------------------------------------------------------------- #

def group_reduce_plain(vals: torch.Tensor, mask: torch.Tensor, gids, G: int,
                       how: str) -> torch.Tensor:
    """The CPU lowering of the JAX package's ``_reduce``: rows outside
    the mask take the neutral, then a scatter (``index_add_`` /
    ``scatter_reduce_``) into G + 1 slots whose last is the sink, or one
    full reduction without gids.  Computes at int64 or float64 and casts
    back, as the kernel's wrapper does."""
    wide_t = torch.float64 if vals.dtype.is_floating_point else torch.int64
    neu = neutral(vals.dtype, how)
    v = torch.where(mask, vals.to(wide_t),
                    torch.tensor(neu, dtype=wide_t, device=vals.device))
    if gids is None:
        red = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}[how]
        res = red(v).reshape(1)
    else:
        g = torch.where((gids >= 0) & (gids < G), gids.to(torch.int64), G)
        res = torch.full((G + 1,), neu, dtype=wide_t, device=vals.device)
        if how == "sum":
            res.index_add_(0, g, v)
        else:
            res.scatter_reduce_(0, g, v, reduce="a" + how,
                                include_self=True)
        res = res[:G]
    return res if res.dtype == vals.dtype else res.to(vals.dtype)


__all__ = ["LAUNCHES", "REG_SLOTS", "SMEM_SLOTS", "MAX_FLOAT_SUM_ROWS",
           "group_reduce", "group_reduce_plain", "neutral",
           "table_mode"]

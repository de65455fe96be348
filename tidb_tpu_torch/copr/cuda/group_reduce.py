# ported from tidb_tpu/copr/exec.py @ a9e9482
"""The masked grouped reductions of an aggregation's state table.

In the JAX package, ``copr/exec.py::_reduce`` is traced once a state lane
(``_one_agg_state``, ``_agg_partial_states``) into the fused XLA program
of a scan: a one-hot compare on the TPU for up to 64 groups, a scatter
beyond.  Here every lane of a state table is one launch of one
hand-written CUDA kernel, ``group_reduce.cu`` (built for sm_90a at first
use by ``build.py``), and the plain PyTorch version is the CPU path.

``group_reduce_lanes(gids, G, lanes)`` returns one (G,) table a lane:

- ``gids``: (n,) int32 or int64 in ``[0, G]``, or None (then G = 1);
  rows whose gid lies outside ``[0, G)`` are dropped, so ``G`` itself
  serves the callers as a sink slot for dead rows;
- a ``Lane(kind, src, mask)``: ``mask`` the (n,) bool rows that take
  part, ``src`` the (n,) column the kind reads (None for a count), at its
  stored dtype; kinds and their tables:

  ==========  =====================  ============================
  kind        src                    table
  ==========  =====================  ============================
  count       None                   int64: the mask's ones
  sum         int8/16/32/64, uint8   int64 sum of the widened value
  sum_hi32    or bool                int64 sum of ``v >> 32``
  sum_lo32                           int64 sum of ``v & 0xFFFFFFFF``
  min, max    int8/16/32/64, uint8   src's dtype
  fsum        float32/64             float64 sum
  fmin, fmax  float32/64             src's dtype, NaN winning
  ==========  =====================  ============================

A slot no row reaches holds the neutral (0, the dtype's max or min,
+-inf).  Two lanes with the same kind, source and mask (by tensor
identity) are one lane: a COUNT whose mask is the selection reuses the
table of ``__rows__``.  On the card the kernel reads each distinct
source, mask and the gids once, at their stored widths; float sums
accumulate in fixed point (see the .cu), the same bits on every launch,
within rounding of the plain version's double-precision sum.

``group_reduce(vals, mask, gids, G, how)`` is the one-lane call through
the same kernel (``how`` "sum", "min" or "max"; the table in ``vals``'
dtype, a narrow integer sum wrapping as the dtype does).

On a CUDA tensor the wrappers launch the kernel or raise; on a CPU
tensor they run the plain versions (``group_reduce_lanes_plain``, which
applies each lane's transform in torch and calls ``group_reduce_plain``).
``LAUNCHES["group_reduce"]`` counts the kernel's launches as its C
launcher reports them: one a state table whose lanes fit one launch
(``MAX_SRCS`` sources, ``MAX_MASKS`` masks, ``MAX_LANES`` lanes,
``MAX_COLS`` table columns), one more for each further such set.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from .build import Library, raise_on, stream_of

LAUNCHES = {"group_reduce": 0}

MAX_FLOAT_SUM_ROWS = 1 << 30   # exact limb sums of the float-sum lanes
# the kernel's limits (checked against group_reduce.cu at load)
MAX_SRCS, MAX_MASKS, MAX_LANES, MAX_COLS = 8, 8, 32, 48
PRIV_ENTRIES = 112        # G x columns up to this: a table a thread
SMEM_ENTRIES = 12288      # G x columns up to this: a table a block

_SRC = Path(__file__).with_name("group_reduce.cu")
_INTS = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)
_FLOATS = (torch.float32, torch.float64)
_DTYPE_CODE = {torch.int8: 0, torch.int16: 1, torch.int32: 2,
               torch.int64: 3, torch.uint8: 4, torch.bool: 4,
               torch.float32: 5, torch.float64: 6}
KINDS = ("count", "sum", "sum_hi32", "sum_lo32", "min", "max", "fsum",
         "fmin", "fmax")
_KIND_CODE = {k: i for i, k in enumerate(KINDS)}
# the source dtypes each kind reads
_SRC_DTYPES = {"count": (), "sum": _INTS + (torch.bool,),
               "sum_hi32": _INTS + (torch.bool,),
               "sum_lo32": _INTS + (torch.bool,), "min": _INTS,
               "max": _INTS, "fsum": _FLOATS, "fmin": _FLOATS,
               "fmax": _FLOATS}


@dataclass(frozen=True, eq=False)
class Lane:
    """One state lane: ``kind`` over ``src`` (None for a count) on the
    rows of ``mask``."""
    kind: str
    src: torch.Tensor | None
    mask: torch.Tensor

    def key(self) -> tuple:
        return (self.kind, id(self.src), id(self.mask))


def _setup(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    ints = ctypes.POINTER(ctypes.c_int)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.group_reduce_limits.argtypes = [ints]
    lib.group_reduce_limits.restype = i32
    lib.group_reduce_lanes_launch.argtypes = [
        p, i32, i64, i64, i32, ptrs, ints, i32, ptrs, i32, ints, ints, ints,
        p, p, p, p, i32, p, ints]
    lib.group_reduce_lanes_launch.restype = i32
    got = (ctypes.c_int * 6)()
    lib.group_reduce_limits(got)
    want = (MAX_SRCS, MAX_MASKS, MAX_LANES, MAX_COLS, PRIV_ENTRIES,
            SMEM_ENTRIES)
    if tuple(got) != want:
        raise RuntimeError(f"group_reduce.cu limits {tuple(got)} differ "
                           f"from group_reduce.py's {want}")


LIBRARY = Library(_SRC, _setup)


def table_mode(G: int, cols: int = 1) -> str:
    """Where the kernel keeps a table of G slots and ``cols`` int64
    columns: ``private`` (one a thread in shared memory), ``shared``
    (one a block) or ``global`` (device memory only)."""
    if G * cols <= PRIV_ENTRIES:
        return "private"
    return "shared" if G * cols <= SMEM_ENTRIES else "global"


def lane_cols(kind: str) -> int:
    """int64 table columns of a lane of ``kind`` (an fsum's three limbs)."""
    return 3 if kind == "fsum" else 1


def neutral(dtype: torch.dtype, how: str):
    """The value of a slot no row reaches."""
    if how == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if how == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if how == "min" else info.min


def unique_lanes(lanes) -> list:
    """The lanes with duplicates (same kind, source and mask) dropped,
    in first-seen order."""
    seen = {}
    for ln in lanes:
        seen.setdefault(ln.key(), ln)
    return list(seen.values())


# --------------------------------------------------------------------- #
# validation
# --------------------------------------------------------------------- #

def _check_rows(name, t, n, dtypes, device) -> None:
    if not isinstance(t, torch.Tensor) or t.dim() != 1 or t.shape[0] != n \
            or t.device != device:
        raise ValueError(f"{name} must be a ({n},) tensor on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} of dtype {t.dtype} is not reduced")


def _check_lanes(gids, G, lanes) -> None:
    if not lanes:
        raise ValueError("a state table needs at least one lane")
    for ln in lanes:
        if not isinstance(ln, Lane) or ln.kind not in KINDS:
            raise ValueError(f"a lane's kind must be one of {KINDS}")
        if not isinstance(ln.mask, torch.Tensor) or ln.mask.dim() != 1:
            raise ValueError("a lane's mask must be a 1-d bool tensor")
    n, dev = lanes[0].mask.shape[0], lanes[0].mask.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"lanes lie on unsupported device {dev}")
    for ln in lanes:
        _check_rows("mask", ln.mask, n, (torch.bool,), dev)
        if ln.kind == "count":
            if ln.src is not None:
                raise ValueError("a count lane reads no source")
        else:
            _check_rows(f"the source of a {ln.kind} lane", ln.src, n,
                        _SRC_DTYPES[ln.kind], dev)
    if isinstance(G, bool) or not isinstance(G, int) or G < 1:
        raise ValueError(f"G must be an int >= 1, got {G!r}")
    if gids is None:
        if G != 1:
            raise ValueError("a reduction without gids has G = 1")
    else:
        _check_rows("gids", gids, n, (torch.int32, torch.int64), dev)
    if n >= MAX_FLOAT_SUM_ROWS and any(ln.kind == "fsum" for ln in lanes):
        raise ValueError(f"a float sum over {n} rows exceeds the "
                         f"{MAX_FLOAT_SUM_ROWS} rows of its exact limbs")


def _lane_dtype(ln: Lane) -> torch.dtype:
    if ln.kind in ("min", "max", "fmin", "fmax"):
        return ln.src.dtype
    return torch.float64 if ln.kind == "fsum" else torch.int64


# --------------------------------------------------------------------- #
# the wrappers
# --------------------------------------------------------------------- #

def group_reduce_lanes(gids, G: int, lanes) -> list:
    """One (G,) table a lane of ``lanes`` (see the module docstring)."""
    lanes = list(lanes)
    _check_lanes(gids, G, lanes)
    if lanes[0].mask.device.type == "cpu":
        return group_reduce_lanes_plain(gids, G, lanes)
    uniq = unique_lanes(lanes)
    tables = {}
    for part in _launch_sets(uniq):
        tables.update(zip((ln.key() for ln in part),
                          _lanes_cuda(gids, G, part)))
    return [tables[ln.key()] for ln in lanes]


def _launch_sets(uniq: list) -> list:
    """The distinct lanes cut into sets that fit one launch, in order: at
    most ``MAX_SRCS`` sources, ``MAX_MASKS`` masks, ``MAX_LANES`` lanes,
    ``MAX_COLS`` columns, and one lane a (source, kind) (the kernel runs
    each kind of a source as its own specialized body)."""
    sets, cur, srcs, masks, kinds, cols = [], [], set(), set(), set(), 0
    for ln in uniq:
        s = set() if ln.src is None else {id(ln.src)}
        m = {id(ln.mask)}
        k = (id(ln.src), ln.kind, id(ln.mask) if ln.src is None else 0)
        if cur and (len(cur) == MAX_LANES
                    or len(srcs | s) > MAX_SRCS
                    or len(masks | m) > MAX_MASKS
                    or k in kinds
                    or cols + lane_cols(ln.kind) > MAX_COLS):
            sets.append(cur)
            cur, srcs, masks, kinds, cols = [], set(), set(), set(), 0
        cur.append(ln)
        srcs |= s
        masks |= m
        kinds.add(k)
        cols += lane_cols(ln.kind)
    return sets + [cur]


def _lanes_cuda(gids, G: int, lanes: list) -> list:
    """One launch over ``lanes`` (distinct, within the kernel's limits)."""
    dev = lanes[0].mask.device
    srcs, masks = {}, {}
    for ln in lanes:
        if ln.src is not None:
            srcs.setdefault(id(ln.src), ln.src.contiguous())
        masks.setdefault(id(ln.mask), ln.mask.contiguous())
    src_ix = {k: i for i, k in enumerate(srcs)}
    mask_ix = {k: i for i, k in enumerate(masks)}
    ncol = sum(lane_cols(ln.kind) for ln in lanes)
    nfsum = sum(ln.kind == "fsum" for ln in lanes)
    nfloat = sum(ln.kind in ("fsum", "fmin", "fmax") for ln in lanes)
    n = lanes[0].mask.shape[0]
    table = torch.empty(ncol * G, dtype=torch.int64, device=dev)
    flags = torch.empty(nfsum * G, dtype=torch.int32, device=dev) \
        if nfsum else None
    mx = torch.empty(len(lanes), dtype=torch.int64, device=dev)
    out = torch.empty(nfloat * G, dtype=torch.float64, device=dev) \
        if nfloat else None
    if gids is not None:
        gids = gids.contiguous()

    def arr(ctype, xs):
        return (ctype * max(len(xs), 1))(*xs)

    def ptr(t):
        return None if t is None else t.data_ptr()
    src_t = list(srcs.values())
    launched = ctypes.c_int(0)
    raise_on(LIBRARY.get().group_reduce_lanes_launch(
        ptr(gids),
        0 if gids is None else gids.element_size(), n, G, len(src_t),
        arr(ctypes.c_void_p, [t.data_ptr() for t in src_t]),
        arr(ctypes.c_int, [_DTYPE_CODE[t.dtype] for t in src_t]),
        len(masks), arr(ctypes.c_void_p, [t.data_ptr() for t in
                                          masks.values()]),
        len(lanes), arr(ctypes.c_int, [_KIND_CODE[ln.kind] for ln in lanes]),
        arr(ctypes.c_int, [src_ix.get(id(ln.src), -1) for ln in lanes]),
        arr(ctypes.c_int, [mask_ix[id(ln.mask)] for ln in lanes]),
        table.data_ptr(), ptr(flags), mx.data_ptr(), ptr(out),
        dev.index, stream_of(table), ctypes.byref(launched)),
        "group_reduce")
    LAUNCHES["group_reduce"] += launched.value
    res, col, fo = {}, 0, 0
    cols = table.view(G, ncol)        # slot-major: a lane's table strided
    for ln in lanes:
        if ln.kind in ("fsum", "fmin", "fmax"):
            t = out[fo * G:(fo + 1) * G]
            fo += 1
        else:
            t = cols[:, col]
        col += lane_cols(ln.kind)
        want = _lane_dtype(ln)
        if ln.kind in ("min", "max") and want != torch.int64:
            # an empty slot holds the int64 neutral: the narrow one's
            info = torch.iinfo(want)
            t = t.clamp(info.min, info.max)
        res[ln.key()] = t if t.dtype == want else t.to(want)
    return [res[ln.key()] for ln in lanes]


def group_reduce(vals: torch.Tensor, mask: torch.Tensor, gids, G: int,
                 how: str) -> torch.Tensor:
    """The (G,) masked grouped ``how``-reduction of ``vals`` by ``gids``,
    in ``vals``' dtype: one lane of ``group_reduce_lanes``."""
    if not isinstance(vals, torch.Tensor) or vals.dim() != 1:
        raise ValueError("vals must be a 1-d tensor")
    if vals.dtype not in _INTS + _FLOATS:
        raise TypeError(f"vals of dtype {vals.dtype} are not reduced")
    if how not in ("sum", "min", "max"):
        raise ValueError(f"how must be sum, min or max, got {how!r}")
    kind = ("f" + how) if vals.dtype.is_floating_point else how
    out = group_reduce_lanes(gids, G, [Lane(kind, vals, mask)])[0]
    return out if out.dtype == vals.dtype else out.to(vals.dtype)


# --------------------------------------------------------------------- #
# the plain PyTorch versions (the CPU path and the on-card reference)
# --------------------------------------------------------------------- #

def lane_values(ln: Lane) -> tuple:
    """A lane as the (values, how) that ``group_reduce_plain`` reduces:
    its transform applied in torch."""
    if ln.kind == "count":
        return ln.mask.to(torch.int64), "sum"
    if ln.kind in ("fsum", "fmin", "fmax"):
        v = ln.src.to(torch.float64) if ln.kind == "fsum" else ln.src
        return v, ln.kind[1:]
    if ln.kind in ("min", "max"):
        return ln.src, ln.kind
    v = ln.src.to(torch.int64)
    if ln.kind == "sum_hi32":
        v = v >> 32
    elif ln.kind == "sum_lo32":
        v = v & 0xFFFFFFFF
    return v, "sum"


def group_reduce_lanes_plain(gids, G: int, lanes) -> list:
    """``group_reduce_lanes`` in plain torch: each distinct lane's
    transform, then ``group_reduce_plain``."""
    done = {}
    for ln in lanes:
        if ln.key() not in done:
            v, how = lane_values(ln)
            done[ln.key()] = group_reduce_plain(v, ln.mask, gids, G, how)
    return [done[ln.key()] for ln in lanes]


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


__all__ = ["LAUNCHES", "KINDS", "Lane", "MAX_FLOAT_SUM_ROWS", "MAX_SRCS",
           "MAX_MASKS", "MAX_LANES", "MAX_COLS", "PRIV_ENTRIES",
           "SMEM_ENTRIES", "group_reduce", "group_reduce_lanes",
           "group_reduce_lanes_plain", "group_reduce_plain", "lane_cols",
           "lane_values", "neutral", "table_mode", "unique_lanes"]

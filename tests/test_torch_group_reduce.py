"""The port's ``group_reduce`` (the ``_reduce`` of the aggregation paths)
against the JAX package's ``copr/exec.py::_reduce``.

The JAX ``_reduce`` has two branches, chosen by the platform it traces
for: a one-hot compare (``set_trace_platform("tpu")``, up to
``DENSE_BROADCAST_MAX_GROUPS`` = 64 groups) and a scatter (``"cpu"``).
The port's ``exec._reduce`` on CPU tensors runs ``group_reduce``'s plain
version; it is held against both branches over G in {1, 12, 64, 65,
5000}, with masked rows, rows in the sink slot G, NaN among the floats,
and narrow integer values.  Integers compare exactly; float sums, which
each side adds in its own order, within ``FLOAT_RTOL``; float min/max
exactly, NaN included.

The one-hot branch sums a narrow integer type in int64 (``jnp.sum``
promotes), the scatter branch in the narrow type itself (it wraps).  The
port follows the scatter branch (the table keeps ``vals``' dtype), so
against the one-hot branch a narrow sum compares after the wrap.

The CUDA kernel runs only on a GPU (``tests/test_torch_cuda.py``), but
its lane arithmetic (the int64 lanes of each kind, the fixed-point limbs
of a float sum, the order-preserving keys of float min/max, and the
finalize back to doubles) is plain C++: ``test_kernel_lane_arithmetic_
on_the_host`` compiles that part of ``group_reduce.cu`` with the host's
C++ compiler and reduces through it row by row.
"""

import shutil
import subprocess
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.copr import exec as jexec
from tidb_tpu_torch.copr import exec as pexec
from tidb_tpu_torch.copr.cuda import group_reduce as gr

FLOAT_RTOL = 1e-12
N = 3000
GROUPS = [1, 12, 64, 65, 5000]
DTYPES = ["int8", "int16", "int64", "float64"]


def _inputs(dtype, G, seed):
    """vals (with NaN among floats), mask (~80% live), gids in [0, G]
    (G being the sink slot), or None for G == 1."""
    rng = np.random.default_rng(seed)
    if dtype == "float64":
        v = rng.normal(0.0, 1e3, N)
        v[rng.random(N) < 0.01] = np.nan
    else:
        info = np.iinfo(dtype)
        v = rng.integers(info.min, info.max, N, endpoint=True).astype(dtype)
    m = rng.random(N) < 0.8
    g = None if G == 1 else rng.integers(0, G + 1, N).astype(np.int32)
    return v, m, g


def _jax_reduce(v, m, g, G, how, platform):
    jexec.set_trace_platform(platform)
    try:
        return np.asarray(jexec._reduce(
            jnp.asarray(v), jnp.asarray(m),
            None if g is None else jnp.asarray(g), G, how))
    finally:
        jexec.set_trace_platform(None)


def _port_reduce(v, m, g, G, how):
    return pexec._reduce(torch.from_numpy(v), torch.from_numpy(m),
                         None if g is None else torch.from_numpy(g), G,
                         how).numpy()


@pytest.mark.parametrize("branch", ["one-hot", "scatter"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("how", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_reduce_equals_jax_reduce(branch, G, how, dtype):
    v, m, g = _inputs(dtype, G, G * 7 + len(how) + len(dtype))
    want = _jax_reduce(v, m, g, G, how,
                       "tpu" if branch == "one-hot" else "cpu")
    got = _port_reduce(v, m, g, G, how)
    assert got.shape == want.shape
    if dtype == "float64":
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL,
                                   equal_nan=True)
        return
    if G > 1 and how == "sum" and want.dtype != got.dtype:
        # the one-hot branch sums a narrow type in int64 (see above)
        assert branch == "one-hot" and got.dtype == np.dtype(dtype)
        want = want.astype(dtype)
    assert got.dtype == want.dtype
    assert (got == want).all()


@pytest.mark.parametrize("how", ["sum", "min", "max"])
def test_gids_past_the_sink_are_dropped(how):
    """Rows whose gid lies beyond the sink slot are dropped, as the JAX
    scatter's mode="drop" drops them."""
    rng = np.random.default_rng(3)
    v = rng.integers(-10 ** 9, 10 ** 9, N)
    m = rng.random(N) < 0.9
    g = rng.integers(0, 40, N).astype(np.int64)
    want = _jax_reduce(v, m, g, 30, how, "cpu")
    assert (_port_reduce(v, m, g, 30, how) == want).all()


def test_scalar_narrow_sum_promotes_like_jnp_sum():
    v = np.full(1000, 100, np.int8)
    m = np.ones(1000, bool)
    got = _port_reduce(v, m, None, 1, "sum")
    assert got.dtype == np.int64 and got.shape == () and int(got) == 100_000
    assert int(_jax_reduce(v, m, None, 1, "sum", "cpu")) == 100_000


def test_table_modes():
    """A table of G slots and some int64 columns lives in a private
    table a thread up to PRIV_ENTRIES entries (TPC-H Q1: G = 12, nine
    columns), a block's shared table up to SMEM_ENTRIES, else in device
    memory."""
    assert [gr.table_mode(G) for G in (1, 12, 112, 113, 12288, 12289,
                                       1 << 23)] \
        == ["private"] * 3 + ["shared"] * 2 + ["global"] * 2
    assert [gr.table_mode(12, c) for c in (9, 10)] == ["private", "shared"]
    assert [gr.table_mode(4096, c) for c in (3, 4)] == ["shared", "global"]


def _bad_calls():
    v = torch.zeros(8, dtype=torch.int64)
    m = torch.ones(8, dtype=torch.bool)
    g = torch.zeros(8, dtype=torch.int32)
    huge = torch.zeros(1, dtype=torch.float64).expand(gr.MAX_FLOAT_SUM_ROWS)
    return {
        "vals 2-d": (v.reshape(2, 4), m, g, 4, "sum"),
        "vals bool": (m, m, g, 4, "sum"),
        "mask int": (v, v, g, 4, "sum"),
        "mask shape": (v, m[:4], g, 4, "sum"),
        "gids float": (v, m, v.double(), 4, "sum"),
        "gids shape": (v, m, g[:4], 4, "sum"),
        "no gids, G > 1": (v, m, None, 4, "sum"),
        "G zero": (v, m, g, 0, "sum"),
        "G bool": (v, m, g, True, "sum"),
        "how": (v, m, g, 4, "mean"),
        "float sum past the limb rows": (
            huge, torch.ones(1, dtype=torch.bool).expand(huge.shape[0]),
            None, 1, "sum"),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects_bad_input(case):
    with pytest.raises((TypeError, ValueError)):
        gr.group_reduce(*_bad_calls()[case])


def test_plain_path_launches_no_kernel():
    before = dict(gr.LAUNCHES)
    v, m, g = _inputs("int64", 12, 1)
    gr.group_reduce(torch.from_numpy(v), torch.from_numpy(m),
                    torch.from_numpy(g), 12, "sum")
    assert gr.LAUNCHES == before


# ------------------------------------------------------------------ #
# the kernel's lane arithmetic, compiled for the host
# ------------------------------------------------------------------ #

_SHIMS = r"""
#include <climits>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#define __device__
#define __host__
#define __forceinline__ inline
static inline double __longlong_as_double(long long b) {
  double d; std::memcpy(&d, &b, 8); return d;
}
static inline long long __double_as_longlong(double d) {
  long long b; std::memcpy(&b, &d, 8); return b;
}
static inline float __uint_as_float(unsigned u) {
  float f; std::memcpy(&f, &u, 4); return f;
}
"""

_MAIN = r"""
template <class T> std::vector<T> load(const char* path, long long n) {
  std::vector<T> v(n);
  FILE* f = std::fopen(path, "rb");
  if (!f || (n && std::fread(v.data(), sizeof(T), n, f) != (size_t)n))
    std::exit(3);
  std::fclose(f);
  return v;
}

// one lane of the kernel, one row at a time: the source at its stored
// width widened, the lane's transform, the columns combined (integer
// columns are exact, so any order of the rows gives these bits), the
// float lanes finalized
int main(int argc, char** argv) {
  if (argc != 9) return 2;
  const int kind = std::atoi(argv[1]);
  const long long G = std::atoll(argv[2]), n = std::atoll(argv[3]);
  const int dt = std::atoi(argv[4]), b = dtype_bytes(dt);
  auto bytes = load<unsigned char>(argv[5], n * b);
  auto gid = load<long long>(argv[6], n);
  auto mask = load<unsigned char>(argv[7], n);
  std::vector<long long> w(n);
  for (long long i = 0; i < n; ++i) {
    unsigned long long x = 0;
    std::memcpy(&x, &bytes[i * b], b);
    w[i] = widen(dt, x);
  }
  const int op = kind_op(kind), nc = kind_cols(kind);
  std::vector<long long> table(G * nc, neutral_of(op));   // slot-major
  std::vector<int> flags(G, 0);
  unsigned long long mx = 0;
  for (long long i = 0; i < n; ++i)       // the fsum prepass
    if (kind == K_FSUM && mask[i] && gid[i] >= 0 && gid[i] < G &&
        !bits_nonfinite(w[i])) {
      const unsigned long long ab = (unsigned long long)(w[i] & LLONG_MAX);
      if (ab > mx) mx = ab;
    }
  const int scale = kind == K_FSUM ? fsum_scale(mx) : 0;
  for (long long i = 0; i < n; ++i) {
    const long long g = gid[i];
    if (!mask[i] || g < 0 || g >= G) continue;
    long long ln[3];
    const int flag = lane_value(kind, w[i], scale, ln);
    if (flag) { flags[g] |= flag; continue; }
    for (int c = 0; c < nc; ++c)
      table[g * nc + c] = combine(op, table[g * nc + c], ln[c]);
  }
  FILE* f = std::fopen(argv[8], "wb");
  for (long long g = 0; g < G; ++g) {
    if (kind_float(kind)) {
      const double x = finalize_float(kind, &table[g * nc], flags[g], mx);
      std::fwrite(&x, 8, 1, f);
    } else {
      std::fwrite(&table[g * nc], 8, 1, f);
    }
  }
  std::fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def lane_program(tmp_path_factory):
    """The lane arithmetic of group_reduce.cu, with a serial main program,
    built by the host's C++ compiler."""
    src = Path(gr.__file__).with_name("group_reduce.cu").read_text()
    begin = src.index("// -- the lane arithmetic")
    end = src.index("// -- end of the lane arithmetic --")
    d = tmp_path_factory.mktemp("lanes")
    cpp = d / "lanes.cpp"
    cpp.write_text(_SHIMS + src[begin:end] + _MAIN)
    exe = d / "lanes"
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "the host C++ compiler the native modules build with"
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-o", str(exe),
                          str(cpp)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    return exe, d


_DT_CODE = {"int8": 0, "int16": 1, "int32": 2, "int64": 3, "uint8": 4,
            "float32": 5, "float64": 6}


def _lanes(lane_program, vals, mask, gids, G, how):
    """One lane through the kernel's arithmetic on the host: ``how`` is a
    lane kind, or sum/min/max (then the kind the one-lane call takes for
    ``vals``' dtype); ``vals`` are written at their stored width."""
    exe, d = lane_program
    if how in ("sum", "min", "max") and vals.dtype.kind == "f":
        how = "f" + how
    n = len(vals)
    np.ascontiguousarray(vals).tofile(d / "raw")
    (np.zeros(n, np.int64) if gids is None else gids.astype(np.int64)
     ).tofile(d / "gid")
    mask.astype(np.uint8).tofile(d / "mask")
    out = subprocess.run([str(exe), str(gr.KINDS.index(how)), str(G), str(n),
                          str(_DT_CODE[vals.dtype.name]), str(d / "raw"),
                          str(d / "gid"), str(d / "mask"), str(d / "out")],
                         capture_output=True)
    assert out.returncode == 0, out
    return np.fromfile(d / "out", np.float64 if how in ("fsum", "fmin",
                                                        "fmax") else np.int64)


def _float_cases():
    rng = np.random.default_rng(11)
    base = rng.normal(0.0, 1.0, N)
    wide = base * 10.0 ** rng.integers(-8, 9, N)
    specials = base.copy()
    specials[rng.integers(0, N, 5)] = np.nan
    specials[rng.integers(0, N, 3)] = np.inf
    inf_only = base.copy()
    inf_only[::997] = -np.inf
    return {"normal": base * 1e3, "eight decades": wide,
            "tiny": base * 1e-300, "huge": base * 1e300,
            "NaN and +inf": specials, "-inf": inf_only,
            "negative zeros": np.full(N, -0.0),
            "cents": rng.integers(-10 ** 8, 10 ** 8, N) / 100.0}


@pytest.mark.parametrize("G", [1, 12, 5000])
@pytest.mark.parametrize("case", sorted(_float_cases()))
def test_kernel_lane_arithmetic_on_the_host(lane_program, case, G):
    """Float sums through the fixed-point limbs land within rounding of
    the exact sum (each term rounded to 2^-s, s = 94 - e, then the total
    once) and of the plain version; NaN, +-inf, -0.0 as IEEE sums give
    them.  Float min/max through the keys equal the plain version, NaN
    included."""
    rng = np.random.default_rng(G)
    v = _float_cases()[case]
    m = rng.random(N) < 0.85
    g = None if G == 1 else rng.integers(0, G + 1, N)
    tg = None if g is None else torch.from_numpy(g)
    for how in ("min", "max"):
        got = _lanes(lane_program, v, m, g, G, how)
        want = gr.group_reduce_plain(torch.from_numpy(v), torch.from_numpy(m),
                                     tg, G, how).numpy()
        np.testing.assert_array_equal(got, want)
        assert (np.signbit(got) == np.signbit(want)).all()
    got = _lanes(lane_program, v, m, g, G, "sum")
    want = gr.group_reduce_plain(torch.from_numpy(v), torch.from_numpy(m),
                                 tg, G, "sum").numpy()
    fin = v[m & np.isfinite(v)]
    big = float(np.abs(fin).max()) if len(fin) else 0.0
    for slot in range(G):
        rows = v[m & ((g == slot) if g is not None else True)]
        if not np.isfinite(rows).all():
            assert got[slot] == want[slot] or (np.isnan(got[slot])
                                               and np.isnan(want[slot]))
            continue
        exact = sum((Fraction(float(x)) for x in rows), Fraction(0))
        # one rounding of the total, plus n terms of at most 2^-95 of the
        # largest magnitude each
        bound = abs(exact) * Fraction(1, 2 ** 52) + \
            Fraction(big) * len(v) * Fraction(1, 2 ** 93)
        assert abs(Fraction(float(got[slot])) - exact) <= bound, slot
        assert got[slot] == pytest.approx(want[slot], rel=FLOAT_RTOL,
                                          abs=big * 1e-15)


@pytest.mark.parametrize("how", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["int8", "int16", "int64"])
def test_kernel_integer_lanes_on_the_host(lane_program, dtype, how):
    """Integer kinds: the int64 lanes wrap as the dtype's sum wraps once
    narrowed; min/max are exact."""
    v, m, g = _inputs(dtype, 65, 5)
    got = _lanes(lane_program, v, m, g, 65, how)
    want = gr.group_reduce_plain(torch.from_numpy(v), torch.from_numpy(m),
                                 torch.from_numpy(g), 65, how).numpy()
    if how == "sum":
        got = got.astype(dtype)
    else:   # the wrapper's clamp of an empty slot's int64 neutral
        info = np.iinfo(dtype)
        got = np.clip(got, info.min, info.max).astype(dtype)
    assert (got == want).all()


# ------------------------------------------------------------------ #
# the lane contract: group_reduce_lanes and its plain version
# ------------------------------------------------------------------ #

LANE_DTYPES = ["int8", "int16", "int32", "int64", "uint8", "float32",
               "float64"]
INT_KINDS = ("count", "sum", "sum_hi32", "sum_lo32", "min", "max")
FLOAT_KINDS = ("count", "fsum", "fmin", "fmax")
LANE_GROUPS = [1, 12, 4096 + 1, 1 << 16]


def _lane_source(dtype, seed, n=N):
    """Values of ``dtype`` over its whole range (NaN and +-inf among
    floats)."""
    rng = np.random.default_rng(seed)
    if dtype.startswith("float"):
        v = rng.normal(0.0, 1e5, n).astype(dtype)
        v[rng.random(n) < 0.01] = np.nan
        v[rng.random(n) < 0.005] = np.inf
        return v
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)


def _lane_np(kind, v, m):
    """A lane's (values, how) in numpy, for the JAX ``_reduce``."""
    if kind == "count":
        return m.astype(np.int64), "sum"
    if kind in ("fsum", "fmin", "fmax"):
        return (v.astype(np.float64) if kind == "fsum" else v), kind[1:]
    if kind in ("min", "max"):
        return v, kind
    w = v.astype(np.int64)
    return {"sum": w, "sum_hi32": w >> 32,
            "sum_lo32": w & 0xFFFFFFFF}[kind], "sum"


@pytest.mark.parametrize("dtype", LANE_DTYPES)
@pytest.mark.parametrize("G", LANE_GROUPS)
def test_lanes_plain_equals_per_lane_and_jax_reduce(G, dtype):
    """Every kind a source of ``dtype`` takes, on two masks (the
    selection and one that is not it), with sink rows and duplicate
    lanes: ``group_reduce_lanes`` (the plain version on the CPU) equals
    one ``group_reduce_plain`` a lane over the lane's transform and the
    JAX package's ``_reduce`` (its scatter branch), exactly for every
    integer kind and float min/max, float sums within FLOAT_RTOL."""
    rng = np.random.default_rng(G + len(dtype))
    v = _lane_source(dtype, G)
    sel = rng.random(N) < 0.8
    other = sel & (rng.random(N) < 0.6)
    g = None if G == 1 else rng.integers(0, G + 1, N).astype(
        np.int32 if G < 4096 else np.int64)
    tv, tg = torch.from_numpy(v), None if g is None else torch.from_numpy(g)
    masks = {"sel": torch.from_numpy(sel), "other": torch.from_numpy(other)}
    kinds = FLOAT_KINDS if dtype.startswith("float") else INT_KINDS
    lanes = [gr.Lane(k, None if k == "count" else tv, masks[mk])
             for mk in masks for k in kinds]
    lanes += lanes[:3]                              # duplicates
    got = gr.group_reduce_lanes(tg, G, lanes)
    assert len(got) == len(lanes)
    for i in range(3):
        assert got[-3 + i] is got[i]
    for ln, t in zip(lanes, got):
        vals, how = gr.lane_values(ln)
        assert torch.equal(t, gr.group_reduce_plain(vals, ln.mask, tg, G,
                                                    how)) \
            or (t.is_floating_point() and torch.allclose(
                t, gr.group_reduce_plain(vals, ln.mask, tg, G, how),
                equal_nan=True))
        m = ln.mask.numpy()
        jv, jhow = _lane_np(ln.kind, v, m)
        want = _jax_reduce(jv, m, g, G, jhow, "cpu").reshape(-1)
        assert t.numpy().dtype == np.asarray(want).dtype, ln.kind
        if ln.kind == "fsum":
            np.testing.assert_allclose(t.numpy(), want, rtol=FLOAT_RTOL,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(t.numpy(), want)


def test_count_of_the_selection_is_the_rows_lane():
    """A COUNT whose mask is the selection itself is the ``__rows__``
    lane: one table, the same object."""
    sel = torch.from_numpy(np.random.default_rng(1).random(N) < 0.5)
    g = torch.from_numpy(np.random.default_rng(2).integers(0, 13, N))
    v = torch.arange(N)
    rows, cnt, other = gr.group_reduce_lanes(g, 12, [
        gr.Lane("count", None, sel), gr.Lane("count", None, sel),
        gr.Lane("count", None, sel.clone())])
    assert cnt is rows and torch.equal(other, rows)
    assert len(gr.unique_lanes([gr.Lane("sum", v, sel),
                                gr.Lane("sum", v, sel),
                                gr.Lane("sum_hi32", v, sel),
                                gr.Lane("sum", v.clone(), sel)])) == 3


def _bad_lanes():
    v = torch.zeros(8, dtype=torch.int64)
    f = torch.zeros(8, dtype=torch.float32)
    m = torch.ones(8, dtype=torch.bool)
    g = torch.zeros(8, dtype=torch.int32)
    return {
        "no lanes": (g, 4, []),
        "kind": (g, 4, [gr.Lane("mean", v, m)]),
        "count with a source": (g, 4, [gr.Lane("count", v, m)]),
        "sum without a source": (g, 4, [gr.Lane("sum", None, m)]),
        "sum of floats": (g, 4, [gr.Lane("sum", f, m)]),
        "fsum of ints": (g, 4, [gr.Lane("fsum", v, m)]),
        "min of bools": (g, 4, [gr.Lane("min", m, m)]),
        "masks of two lengths": (g, 4, [gr.Lane("count", None, m),
                                        gr.Lane("count", None, m[:4])]),
        "mask int": (g, 4, [gr.Lane("sum", v, v)]),
        "gids int16": (g.to(torch.int16), 4, [gr.Lane("sum", v, m)]),
        "no gids, G > 1": (None, 4, [gr.Lane("sum", v, m)]),
    }


@pytest.mark.parametrize("case", sorted(_bad_lanes()))
def test_lanes_reject_bad_input(case):
    with pytest.raises((TypeError, ValueError)):
        gr.group_reduce_lanes(*_bad_lanes()[case])


def test_launch_sets_keep_the_kernel_limits():
    """Lanes past one launch's sources, masks, lanes or columns are cut
    into further sets, in order; the main path's sets fit one."""
    n = 16
    srcs = [torch.arange(n) + i for i in range(gr.MAX_SRCS + 2)]
    m = torch.ones(n, dtype=torch.bool)
    lanes = [gr.Lane(k, s, m) for s in srcs for k in ("sum_hi32",
                                                      "sum_lo32")]
    sets = gr._launch_sets(lanes)
    assert [ln for s in sets for ln in s] == lanes
    for s in sets:
        assert len({id(ln.src) for ln in s}) <= gr.MAX_SRCS
        assert sum(gr.lane_cols(ln.kind) for ln in s) <= gr.MAX_COLS
    assert len(sets) == 2
    # the widest set: every float kind of eight sources and a count on
    # eight masks, 32 lanes in 48 columns
    fs = [torch.zeros(n) + i for i in range(gr.MAX_SRCS)]
    fm = [m.clone() for _ in range(gr.MAX_MASKS)]
    fl = [gr.Lane(k, s, fm[0]) for s in fs for k in ("fsum", "fmin",
                                                     "fmax")]
    fl += [gr.Lane("count", None, mk) for mk in fm]
    assert sum(gr.lane_cols(ln.kind) for ln in fl) == gr.MAX_COLS
    fl.append(gr.Lane("count", None, m))
    assert [len(s) for s in gr._launch_sets(fl)] == [gr.MAX_LANES, 1]
    ms = [gr.Lane("count", None, m.clone()) for _ in range(9)]
    assert [len(s) for s in gr._launch_sets(ms)] == [8, 1]
    # one lane a (source, kind): the same kind of a source on a second
    # mask opens a second set
    two = [gr.Lane("sum", srcs[0], m), gr.Lane("min", srcs[0], m),
           gr.Lane("sum", srcs[0], m.clone())]
    assert [len(s) for s in gr._launch_sets(two)] == [2, 1]


@pytest.mark.parametrize("dtype,kind", [
    (d, k) for d in LANE_DTYPES
    for k in (FLOAT_KINDS if d.startswith("float") else INT_KINDS)])
def test_kernel_lane_transforms_on_the_host(lane_program, dtype, kind):
    """The kernel's widening of a source read at its stored width and
    each lane's transform (count, the int64 sum, its high and low limbs,
    min/max, and the float kinds over float32 and float64), reduced
    through its arithmetic on the host, equal the plain version: exactly
    for the integer kinds and float min/max, within rounding for fsum."""
    rng = np.random.default_rng(len(kind) * 7 + len(dtype))
    v = _lane_source(dtype, 3)
    m = rng.random(N) < 0.85
    g = rng.integers(0, 13, N)
    got = _lanes(lane_program, v, m, g, 12, kind)
    want = gr.group_reduce_lanes_plain(
        torch.from_numpy(g), 12,
        [gr.Lane(kind, None if kind == "count" else torch.from_numpy(v),
                 torch.from_numpy(m))])[0].numpy()
    if kind in ("min", "max") and dtype != "int64":
        info = np.iinfo(dtype)        # the wrapper's clamp, then narrow
        got = np.clip(got, info.min, info.max).astype(dtype)
    elif kind in ("fmin", "fmax"):
        got = got.astype(dtype)
    if kind == "fsum":
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL,
                                   equal_nan=True)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

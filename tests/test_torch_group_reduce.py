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
    assert [gr.table_mode(G) for G in (1, 12, 16, 17, 4096, 4097, 1 << 23)] \
        == ["registers"] * 3 + ["shared"] * 2 + ["global"] * 2


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
"""

_MAIN = r"""
template <class T> std::vector<T> load(const char* path, long long n) {
  std::vector<T> v(n);
  FILE* f = std::fopen(path, "rb");
  if (!f || std::fread(v.data(), sizeof(T), n, f) != (size_t)n) std::exit(3);
  std::fclose(f);
  return v;
}

// the kernel's reduction, one row at a time: integer lanes are exact,
// so any order of the rows gives these bits
template <int K> int run(long long n, long long G, char** p) {
  constexpr int L = Traits<K>::L, OP = Traits<K>::OP;
  auto raw = load<long long>(p[0], n);
  auto gid = load<long long>(p[1], n);
  auto mask = load<unsigned char>(p[2], n);
  std::vector<long long> table(L * G, neutral_of<OP>());
  std::vector<int> flags(G, 0);
  unsigned long long mx = 0;
  for (long long i = 0; i < n; ++i)          // fsum_maxabs_kernel
    if (mask[i] && gid[i] >= 0 && gid[i] < G && !bits_nonfinite(raw[i])) {
      const unsigned long long ab = (unsigned long long)(raw[i] & LLONG_MAX);
      if (ab > mx) mx = ab;
    }
  const int scale = K == F64_SUM ? fsum_scale(&mx) : 0;
  for (long long i = 0; i < n; ++i) {
    const long long g = gid[i];
    if (!mask[i] || g < 0 || g >= G) continue;
    long long ln[3];
    const int flag = row_lanes<K>(raw[i], scale, ln);
    if (flag) { flags[g] |= flag; continue; }
    for (int l = 0; l < L; ++l)
      table[l * G + g] = combine<OP>(table[l * G + g], ln[l]);
  }
  Args a{raw.data(), mask.data(), nullptr, 8, n, G, table.data(),
         flags.data(), &mx};
  FILE* f = std::fopen(p[3], "wb");
  for (long long g = 0; g < G; ++g) {
    if constexpr (K == F64_MIN || K == F64_MAX || K == F64_SUM) {
      const double x = finalize_slot<K>(a, g);
      std::fwrite(&x, 8, 1, f);
    } else {
      std::fwrite(&table[g], 8, 1, f);
    }
  }
  std::fclose(f);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const int kind = std::atoi(argv[1]);
  const long long G = std::atoll(argv[2]), n = std::atoll(argv[3]);
  char** p = argv + 4;
  switch (kind) {
    case I64_SUM: return run<I64_SUM>(n, G, p);
    case I64_MIN: return run<I64_MIN>(n, G, p);
    case I64_MAX: return run<I64_MAX>(n, G, p);
    case F64_MIN: return run<F64_MIN>(n, G, p);
    case F64_MAX: return run<F64_MAX>(n, G, p);
    case F64_SUM: return run<F64_SUM>(n, G, p);
  }
  return 2;
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


def _lanes(lane_program, vals, mask, gids, G, how):
    exe, d = lane_program
    kind = gr._KIND[("float" if vals.dtype.kind == "f" else "int", how)]
    n = len(vals)
    raw = np.ascontiguousarray(vals.astype(np.float64 if vals.dtype.kind
                                           == "f" else np.int64))
    raw.view(np.int64).tofile(d / "raw")
    (np.zeros(n, np.int64) if gids is None else gids.astype(np.int64)
     ).tofile(d / "gid")
    mask.astype(np.uint8).tofile(d / "mask")
    out = subprocess.run([str(exe), str(kind), str(G), str(n),
                          str(d / "raw"), str(d / "gid"), str(d / "mask"),
                          str(d / "out")], capture_output=True)
    assert out.returncode == 0, out
    return np.fromfile(d / "out",
                       np.float64 if vals.dtype.kind == "f" else np.int64)


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

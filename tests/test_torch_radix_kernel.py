"""The radix counting-sort kernels of the PyTorch port against the JAX
package's Pallas kernels.

On the CPU every wrapper of ``tidb_tpu_torch/copr/cuda/radix_kernel.py``
runs its plain PyTorch version; the JAX side runs its Pallas kernels in
interpret mode and its XLA lowering, as its own tests do.  The port's
kernels take the partition key and the pass's shift; with ``key = dig``
and ``shift = 0`` at ``tile=512`` their plain versions compute what the
Pallas kernels compute, and at the kernels' own tile (``KERNEL_TILE``)
they give the same stable permutation.  Everything is integer, so every
comparison is exact.  The CUDA kernels themselves are
held against the plain versions by tests/test_torch_cuda.py, which runs
only where a GPU is present.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tidb_tpu.copr import dag as JD
from tidb_tpu.copr import radix as jradix
from tidb_tpu.copr.pallas import radix_kernel as jrk
from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.copr import radix
from tidb_tpu_torch.copr.cuda import radix_kernel as rk


@pytest.fixture(autouse=True)
def _auto_pallas_mode():
    jradix.set_pallas_mode("auto")
    yield
    jradix.set_pallas_mode("auto")


def _digits(n, seed, skew=False):
    rng = np.random.default_rng(seed)
    if skew:        # a few hot digits: long runs within a tile
        return rng.choice([0, 7, 255], n).astype(np.int32)
    return rng.integers(0, 256, n).astype(np.int32)


def _jax_hist(dig):
    """The TPU histogram kernel itself, through Pallas interpret mode."""
    n = dig.shape[0]
    return np.asarray(pl.pallas_call(
        jrk._hist_kernel, grid=(n // jrk.TILE,),
        in_specs=[pl.BlockSpec((jrk.TILE,), lambda t: (t,))],
        out_specs=pl.BlockSpec((1, jrk.N_DIGITS), lambda t: (t, 0)),
        out_shape=jax.ShapeDtypeStruct((n // jrk.TILE, jrk.N_DIGITS),
                                       jnp.int32),
        interpret=True)(jnp.asarray(dig)))


def test_geometry_matches_jax():
    assert rk.TILE == jrk.TILE == D.RADIX_TILE == JD.RADIX_TILE
    assert rk.N_DIGITS == jrk.N_DIGITS
    ratio = rk.KERNEL_TILE // rk.TILE
    assert rk.KERNEL_TILE == ratio * rk.TILE and ratio & (ratio - 1) == 0
    for b in (1, 1024, 1 << 15, 1 << 22, 1 << 23):
        assert D.radix_key_bits(b) == JD.radix_key_bits(b)
        assert D.radix_passes(b) == JD.radix_passes(b)


def test_kernel_tile_is_the_sources_constant():
    """The .cu's KERNEL_TILE (checked against the built library at load)
    is the wrapper's."""
    src = rk._SRC.read_text()
    assert f"#define KERNEL_TILE {rk.KERNEL_TILE} " in src
    assert f"#define RADIX_TILE {rk.TILE} " in src


def _keys(dig, shift, seed):
    """int32 keys whose digit at ``shift`` is ``dig``, random bits below
    and above it (within [0, 2^31))."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 1 << shift, dig.shape[0]) if shift else 0
    high = rng.integers(0, 1 << max(23 - shift, 0), dig.shape[0])
    return ((high << (shift + 8)) | (dig.astype(np.int64) << shift)
            | low).astype(np.int32)


@pytest.mark.parametrize("n_tiles,skew", [(1, False), (8, False), (8, True)])
def test_hist_plain_equals_pallas_hist_kernel(n_tiles, skew):
    dig = _digits(n_tiles * rk.TILE, 3 + n_tiles, skew)
    want = _jax_hist(dig)
    got = rk.radix_hist_plain(torch.from_numpy(dig), 0, tile=rk.TILE)
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()
    for shift in (8, 16):          # the digit taken from a wider key
        key = torch.from_numpy(_keys(dig, shift, shift))
        assert (rk.radix_hist_plain(key, shift, tile=rk.TILE).numpy()
                == want).all()


@pytest.mark.parametrize("n", [1, 4095, 4097, 3 * 4096 + 17, 8191, 8193,
                               3 * 8192 + 17, 20_000])
def test_kernel_tile_hist_sums_512_tile_hist(n):
    """The histogram at KERNEL_TILE (the wrapper's, on the CPU) is the
    512-tile histogram summed over groups of KERNEL_TILE/512 tiles."""
    key = torch.from_numpy(_keys(_digits(n, n, skew=n % 2 == 0), 8, n))
    fine = rk.radix_hist_plain(key, 8, tile=rk.TILE)
    group = rk.KERNEL_TILE // rk.TILE
    pad = -fine.shape[0] % group
    fine = torch.cat([fine, fine.new_zeros((pad, rk.N_DIGITS))])
    want = fine.view(-1, group, rk.N_DIGITS).sum(1, dtype=torch.int32)
    got = rk.radix_hist(key, 8)
    assert got.shape == (rk.n_tiles(n), rk.N_DIGITS) == want.shape
    assert torch.equal(got, want)
    assert torch.equal(got, rk.radix_hist_plain(key, 8))


@pytest.mark.parametrize("n_tiles,skew", [(1, False), (6, False), (6, True)])
def test_counting_sort_pass_plain_equals_pallas(n_tiles, skew):
    """Port's plain pass == JAX counting_sort_pass(interpret=True), the
    key carried beside the values."""
    n = n_tiles * rk.TILE
    dig = _digits(n, 11 + n_tiles, skew)
    val = np.random.default_rng(n).permutation(n).astype(np.int32)
    want = np.asarray(jrk.counting_sort_pass(
        jnp.asarray(dig), jnp.asarray(val), interpret=True))
    key_out, got = rk.counting_sort_pass(torch.from_numpy(dig),
                                         torch.from_numpy(val), 0)
    perm = np.argsort(dig, kind="stable")
    assert (got.numpy() == want).all()
    assert (want == val[perm]).all()
    assert (key_out.numpy() == dig[perm]).all()


@pytest.mark.parametrize("n", [1, 511, 513, 5000, 4 * 512, 4097,
                               3 * 4096 + 17, 8193])
def test_hist_scatter_compose_to_plain_pass(n):
    """The two plain kernels chained through the exclusive offsets, at
    the kernel tile (the wrappers) and at the TPU tile, equal the 1-bit
    plain pass and a stable argsort, ragged last tile included."""
    dig = _digits(n, n)
    key = torch.from_numpy(dig)
    val = torch.arange(n, dtype=torch.int32)
    want = np.argsort(dig, kind="stable")
    hist = rk.radix_hist(key, 0)
    assert hist.shape == (rk.n_tiles(n), rk.N_DIGITS)
    assert int(hist.sum()) == n
    for k_out, v_out in (
            rk.radix_scatter(key, val, rk.exclusive_offsets(hist), 0),
            rk.radix_scatter_plain(key, val, rk.exclusive_offsets(
                rk.radix_hist_plain(key, 0, tile=rk.TILE)), 0,
                tile=rk.TILE),
            rk.counting_sort_pass(key, val, 0)):
        assert (v_out.numpy() == want).all()
        assert (k_out.numpy() == dig[want]).all()


def test_scatter_plain_equals_pallas_scatter_kernel():
    """Given the same offsets, the plain scatter at the TPU tile equals
    the TPU scatter kernel run in interpret mode."""
    n = 4 * rk.TILE
    dig = _digits(n, 21, skew=True)
    val = np.random.default_rng(2).integers(-9, 9, n).astype(np.int32)
    offs = rk.exclusive_offsets(rk.radix_hist_plain(
        torch.from_numpy(dig), 0, tile=rk.TILE))
    want = np.asarray(pl.pallas_call(
        jrk._scatter_kernel, grid=(n // jrk.TILE,),
        in_specs=[pl.BlockSpec((jrk.TILE,), lambda t: (t,)),
                  pl.BlockSpec((jrk.TILE,), lambda t: (t,)),
                  pl.BlockSpec((1, jrk.N_DIGITS), lambda t: (t, 0))],
        out_specs=pl.BlockSpec((n,), lambda t: (0,)),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.int32),
        interpret=True)(jnp.asarray(dig), jnp.asarray(val),
                        jnp.asarray(offs.numpy())))
    key_out, got = rk.radix_scatter_plain(
        torch.from_numpy(dig), torch.from_numpy(val), offs, 0, tile=rk.TILE)
    assert (got.numpy() == want).all()
    assert (key_out.numpy() == np.sort(dig, kind="stable")).all()


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
def test_key_carrying_pass(shift):
    """Every lowering of one pass at every shift returns the stable
    permutation of the pass's digit and carries the key with it:
    ``key_out == key[perm]``."""
    n = 3 * rk.KERNEL_TILE + 17
    rng = np.random.default_rng(shift)
    key_np = rng.integers(0, 1 << 31, n).astype(np.int32)
    key_np[rng.random(n) < 0.285] = 1 << 30       # the dead rows' tail key
    key = torch.from_numpy(key_np)
    val = torch.from_numpy(rng.permutation(n).astype(np.int32))
    perm = np.argsort((key_np >> shift) & 255, kind="stable")
    outs = {
        "pass": rk.counting_sort_pass(key, val, shift),
        "plain pass": rk.counting_sort_pass_plain(key, val, shift),
        "kernel tile": rk.radix_scatter(
            key, val, rk.exclusive_offsets(rk.radix_hist(key, shift)),
            shift),
        "tpu tile": rk.radix_scatter_plain(
            key, val, rk.exclusive_offsets(
                rk.radix_hist_plain(key, shift, tile=rk.TILE)),
            shift, tile=rk.TILE),
    }
    for name, (k_out, v_out) in outs.items():
        assert (v_out.numpy() == val.numpy()[perm]).all(), name
        assert (k_out.numpy() == key_np[perm]).all(), name


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("num_buckets", [1024, 1 << 15, 1 << 23])
def test_scatter_permutation_equals_jax(num_buckets, mode):
    """Port scatter_permutation (plain path) and its kernel path (run
    here through the plain pass) equal JAX's under the Pallas gate (on:
    interpret mode) and the XLA lowering (off), and the stable argsort of
    the partition key; dead rows and a ragged n included."""
    rng = np.random.default_rng(num_buckets % 997)
    n = 3000
    h = rng.integers(0, 1 << 63, n, dtype=np.uint64) \
        | (rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(63))
    sel = rng.random(n) < 0.9
    jradix.set_pallas_mode(mode)
    want = np.asarray(jradix.scatter_permutation(
        jnp.asarray(h, dtype=jnp.uint64), jnp.asarray(sel), num_buckets, n,
        "cpu"))
    th = torch.from_numpy(h.view(np.int64))
    tsel = torch.from_numpy(sel)
    got = radix.scatter_permutation(th, tsel, num_buckets, n)
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()
    key = radix.partition_key(th, tsel, num_buckets)
    bits = D.radix_key_bits(num_buckets)
    via_kernel_path = radix._partition_kernel(key, bits, n)
    assert (via_kernel_path.numpy() == want).all()
    key_bits = bits - 1
    keys = (h >> np.uint64(64 - key_bits)).astype(np.int64)
    keys[~sel] = 1 << key_bits
    assert (key.numpy() == keys).all()
    assert (want == np.argsort(keys, kind="stable")).all()


def _tiled_pass(key, val, shift, err=None):
    """One pass as the CUDA kernels compute it, through their plain
    versions at KERNEL_TILE."""
    hist = rk.radix_hist_plain(key, shift)
    return rk.radix_scatter_plain(key, val, rk.exclusive_offsets(hist),
                                  shift)


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("num_buckets", [1024, 1 << 23])
def test_kernel_path_through_tiled_kernels_equals_jax(num_buckets, mode,
                                                      monkeypatch):
    """The kernel path's key-carrying passes, each the hist + offsets +
    scatter chain at KERNEL_TILE (the CUDA kernels' arithmetic), give
    JAX's permutation."""
    rng = np.random.default_rng(7)
    n = 2 * rk.KERNEL_TILE + 300
    h = rng.integers(0, 1 << 63, n, dtype=np.uint64) << np.uint64(1)
    sel = rng.random(n) < 0.715
    jradix.set_pallas_mode(mode)
    want = np.asarray(jradix.scatter_permutation(
        jnp.asarray(h, dtype=jnp.uint64), jnp.asarray(sel), num_buckets, n,
        "cpu"))
    monkeypatch.setattr(rk, "counting_sort_pass", _tiled_pass)
    key = radix.partition_key(torch.from_numpy(h.view(np.int64)),
                              torch.from_numpy(sel), num_buckets)
    got = radix._partition_kernel(key, D.radix_key_bits(num_buckets), n)
    assert (got.numpy() == want).all()


def _bad_inputs():
    d = torch.zeros(4096, dtype=torch.int32)
    off = torch.zeros((1, 256), dtype=torch.int32)
    return {
        # int64 keys are taken (the sort's instantiation); their values
        # are int32 all the same
        "int64 digits": (rk.radix_scatter, (d.to(torch.int64),
                                            d.to(torch.int64), off, 0),
                         TypeError),
        "2-d digits": (rk.radix_hist, (d.view(8, 512), 0), ValueError),
        "strided digits": (rk.radix_hist, (d[::2], 0), ValueError),
        "meta device": (rk.radix_hist, (d.to("meta"), 0), ValueError),
        "not a tensor": (rk.radix_hist, (d.numpy(), 0), TypeError),
        "negative key": (rk.radix_scatter, (d - 5, d, off, 0), ValueError),
        "negative digit": (rk.counting_sort_pass, (d - 1, d, 0), ValueError),
        "short values": (rk.counting_sort_pass, (d, d[:10], 0), ValueError),
        "int64 values": (rk.radix_scatter,
                         (d, d.to(torch.int64), off, 0), TypeError),
        "offsets shape": (rk.radix_scatter, (d, d, off[:0], 0), ValueError),
        "offsets past n": (rk.radix_scatter, (d, d, off + 4096, 0),
                           ValueError),
        "shift 32": (rk.radix_hist, (d, 32), ValueError),
        "negative shift": (rk.counting_sort_pass, (d, d, -8), ValueError),
        "float shift": (rk.radix_scatter, (d, d, off, 8.0), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrappers_reject_bad_input(case):
    fn, args, err = _bad_inputs()[case]
    with pytest.raises(err):
        fn(*args)


def test_plain_path_launches_no_kernel():
    before = dict(rk.LAUNCHES)
    d = torch.from_numpy(_digits(2000, 5))
    rk.counting_sort_pass(d, torch.arange(2000, dtype=torch.int32), 0)
    rk.radix_scatter(d, d, rk.exclusive_offsets(rk.radix_hist(d, 0)), 0)
    assert rk.LAUNCHES == before

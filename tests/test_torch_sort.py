"""The port's stable multi-key sort and its int64 counting-sort pass
against the JAX package's ``lax.sort`` and numpy.

``tidb_tpu_torch.ops.sort.stable_argsort`` replaces the stable
``lax.sort(..., num_keys=k)`` of the SORT and SEGMENT group-bys and of
TopN.  Here, on the CPU, every pass runs the plain versions of the
counting-sort kernels (``copr/cuda/radix_kernel.py``), at the kernels'
own tile where the test says so; the kernels themselves are held
against those plain versions by tests/test_torch_cuda.py on a GPU.
Everything is integer, so every comparison is exact, ties included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tidb_tpu.ops import sortkeys as jsk
from tidb_tpu_torch.copr.cuda import radix_kernel as rk
from tidb_tpu_torch.ops import sort as S
from tidb_tpu_torch.ops import sortkeys as sk

I64_MIN, I64_MAX = -(2 ** 63), 2 ** 63 - 1


def _lax_perm(keys):
    n = len(keys[0])
    out = lax.sort(tuple(jnp.asarray(k) for k in keys)
                   + (jnp.arange(n, dtype=jnp.int64),),
                   num_keys=len(keys))
    return np.asarray(out[-1])


def _case(name, n, seed):
    """(keys in priority order) of each named case, numpy int32/int64."""
    rng = np.random.default_rng(seed)

    def i64(lo, hi):
        return rng.integers(lo, hi, n, dtype=np.int64)
    flag = rng.integers(0, 2, n).astype(np.int32)
    if name == "one uniform key":
        return [i64(I64_MIN, I64_MAX)]
    if name == "many ties":
        return [i64(-3, 3), i64(0, 2)]
    if name == "extremes":
        k = rng.choice(np.array([I64_MIN, I64_MIN + 1, -1, 0, 1,
                                 I64_MAX - 1, I64_MAX]), n)
        return [k, i64(-5, 5)]
    if name == "negative keys":
        return [i64(-(1 << 40), 0), i64(-(1 << 20), 1 << 20)]
    if name == "DESC key":
        return [~i64(0, 1 << 23), i64(0, 1 << 23)]
    if name == "0/1 flags":
        return [flag, (1 - flag).astype(np.int32), i64(0, 1000)]
    if name == "constant keys":
        return [np.zeros(n, np.int32), np.full(n, 0x2A5A5A5A5A5A5A5A),
                np.full(n, -7), i64(0, 3)]
    if name == "all constant":
        return [np.ones(n, np.int32), np.full(n, I64_MIN)]
    if name == "TopN keys":
        # dead flag, then (null flag, ~price) and (null flag, orderkey)
        price = i64(90_000, 10_500_000)
        return [flag, np.zeros(n, np.int32), ~price, np.zeros(n, np.int32),
                i64(1, 6_000_000)]
    if name == "SORT keys":
        nulls = (rng.random(n) < 0.1).astype(np.int32)
        code = np.where(nulls == 1, 0, i64(-100, 100))
        return [flag, nulls, code]
    raise KeyError(name)


CASES = ["one uniform key", "many ties", "extremes", "negative keys",
         "DESC key", "0/1 flags", "constant keys", "all constant",
         "TopN keys", "SORT keys"]


@pytest.mark.parametrize("n", [1, 257, rk.KERNEL_TILE + 1,
                               3 * rk.KERNEL_TILE + 17])
@pytest.mark.parametrize("case", CASES)
def test_stable_argsort_equals_lax_sort(case, n):
    keys = _case(case, n, n + len(case))
    want = _lax_perm(keys)
    assert (want == np.lexsort(tuple(keys[::-1]))).all()
    got = S.stable_argsort([torch.from_numpy(k) for k in keys])
    assert got.dtype == torch.int64
    assert (got.numpy() == want).all()


def test_passes_skip_constant_digits():
    """A key's passes stop at the highest bit in which its min and max
    differ, in unsigned order after the sign flip."""
    assert S.key_passes(5, 5) == 0
    assert S.key_passes(0, 1) == 1
    assert S.key_passes(0, 255) == 1
    assert S.key_passes(0, 256) == 2
    assert S.key_passes(1, (1 << 23) - 1) == 3        # l_orderkey at SF=1
    assert S.key_passes(-1, 0) == 8                   # the sign bit differs
    assert S.key_passes(I64_MIN, I64_MAX) == 8
    assert S.key_passes(~10_500_000, ~90_000) == 3    # a DESC price
    rng = np.random.default_rng(3)
    keys = [torch.from_numpy(k) for k in _case("TopN keys", 5000, 1)]
    before = S.PASSES["stable_argsort"]
    S.stable_argsort(keys)
    # dead flag 1, price 3, orderkey 3; the zero null flags none
    assert S.PASSES["stable_argsort"] - before == 7
    assert S.plan_passes(keys) == [1, 0, 3, 0, 3]
    before = S.PASSES["stable_argsort"]
    perm = S.stable_argsort([torch.from_numpy(
        rng.integers(0, 9, 100)).fill_(4)])
    assert S.PASSES["stable_argsort"] == before
    assert (perm.numpy() == np.arange(100)).all()


def test_stable_argsort_rejects_bad_keys():
    k = torch.arange(10)
    with pytest.raises(ValueError):
        S.stable_argsort([])
    with pytest.raises(ValueError):
        S.stable_argsort([k, k[:5]])
    with pytest.raises(TypeError):
        S.stable_argsort([k.to(torch.float64)])
    with pytest.raises(ValueError):
        S.stable_argsort([k.view(2, 5)])


def _np_counting_pass(key, val, shift):
    """A numpy stable counting sort on the digit of int64 ``key`` at
    ``shift`` in unsigned order."""
    d = ((key.view(np.uint64) ^ np.uint64(1 << 63)) >> np.uint64(shift)) \
        & np.uint64(255)
    counts = np.bincount(d.astype(np.int64), minlength=256)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.empty(len(key), np.int64)
    seen = np.zeros(256, np.int64)
    for i, di in enumerate(d.astype(np.int64)):
        pos[i] = start[di] + seen[di]
        seen[di] += 1
    k_out = np.empty_like(key)
    v_out = np.empty_like(val)
    k_out[pos] = key
    v_out[pos] = val
    return k_out, v_out


@pytest.mark.parametrize("shift", [0, 8, 24, 48, 56])
@pytest.mark.parametrize("n", [1, 4095, 8193, 3 * 8192 + 17])
def test_int64_pass_plain_equals_numpy_counting_sort(n, shift):
    """Every lowering of one int64 pass (the 1-bit plain pass, the
    wrapper on the CPU, and the histogram and scatter chained at the
    kernels' tile and at the TPU tile) equals a numpy stable
    counting sort, and carries the key with it."""
    rng = np.random.default_rng(n + shift)
    key_np = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)
    key_np[rng.random(n) < 0.2] = I64_MAX           # SEGMENT's dead rows
    key_np[rng.random(n) < 0.1] = I64_MIN
    val_np = rng.permutation(n).astype(np.int32)
    want_k, want_v = _np_counting_pass(key_np, val_np, shift)
    key, val = torch.from_numpy(key_np), torch.from_numpy(val_np)
    hist = rk.radix_hist(key, shift)
    assert hist.shape == (rk.n_tiles(n), rk.N_DIGITS)
    outs = {
        "plain pass": rk.counting_sort_pass_plain(key, val, shift),
        "wrapper": rk.counting_sort_pass(key, val, shift),
        "kernel tile": rk.radix_scatter(key, val, rk.exclusive_offsets(
            hist), shift),
        "tpu tile": rk.radix_scatter_plain(key, val, rk.exclusive_offsets(
            rk.radix_hist_plain(key, shift, tile=rk.TILE)), shift,
            tile=rk.TILE),
    }
    for name, (k_out, v_out) in outs.items():
        assert k_out.dtype == torch.int64 and v_out.dtype == torch.int32
        assert (k_out.numpy() == want_k).all(), name
        assert (v_out.numpy() == want_v).all(), name


def test_int64_digits_are_signed_order():
    """The top digit of an int64 key flips the sign bit, so unsigned
    digit order is signed key order."""
    k = torch.tensor([I64_MIN, -1, 0, 1, I64_MAX])
    assert rk.digits_plain(k, 56).tolist() == [0, 127, 128, 128, 255]
    assert rk.digits_plain(k, 0).tolist() == [0, 255, 0, 1, 255]


def test_int64_wrappers_check_shift_and_values():
    k = torch.zeros(10, dtype=torch.int64)
    v = torch.zeros(10, dtype=torch.int32)
    rk.counting_sort_pass(k, v, 56)
    with pytest.raises(ValueError):
        rk.counting_sort_pass(k, v, 64)
    with pytest.raises(TypeError):
        rk.counting_sort_pass(k, v.to(torch.int64), 0)
    # a negative int64 key is a key like any other
    rk.radix_hist(k - 5, 0)


def _floats():
    return np.array([np.nan, -np.nan, -np.inf, -1e300, -1.5, -0.0, 0.0,
                     5e-324, 1.5, 1e300, np.inf, 3.0, -3.0])


def test_float_sortable_equals_jax():
    f = _floats()
    want = np.asarray(jsk.float_sortable(jnp.asarray(f)))
    got = sk.float_sortable(torch.from_numpy(f)).numpy()
    assert (got == want).all()
    order = np.argsort(got, kind="stable")
    assert np.isnan(f[order[0]]) and np.signbit(f[order[0]])
    assert np.isnan(f[order[-1]]) and not np.signbit(f[order[-1]])
    fin = f[order][1:-1]
    assert (np.diff(fin) >= 0).all()
    f32 = np.where(np.abs(f) > 1e30, np.copysign(np.inf, f), f).astype(
        np.float32)
    assert (sk.sortable_int64(torch.from_numpy(f32), True).numpy()
            == np.asarray(jsk.sortable_int64(jnp, jnp.asarray(f32),
                                             True))).all()


def test_unsigned_sortable_equals_jax():
    u = np.array([0, 1, 2 ** 62, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 5,
                  2 ** 64 - 1], dtype=np.uint64)
    want = np.asarray(jsk.sortable_int64(jnp, jnp.asarray(u), False, True))
    got = sk.sortable_int64(torch.from_numpy(u), False, True).numpy()
    assert got.dtype == np.int64
    assert (got == want).all()
    assert (np.diff(got) > 0).all()

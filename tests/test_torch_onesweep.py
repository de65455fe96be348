"""The onesweep sort's plain versions against the per-pass counting sort
and the JAX package's ``lax.sort``.

``tidb_tpu_torch/copr/cuda/onesweep.py`` sorts one int64 key with one
histogram of all its digits and one look-back pass a digit; on the CPU
its wrappers run the plain versions held here against
``radix_kernel.py``'s plain per-pass histogram, offsets and counting
sort (the reference of the per-pass kernels), and ``stable_argsort`` on the
CPU, which goes through them, against ``lax.sort(..., num_keys=k)``.
The kernels themselves are held against these plain versions by
tests/test_torch_cuda.py on a GPU.  Everything is integer, so every
comparison is exact, ties included.
"""

import numpy as np
import pytest
import torch

from test_torch_sort import CASES, _case, _lax_perm
from tidb_tpu_torch.copr.cuda import onesweep as os1
from tidb_tpu_torch.copr.cuda import radix_kernel as rk
from tidb_tpu_torch.ops import sort as S

I64_MIN, I64_MAX = -(2 ** 63), 2 ** 63 - 1
TILE = os1.KERNEL_TILE
SIZES = [0, 1, TILE - 1, TILE + 1, 3 * TILE + 5]
DISTS = ["uniform", "skew", "extremes"]


def _key(n, dist, seed):
    """int64 keys: uniform over 64 bits; 28.5% of the rows on one key
    (INT64_MAX, SEGMENT's dead rows); or INT64_MIN, INT64_MAX and
    negative keys."""
    rng = np.random.default_rng(seed)
    k = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)
    if dist == "skew":
        k[rng.random(n) < 0.285] = I64_MAX
    elif dist == "extremes":
        k = rng.choice(np.array([I64_MIN, I64_MIN + 1, -(1 << 40), -1, 0,
                                 I64_MAX], dtype=np.int64), n)
    return torch.from_numpy(k)


def _val(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).permutation(n)
                            .astype(np.int32))


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("n", SIZES)
def test_hist_all_equals_per_pass_histograms(n, dist):
    key = _key(n, dist, n + 1)
    hist = os1.radix_hist_all64_plain(key, 8)
    assert hist.shape == (8, 256) and hist.dtype == torch.int32
    for p in range(8):
        want = rk.radix_hist_plain(key, 8 * p).sum(0, dtype=torch.int32)
        assert torch.equal(hist[p], want), p
    assert torch.equal(os1.radix_hist_all64(key, 3), hist[:3])
    assert os1.radix_hist_all64(key, 0).shape == (0, 256)


@pytest.mark.parametrize("shift", [0, 24, 56])
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("n", SIZES)
def test_offsets_equal_exclusive_offsets(n, dist, shift):
    """The digit base plus the look-back's prefix over earlier tiles is
    the per-(tile, digit) offset of the digit-major exclusive cumsum."""
    key = _key(n, dist, n + 2)
    tiles = rk.radix_hist_plain(key, shift)
    hist_p = tiles.sum(0, dtype=torch.int32)
    got = os1.onesweep_offsets_plain(tiles, hist_p)
    assert got.dtype == torch.int64
    assert torch.equal(got, rk.exclusive_offsets(tiles).to(torch.int64))


@pytest.mark.parametrize("shift", [0, 8, 48, 56])
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("n", SIZES)
def test_pass_equals_counting_sort_pass(n, dist, shift):
    """Key and value equal the per-pass counting sort; without the key
    store, the values alone; at the kernel's tile and at the TPU's."""
    key, val = _key(n, dist, n + 3), _val(n, n)
    hist_p = os1.radix_hist_all64_plain(key, 8)[shift // 8]
    want_k, want_v = rk.counting_sort_pass_plain(key, val, shift)
    for tile in (TILE, rk.TILE):
        k, v = os1.radix_onesweep64_plain(key, val, hist_p, shift,
                                          tile=tile)
        assert torch.equal(k, want_k) and torch.equal(v, want_v), tile
    k, v = os1.radix_onesweep64(key, val, hist_p, shift, store_key=False)
    assert k is None and torch.equal(v, want_v)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("n", [1, TILE + 1, 3 * TILE + 5])
def test_onesweep_sort_equals_chained_passes(n, dist):
    """One key's passes through ``onesweep_sort`` (the CPU path of
    ``stable_argsort``) equal the plain per-pass sort chained, for every
    number of passes."""
    key, val = _key(n, dist, n + 4), _val(n, n + 1)
    k, v = key, val
    for passes in range(1, 9):
        k, v = rk.counting_sort_pass_plain(k, v, 8 * (passes - 1))
        assert torch.equal(os1.onesweep_sort(key, val, passes), v), passes
    assert torch.equal(os1.onesweep_sort(key, val, 0), val)
    assert torch.equal(os1.onesweep_sort(key, None, 1, wide=True),
                       os1.onesweep_sort(key, torch.arange(
                           n, dtype=torch.int32), 1).to(torch.int64))


@pytest.mark.parametrize("n", [TILE - 1, 3 * TILE + 5])
@pytest.mark.parametrize("case", CASES)
def test_stable_argsort_equals_lax_sort_at_kernel_tiles(case, n):
    """``stable_argsort`` on the CPU (each key one onesweep plain sort)
    equals ``lax.sort`` with ``num_keys``, ties included, over ragged
    kernel tiles; it sorted each key that has passes once."""
    keys = _case(case, n, n + len(case))
    want = _lax_perm(keys)
    before = dict(S.PASSES)
    got = S.stable_argsort([torch.from_numpy(k) for k in keys])
    assert (got.numpy() == want).all()
    plan = S.plan_passes([torch.from_numpy(k) for k in keys])
    assert S.PASSES["stable_argsort"] - before["stable_argsort"] == sum(plan)
    assert S.PASSES["stable_argsort_keys"] \
        - before["stable_argsort_keys"] == sum(1 for p in plan if p)


def test_plain_pass_reports_positions_outside_n():
    n = 3 * TILE + 5
    key, val = _key(n, "uniform", 9), _val(n, 9)
    hist_p = os1.radix_hist_all64_plain(key, 1)[0].clone()
    hist_p[0] += 1                       # every later digit's base + 1
    with pytest.raises(ValueError, match="outside"):
        os1.radix_onesweep64(key, val, hist_p, 0)


def test_wrappers_check_their_arguments():
    key = torch.zeros(10, dtype=torch.int64)
    val = torch.zeros(10, dtype=torch.int32)
    hist_p = torch.zeros(256, dtype=torch.int32)
    hist_p[128] = 10
    os1.radix_onesweep64(key, val, hist_p, 0)
    with pytest.raises(ValueError):
        os1.radix_onesweep64(key, val, hist_p, 4)       # not a digit shift
    with pytest.raises(ValueError):
        os1.radix_onesweep64(key, val, hist_p, 64)
    with pytest.raises(ValueError):
        os1.radix_onesweep64(key, val, hist_p[:255], 0)
    with pytest.raises(TypeError):
        os1.radix_onesweep64(key.to(torch.int32), val, hist_p, 0)
    with pytest.raises(TypeError):
        os1.radix_onesweep64(key, val.to(torch.int64), hist_p, 0)
    with pytest.raises(ValueError):
        os1.radix_hist_all64(key, 9)
    with pytest.raises(ValueError):
        os1.onesweep_sort(key, val, -1)

"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

Every test here needs a CUDA GPU and skips without one.  The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.copr import dag as D
from tidb_tpu_torch.copr import radix
from tidb_tpu_torch.copr.aggregate import GroupKeyMeta
from tidb_tpu_torch.copr.cuda import radix_kernel as rk
from tidb_tpu_torch.expr.ir import ColumnRef
from tidb_tpu_torch.parallel.spmd import ShardedCopProgram
from tidb_tpu_torch.store import CopClient, snapshot_from_numpy
from tidb_tpu_torch.types import dtypes as dt

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _digits(n, seed, dev, hot=False):
    rng = np.random.default_rng(seed)
    d = rng.choice([0, 7, 255], n) if hot else rng.integers(0, 256, n)
    return torch.from_numpy(d.astype(np.int32)).to(dev)


def _assert_kernels_equal_plain(key, val, shift):
    """Each kernel, and the pass through both, equals its plain version
    exactly, and each wrapper launched its kernel."""
    before = dict(rk.LAUNCHES)
    hist = rk.radix_hist(key, shift)
    assert torch.equal(hist, rk.radix_hist_plain(key, shift))
    offs = rk.exclusive_offsets(hist)
    got = rk.radix_scatter(key, val, offs, shift)
    want = rk.radix_scatter_plain(key, val, offs, shift)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    full = rk.counting_sort_pass(key, val, shift)
    plain = rk.counting_sort_pass_plain(key, val, shift)
    assert torch.equal(full[0], plain[0]) and torch.equal(full[1], plain[1])
    assert torch.equal(full[1], got[1])
    assert rk.LAUNCHES["radix_hist"] == before["radix_hist"] + 2
    assert rk.LAUNCHES["radix_scatter"] == before["radix_scatter"] + 2


@pytest.mark.parametrize("n,hot", [(1, False), (511, False),
                                   (70_123, False), (70_123, True),
                                   (1 << 20, False)])
def test_kernels_equal_plain_versions(dev, n, hot):
    dig = _digits(n, n, dev, hot)
    val = torch.arange(n, dtype=torch.int32, device=dev)
    _assert_kernels_equal_plain(dig, val, 0)
    full = rk.counting_sort_pass(dig, val, 0)
    cpu = rk.counting_sort_pass(dig.cpu(), val.cpu(), 0)
    assert torch.equal(full[1].cpu(), cpu[1])


def _keys(n, seed, dist, dev):
    """int32 partition keys in [0, 2^31): uniform, one value for every
    row (one digit at every shift), or the main path's skew (28.5% of
    the rows on the dead rows' tail key 2^30, as query A at SF=1)."""
    rng = np.random.default_rng(seed)
    if dist == "one digit":
        k = np.full(n, 0x2A5A5A5A, np.int64)
    else:
        k = rng.integers(0, 1 << 31 if dist == "uniform" else 1 << 30, n)
        if dist == "tail skew":
            k[rng.random(n) < 0.285] = 1 << 30
    return torch.from_numpy(k.astype(np.int32)).to(dev)


@pytest.mark.parametrize("dist", ["uniform", "one digit", "tail skew"])
@pytest.mark.parametrize("shift", [0, 8, 16, 24])
@pytest.mark.parametrize("n", [1, 4095, 4097, 3 * 4096 + 17, 8191, 8193,
                               3 * 8192 + 17, 8_388_608])
def test_kernels_equal_plain_at_kernel_tiles(dev, n, shift, dist):
    """Ragged and whole kernel tiles, the main path's row count, every
    shift, and the digit skews of the main path."""
    key = _keys(n, n + shift, dist, dev)
    val = torch.randperm(n, device=dev).to(torch.int32)
    _assert_kernels_equal_plain(key, val, shift)


def test_unaligned_tensors_take_the_scalar_loads(dev):
    """A view 4 bytes into its storage is not 16-byte aligned: the
    kernels fall back to scalar loads and stay exact."""
    n = 3 * 4096 + 5
    store = _keys(n + 1, 3, "uniform", dev)
    key = store[1:]
    val = torch.arange(n + 1, dtype=torch.int32, device=dev)[1:]
    assert key.data_ptr() % 16 and val.data_ptr() % 16
    _assert_kernels_equal_plain(key, val, 8)


def test_kernels_report_bad_input(dev):
    dig = _digits(4096, 1, dev)
    val = torch.arange(4096, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="key outside"):
        rk.radix_hist(dig - 1, 0)
    with pytest.raises(ValueError, match="key outside"):
        rk.counting_sort_pass(dig - 1, val, 0)
    offs = rk.exclusive_offsets(rk.radix_hist(dig, 0))
    with pytest.raises(ValueError, match="offsets"):
        rk.radix_scatter(dig, val, offs + 4096, 0)
    with pytest.raises(ValueError):
        rk.radix_scatter(dig, val.cpu(), offs, 0)


def test_partition_reads_one_error_flag(dev, monkeypatch):
    """The partition's passes share one device flag, read once after the
    last pass; a bad key raises there."""
    reads = []
    real = rk.read_err

    def counted(err, name):
        reads.append(name)
        real(err, name)
    monkeypatch.setattr(rk, "read_err", counted)
    n = 100_000
    key = _keys(n, 9, "tail skew", dev)
    got = radix._partition_kernel(key, 31, n)
    assert reads == ["scatter_permutation"]
    want = radix._partition_plain(key.cpu(), 31, n)
    assert torch.equal(got.cpu(), want)
    key[n // 2] = -1
    with pytest.raises(ValueError, match="key outside"):
        radix._partition_kernel(key, 31, n)


def test_client_on_gpu_equals_plain_path(dev):
    """Per-device states and the merged result of a SCATTER aggregation
    on the GPU equal the plain CPU path's, NULL keys included."""
    rng = np.random.default_rng(4)
    n = 50_000
    a = rng.integers(-3000, 3000, n)
    av = rng.random(n) < 0.9
    v = rng.integers(-10 ** 6, 10 ** 6, n)
    snap = snapshot_from_numpy(["a", "v"], [
        {"kind": "INT64", "data": a, "validity": av},
        {"kind": "DECIMAL", "prec": 15, "scale": 2, "nullable": False,
         "data": v}])
    dec = dt.decimal(15, 2, False)
    agg = D.Aggregation(
        D.TableScan((0, 1), (dt.bigint(), dec)), (ColumnRef(dt.bigint(), 0),),
        (D.AggDesc(D.AggFunc.SUM, ColumnRef(dec, 1), dt.decimal(37, 2)),
         D.AggDesc(D.AggFunc.MIN, ColumnRef(dec, 1), dec),
         D.AggDesc(D.AggFunc.COUNT, None, dt.bigint(False))),
        D.GroupStrategy.SCATTER, num_buckets=1 << 13)
    got = {}
    for d in (dev, torch.device("cpu")):
        cols, counts = snap.device_cols((d,))
        got[d.type] = ShardedCopProgram(agg, (d,))(cols, counts)
    for k, v_ in got["cpu"].items():
        w = v_ if isinstance(v_, dict) else {"": v_}
        g = got["cuda"][k] if isinstance(v_, dict) else {"": got["cuda"][k]}
        for f in w:
            assert torch.equal(g[f].cpu(), w[f]), (k, f)
    meta = [GroupKeyMeta(dt.bigint(), 0)]
    r_gpu = CopClient("cuda").execute_agg(agg, snap, meta)
    r_cpu = CopClient("cpu").execute_agg(agg, snap, meta)
    for x, y in zip(r_gpu.key_columns + r_gpu.columns,
                    r_cpu.key_columns + r_cpu.columns):
        assert (x.data == y.data).all() and (x.validity == y.validity).all()

"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

The radix counting-sort kernels (int32 and int64 keys), the onesweep
kernels (``radix_hist_all64``, ``radix_onesweep64``) and
``stable_argsort`` equal their plain versions bit for bit, the onesweep
pass equals the int64 ``counting_sort_pass`` too, and the
slice-4 statements (SORT, SEGMENT, TopN, Limit, filtered rows) through
``CopClient(device="cuda")`` equal the plain CPU path;
``group_reduce`` and its lane sets (``group_reduce_lanes``) equal their
plain versions (computed on the CPU, whose scatter propagates NaN as the
JAX package's does) exactly for integers and float min/max, and within
``FSUM_RTOL`` of the slot's sum of |v| for float sums, which must come
back as the same bits on every launch; an aggregation's state table is
one launch a program run; the join statements (broadcast, m:n,
repartition, host joins) through a ``Session`` on the card on one and
on eight logical devices return the CPU session's rows and take no
host fallback, and the exchange receives what it receives on the CPU.
Every lane of the device evaluator (tests/torch_lane_cases.py) equals
the CPU bit for bit on the card, doubles included; rollup's states (the
DENSE level-by-level branch and the SORT one over the materialized
expand), the 22 TPC-H statements and the window statements (8 logical
devices) equal the CPU's; the ANALYZE kernel equals its plain version
in every output.  The scheduler's batched and fused programs equal the
CPU's (and the solo runs'), a batched aggregation launching one
``group_reduce`` launch set a logical device for all its slots, and
statements submitted from threads on side streams at once return the
CPU's rows.  EXPLAIN ANALYZE and the JSON functions on the card return
the CPU's operators, row counts and rows, and a traced launch carries
its device time from CUDA events.

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
from tidb_tpu_torch.copr.cuda import group_reduce as gr
from tidb_tpu_torch.copr.cuda import onesweep as os1
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


@pytest.fixture(scope="module")
def card():
    """The module-scoped fixtures' device: they run before ``dev``."""
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


# ------------------------------------------------------------------ #
# the int64 instantiation and stable_argsort
# ------------------------------------------------------------------ #

I64_MIN, I64_MAX = -(2 ** 63), 2 ** 63 - 1


def _keys64(n, seed, dist, dev):
    """int64 sort keys: uniform over all 64 bits, one value for every
    row, 23-bit non-negative (an orderkey), or SEGMENT's hashes with
    28.5% of the rows parked at INT64_MAX."""
    rng = np.random.default_rng(seed)
    if dist == "one value":
        k = np.full(n, -0x2A5A5A5A5A5A5A5A, np.int64)
    elif dist == "23-bit":
        k = rng.integers(0, 1 << 23, n, dtype=np.int64)
    else:
        k = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)
        if dist == "dead rows":
            k[rng.random(n) < 0.285] = I64_MAX
    return torch.from_numpy(k).to(dev)


@pytest.mark.parametrize("dist", ["uniform", "one value", "23-bit",
                                  "dead rows"])
@pytest.mark.parametrize("shift", [0, 8, 24, 56])
@pytest.mark.parametrize("n", [1, 4095, 4097, 3 * 4096 + 17, 8193,
                               1 << 20, 8_388_608])
def test_int64_kernels_equal_plain(dev, n, shift, dist):
    """The int64 instantiation at ragged and whole tiles, every digit
    position (the top one flips the sign bit), and the slice's key
    shapes; each wrapper launched its int64 kernel."""
    key = _keys64(n, n + shift, dist, dev)
    val = torch.randperm(n, device=dev).to(torch.int32)
    before = dict(rk.LAUNCHES)
    hist = rk.radix_hist(key, shift)
    assert hist.shape == (rk.n_tiles(n), rk.N_DIGITS)
    assert torch.equal(hist, rk.radix_hist_plain(key, shift))
    offs = rk.exclusive_offsets(hist)
    got = rk.radix_scatter(key, val, offs, shift)
    want = rk.radix_scatter_plain(key, val, offs, shift)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    full = rk.counting_sort_pass(key, val, shift)
    plain = rk.counting_sort_pass_plain(key, val, shift)
    assert torch.equal(full[0], plain[0]) and torch.equal(full[1], plain[1])
    assert rk.LAUNCHES["radix_hist64"] == before["radix_hist64"] + 2
    assert rk.LAUNCHES["radix_scatter64"] == before["radix_scatter64"] + 2
    assert rk.LAUNCHES["radix_hist"] == before["radix_hist"]


def test_int64_unaligned_tensors_take_the_scalar_loads(dev):
    n = 3 * 4096 + 5
    key = _keys64(n + 1, 3, "uniform", dev)[1:]
    val = torch.arange(n + 1, dtype=torch.int32, device=dev)[1:]
    assert key.data_ptr() % 16 and val.data_ptr() % 16
    got = rk.counting_sort_pass(key, val, 56)
    want = rk.counting_sort_pass_plain(key, val, 56)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [1, 5000, 1 << 20])
def test_stable_argsort_on_gpu_equals_plain(dev, n):
    """The TopN key set (dead flag, null flags, ~price, orderkey), the
    SORT key set and one uniform 64-bit key: the permutation on the card
    equals the plain path's on the CPU; the onesweep kernels launched
    once a key with passes and once a pass, and the per-pass
    kernels not at all."""
    from tidb_tpu_torch.ops import sort as S
    rng = np.random.default_rng(n)
    flag = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    zeros = torch.zeros(n, dtype=torch.int32)
    price = torch.from_numpy(rng.integers(90_000, 10_500_000, n))
    okey = torch.from_numpy(rng.integers(1, 6_000_000, n))
    sets = {"TopN": [flag, zeros, ~price, zeros, okey],
            "SORT": [flag, zeros, torch.from_numpy(rng.integers(-9, 9, n))],
            "uniform": [torch.from_numpy(rng.integers(
                I64_MIN, I64_MAX, n, dtype=np.int64))]}
    for name, keys in sets.items():
        want = S.stable_argsort(keys)
        before = dict(rk.LAUNCHES)
        before_os = dict(os1.LAUNCHES)
        passes = dict(S.PASSES)
        got = S.stable_argsort([k.to(dev) for k in keys])
        ran = S.PASSES["stable_argsort"] - passes["stable_argsort"]
        sorted_keys = S.PASSES["stable_argsort_keys"] \
            - passes["stable_argsort_keys"]
        assert torch.equal(got.cpu(), want), name
        assert sorted_keys == sum(1 for p in S.plan_passes(keys) if p)
        assert os1.LAUNCHES["radix_onesweep64"] \
            - before_os["radix_onesweep64"] == ran
        assert os1.LAUNCHES["radix_hist_all64"] \
            - before_os["radix_hist_all64"] == sorted_keys
        assert rk.LAUNCHES == before, name


# ------------------------------------------------------------------ #
# the onesweep kernels
# ------------------------------------------------------------------ #

def _onesweep_rows(n, dev):
    """A row count, or "4x SMs": a ragged count of at least four tiles an
    SM, so that blocks wait on each other's look-back."""
    if n != "4x SMs":
        return n
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return 4 * sms * os1.KERNEL_TILE + 77


def _assert_onesweep_equals_plain(key, val, shifts):
    """The histogram of every digit equals its plain version and the
    per-tile histograms summed; each pass at ``shifts`` equals its plain
    version and the per-pass ``counting_sort_pass`` bit for bit, with and
    without the key store; each wrapper launched its kernel."""
    before = dict(os1.LAUNCHES)
    hist = os1.radix_hist_all64(key, 8)
    assert hist.shape == (8, rk.N_DIGITS) and hist.dtype == torch.int32
    assert torch.equal(hist, os1.radix_hist_all64_plain(key, 8))
    for p in range(8):
        assert torch.equal(hist[p], rk.radix_hist_plain(key, 8 * p).sum(
            0, dtype=torch.int32))
    for shift in shifts:
        hp = hist[shift // 8].contiguous()
        k_out, v_out = os1.radix_onesweep64(key, val, hp, shift)
        pk, pv = os1.radix_onesweep64_plain(key, val, hp, shift)
        ref = rk.counting_sort_pass(key, val, shift)
        assert torch.equal(k_out, pk) and torch.equal(v_out, pv)
        assert torch.equal(k_out, ref[0]) and torch.equal(v_out, ref[1])
        none, v_only = os1.radix_onesweep64(key, val, hp, shift,
                                            store_key=False)
        assert none is None and torch.equal(v_only, ref[1])
    assert os1.LAUNCHES["radix_hist_all64"] == before["radix_hist_all64"] + 1
    assert os1.LAUNCHES["radix_onesweep64"] \
        == before["radix_onesweep64"] + 2 * len(shifts)


@pytest.mark.parametrize("dist", ["uniform", "one value", "23-bit",
                                  "dead rows"])
@pytest.mark.parametrize("n", [1, 8191, 8193, 3 * 8192 + 5, "4x SMs",
                               8_388_608])
def test_onesweep_kernels_equal_plain(dev, n, dist):
    """Ragged and whole tiles, blocks that wait on each other, the
    slice's batch, every digit skew: one value everywhere (one digit at
    every shift, the longest look-back chains), an orderkey's 23 bits,
    SEGMENT's dead rows at INT64_MAX."""
    n = _onesweep_rows(n, dev)
    key = _keys64(n, n + 1, dist, dev)
    val = torch.randperm(n, device=dev).to(torch.int32)
    _assert_onesweep_equals_plain(key, val, (0, 16, 56))


@pytest.mark.parametrize("dist", ["uniform", "one value", "dead rows"])
@pytest.mark.parametrize("n", [1, 8193, "4x SMs", 8_388_608])
def test_onesweep_sort_equals_per_pass_sort(dev, n, dist):
    """One C call a key (memset, histogram, passes, no key store on the
    last) equals the per-pass sort chained, for every number of passes, with
    values given and with the row indices made by the kernel."""
    n = _onesweep_rows(n, dev)
    key = _keys64(n, n + 2, dist, dev)
    val = torch.arange(n, dtype=torch.int32, device=dev)
    k, v = key, val
    for passes in range(1, 9):
        k, v = rk.counting_sort_pass(k, v, 8 * (passes - 1))
        before = dict(os1.LAUNCHES)
        got = os1.onesweep_sort(key, val, passes)
        assert torch.equal(got, v), passes
        # the row indices made by the first pass, the int64 permutation
        # written by the last
        wide = os1.onesweep_sort(key, None, passes, wide=True)
        assert wide.dtype == torch.int64 and torch.equal(wide, v.long())
        assert os1.LAUNCHES["radix_onesweep64"] \
            == before["radix_onesweep64"] + 2 * passes
        assert os1.LAUNCHES["radix_hist_all64"] \
            == before["radix_hist_all64"] + 2


def test_onesweep_unaligned_tensors_take_the_scalar_loads(dev):
    n = 3 * 8192 + 5
    key = _keys64(n + 1, 4, "uniform", dev)[1:]
    val = torch.arange(n + 1, dtype=torch.int32, device=dev)[1:]
    assert key.data_ptr() % 16 and val.data_ptr() % 16
    _assert_onesweep_equals_plain(key, val, (0, 56))


def test_onesweep_status_word_holds_counts_past_2_30(dev):
    """One pass whose single digit counts more than 2^30 rows: a 30-bit
    count in the status word would wrap; the 64-bit word does not.  The
    last 8193 rows take other digits, so they land past 2^30."""
    n = (1 << 30) + 8193
    if torch.cuda.get_device_properties(dev).total_memory < 40 * 2 ** 30:
        pytest.skip("needs 40 GiB on the card")
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    key[-8193:] = torch.randint(0, 256, (8193,), generator=gen, device=dev,
                                dtype=torch.int64) ^ I64_MIN
    val = torch.arange(n, dtype=torch.int32, device=dev)
    hist = os1.radix_hist_all64(key, 1)
    assert int(hist.max()) > 1 << 30
    want = rk.counting_sort_pass(key, val, 0)[1]
    got = os1.radix_onesweep64(key, val, hist[0], 0, store_key=False)[1]
    assert torch.equal(got, want)
    del got
    assert torch.equal(os1.onesweep_sort(key, val, 1), want)


def test_onesweep_reports_positions_outside_n(dev):
    """A histogram that does not describe the key sends rows past n: the
    kernel skips their stores and sets the error flag, which raises."""
    n = 3 * 8192 + 5
    key = _keys64(n, 5, "uniform", dev)
    val = torch.arange(n, dtype=torch.int32, device=dev)
    hist = os1.radix_hist_all64(key, 1)[0].clone()
    hist[0] += 1
    with pytest.raises(ValueError, match="outside"):
        os1.radix_onesweep64(key, val, hist, 0)
    with pytest.raises(ValueError):
        os1.radix_onesweep64(key, val, hist.cpu(), 0)
    with pytest.raises(ValueError):
        os1.radix_onesweep64(key, val, hist, 4)


def test_slice4_paths_on_gpu_equal_cpu(dev):
    """SORT and SEGMENT aggregations (a DOUBLE key with -0.0 and NaN
    among them) and the TopN, Limit and filtered-projection rows through
    CopClient(device="cuda") equal the plain CPU path."""
    import chip_smoke as cs
    for _name, kind, root, snap, meta in cs.reference_cases(0.01):
        if kind == "agg":
            r = [CopClient(d).execute_agg(root, snap, meta)
                 for d in ("cuda", "cpu")]
            a, b_ = (cs.agg_map(x) for x in r)
        else:
            a, b_ = (cs.rows_map(CopClient(d).execute_rows(
                root, snap, D.output_dtypes(root))) for d in ("cuda", "cpu"))
        assert a == b_, kind


# ------------------------------------------------------------------ #
# group_reduce
# ------------------------------------------------------------------ #

FSUM_RTOL = 1e-12
GR_DTYPES = [torch.int8, torch.int16, torch.int32, torch.int64,
             torch.float32, torch.float64]


def _gr_inputs(n, G, dtype, seed, gid_dtype=torch.int32):
    """Values (NaN and +-inf among floats), a mask keeping ~80%, gids in
    [0, G] (G = the sink slot; none for G = 1), on the CPU."""
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        v = rng.normal(0.0, 1e4, n)
        v[rng.random(n) < 0.002] = np.nan
        v[rng.random(n) < 0.001] = np.inf
        vals = torch.from_numpy(v).to(dtype)
    else:
        info = torch.iinfo(dtype)
        vals = torch.from_numpy(rng.integers(info.min, info.max, n,
                                             endpoint=True)).to(dtype)
    mask = torch.from_numpy(rng.random(n) < 0.8)
    gids = None if G == 1 else torch.from_numpy(
        rng.integers(0, G + 1, n)).to(gid_dtype)
    return vals, mask, gids


def _assert_gr_equal(got, want, vals, mask, gids, G, how):
    assert got.dtype == want.dtype and got.shape == want.shape
    if vals.dtype.is_floating_point and how == "sum":
        absum = gr.group_reduce_plain(vals.double().abs().nan_to_num(
            posinf=0.0), mask, gids, G, "sum")
        g, w = got.double(), want.double()
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        close = (g - w).abs() <= FSUM_RTOL * absum \
            + (1e-6 if vals.dtype == torch.float32 else 0.0) * absum
        assert bool((same | close).all())
    else:
        assert torch.equal(got.isnan() if got.is_floating_point() else got,
                           want.isnan() if want.is_floating_point()
                           else want)
        if got.is_floating_point():
            keep = ~want.isnan()
            assert torch.equal(got[keep], want[keep])


@pytest.mark.parametrize("how", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", GR_DTYPES, ids=str)
@pytest.mark.parametrize("G", [1, 12, 16, 17, 4096, 4097, 1 << 17])
@pytest.mark.parametrize("n", [1, 1023, 70_001, 1 << 20])
def test_group_reduce_equals_plain(dev, n, G, dtype, how):
    """The one-lane call through the lanes kernel, in every table mode
    (private up to 112 slots, shared, global) at ragged and large n,
    every dtype: against the plain version on the CPU."""
    vals, mask, gids = _gr_inputs(n, G, dtype, n + G)
    before = gr.LAUNCHES["group_reduce"]
    got = gr.group_reduce(vals.to(dev), mask.to(dev),
                          None if gids is None else gids.to(dev), G, how)
    assert gr.LAUNCHES["group_reduce"] == before + 1
    want = gr.group_reduce_plain(vals, mask, gids, G, how)
    _assert_gr_equal(got.cpu(), want, vals, mask, gids, G, how)


@pytest.mark.parametrize("G", [1, 12, 4096, 1 << 20])
def test_group_reduce_float_sum_is_deterministic(dev, G):
    """Two launches on the same input give the same bits."""
    vals, mask, gids = _gr_inputs(3_000_017, G, torch.float64, G)
    vals = vals.nan_to_num(nan=1.0, posinf=2.0).to(dev)
    mask = mask.to(dev)
    gids = None if gids is None else gids.to(dev)
    first = gr.group_reduce(vals, mask, gids, G, "sum")
    for _ in range(3):
        assert torch.equal(gr.group_reduce(vals, mask, gids, G, "sum"),
                           first)


@pytest.mark.parametrize("how", ["sum", "min", "max"])
def test_group_reduce_int64_gids_of_the_segment_reduce(dev, how):
    """The SCATTER segment reduce's int64 gids, sorted, with dead rows in
    the sink slot."""
    n, G = 500_000, 1 << 18
    rng = np.random.default_rng(5)
    gids = torch.from_numpy(np.sort(rng.integers(0, G + 1, n)))
    vals = torch.from_numpy(rng.integers(-10 ** 12, 10 ** 12, n))
    mask = gids < G
    got = gr.group_reduce(vals.to(dev), mask.to(dev), gids.to(dev), G, how)
    assert torch.equal(got.cpu(),
                       gr.group_reduce_plain(vals, mask, gids, G, how))


def test_reduce_takes_the_kernel_on_cuda(dev):
    """exec._reduce on CUDA tensors launches group_reduce; SCALAR comes
    back 0-d."""
    from tidb_tpu_torch.copr.exec import _reduce
    vals = torch.arange(1000, dtype=torch.int64, device=dev)
    mask = vals % 3 == 0
    before = gr.LAUNCHES["group_reduce"]
    got = _reduce(vals, mask, None, 1, "sum")
    assert gr.LAUNCHES["group_reduce"] == before + 1
    assert got.shape == () and int(got) == sum(range(0, 1000, 3))


def test_q6_on_gpu_equals_cpu(dev):
    """TPC-H Q6 (and Q1) through CopClient(device="cuda") equal the plain
    CPU path, and launch group_reduce as _agg_partial_states implies."""
    import chip_smoke as cs
    from tidb_tpu_torch.store import snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    names, cols = gen_lineitem(0.02, seed=1, columns=cs.Q_COLS)
    snap = snapshot_from_columns(names, cols)
    for which in ("Q6", "Q1"):
        agg, meta = cs.build_main_query(which, names, cols)
        before = gr.LAUNCHES["group_reduce"]
        got = cs.result_rows(CopClient("cuda").execute_agg(agg, snap, meta))
        assert gr.LAUNCHES["group_reduce"] - before == \
            cs.expected_reduces(agg)
        assert got == cs.result_rows(CopClient("cpu", 8).execute_agg(
            agg, snap, meta))
        assert got == cs.main_oracle(which, names, cols)


# ------------------------------------------------------------------ #
# group_reduce_lanes: every lane of a state table in one launch
# ------------------------------------------------------------------ #

LANE_SRC_DTYPES = [torch.int8, torch.int16, torch.int32, torch.int64,
                   torch.uint8, torch.float32, torch.float64]


def _lane_set(n, seed, narrow_only=False):
    """Sources of every stored dtype, two masks (the selection and one
    that is not it), and a lane set over them: every kind, duplicates
    included; on the CPU."""
    rng = np.random.default_rng(seed)
    srcs = {}
    for dt_ in LANE_SRC_DTYPES:
        if dt_.is_floating_point:
            v = rng.normal(0.0, 1e5, n)
            v[rng.random(n) < 0.002] = np.nan
            v[rng.random(n) < 0.001] = -np.inf
            srcs[dt_] = torch.from_numpy(v).to(dt_)
        else:
            info = torch.iinfo(dt_)
            srcs[dt_] = torch.from_numpy(rng.integers(
                info.min, info.max, n, endpoint=True)).to(dt_)
    sel = torch.from_numpy(rng.random(n) < 0.8)
    other = sel & torch.from_numpy(rng.random(n) < 0.7)
    S = srcs
    lanes = [gr.Lane("count", None, sel), gr.Lane("count", None, other),
             gr.Lane("sum_hi32", S[torch.int8], sel),
             gr.Lane("sum_lo32", S[torch.int8], sel),
             gr.Lane("min", S[torch.int16], other),
             gr.Lane("max", S[torch.int16], other),
             gr.Lane("sum", S[torch.int32], sel),
             gr.Lane("sum_lo32", S[torch.int32], sel),
             gr.Lane("sum_hi32", S[torch.int64], other),
             gr.Lane("sum_lo32", S[torch.int64], other),
             gr.Lane("min", S[torch.int64], other),
             gr.Lane("max", S[torch.uint8], sel),
             gr.Lane("sum", S[torch.uint8], sel),
             gr.Lane("count", None, sel)]
    if not narrow_only:
        lanes += [gr.Lane("fsum", S[torch.float32], other),
                  gr.Lane("fmin", S[torch.float32], other),
                  gr.Lane("fsum", S[torch.float64], sel),
                  gr.Lane("fmax", S[torch.float64], sel)]
    return lanes


def _on(lanes, dev):
    """The same lanes with their tensors on ``dev`` (one copy a tensor,
    so identities are kept)."""
    moved = {}

    def mv(t):
        if t is None:
            return None
        if id(t) not in moved:
            moved[id(t)] = t.to(dev)
        return moved[id(t)]
    return [gr.Lane(ln.kind, mv(ln.src), mv(ln.mask)) for ln in lanes]


def _assert_lanes_equal_plain(lanes, gids, G, dev, launches=1):
    before = gr.LAUNCHES["group_reduce"]
    got = gr.group_reduce_lanes(None if gids is None else gids.to(dev), G,
                                _on(lanes, dev))
    assert gr.LAUNCHES["group_reduce"] == before + launches
    want = gr.group_reduce_lanes_plain(gids, G, lanes)
    for ln, g, w in zip(lanes, got, want):
        vals, how = gr.lane_values(ln)
        _assert_gr_equal(g.cpu(), w, vals, ln.mask, gids, G, how)
    return got


@pytest.mark.parametrize("G", [1, 5, 12, 500, 4097, 1 << 17])
@pytest.mark.parametrize("n", [1, 4097, 70_001, 1 << 20])
def test_lane_sets_equal_plain(dev, n, G):
    """Every kind over sources of every stored width, on two masks, with
    sink rows and duplicate lanes, in one launch, in each table mode
    (private at G = 1 and at G = 5 for the narrow set, shared, global):
    equal to the plain version."""
    rng = np.random.default_rng(G + n)
    gids = None if G == 1 else torch.from_numpy(
        rng.integers(0, G + 1, n)).to(torch.int32 if G < 4096
                                      else torch.int64)
    lanes = _lane_set(n, n + G, narrow_only=(G == 5))
    _assert_lanes_equal_plain(lanes, gids, G, dev)


@pytest.mark.parametrize("dist", ["Q1", "uniform"])
def test_q1_lane_set_private_tables(dev, dist):
    """TPC-H Q1's nine lanes (the count and the (hi, lo) limbs of an
    int8, an int32 and two int64 columns) over G = 12: 108 entries, the
    private tables, at ragged and large n."""
    for n in (3, 4097, 1_000_003):
        rng = np.random.default_rng(n)
        g = rng.choice([0, 3, 6, 7], n, p=[.247, .247, .013, .493]) \
            if dist == "Q1" else rng.integers(0, 13, n)
        gids = torch.from_numpy(g.astype(np.int32))
        sel = torch.from_numpy(rng.random(n) < 0.98)
        cols = [torch.from_numpy(rng.integers(1, 51, n).astype(np.int8)),
                torch.from_numpy(rng.integers(9e4, 1.05e7, n)
                                 .astype(np.int32)),
                torch.from_numpy(rng.integers(0, 1 << 40, n)),
                torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n))]
        lanes = [gr.Lane("count", None, sel)]
        for c in cols:
            lanes += [gr.Lane("sum_hi32", c, sel),
                      gr.Lane("sum_lo32", c, sel),
                      gr.Lane("count", None, sel)]
        assert gr.table_mode(12, 9) == "private"
        _assert_lanes_equal_plain(lanes, gids, 12, dev)


@pytest.mark.parametrize("G", [1, 12, 4097, 1 << 17])
def test_lane_sets_take_unaligned_narrow_sources(dev, G):
    """Sources, masks and gids that are views one element into their
    storage (not aligned for the vector loads) and a ragged tail take
    the scalar loads and stay exact."""
    n = 70_001
    rng = np.random.default_rng(G)
    lanes = _on(_lane_set(n + 1, G, narrow_only=True), dev)
    views = {}

    def off(t):
        if t is None:
            return None
        if id(t) not in views:
            views[id(t)] = t[1:]
        return views[id(t)]
    lanes = [gr.Lane(ln.kind, off(ln.src), off(ln.mask)) for ln in lanes]
    for ln in lanes:
        if ln.src is not None and ln.src.element_size() < 8:
            assert ln.src.data_ptr() % 16
    gids = None if G == 1 else torch.from_numpy(rng.integers(
        0, G + 1, n + 1)).to(torch.int32).to(dev)[1:]
    before = gr.LAUNCHES["group_reduce"]
    got = gr.group_reduce_lanes(gids, G, lanes)
    assert gr.LAUNCHES["group_reduce"] == before + 1
    cpu = [gr.Lane(ln.kind, None if ln.src is None else ln.src.cpu(),
                   ln.mask.cpu()) for ln in lanes]
    want = gr.group_reduce_lanes_plain(None if gids is None else gids.cpu(),
                                       G, cpu)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("gid_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("G", [12, 4097, 1 << 20])
def test_runs_of_equal_gids_across_warp_and_block_edges(dev, G, gid_dtype):
    """Gids in segment order with runs of 1 to 5000 rows, which cross the
    warps' 32-row and the blocks' edges, the sink rows after them (the
    segment reduce's layout), and a mask with holes inside the runs:
    the run sums equal the plain version."""
    rng = np.random.default_rng(G)
    lens = rng.choice([1, 2, 31, 32, 33, 63, 257, 1000, 5000], 3000)
    g = np.repeat(np.arange(len(lens)) % G, lens)
    g = np.sort(g)
    n = len(g) + 20_000
    gids = torch.from_numpy(np.concatenate([g, np.full(20_000, G)])
                            ).to(gid_dtype)
    sel = torch.from_numpy(np.arange(n) < len(g))
    hole = sel & torch.from_numpy(rng.random(n) < 0.9)
    v = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n))
    f = torch.from_numpy(rng.normal(0.0, 1e3, n))
    lanes = [gr.Lane("count", None, sel), gr.Lane("count", None, hole),
             gr.Lane("sum_hi32", v, hole), gr.Lane("sum_lo32", v, hole),
             gr.Lane("min", v, hole), gr.Lane("max", v, sel),
             gr.Lane("fsum", f, hole), gr.Lane("fmax", f, sel)]
    _assert_lanes_equal_plain(lanes, gids, G, dev)


@pytest.mark.parametrize("G", [4097, 1 << 22])
def test_random_gids_at_high_g(dev, G):
    """Random int64 gids over a table past the shared-memory modes (the
    segment reduce before a sort, the high-NDV tables): every run is one
    row, so the warp's ballot finds no run and each row adds its own
    atomics."""
    n = 1 << 21
    rng = np.random.default_rng(G)
    gids = torch.from_numpy(rng.integers(0, G + 1, n))
    sel = torch.from_numpy(rng.random(n) < 0.7)
    v = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n))
    q = torch.from_numpy(rng.integers(1, 51, n).astype(np.int8))
    lanes = [gr.Lane("count", None, sel), gr.Lane("sum_hi32", v, sel),
             gr.Lane("sum_lo32", v, sel), gr.Lane("sum", q, sel)]
    assert gr.table_mode(G, 4) == "global"
    _assert_lanes_equal_plain(lanes, gids, G, dev)


@pytest.mark.parametrize("G", [1, 12, 4096, 1 << 20])
def test_lane_float_sums_are_deterministic(dev, G):
    """Float sums of float32 and float64 sources among integer lanes: the
    same bits on every launch."""
    n = 3_000_017
    rng = np.random.default_rng(G)
    gids = None if G == 1 else torch.from_numpy(
        rng.integers(0, G + 1, n)).to(dev)
    sel = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    f64 = torch.from_numpy(rng.normal(0.0, 1e6, n)).to(dev)
    f32 = f64.float()
    v = torch.from_numpy(rng.integers(-(1 << 50), 1 << 50, n)).to(dev)
    lanes = [gr.Lane("count", None, sel), gr.Lane("fsum", f64, sel),
             gr.Lane("sum_hi32", v, sel), gr.Lane("fsum", f32, sel),
             gr.Lane("sum_lo32", v, sel)]
    first = gr.group_reduce_lanes(gids, G, lanes)
    for _ in range(3):
        for a, b_ in zip(gr.group_reduce_lanes(gids, G, lanes), first):
            assert torch.equal(a, b_)


def test_lanes_past_one_launch_take_more(dev):
    """Lanes over more sources than one launch takes are cut into sets,
    a launch each, and stay exact."""
    n = 10_000
    rng = np.random.default_rng(3)
    gids = torch.from_numpy(rng.integers(0, 13, n).astype(np.int32))
    sel = torch.from_numpy(rng.random(n) < 0.8)
    lanes = [gr.Lane(k, torch.from_numpy(rng.integers(-99, 99, n)), sel)
             for _ in range(gr.MAX_SRCS + 1) for k in ("sum",)]
    _assert_lanes_equal_plain(lanes, gids, 12, dev, launches=2)


@pytest.mark.parametrize("strategy", ["SORT", "SEGMENT", "SCATTER"])
def test_one_launch_per_state_table_high_ndv(dev, strategy):
    """``states_from_partition`` (SORT, SEGMENT, SCATTER) launches
    group_reduce once a program run on the card, and its states equal
    the plain CPU path's."""
    rng = np.random.default_rng(9)
    n = 60_000
    k = rng.integers(0, 5000, n)
    v = rng.integers(-10 ** 6, 10 ** 6, n)
    f = rng.normal(0.0, 1e3, n)
    snap = snapshot_from_numpy(["k", "v", "f"], [
        {"kind": "INT64", "data": k, "validity": rng.random(n) < 0.95},
        {"kind": "DECIMAL", "prec": 15, "scale": 2, "nullable": True,
         "data": v, "validity": rng.random(n) < 0.9},
        {"kind": "FLOAT64", "nullable": False, "data": f}])
    dec = dt.decimal(15, 2)
    agg = D.Aggregation(
        D.TableScan((0, 1, 2), (dt.bigint(), dec, dt.double(False))),
        (ColumnRef(dt.bigint(), 0),),
        (D.AggDesc(D.AggFunc.SUM, ColumnRef(dec, 1), dt.decimal(37, 2)),
         D.AggDesc(D.AggFunc.COUNT, ColumnRef(dec, 1), dt.bigint(False)),
         D.AggDesc(D.AggFunc.MAX, ColumnRef(dec, 1), dec),
         D.AggDesc(D.AggFunc.SUM, ColumnRef(dt.double(False), 2),
                   dt.double()),
         D.AggDesc(D.AggFunc.COUNT, None, dt.bigint(False))),
        D.GroupStrategy[strategy], group_capacity=8192, num_buckets=8192)
    got = {}
    for d in (dev, torch.device("cpu")):
        cols, counts = snap.device_cols((d,))
        before = gr.LAUNCHES["group_reduce"]
        got[d.type] = ShardedCopProgram(agg, (d,))(cols, counts)
        if d.type == "cuda":
            assert gr.LAUNCHES["group_reduce"] == before + 1
    for key, w in got["cpu"].items():
        for f_, wv in (w.items() if isinstance(w, dict) else [("", w)]):
            gv = got["cuda"][key][f_] if f_ else got["cuda"][key]
            if f_ == "sum" and wv.is_floating_point():
                assert torch.allclose(gv.cpu(), wv, rtol=FSUM_RTOL), key
            else:
                assert torch.equal(gv.cpu(), wv), (key, f_)


def test_one_launch_per_state_table_dense(dev):
    """``_agg_partial_states`` launches group_reduce once for Q1's nine
    lanes on the card (one-lane launches took 13) and the
    states equal the plain CPU path's."""
    import chip_smoke as cs
    from tidb_tpu_torch.store import snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    names, cols = gen_lineitem(0.01, seed=2, columns=cs.Q_COLS)
    snap = snapshot_from_columns(names, cols)
    agg, _ = cs.build_main_query("Q1", names, cols)
    got = {}
    for d in (dev, torch.device("cpu")):
        dcols, counts = snap.device_cols((d,))
        before = gr.LAUNCHES["group_reduce"]
        got[d.type] = ShardedCopProgram(agg, (d,))(dcols, counts)
        if d.type == "cuda":
            assert gr.LAUNCHES["group_reduce"] == before + 1
    for key, w in got["cpu"].items():
        for f_, wv in (w.items() if isinstance(w, dict) else [("", w)]):
            gv = got["cuda"][key][f_] if f_ else got["cuda"][key]
            assert torch.equal(gv.cpu(), wv), (key, f_)


SQL_ON_CARD = {"Q1": ("group_reduce",), "Q6": ("group_reduce",),
               "SORT two keys": ("group_reduce", "radix_onesweep64"),
               "TopN": ("radix_onesweep64",), "rows": (),
               "HAVING": ("group_reduce",)}


@pytest.mark.parametrize("name", sorted(SQL_ON_CARD))
def test_sql_on_the_card_equals_the_cpu(dev, name):
    """A statement of the SQL path through a ``Session`` on the card
    returns the rows the same session returns on the CPU (plain kernel
    versions), exactly, and launched its hand kernels."""
    from tidb_tpu_torch.testing import tpch
    sql = tpch.SQL_QUERIES[name]
    before = {**gr.LAUNCHES, **os1.LAUNCHES}
    got = tpch.tpch_sql_session(0.01, device="cuda").execute(sql)
    launched = {k: v - before[k] for k, v in {**gr.LAUNCHES,
                                               **os1.LAUNCHES}.items()}
    want = tpch.tpch_sql_session(0.01, device="cpu").execute(sql)
    assert got.names == want.names
    assert got.rows == want.rows
    for k in SQL_ON_CARD[name]:
        assert launched[k] > 0, k


# the join statements on the card and the hand kernels each launches
# (the repartition statements with the broadcast budget at 0)
JOIN_ON_CARD = {"join agg": ("group_reduce",), "join rows": (),
                "semi": (), "anti": ("group_reduce",),
                "join TopN": ("group_reduce", "radix_onesweep64"),
                "Q19": ("group_reduce",), "m:n left": ("group_reduce",),
                "three tables": (), "left join ON filter": (),
                "shuffle": ("group_reduce", "radix_onesweep64"),
                "shuffle group by": ("group_reduce", "radix_onesweep64")}


@pytest.mark.parametrize("n_devices", [1, 8])
@pytest.mark.parametrize("name", sorted(JOIN_ON_CARD))
def test_join_on_the_card_equals_the_cpu(dev, name, n_devices, monkeypatch):
    """A join statement through a ``Session`` on the card returns the
    rows of the same session on the CPU, exactly, launched its hand
    kernels, and took no host fallback of a join."""
    from tidb_tpu_torch.executor import plan as pplan
    from tidb_tpu_torch.testing import tpch
    if name.startswith("shuffle"):
        monkeypatch.setattr(pplan, "BROADCAST_BUILD_MAX_ROWS", 0)
    sql = tpch.JOIN_QUERIES[name]

    def session(device):
        return tpch.tpch_sql_session(0.02, device=device,
                                     n_devices=n_devices, part_sf=0.2,
                                     n_orders=512)
    before = {**gr.LAUNCHES, **os1.LAUNCHES}
    card = session("cuda")
    got = card.execute(sql)
    launched = {k: v - before[k] for k, v in {**gr.LAUNCHES,
                                               **os1.LAUNCHES}.items()}
    want = session("cpu").execute(sql)
    assert got.names == want.names
    assert got.rows == want.rows
    assert card.domain.client.join_fallbacks == 0
    for k in JOIN_ON_CARD[name]:
        assert launched[k] > 0, k


@pytest.mark.parametrize("cap", [4096, 64])
def test_exchange_on_the_card_equals_the_cpu(dev, cap):
    """The exchange over 8 logical devices on the card receives what it
    receives on the CPU."""
    from tidb_tpu_torch.parallel import exchange as pex
    rng = np.random.default_rng(3)
    keys = rng.integers(-2 ** 40, 2 ** 40, 8 * 1000)
    valid = rng.random(len(keys)) < 0.9
    out = {}
    for d in (dev, torch.device("cpu")):
        k, ok = torch.from_numpy(keys).to(d), torch.from_numpy(valid).to(d)
        per_dev = [([(k[i * 1000:(i + 1) * 1000], True)],
                    ok[i * 1000:(i + 1) * 1000], k[i * 1000:(i + 1) * 1000])
                   for i in range(8)]
        out[d.type] = pex.all_to_all_exchange(per_dev, 8, cap)
    for (gc, gv, go, gm), (wc, wv, wo, wm) in zip(out["cuda"], out["cpu"]):
        assert torch.equal(gc[0][0].cpu(), wc[0][0])
        assert torch.equal(gv.cpu(), wv)
        assert int(go) == int(wo) and int(gm) == int(wm)


# ------------------------------------------------------------------ #
# the SELECT surface on the card against the CPU
# ------------------------------------------------------------------ #

def _card_rows_equal(got, want, rtol=FSUM_RTOL) -> None:
    """Rows equal as multisets: integers, decimals, strings and NULLs
    exactly, doubles within ``rtol`` (a float SUM's fixed-point limbs on
    the card against the CPU's double sum)."""
    import math
    key = lambda r: tuple(  # noqa: E731
        (1, "") if x is None else (0, f"{x:.9e}") if isinstance(x, float)
        else (0, repr(x)) for x in r)
    assert len(got) == len(want)
    for g, w in zip(sorted(map(tuple, got), key=key),
                    sorted(map(tuple, want), key=key)):
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert isinstance(a, float) and (
                    a == b or math.isclose(a, b, rel_tol=rtol)
                    or (math.isnan(a) and math.isnan(b))), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


@pytest.fixture(scope="module")
def lane_cols(card):
    from torch_lane_cases import DATA, NAMES
    out = {}
    for d in ("cpu", "cuda"):
        out[d] = [(torch.from_numpy(DATA[n][1].copy()).to(d),
                   True if DATA[n][2] is None
                   else torch.from_numpy(DATA[n][2].copy()).to(d))
                  for n in NAMES]
    return out


def _lane_np(v, n):
    if isinstance(v, torch.Tensor):
        v = v.cpu()
        if v.dtype == torch.uint64:
            v = v.view(torch.int64)
        v = v.numpy()
    return np.broadcast_to(np.asarray(v), (n,))


def _lane_case_names():
    from torch_lane_cases import CASES
    return sorted(CASES)


# the lanes that call CUDA's libm (or torch's CPU one): their doubles may
# differ in the last bits between the card and the CPU, as the JAX
# package's XLA and torch's CPU do (tests/test_torch_evaluator.py)
LIBM_OPS = frozenset({"sqrt", "exp", "ln", "log", "log2", "log10", "pow",
                      "sin", "cos", "tan", "cot", "asin", "acos", "atan",
                      "atan2"})
LIBM_MAX_ULP = 4


def _func_ops(e) -> set:
    from tidb_tpu_torch.expr import ir
    out, stack = set(), [e]
    while stack:
        x = stack.pop()
        if isinstance(x, ir.Func):
            out.add(x.op)
            stack.extend(x.args)
    return out


@pytest.mark.parametrize("name", _lane_case_names())
def test_lane_on_the_card_equals_the_cpu(dev, lane_cols, name):
    """Every case of the device evaluator's lanes (every ``DEVICE_OPS``
    op over tests/torch_lane_cases.py's columns) on the card equals the
    CPU bit for bit, doubles included (a NaN against a NaN, a zero's
    sign kept): masks, integers, dates, decimals, and the doubles of
    ``/``, ``ROUND``, ``TRUNCATE`` and every DECIMAL operand of a double
    lane, which divide by a 0-d tensor on the lane's device.  The lanes
    of ``LIBM_OPS`` call the card's libm: their doubles agree within
    ``LIBM_MAX_ULP`` units in the last place."""
    from tidb_tpu_torch.expr.compile import Evaluator
    from torch_lane_cases import CASES, N, _P
    e = CASES[name](_P)
    libm = bool(_func_ops(e) & LIBM_OPS)
    gv, gm = Evaluator(dev).eval(e, lane_cols["cuda"])
    wv, wm = Evaluator("cpu").eval(e, lane_cols["cpu"])
    m_got = np.broadcast_to(np.asarray(gm if isinstance(gm, bool) else
                                       gm.cpu().numpy()), (N,))
    m_want = np.broadcast_to(np.asarray(wm if isinstance(wm, bool) else
                                        wm.numpy()), (N,))
    assert np.array_equal(m_got, m_want), f"{name}: validity differs"
    a, b = _lane_np(gv, N), _lane_np(wv, N)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype.kind == "f":
        same = ((a == b) & (np.signbit(a) == np.signbit(b))) \
            | (np.isnan(a) & np.isnan(b))
        if libm:
            fin = np.isfinite(a) & np.isfinite(b)
            a0, b0 = np.where(fin, a, 0.0), np.where(fin, b, 0.0)
            tol = LIBM_MAX_ULP * np.spacing(np.maximum(np.abs(a0),
                                                       np.abs(b0)))
            same |= fin & (np.abs(a0 - b0) <= tol)
        bad = np.flatnonzero(~same)
        assert not len(bad), f"{name}: {len(bad)} lanes differ, first " \
            f"{a[bad[0]]!r} against {b[bad[0]]!r}"
    else:
        bad = np.flatnonzero(a != b)
        assert not len(bad), f"{name}: {len(bad)} lanes differ, first " \
            f"{a[bad[0]]!r} against {b[bad[0]]!r}"


def _rollup_snap_and_agg(strategy):
    """A seeded table and ``SELECT k1, k2, COUNT(*), SUM(v), SUM(f),
    SUM(n), MIN(n), MAX(v), COUNT(v) ... GROUP BY k1, k2 WITH ROLLUP`` as
    the planner binds it (tests/test_torch_rollup.py's)."""
    n = 20_000
    rng = np.random.default_rng(41)
    specs = [
        {"kind": "INT64", "nullable": True, "data": rng.integers(0, 40, n),
         "validity": rng.random(n) > 0.1},
        {"kind": "STRING", "nullable": False,
         "data": rng.integers(0, 3, n).astype(np.int32),
         "dictionary": ["x", "y", "z"]},
        {"kind": "DECIMAL", "nullable": True, "prec": 12, "scale": 2,
         "data": rng.integers(-10 ** 7, 10 ** 7, n),
         "validity": rng.random(n) > 0.05},
        {"kind": "FLOAT64", "nullable": False,
         "data": rng.normal(0, 100, n)},
        {"kind": "INT64", "nullable": False,
         "data": rng.integers(-20_000, 20_000, n)}]
    snap = snapshot_from_numpy(["k1", "k2", "v", "f", "n"], specs)
    from tidb_tpu_torch.copr.aggregate import sum_out_dtype
    ni64, i64, s = dt.bigint(), dt.bigint(False), dt.varchar(False)
    dec, f64 = dt.decimal(12, 2), dt.double(False)
    scan = D.TableScan((0, 1, 2, 3, 4), (ni64, s, dec, f64, i64))
    exp = D.Expand(scan, (ColumnRef(ni64, 0, "k1"), ColumnRef(s, 1, "k2")),
                   3)
    gb = (ColumnRef(ni64, 5), ColumnRef(dt.varchar(True), 6),
          ColumnRef(i64, 7))
    A, F = D.AggDesc, D.AggFunc
    v, f, nn = ColumnRef(dec, 2), ColumnRef(f64, 3), ColumnRef(i64, 4)
    aggs = (A(F.COUNT, None, i64), A(F.SUM, v, sum_out_dtype(dec)),
            A(F.SUM, f, dt.double()), A(F.SUM, nn, sum_out_dtype(i64)),
            A(F.MIN, nn, dt.bigint()), A(F.MAX, v, dec),
            A(F.COUNT, v, i64))
    if strategy == "DENSE":
        agg = D.Aggregation(exp, gb, aggs, D.GroupStrategy.DENSE,
                            domain_sizes=(41, 4, 3))
    else:
        agg = D.Aggregation(exp, gb, aggs, D.GroupStrategy[strategy],
                            group_capacity=512, num_buckets=512)
    return snap, agg


@pytest.mark.parametrize("strategy", ["DENSE", "SORT"])
def test_rollup_states_on_the_card_equal_the_cpu(dev, strategy):
    """Rollup's two branches, the DENSE one level by level and the SORT
    one over the materialized expand, on 8 logical devices of the card:
    counts, limbs and MIN/MAX equal the CPU's, float sums within
    ``FSUM_RTOL`` of the slot's sum of |v|."""
    snap, agg = _rollup_snap_and_agg(strategy)
    out = {}
    for d in (dev, torch.device("cpu")):
        devs = (d,) * 8
        cols, counts = snap.device_cols(devs)
        out[d.type] = ShardedCopProgram(agg, devs)(cols, counts, ())
    absum = float(np.abs(snap.columns[3].data).sum())

    def leaves(t, p=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{p}/{k}")
        else:
            yield p, t
    got, want = dict(leaves(out["cuda"])), dict(leaves(out["cpu"]))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.is_floating_point and "sum" in k:
            assert ((g - w).abs() <= FSUM_RTOL * absum).all(), k
        else:
            assert torch.equal(g, w) or (
                w.dtype.is_floating_point and torch.equal(
                    torch.nan_to_num(g, 7.0), torch.nan_to_num(w, 7.0))), k


@pytest.fixture(scope="module")
def tpch_pair(card):
    from tidb_tpu_torch.testing import tpch
    data = tpch.gen_tpch(0.001, seed=0)
    return (tpch.sql_session(data, device="cuda", n_devices=8),
            tpch.sql_session(data, device="cpu", n_devices=8))


def _tpch_names():
    from tidb_tpu_torch.testing import tpch
    return sorted(tpch.TPCH_22)


@pytest.mark.parametrize("qn", _tpch_names())
def test_tpch_on_the_card_equals_the_cpu(dev, tpch_pair, qn):
    """The 22 TPC-H statements over ``gen_tpch(0.001)`` through a session
    on the card (8 logical devices) return the CPU session's rows."""
    from tidb_tpu_torch.testing import tpch
    card, cpu = tpch_pair
    sql = tpch.TPCH_22[qn]
    got, want = card.execute(sql), cpu.execute(sql)
    assert got.names == want.names
    _card_rows_equal(got.rows, want.rows)


# ------------------------------------------------------------------ #
# windows and statistics on the card
# ------------------------------------------------------------------ #

def _window_tables(dtm, Column, StringDict):
    rng = np.random.default_rng(7)
    n = 30_000
    g = rng.integers(0, 300, n)
    return {"t": (["g", "o", "v", "d", "f", "name"], [
        Column(dtm.bigint(True), g.astype(np.int64), rng.random(n) > 0.01),
        Column(dtm.bigint(False), rng.integers(0, 60, n).astype(np.int64),
               np.ones(n, bool)),
        Column(dtm.bigint(True), rng.integers(-50, 50, n).astype(np.int64),
               rng.random(n) > 0.02),
        Column(dtm.decimal(12, 2, True),
               rng.integers(0, 10 ** 7, n).astype(np.int64),
               rng.random(n) > 0.02),
        Column(dtm.double(True), rng.normal(0, 100, n),
               rng.random(n) > 0.02),
        Column(dtm.varchar(False), rng.integers(0, 4, n).astype(np.int32),
               np.ones(n, bool), StringDict(["apple", "fig", "kiwi",
                                             "pear"]))]),
        "sk": (["g", "v"], [
            Column(dtm.bigint(False), np.full(20_000, 7, np.int64),
                   np.ones(20_000, bool)),
            Column(dtm.bigint(False), np.arange(20_000, dtype=np.int64),
                   np.ones(20_000, bool))])}


WINDOW_ON_CARD = {
    "row_number": ("select g, o, v, row_number() over (partition by g "
                   "order by o, v) from t", ("radix_onesweep64",)),
    "rank dense_rank desc": (
        "select g, v, rank() over (partition by g order by v desc), "
        "dense_rank() over (partition by g order by v desc) from t",
        ("radix_onesweep64",)),
    "aggregates": (
        "select g, sum(v) over (partition by g), count(*) over (partition "
        "by g), min(v) over (partition by g), max(d) over (partition by "
        "g), avg(v) over (partition by g), avg(d) over (partition by g), "
        "sum(f) over (partition by g), min(name) over (partition by g) "
        "from t", ("radix_onesweep64", "group_reduce")),
    "skew regrow": ("select v, row_number() over (partition by g order by "
                    "v) from sk", ("radix_onesweep64",)),
}


@pytest.fixture(scope="module")
def window_pair(card):
    from tidb_tpu_torch.chunk.column import Column, StringDict
    from tidb_tpu_torch.testing import tpch
    tabs = _window_tables(dt, Column, StringDict)
    return (tpch.sql_session(tabs, device="cuda", n_devices=8),
            tpch.sql_session(tabs, device="cpu", n_devices=8))


@pytest.mark.parametrize("name", sorted(WINDOW_ON_CARD))
def test_window_on_the_card_equals_the_cpu(dev, window_pair, name):
    """A window statement through a session on the card (8 logical
    devices: the exchange moves rows) returns the CPU session's rows,
    its regrow rounds equal, its hand kernels launched."""
    card, cpu = window_pair
    sql, kernels = WINDOW_ON_CARD[name]
    assert "CopWindow" in "\n".join(
        r[0] for r in card.execute("explain " + sql).rows)
    before = {**gr.LAUNCHES, **os1.LAUNCHES}
    got = card.execute(sql)
    launched = {k: v - before[k] for k, v in {**gr.LAUNCHES,
                                               **os1.LAUNCHES}.items()}
    want = cpu.execute(sql)
    assert got.names == want.names
    _card_rows_equal(got.rows, want.rows)
    assert card.domain.client.timings["windows"] == \
        cpu.domain.client.timings["windows"]
    for k in kernels:
        assert launched[k] > 0, k


STATS_ON_CARD = ["ints with nulls", "floats with nulls", "ties", "one value",
                 "few rows", "all null", "full range"]


def _stats_case(name):
    from tidb_tpu_torch.stats.build import sortable_f64
    rng = np.random.default_rng(13)
    n = 200_000
    some = rng.random(n) < 0.9
    if name == "ints with nulls":
        return rng.integers(0, 50_000, n), some
    if name == "floats with nulls":
        return sortable_f64(rng.normal(size=n) * 1e3), some
    if name == "ties":
        return rng.permutation(np.repeat(np.arange(40), 10)), \
            np.ones(400, bool)
    if name == "one value":
        return np.full(5000, 42), np.ones(5000, bool)
    if name == "few rows":
        return np.array([5, 3, 5, 9, 3, 5]), \
            np.array([True, True, True, False, True, True])
    if name == "all null":
        return rng.integers(0, 9, 3000), np.zeros(3000, bool)
    return rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64), some


@pytest.mark.parametrize("name", STATS_ON_CARD)
def test_stats_kernel_on_the_card_equals_plain(dev, name):
    """The ANALYZE kernel on the card (``stable_argsort`` on the
    onesweep kernels, the run and CM tables on ``group_reduce``) equals
    its plain version on the CPU in every output, exactly, and launched
    its hand kernels."""
    from tidb_tpu_torch.stats.build import stats_kernel
    x, valid = _stats_case(name)
    x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))
    v = torch.from_numpy(valid)
    before = {**gr.LAUNCHES, **os1.LAUNCHES}
    got = stats_kernel(x.to(dev), v.to(dev), 64, 16)
    torch.cuda.synchronize()
    launched = {k: val - before[k] for k, val in {**gr.LAUNCHES,
                                                   **os1.LAUNCHES}.items()}
    want = stats_kernel(x, v, 64, 16)
    assert set(got) == set(want)
    for k in want:
        g = got[k].cpu()
        assert g.dtype == want[k].dtype, k
        assert torch.equal(g, want[k]), k
    assert launched["group_reduce"] == 2
    assert launched["radix_hist_all64"] >= 1


# ------------------------------------------------------------------ #
# the streamed path and the OOM ladder on the card
# ------------------------------------------------------------------ #

def test_uncached_batch_equals_the_resident_placement(dev):
    """A batch placed by ``device_put_uncached`` (pinned host stacks,
    non-blocking copies, timing events) holds what ``device_cols``
    places."""
    import chip_smoke as cs
    from tidb_tpu_torch.store import snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    names, cols = gen_lineitem(0.01, seed=2, columns=cs.Q_COLS)
    snap = snapshot_from_columns(names, cols, min_capacity=256)
    batch = snap.row_batches(snap.device_bytes() // 4)[1]
    rec = {}
    got, counts = batch.device_put_uncached((dev,), rec)
    want, want_counts = batch.device_cols((dev,))
    assert torch.equal(counts, want_counts)
    for (d, v), (wd, wv) in zip(got, want):
        assert d.dtype == wd.dtype and torch.equal(d, wd)
        assert (v is None) == (wv is None) and (v is None or
                                                torch.equal(v, wv))
    rec["h2d"][1].synchronize()
    assert rec["stack_s"] > 0 and rec["h2d"][0].elapsed_time(
        rec["h2d"][1]) >= 0


@pytest.mark.parametrize("which", ["Q1", "Q6", "SORT"])
def test_streamed_equals_resident_on_gpu(dev, which):
    """Q1, Q6 and the SORT group-by streamed in at least four batches on
    the card equal the resident run, one group_reduce launch a batch
    program run, every batch's CUDA-event times recorded."""
    import chip_smoke as cs
    from tidb_tpu_torch.store import snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    if which == "SORT":
        names, cols = gen_lineitem(0.01, seed=2, columns=cs.S4_COLS)
        _kind, agg, meta = cs.build_s4("SORT")
        rows = cs.agg_map
    else:
        names, cols = gen_lineitem(0.01, seed=2, columns=cs.Q_COLS)
        agg, meta = cs.build_main_query(which, names, cols)
        rows = cs.result_rows
    snap = snapshot_from_columns(names, cols, min_capacity=256)
    resident = rows(CopClient("cuda").execute_agg(agg, snap, meta))
    client = CopClient("cuda")
    client.device_mem_cap = snap.device_bytes() // 4
    planned = len(snap.row_batches(client.device_mem_cap))
    before = gr.LAUNCHES["group_reduce"]
    assert rows(client.execute_agg(agg, snap, meta)) == resident
    t = client.timings
    runs = len(t["buckets"]) if which == "SORT" else planned
    assert planned >= 4 and len(t["batches"]) == planned
    assert gr.LAUNCHES["group_reduce"] - before == runs
    assert all(r["h2d_ms"] >= 0 and r["device_ms"] >= 0
               and r["wait_ms"] >= 0 for r in t["batches"])


def test_streamed_sort_under_a_busy_stream(dev, monkeypatch):
    """A streamed SORT whose stream holds another statement's kernel
    (a server's connection threads share the stream) queued between its
    last batch's host sync and that batch's end event: the batches'
    event times are read once the event is done, so the statement
    neither fails nor differs from the resident run."""
    import chip_smoke as cs
    from tidb_tpu_torch.store import snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    names, cols = gen_lineitem(0.01, seed=2, columns=cs.S4_COLS)
    _kind, agg, meta = cs.build_s4("SORT")
    snap = snapshot_from_columns(names, cols, min_capacity=256)
    resident = cs.agg_map(CopClient("cuda").execute_agg(agg, snap, meta))
    client = CopClient("cuda")
    client.device_mem_cap = snap.device_bytes() // 4
    end_batch = client._end_batch

    def busy_then_end(rec):
        torch.cuda._sleep(200_000_000)    # ~0.1 s of another statement
        end_batch(rec)
    monkeypatch.setattr(client, "_end_batch", busy_then_end)
    assert cs.agg_map(client.execute_agg(agg, snap, meta)) == resident
    t = client.timings["batches"]
    assert len(t) >= 4 and t[-1]["device_ms"] >= 50.0


def test_oom_ladder_on_gpu(dev, monkeypatch):
    """A torch.cuda.OutOfMemoryError from the resident launch: the
    half-size streamed batches answer, equal to the resident run."""
    import chip_smoke as cs
    from tidb_tpu_torch.store import snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    names, cols = gen_lineitem(0.01, seed=2, columns=cs.Q_COLS)
    agg, meta = cs.build_main_query("Q1", names, cols)
    want = cs.result_rows(CopClient("cuda").execute_agg(
        agg, snapshot_from_columns(names, cols), meta))
    snap = snapshot_from_columns(names, cols, min_capacity=256)
    client = CopClient("cuda")
    real, calls = client._launch, []

    def launch(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return real(*a, **k)
    monkeypatch.setattr(client, "_launch", launch)
    assert cs.result_rows(client.execute_agg(agg, snap, meta)) == want
    assert client.oom_recovered == 1 and client.degraded == 0
    assert client.timings["oom_rung"] == "stream"
    assert not snap._device_cache


def test_oom_the_stream_does_not_answer_propagates_on_gpu(dev, monkeypatch):
    """An OOM that the half-size batches meet again propagates from a
    client on the card (its host fallback is off): no CPU rung."""
    import chip_smoke as cs
    from tidb_tpu_torch.store import snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    names, cols = gen_lineitem(0.01, seed=2, columns=cs.Q_COLS)
    agg, meta = cs.build_main_query("Q1", names, cols)
    client = CopClient("cuda")

    def launch(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
    monkeypatch.setattr(client, "_launch", launch)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        client.execute_agg(agg, snapshot_from_columns(
            names, cols, min_capacity=256), meta)
    assert client.oom_recovered == client.degraded == 0


# ------------------------------------------------------------------ #
# admission and programs: the batched and fused programs, the streams
# ------------------------------------------------------------------ #

def _tree_on(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_on(v, dev) for v in tree)
    return tree.to(dev)


def _assert_tree_equal(got, want, rtol=FSUM_RTOL):
    """State or row trees: float leaves within ``rtol`` (relative), every
    other leaf bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k], rtol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w, rtol)
        return
    g, w = got.cpu(), want.cpu()
    assert g.shape == w.shape and g.dtype == w.dtype
    if w.dtype.is_floating_point:
        assert torch.allclose(g.double(), w.double(), rtol=rtol, atol=0.0,
                              equal_nan=True)
    else:
        assert torch.equal(g, w)


def _adm_tables():
    import chip_smoke as cs
    from tidb_tpu_torch.store import snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    snaps = []
    for seed in (0, 1, 2):
        names, cols = gen_lineitem(0.01, seed=seed, columns=cs.Q_COLS)
        snaps.append(snapshot_from_columns(names, cols))
    return cs, names, cols, snaps


@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.parametrize("which", ["Q1", "Q6"])
def test_batched_programs_on_the_card_equal_the_cpu(dev, n_dev, which):
    """BatchedCopProgram over three tables (four slots) on the card: one
    group_reduce launch set a logical device, each slot's states equal
    the CPU's batched and solo states."""
    from tidb_tpu_torch.parallel import spmd
    cs, names, cols, snaps = _adm_tables()
    agg, _meta = cs.build_main_query(which, names, cols)
    gpu, cpu = (dev,) * n_dev, (torch.device("cpu"),) * n_dev
    gin = [s.device_cols(gpu) for s in snaps]
    cin = [s.device_cols(cpu) for s in snaps]
    before = gr.LAUNCHES["group_reduce"]
    got = spmd.get_batched_program(agg, gpu, 3)([c for c, _ in gin],
                                                [n for _, n in gin])
    assert gr.LAUNCHES["group_reduce"] - before == \
        n_dev * cs.expected_reduces(agg)
    want = spmd.get_batched_program(agg, cpu, 3)([c for c, _ in cin],
                                                 [n for _, n in cin])
    solo = spmd.get_sharded_program(agg, gpu)
    for i in range(3):
        _assert_tree_equal(got[i], want[i])
        _assert_tree_equal(got[i], solo(*gin[i]))


@pytest.mark.parametrize("cap", [1024, 16])
def test_batched_and_fused_rows_on_the_card_equal_the_cpu(dev, cap):
    from tidb_tpu_torch.parallel import spmd
    cs, names, cols, snaps = _adm_tables()
    ix = {n: i for i, n in enumerate(names)}
    scan = D.TableScan(tuple(range(len(names))),
                       tuple(c.dtype for c in cols))
    qty = ColumnRef(cols[ix["l_quantity"]].dtype, ix["l_quantity"])
    from tidb_tpu_torch.expr import builders as b
    roots = [D.Projection(D.Selection(scan, (b.compare(
        "lt", qty, b.decimal_lit(str(q))),)),
        (qty, ColumnRef(cols[ix["l_extendedprice"]].dtype,
                        ix["l_extendedprice"]))) for q in (20, 3)]
    gpu, cpu = (dev,) * 8, (torch.device("cpu"),) * 8
    gin = [s.device_cols(gpu) for s in snaps[:2]]
    cin = [s.device_cols(cpu) for s in snaps[:2]]
    got = spmd.get_batched_rows_program(roots[0], gpu, cap, 2)(
        [c for c, _ in gin], [n for _, n in gin])
    want = spmd.get_batched_rows_program(roots[0], cpu, cap, 2)(
        [c for c, _ in cin], [n for _, n in cin])
    _assert_tree_equal(got, want)
    fused = D.FusedDag(tuple(roots))
    got = spmd.get_fused_rows_program(fused, gpu, (cap, cap))(*gin[0])
    want = spmd.get_fused_rows_program(fused, cpu, (cap, cap))(*cin[0])
    _assert_tree_equal(got, want)


def test_fused_program_on_the_card_equals_the_cpu(dev):
    from tidb_tpu_torch.parallel import spmd
    cs, names, cols, snaps = _adm_tables()
    q1, _m = cs.build_main_query("Q1", names, cols)
    q6, _m = cs.build_main_query("Q6", names, cols)
    fused = D.FusedDag((q1, q6))
    gin = snaps[0].device_cols((dev,))
    cin = snaps[0].device_cols((torch.device("cpu"),))
    got = spmd.get_fused_program(fused, (dev,))(*gin)
    want = spmd.get_fused_program(fused, (torch.device("cpu"),))(*cin)
    _assert_tree_equal(got, want)
    for g, m in zip(got, (q1, q6)):
        _assert_tree_equal(g, spmd.get_sharded_program(m, (dev,))(*gin))


def test_scheduled_launch_from_a_side_stream_thread(dev):
    """Threads on side streams submit through the scheduler at once: the
    drain launches on the lead's stream after every member's ``ready``
    event, a waiter on another stream waits on ``launched`` and adopts
    the outputs; every result equals the CPU's."""
    import threading
    from tidb_tpu_torch.testing.tpch import SQL_QUERIES, gen_lineitem, \
        sql_session
    data = gen_lineitem(0.01, seed=0)
    sess = sql_session({"lineitem": data}, device="cuda")
    sess.execute("set global tidb_tpu_result_cache_entries = 0")
    want = sql_session({"lineitem": data}, device="cpu").execute(
        SQL_QUERIES["Q6"]).rows
    assert sess.execute(SQL_QUERIES["Q6"]).rows == want
    sched = sess.domain.client._sched_obj
    from tidb_tpu_torch.session import Session
    out, errs = {}, []

    def run(i):
        try:
            s = torch.cuda.Stream(dev)
            with torch.cuda.stream(s):
                # queue work on this stream first: the launch must wait
                # for it (the stream's ready event)
                junk = torch.ones(1 << 24, device=dev)
                junk.mul_(2)
                out[i] = Session(sess.domain).execute(
                    SQL_QUERIES["Q6"]).rows
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append(e)
    sched.pause()
    try:
        ths = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for th in ths:
            th.start()
        import time
        deadline = time.monotonic() + 60
        while sched.depth < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sched.depth >= 4
    finally:
        sched.resume()
    for th in ths:
        th.join(60)
        assert not th.is_alive()
    assert not errs, errs
    assert all(out[i] == want for i in range(4))


# ------------------------------------------------------------------ #
# the statement's observability on the card
# ------------------------------------------------------------------ #

def _obs_pair():
    from tidb_tpu_torch.session import Domain, Session
    out = []
    for device in ("cuda", "cpu"):
        s = Session(Domain(device, n_devices=8))
        s.execute("create table j (id bigint, doc json, n bigint)")
        s.execute("""insert into j values
            (1, '{"a": 1, "b": {"c": "x"}, "arr": [1,2,3]}', 4),
            (2, '{"a": 2}', 5), (3, 'not json', 6), (4, NULL, 7),
            (5, '[1, {"a": "x"}]', 8), (6, '{"a": [1, 2]}', 9)""")
        s.execute("set global tidb_tpu_result_cache_entries = 0")
        s.execute("set global tidb_tpu_trace_sample = 1")
        out.append(s)
    return out


def test_explain_analyze_on_the_card_equals_the_cpu(dev):
    """EXPLAIN ANALYZE on the card: the CPU's operators, actRows and
    loops, the cop task named on cuda with one launch; the statement's
    sched.launch span carries device_ms from its CUDA events."""
    import re
    card, cpu = _obs_pair()
    sql = ("select json_type(doc), count(*), sum(n) from j "
           "group by json_type(doc) order by 1")
    for s in (card, cpu):
        s.execute(sql)

    def norm(s):
        rows = s.execute("explain analyze " + sql).rows
        return [(re.sub(r" \[schedWait.*\]$", "", op)
                 .replace("-> cuda", "-> dev").replace("-> cpu", "-> dev"),
                 act, loops) for op, act, _t, loops in rows]
    assert norm(card) == norm(cpu)
    assert any("-> cuda" in r[0] for r in card.execute(
        "explain analyze " + sql).rows)
    card.execute("select count(*), sum(n) from j "
                 "where json_valid(doc) = 1")
    tree = card.domain.flight_recorder.get(
        card.domain.flight_recorder.index()[0]["trace_id"])
    launch = [sp for sp in tree.spans if sp.name == "sched.launch"]
    assert launch and all(sp.attrs.get("device_ms", 0) > 0
                          for sp in launch), [sp.attrs for sp in launch]


def test_json_statement_on_the_card_equals_the_cpu(dev):
    card, cpu = _obs_pair()
    sql = ("select id, json_extract(doc, '$.a'), json_type(doc), "
           "json_valid(doc), json_length(doc), json_keys(doc) from j "
           "where json_valid(doc) = 1 or doc is null order by id")
    assert card.execute(sql).rows == cpu.execute(sql).rows

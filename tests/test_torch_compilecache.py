"""The port's program cache (compilecache/) and its warm manifest.

Programs are memoized by their restart-stable ``CompileKey``
(analysis/compilekey): a second resolve of one key is a hit that
returns the same object; with a cache directory each build is recorded
in the manifest (key parts, capacity by plan family), which a
simulated restart reads back (``warm_capacity``, ``warm_start``); a
quarantined digest leaves the manifest and is never recorded again; the
calibration store's payloads persist through the same file.  The keys'
digests equal the JAX package's ``stable_digest``/``family_digest`` of
the same plan.
"""

import json

import pytest
import torch

from tidb_tpu.analysis import compilekey as jck
from tidb_tpu_torch.analysis import calibrate
from tidb_tpu_torch.analysis.compilekey import (backend_fingerprint,
                                                family_digest,
                                                stable_digest, variant_key)
from tidb_tpu_torch.compilecache import (compile_cache, configure,
                                         reset_warmed, simulate_restart,
                                         warm_start)
from tidb_tpu_torch.compilecache.manifest import WarmManifest
from tidb_tpu_torch.parallel import spmd
from tidb_tpu_torch.testing.tpch import SQL_QUERIES, gen_lineitem, \
    sql_session

import test_torch_dense as TD

CPU8 = (torch.device("cpu"),) * 8


@pytest.fixture
def cache_dir(tmp_path):
    """A fresh cache directory, with an empty pool: the programs other
    tests of the process built would be hits, never recorded."""
    d = str(tmp_path / "cc")
    configure(cache_dir=d)
    simulate_restart()
    yield d
    configure(cache_dir="")
    reset_warmed()


def _q1(seed=0, sf=0.0005):
    names, cols = TD.j_gen_lineitem(sf, seed=seed, columns=TD.Q_COLS)
    return (TD._q1(TD._JaxNS, names, cols), TD._q1(TD._PortNS, names, cols))


def test_digests_equal_jax_and_the_key_anatomy():
    jq1, q1 = _q1()
    assert stable_digest(q1) == jck.stable_digest(jq1)
    assert family_digest(q1) == jck.family_digest(jq1)
    key = variant_key(q1, CPU8, "solo")
    assert key.digest == stable_digest(q1)
    # the donation signature is the JAX package's, from the DonationPlan
    assert key.donation_sig == jck.variant_key(
        jq1, None, "solo", n_devices=8).donation_sig
    don = variant_key(q1, CPU8, "solo", donate_argnums=(0, 1, 2))
    assert don.donation_sig == jck.variant_key(
        jq1, None, "solo", n_devices=8,
        donate_argnums=(0, 1, 2)).donation_sig
    assert don.entry_hex() != key.entry_hex()
    assert key.backend_fp == backend_fingerprint(CPU8)
    assert torch.__version__ in key.backend_fp
    assert variant_key(q1, CPU8[:1], "solo").entry_hex() != key.entry_hex()
    assert variant_key(q1, CPU8, "batched", n_slots=2).entry_hex() \
        != key.entry_hex()


def test_hits_and_misses():
    _jq1, q1 = _q1(seed=3)
    cc = compile_cache()
    cc.clear_pool()           # other tests of the process may have built it
    h0, m0 = cc.hits, cc.misses
    p1 = spmd.get_sharded_program(q1, CPU8)
    assert (cc.hits, cc.misses) == (h0, m0 + 1)
    p2 = spmd.get_sharded_program(q1, CPU8)
    assert p2 is p1 and (cc.hits, cc.misses) == (h0 + 1, m0 + 1)
    assert spmd.get_sharded_program(q1, CPU8, 64) is not p1
    configure(enable=False)
    try:
        assert spmd.get_sharded_program(q1, CPU8) is not p1
    finally:
        configure(enable=True)


SORT = SQL_QUERIES["SORT"]


def test_warm_capacity_after_a_simulated_restart(cache_dir):
    """A SORT statement regrows its group capacity; after a restart the
    manifest's capacity for the plan family is the warm one, and the
    warm replay takes the entries of this backend and drops another's."""
    s = sql_session({"lineitem": gen_lineitem(0.002, seed=0)},
                    device="cpu", n_devices=8)
    s.execute("set global tidb_tpu_result_cache_entries = 0")
    want = sorted(s.must_query(SORT))
    caps = s.domain.client.timings["buckets"]
    m = compile_cache().manifest
    assert m is not None and m.stats()["entries"] >= 1
    fams = {e["family"] for _hx, e in m.entries_mru() if e["capacity"]}
    assert fams
    simulate_restart()
    cc = compile_cache()
    assert cc.stats()["pool_entries"] == 0
    backend = backend_fingerprint(CPU8)
    fam = next(iter(fams))
    warm = max(m.capacities_for(fam, backend))
    assert cc.warm_capacity(fam, warm // 2 + 1, backend) == warm
    assert cc.warm_capacity(fam, warm // 2 + 1, "another backend") is None
    # an entry of another backend is dropped by the replay
    hx0, meta = m.entries_mru()[0]
    stale = dict(meta, backend_fp="another backend")
    m.record("ff" * 16, stale, 1, 0.0)
    n = warm_start(s.domain.client, wait=True)
    assert n == len(m.entries_mru())
    assert cc.rejected >= 1 and m.entry("ff" * 16) is None
    assert cc.warm_loaded >= n
    # the statement after the restart enters at the warm capacity
    s2 = sql_session({"lineitem": gen_lineitem(0.002, seed=0)},
                     device="cpu", n_devices=8)
    s2.execute("set global tidb_tpu_result_cache_entries = 0")
    assert sorted(s2.must_query(SORT)) == want
    assert s2.domain.client.timings["buckets"][0] >= caps[0]


def test_quarantine_purges_the_manifest(cache_dir):
    _jq1, q1 = _q1(seed=5)
    spmd.get_sharded_program(q1, CPU8)
    cc = compile_cache()
    d = stable_digest(q1)
    assert cc.manifest.has_program(d)
    cc.quarantine(d)
    assert not cc.manifest.has_program(d)
    assert cc.quarantine_report()["laundered"] == 0
    simulate_restart()
    spmd.get_sharded_program(q1, CPU8)          # rebuilt, never recorded
    assert not cc.manifest.has_program(d)


def test_calibration_persists_through_the_manifest(cache_dir):
    """The drain's measurements (observe, observe_mem, observe_oom)
    persist in the manifest and a fresh store restores them."""
    from tidb_tpu_torch.analysis.copcost import LaunchCost
    store = calibrate.CorrectionStore()
    cost = LaunchCost(input_bytes=1 << 20, inter_bytes=1 << 20,
                      output_bytes=1 << 10, flops=10 ** 6)
    for _ in range(4):
        store.observe("d1", cost, 50_000_000)
    store.observe_mem("d1", cost, 3 << 20)
    store.observe_oom("d2")
    assert store.get("d1").samples == 4
    assert store.get("d2").mem_factor == calibrate.CALIB_OOM_BUMP
    assert store.corrected_cost("d1", cost).flops > cost.flops
    store.sync_manifest(force=True)
    doc = json.loads(open(compile_cache().manifest._path()).read())
    assert set(doc["calibration"]) == {"d1", "d2"}
    fresh = calibrate.CorrectionStore()
    assert fresh.restore(WarmManifest(cache_dir)) == 2
    assert fresh.get("d1").time_factor == pytest.approx(
        store.get("d1").time_factor, abs=1e-4)
    merged = calibrate.merge_correction_payloads(
        fresh.get("d1").payload(), store.get("d2").payload())
    assert calibrate.CALIB_CLAMP_MIN <= merged["mem_factor"] \
        <= calibrate.CALIB_CLAMP_MAX


def test_manifest_lru_evicts_by_bytes(tmp_path):
    m = WarmManifest(str(tmp_path), cap_bytes=100)
    for i in range(5):
        m.record(f"{i:032x}", {"digest": f"d{i}", "family": "f",
                               "capacity": 64 << i}, 40, 1.0)
    assert m.stats()["entries"] <= 2 and m.stats()["evictions"] >= 3
    assert WarmManifest(str(tmp_path)).stats()["entries"] \
        == m.stats()["entries"]

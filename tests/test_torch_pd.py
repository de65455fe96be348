"""The port's coordination plane (tidb_tpu_torch/pd/) against the JAX
package's (tidb_tpu/pd/): every test of tests/test_pd.py, each scenario
run through both packages with the same calls, its outcomes compared
(leases, epochs, versions, quota shares, registry counters, calibration
factors), then the port's checked as the JAX test checks the JAX
package's.  The JSON document of the file backend is one schema: a pd
directory written by either package is read by the other.

Tier-1 runs N members as N Domains inside one interpreter over one
MemoryBackend; the ``slow`` smoke at the bottom runs two real port
processes over the file backend, as the JAX test does.  Metrics are
process-global counters, so every metric assertion is a delta.
"""

import json
import os
import shutil
import time
import types
import urllib.request

import numpy as np
import pytest

import tidb_tpu.pd as jpd
import tidb_tpu_torch.pd as ppd
from tidb_tpu.analysis import calibrate as jcal
from tidb_tpu.analysis import copcost as jcost
from tidb_tpu.compilecache import manifest as jman
from tidb_tpu.pd import registry as jreg
from tidb_tpu.rc import controller as jrc
from tidb_tpu_torch.analysis import calibrate as pcal
from tidb_tpu_torch.analysis import copcost as pcost
from tidb_tpu_torch.compilecache import manifest as pman
from tidb_tpu_torch.pd import registry as preg
from tidb_tpu_torch.rc import controller as prc
from tidb_tpu_torch.session import Domain, Session

JAX = types.SimpleNamespace(pd=jpd, reg=jreg, rc=jrc, man=jman, cal=jcal,
                            cost=jcost)
PORT = types.SimpleNamespace(pd=ppd, reg=preg, rc=prc, man=pman, cal=pcal,
                             cost=pcost)


@pytest.fixture(autouse=True)
def _fresh_plane():
    yield
    ppd.reset_pd()
    jpd.reset_pd()


def _both(scenario):
    """The scenario's outcomes through each package; they must agree."""
    want, got = scenario(JAX), scenario(PORT)
    assert got == want, (got, want)
    return got


def _counter(name: str) -> float:
    from tidb_tpu_torch.utils.metrics import global_registry
    m = global_registry().metrics.get(name)
    return m.get() if m is not None else 0.0


# ------------------------------------------------------------------ #
# store: epochs fence the dead, versions serialize the living
# ------------------------------------------------------------------ #

def test_store_epoch_fencing_and_version_cas():
    def run(ns):
        store = ns.pd.PdStore(ns.pd.MemoryBackend())
        e1 = store.grant("a")
        e2 = store.grant("b")
        out = [e1, e2, sorted(store.members())]
        out.append(store.cas("quota/g", 0, {"v": 1}, epoch=e1))
        out.append(store.get("quota/g"))
        # stale version loses, current version wins — even for another
        # LIVE member (versions serialize the living)
        out.append(store.cas("quota/g", 0, {"v": 2}, epoch=e2))
        out.append(store.cas("quota/g", 1, {"v": 2}, epoch=e2))
        store.release("b", e2)
        with pytest.raises(ns.pd.PdLeaseExpired):
            store.cas("quota/g", 2, {"v": 3}, epoch=e2)
        out.append(store.cas("quota/g", 2, {"v": 3}, epoch=e1))
        return out
    e1, e2, members, fresh, got, stale, cur, survivor = _both(run)
    assert e2 > e1 > 0 and members == ["a", "b"]
    assert fresh and got == ({"v": 1}, 1)
    assert not stale and cur and survivor


def test_store_txn_update_and_read_prefix():
    def run(ns):
        store = ns.pd.PdStore(ns.pd.MemoryBackend())
        e = store.grant("a")

        def bump(cur):
            doc = cur if isinstance(cur, dict) else {"n": 0}
            doc["n"] = doc.get("n", 0) + 1
            return doc

        for _ in range(3):
            store.txn_update("quota/g", bump, epoch=e)
        val, ver = store.get("quota/g")
        store.txn_update("quota/h", bump, epoch=e)
        docs = store.read_prefix("quota/")
        val["n"] = 999        # values are copies, not live references
        return [ver, sorted(docs), docs["quota/h"],
                store.get("quota/g")[0]["n"]]
    ver, keys, h, n = _both(run)
    assert ver == 3 and keys == ["quota/g", "quota/h"]
    assert h == ({"n": 1}, 1) and n == 3


def test_store_down_seam_maps_to_unavailable():
    def run(ns):
        backend = ns.pd.MemoryBackend()
        store = ns.pd.PdStore(backend)
        e = store.grant("a")
        backend.down = True
        with pytest.raises(ns.pd.PdUnavailable):
            store.cas("k", 0, {}, epoch=e)
        with pytest.raises(ns.pd.PdUnavailable):
            store.members()
        backend.down = False
        return [store.cas("k", 0, {"ok": 1}, epoch=e), backend.transactions]
    ok, _n = _both(run)
    assert ok


def test_key_families_schema_is_complete_and_equal():
    assert ppd.verify_key_families() == []
    fields = ("prefix", "owner", "ttl_s", "epoch_rule", "desc")
    assert [tuple(getattr(f, k) for k in fields)
            for f in ppd.KEY_FAMILIES] == \
        [tuple(getattr(f, k) for k in fields) for f in jpd.KEY_FAMILIES]
    from tidb_tpu.pd import store as jstore
    from tidb_tpu_torch.pd import store as pstore
    for name in ("PD_LEASE_TTL_S", "PD_CLAIM_TTL_S", "PD_PROGRAM_TTL_S",
                 "PD_CALIB_TTL_S", "PD_QUOTA_TTL_S", "STORE_FILE",
                 "LOCK_FILE", "_TXN_ATTEMPTS"):
        assert getattr(pstore, name) == getattr(jstore, name), name
    assert ppd.PD_SYNC_S == jpd.PD_SYNC_S


def test_pd_report_matches_the_jax_report():
    assert ppd.pd_report() == jpd.pd_report()
    assert ppd.pd_report().endswith("0 violations")


def test_file_backend_two_stores_share_one_document(tmp_path):
    def run(ns):
        pd_dir = str(tmp_path / f"pd-{ns.pd.__name__}")
        a = ns.pd.PdStore(ns.pd.FileBackend(pd_dir))
        b = ns.pd.PdStore(ns.pd.FileBackend(pd_dir))
        ea = a.grant("a")
        eb = b.grant("b")
        out = [ea, eb, sorted(a.members()), sorted(b.members())]
        out.append(a.cas("quota/g", 0, {"v": 1}, epoch=ea))
        out.append(b.get("quota/g")[0])
        out.append(b.cas("quota/g", 1, {"v": 2}, epoch=eb))
        out.append(a.get("quota/g")[0])
        shutil.rmtree(pd_dir)     # deleting the directory IS killing it
        with pytest.raises(ns.pd.PdUnavailable):
            a.cas("quota/g", 2, {"v": 3}, epoch=ea)
        return out
    out = _both(run)
    assert out[2] == out[3] == ["a", "b"]
    assert out[4:] == [True, {"v": 1}, True, {"v": 2}]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_file_backend_document_crosses_packages(tmp_path, writer, reader):
    """A pd directory written by one package is read, fenced and written
    by the other: the JSON document is one schema."""
    w = {"jax": JAX, "port": PORT}[writer]
    r = {"jax": JAX, "port": PORT}[reader]
    pd_dir = str(tmp_path / "pd")
    sw = w.pd.PdStore(w.pd.FileBackend(pd_dir))
    ew = sw.grant("writer")
    assert sw.cas("quota/g", 0, {"ru_per_sec": 100, "members": {}},
                  epoch=ew)
    sw.txn_update("calib", lambda cur: {"d": {"samples": 3}}, epoch=ew)
    sr = r.pd.PdStore(r.pd.FileBackend(pd_dir))
    assert set(sr.members()) == {"writer"}
    assert sr.get("quota/g") == ({"ru_per_sec": 100, "members": {}}, 1)
    assert sr.read_prefix("calib") == {"calib": ({"d": {"samples": 3}}, 1)}
    er = sr.grant("reader")
    assert er == ew + 1                   # one seq counter in the file
    # version CAS and epoch fencing hold across the two packages
    assert not sr.cas("quota/g", 0, {"v": "stale"}, epoch=er)
    assert sr.cas("quota/g", 1, {"v": "reader"}, epoch=er)
    assert sw.get("quota/g") == ({"v": "reader"}, 2)
    sw.release("writer", ew)
    with pytest.raises(r.pd.PdLeaseExpired):
        sr.cas("quota/g", 2, {}, epoch=ew)
    dump_w, dump_r = sw.dump(), sr.dump()
    for d in (dump_w, dump_r):
        for lease in d["leases"].values():
            lease.pop("ttl_left_s")
    assert dump_w == dump_r
    with open(os.path.join(pd_dir, "pd.json")) as f:
        doc = json.load(f)
    assert sorted(doc) == ["keys", "leases", "seq"]
    assert sorted(doc["keys"]["quota/g"]) == ["epoch", "val", "ver"]


def test_file_backend_corrupt_document_degrades_to_fresh(tmp_path):
    def run(ns):
        pd_dir = str(tmp_path / f"pd-{ns.pd.__name__}")
        store = ns.pd.PdStore(ns.pd.FileBackend(pd_dir))
        store.grant("a")
        with open(os.path.join(pd_dir, "pd.json"), "w") as f:
            f.write("{ not json")
        return [store.members(), store.grant("a")]
    members, epoch = _both(run)
    assert members == {} and epoch > 0


# ------------------------------------------------------------------ #
# leases: expiry, failover, rejoin
# ------------------------------------------------------------------ #

def test_lease_expiry_regrants_under_new_epoch():
    def run(ns):
        store = ns.pd.PdStore(ns.pd.MemoryBackend())
        m = ns.pd.PdMember(store, "m", ttl_s=0.05)
        out = [m.ensure(), m.joined()]
        e1 = m.epoch
        time.sleep(0.12)                 # TTL lapses between ticks
        out += [m.ensure(), m.epoch > e1, m.rejoins, m.consume_rejoin(),
                m.consume_rejoin()]
        with pytest.raises(ns.pd.PdLeaseExpired):
            store.cas("k", 0, {}, epoch=e1)
        out.append(store.cas("k", 0, {}, epoch=m.epoch))
        st = m.stats()
        st.pop("member_id")
        return out + [st]
    out = _both(run)
    assert out[:8] == [True, True, True, True, 1, True, False, True]
    assert out[8]["grants"] == 2 and out[8]["epoch"] == 2


def test_lease_store_loss_degrades_then_rejoins():
    def run(ns):
        backend = ns.pd.MemoryBackend()
        store = ns.pd.PdStore(backend)
        m = ns.pd.PdMember(store, "m", ttl_s=0.05)
        out = [m.ensure()]
        backend.down = True
        time.sleep(0.12)
        out += [m.ensure(), m.degraded, m.joined(), m.degraded_total]
        out += [m.ensure(), m.degraded_total]
        backend.down = False
        out += [m.ensure(), m.degraded, m.consume_rejoin(), m.rejoins]
        return out
    assert _both(run) == [True, False, True, False, 1, False, 1, True,
                          False, True, 1]


def test_member_ids_tell_two_domains_of_one_process_apart():
    a, b = ppd.PdMember(None), ppd.PdMember(None)
    assert a.member_id != b.member_id
    host, pid, _n = a.member_id.rsplit(":", 2)
    assert int(pid) == os.getpid() and host


# ------------------------------------------------------------------ #
# quota: ONE RU_PER_SEC across members
# ------------------------------------------------------------------ #

def _quota_pair(ns, budget, debt_b=0.0):
    store = ns.pd.PdStore(ns.pd.MemoryBackend())
    mgrs = ns.rc.ResourceGroupManager(), ns.rc.ResourceGroupManager()
    for mgr in mgrs:
        mgr.create("shared", budget)
    pools = []
    for name, mgr in zip("ab", mgrs):
        m = ns.pd.PdMember(store, name, ttl_s=5.0)
        assert m.ensure()
        pools.append(ns.pd.QuotaPool(m, mgr))
    if debt_b:
        mgrs[1].get("shared").bucket.force_debit(debt_b)
    pa, pb = pools
    pa.sync()
    pb.sync()
    pa.sync()                        # a sees b's report on its next round
    return mgrs, pools


def test_quota_shares_sum_to_declared_budget():
    def run(ns):
        (mgr_a, _b), (pa, pb) = _quota_pair(ns, 1000)
        return [pa.shares, pb.shares, mgr_a.get("shared").bucket.rate,
                pa.stats()]
    sa, sb, rate, stats = _both(run)
    assert sa["shared"] + sb["shared"] == pytest.approx(1000, rel=1e-6)
    assert sa["shared"] == pytest.approx(500, rel=1e-6)
    assert rate == pytest.approx(sa["shared"])
    assert "default" not in sa          # unlimited groups never join
    assert stats["rebalances"] == 2 and stats["member_counts"] == \
        {"shared": 2}


def test_quota_debt_weights_the_refill_split(monkeypatch):
    """Each package's buckets read one frozen clock, so b's debt (and
    so the shares) cannot drift with the wall time between the pairs."""
    import tidb_tpu.rc.bucket as jbucket
    import tidb_tpu_torch.rc.bucket as pbucket
    frozen = types.SimpleNamespace(monotonic=lambda: 1000.0)
    monkeypatch.setattr(jbucket, "time", frozen)
    monkeypatch.setattr(pbucket, "time", frozen)

    def run(ns):
        _mgrs, (pa, pb) = _quota_pair(ns, 900, debt_b=1800)
        return [pa.shares["shared"], pb.shares["shared"]]
    sa, sb = _both(run)
    assert sb > sa
    assert sa + sb == pytest.approx(900, rel=1e-6)


def test_quota_degraded_local_slice_and_restore():
    def run(ns):
        (mgr_a, _b), (pa, _pb) = _quota_pair(ns, 1000)
        pa.degrade_to_local_slice()
        degraded = mgr_a.get("shared").bucket.rate
        slices = pa.local_slices
        pa.restore_full()
        return [degraded, slices, mgr_a.get("shared").bucket.rate,
                pa.shares]
    degraded, slices, full, shares = _both(run)
    assert degraded == pytest.approx(500)
    assert slices == 1 and full == pytest.approx(1000) and shares == {}


# ------------------------------------------------------------------ #
# registry: compile-once claims, warm gossip, quarantine fan-out
# ------------------------------------------------------------------ #

class _StubCache:
    """compilecache.CompileCache surface the registry touches."""

    def __init__(self, loadable=()):
        self.loadable = set(loadable)
        self.loaded: list = []
        self.quarantined: list = []
        self.manifest = None

    def load_warm(self, entry_hex: str) -> bool:
        self.loaded.append(entry_hex)
        return entry_hex in self.loadable

    def quarantine(self, digest: str) -> int:
        self.quarantined.append(digest)
        return 1


def _registry(ns, store, name):
    m = ns.pd.PdMember(store, name, ttl_s=5.0)
    assert m.ensure()
    return ns.reg.ProgramRegistry(m)


def test_registry_claim_is_exclusive_and_released():
    def run(ns):
        store = ns.pd.PdStore(ns.pd.MemoryBackend())
        ra, rb = _registry(ns, store, "a"), _registry(ns, store, "b")
        hx = "e" * 32
        out = [ra.try_claim(hx), rb.try_claim(hx), rb.claim_denials]
        ra.release_claim(hx)
        out += [rb.try_claim(hx), ra.try_claim(hx)]
        return out + [ra.stats(), rb.stats()]
    out = _both(run)
    assert out[:5] == [True, False, 1, True, False]
    assert out[5]["claims"] == 1 and out[6]["claim_denials"] == 1


def test_registry_publish_then_peer_adopts(tmp_path):
    def run(ns):
        store = ns.pd.PdStore(ns.pd.MemoryBackend())
        ra, rb = _registry(ns, store, "a"), _registry(ns, store, "b")
        man = ns.man.WarmManifest(str(tmp_path / ns.pd.__name__),
                                  cap_bytes=1 << 20)
        hx = "a" * 32
        man.record(hx, {"digest": "d1", "family": "f", "mesh_fp": "m",
                        "donation_sig": "s", "capacity": 0},
                   nbytes=100, compile_ms=1.0)
        out = [ra.publish_manifest(man), ra.publish_manifest(man)]
        cache_b = _StubCache(loadable={hx})
        out += [rb.adopt_from_peers(cache_b), cache_b.loaded,
                rb.adopt_from_peers(cache_b)]
        cache_a = _StubCache(loadable={hx})
        out.append(ra.adopt_from_peers(cache_a))
        doc, _ver = store.get("program/d1")
        out.append({hx: {k: v for k, v in e.items() if k != "ts"}
                    for hx, e in doc["entries"].items()})
        return out + [ra.stats(), rb.stats()]
    out = _both(run)
    assert out[:6] == [1, 0, 1, ["a" * 32], 0, 0]
    assert out[6]["a" * 32] == {"by": "a", "bytes": 100, "family": "f",
                                "capacity": 0}
    assert out[8]["peer_warm"] == 1 and out[7]["published"] == 1


def test_registry_quarantine_tombstone_purges_peers():
    def run(ns):
        store = ns.pd.PdStore(ns.pd.MemoryBackend())
        ra, rb = _registry(ns, store, "a"), _registry(ns, store, "b")
        ra.broadcast_quarantine("deadbeef")
        cache_b, cache_a = _StubCache(), _StubCache()
        return [rb.sync_quarantine(cache_b), cache_b.quarantined,
                rb.sync_quarantine(cache_b), ra.sync_quarantine(cache_a),
                rb.stats()]
    out = _both(run)
    assert out[:4] == [1, ["deadbeef"], 0, 0]
    assert out[4]["quarantine_purged"] == 1


def test_registry_counters_equal_over_one_call_sequence(tmp_path):
    """One seeded sequence of claims, releases, publications, adoptions
    and tombstones over three members: every counter of every member
    equals the JAX package's."""
    rng = np.random.default_rng(18)
    ops = [(int(rng.integers(0, 3)), int(rng.integers(0, 5)),
            int(rng.integers(0, 4))) for _ in range(60)]

    def run(ns):
        store = ns.pd.PdStore(ns.pd.MemoryBackend())
        regs = [_registry(ns, store, n) for n in "abc"]
        mans = []
        for n in "abc":
            man = ns.man.WarmManifest(str(tmp_path / ns.pd.__name__ / n),
                                      cap_bytes=1 << 20)
            mans.append(man)
        caches = [_StubCache(loadable={f"{k:032x}" for k in range(0, 9, 2)})
                  for _ in "abc"]
        trace = []
        for who, k, op in ops:
            r, hx = regs[who], f"{k:032x}"
            if op == 0:
                trace.append(r.try_claim(hx))
            elif op == 1:
                r.release_claim(hx)
            elif op == 2:
                mans[who].record(hx, {"digest": f"d{k}", "family": "f",
                                      "capacity": k}, nbytes=10 + k,
                                 compile_ms=1.0)
                trace.append(r.publish_manifest(mans[who]))
                trace.append(r.adopt_from_peers(caches[who]))
            else:
                r.broadcast_quarantine(f"d{k}")
                trace.append(regs[(who + 1) % 3].sync_quarantine(
                    caches[(who + 1) % 3]))
        return [trace, [r.stats() for r in regs],
                [c.loaded for c in caches], [c.quarantined for c in caches]]
    trace, stats, loaded, quarantined = _both(run)
    assert sum(s["claim_denials"] for s in stats) > 0
    assert sum(s["peer_warm"] for s in stats) > 0


# ------------------------------------------------------------------ #
# calibration sync: a factor learned in A prices B
# ------------------------------------------------------------------ #

def test_calibration_learned_in_a_reaches_b():
    def run(ns):
        store = ns.pd.PdStore(ns.pd.MemoryBackend())
        calib_a, calib_b = ns.cal.CorrectionStore(), ns.cal.CorrectionStore()
        ca = ns.pd.PdCoordinator(store, ns.rc.ResourceGroupManager(),
                                 member_id="a", calib=calib_a,
                                 cache=_StubCache())
        cb = ns.pd.PdCoordinator(store, ns.rc.ResourceGroupManager(),
                                 member_id="b", calib=calib_b,
                                 cache=_StubCache())
        cost = ns.cost.LaunchCost(input_bytes=1 << 20, output_bytes=1 << 10,
                                  flops=10 ** 7)
        digest = "c" * 32
        # A measures the program running 3x slower than the static model
        for _ in range(20):
            calib_a.observe(digest, cost,
                            int(ns.cal.predict_ms(cost) * 3.0 * 1e6))
        fa = calib_a.get(digest).time_factor
        before = calib_b.get(digest)
        ca.tick(force=True)              # A publishes into the calib key
        cb.tick(force=True)              # B folds the shared doc in
        fb = calib_b.get(digest).time_factor
        return [fa, before, fb, cb.calib_merged, ca.sync_total,
                cb.sync_total]
    fa, before, fb, merged, sa, sb = _both(run)
    assert fa > 1.5 and before is None
    assert fb == pytest.approx(fa, abs=1e-3)
    assert 1.0 / 8.0 <= fb <= 8.0
    assert merged >= 1 and sa == sb == 1


# ------------------------------------------------------------------ #
# the program cache's miss path holds the build claim
# ------------------------------------------------------------------ #

def test_program_cache_miss_claims_on_the_plane(tmp_path):
    """With pd on and a cache directory, a miss claims its entry (as the
    JAX cache does before its AOT compile): a peer's live claim counts a
    denial and the port builds anyway; a won claim is released."""
    from tidb_tpu_torch.analysis.compilekey import CompileKey
    from tidb_tpu_torch.compilecache import compile_cache
    cache = compile_cache()
    old_dir = cache.cache_dir
    dom_a, dom_b = Domain("cpu"), Domain("cpu")
    ca = ppd.configure_domain(dom_a, True)
    cb = ppd.configure_domain(dom_b, True)
    try:
        cache.configure(cache_dir=str(tmp_path / "cc"))
        ca.tick(force=True)
        cb.tick(force=True)

        def key(n):
            return CompileKey(f"pd-test-{n}", "fam", "mesh", "cap", "don",
                              "backend", 0)
        built = []
        # the peer holds the claim: a denial, and the build still runs
        assert cb.registry.try_claim(key(1).entry_hex())
        prog = cache.resolve(key(1), lambda: built.append(1) or "p1")
        assert prog == "p1" and built == [1]
        assert ca.registry.claim_denials == 1 and ca.registry.claims == 0
        # no peer claim: won, then released (no claim key stays behind)
        assert cache.resolve(key(2), lambda: "p2") == "p2"
        assert ca.registry.claims == 1
        assert ca.store.get("claim/" + key(2).entry_hex()) == (None, 0)
        # a hit claims nothing
        assert cache.resolve(key(2), lambda: "other") == "p2"
        assert ca.registry.claims == 1
    finally:
        cache.configure(cache_dir=old_dir)
        ppd.configure_domain(dom_a, False)
        ppd.configure_domain(dom_b, False)


# ------------------------------------------------------------------ #
# end-to-end: two Domains, one plane, store killed mid-traffic
# ------------------------------------------------------------------ #

def _pd_domain(n=200):
    """A port Domain on the CPU with a limited resource group bound to
    its session (the resource-group statements arrive with a later
    slice: the group is made on the Domain's manager directly)."""
    dom = Domain("cpu")
    s = Session(dom)
    rng = np.random.default_rng(7)
    a = rng.integers(1, 50, n)
    b = rng.integers(0, 10, n)
    s.execute("create table t (a bigint, b bigint)")
    s.execute("insert into t values "
              + ",".join(f"({x},{y})" for x, y in zip(a, b)))
    dom.resource_groups.create("shared", 100000)
    s.vars["tidb_resource_group"] = "shared"
    s.execute("set global tidb_tpu_result_cache_entries = 0")
    s.execute("set global tidb_tpu_pd = 1")
    m = (b < 7)
    return dom, s, int((a[m] * b[m]).sum())


def test_two_domains_share_plane_and_survive_store_loss():
    """Two Domains join one in-process store, split the shared group's
    refill budget, and killing the store mid-traffic completes every
    in-flight statement with zero failures while both members degrade
    to local slices."""
    dom1, s1, want1 = _pd_domain()
    dom2, s2, want2 = _pd_domain()
    q = "select sum(a*b) from t where b < 7"
    assert s1.execute(q).rows[0][0] == want1
    assert s2.execute(q).rows[0][0] == want2
    c1, c2 = dom1.pd, dom2.pd
    assert c1 is not None and c2 is not None and c1 is not c2
    assert c1.store.backend is c2.store.backend
    c1.tick(force=True)
    c2.tick(force=True)
    c1.tick(force=True)
    assert c1.member.joined() and c2.member.joined()
    shares = c1.quota.shares["shared"] + c2.quota.shares["shared"]
    assert shares == pytest.approx(100000, rel=1e-6)
    assert ppd.pd_status()["enabled"] and \
        len(ppd.pd_status()["members"]) == 2
    # ---- kill the store mid-traffic ------------------------------ #
    before = _counter("tidb_tpu_pd_degraded_total")
    c1.store.backend.down = True
    failures = 0
    for s, want in ((s1, want1), (s2, want2)) * 3:
        try:
            assert s.execute(q).rows[0][0] == want
        except Exception:            # noqa: BLE001 - counting failures
            failures += 1
    c1.tick(force=True)
    c2.tick(force=True)
    assert failures == 0             # degradation is never an error
    assert c1.member.degraded and c2.member.degraded
    assert _counter("tidb_tpu_pd_degraded_total") - before >= 2
    assert c1.quota.local_slices >= 1
    g1 = dom1.resource_groups.get("shared")
    assert g1.bucket.rate == pytest.approx(50000, rel=1e-3)
    # ---- store returns: rejoin + full resync --------------------- #
    c1.store.backend.down = False
    c1.tick(force=True)
    c2.tick(force=True)
    c1.tick(force=True)
    assert c1.member.joined() and c2.member.joined()
    assert c1.member.rejoins >= 1
    assert s1.execute(q).rows[0][0] == want1
    total = c1.quota.shares["shared"] + c2.quota.shares["shared"]
    assert total == pytest.approx(100000, rel=1e-6)
    s1.execute("set global tidb_tpu_pd = 0")
    s2.execute("set global tidb_tpu_pd = 0")
    assert s1.execute(q).rows[0][0] == want1
    assert s2.execute(q).rows[0][0] == want2
    assert dom1.pd is None
    assert g1.bucket.rate == pytest.approx(100000)


def test_drain_charges_the_leased_bucket():
    """The quota share lands in the rc bucket the scheduler's drain
    debits: a statement of the bound group charges its RUs there."""
    dom, s, want = _pd_domain()
    q = "select sum(a*b) from t where b < 7"
    assert s.execute(q).rows[0][0] == want
    dom.pd.tick(force=True)
    g = dom.resource_groups.get("shared")
    assert g.bucket.rate == pytest.approx(dom.pd.quota.shares["shared"])
    before = dom.client.sched_stats()["rc_debited_ru"]
    assert s.execute(q).rows[0][0] == want
    # the debit happens at batch admission, before the launch
    assert dom.client.sched_stats()["rc_debited_ru"] > before
    s.execute("set global tidb_tpu_pd = 0")


def test_pd_route_and_sched_section():
    from tidb_tpu_torch.server.status import StatusServer
    dom, s, want = _pd_domain()
    q = "select sum(a*b) from t where b < 7"
    assert s.execute(q).rows[0][0] == want
    dom.pd.tick(force=True)
    srv = StatusServer(dom)
    port = srv.start()
    try:
        body = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/pd", timeout=5).read())
        sched = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/sched", timeout=5).read())
    finally:
        srv.close()
    assert body["status"]["enabled"], body
    assert body["this_domain"]["member"]["epoch"] > 0, body
    assert body["status"]["store"]["n_keys"] >= 1, body
    assert "pd" in sched, sched
    assert sched["pd"]["enabled"], sched
    from tidb_tpu_torch.utils.metrics import global_registry
    text = global_registry().prometheus_text()
    assert "tidb_tpu_pd_sync_total" in text
    assert "tidb_tpu_pd_members" in text
    s.execute("set global tidb_tpu_pd = 0")


def test_breaker_trip_broadcasts_a_tombstone_that_purges_the_peer(tmp_path):
    """A launch breaker opened in Domain A (faults/ injection) leaves a
    quarantine tombstone on the plane; B's next sync purges the digest
    from its manifest entry (the chip's 19a check at CPU scale)."""
    from tidb_tpu_torch import faults
    from tidb_tpu_torch.compilecache import compile_cache
    cache = compile_cache()
    old_dir = cache.cache_dir
    dom_a, sa, want = _pd_domain()
    dom_b, sb, _w = _pd_domain()
    q = "select sum(a*b) from t where b < 7"
    try:
        sa.execute(f"set global tidb_tpu_compile_cache_dir = "
                   f"'{tmp_path / 'cc'}'")
        sb.execute(f"set global tidb_tpu_compile_cache_dir = "
                   f"'{tmp_path / 'cc'}'")
        # A attaches first: the process-wide hooks speak for the first
        # live coordinator, as the JAX package's do
        assert sa.execute(q).rows[0][0] == want
        cache.clear_pool()          # B's first run builds and records
        assert sb.execute(q).rows[0][0] == _w
        man = cache.manifest
        assert man is not None and man.stats()["entries"] >= 1
        # a poisoned launch fails every retry: the breaker opens on the
        # digest (its threshold of solo failures) and quarantines it
        faults.install(faults.FaultPlan.parse("launch:poison"))
        try:
            for _ in range(8):
                with pytest.raises(Exception):
                    sa.execute(q)
                if dom_a.pd.store.read_prefix("quarantine/"):
                    break
        finally:
            faults.clear()
        tomb = dom_a.pd.store.read_prefix("quarantine/")
        assert len(tomb) == 1, tomb
        digest = next(iter(tomb))[len("quarantine/"):]
        dom_b.pd.tick(force=True)
        assert dom_b.pd.registry.quarantine_purged == 1
        assert not man.has_program(digest)
    finally:
        dom_a.client._scheduler().breaker.reset()   # later files' DAGs
        sa.execute("set global tidb_tpu_pd = 0")
        sb.execute("set global tidb_tpu_pd = 0")
        cache.configure(cache_dir=old_dir)


# ------------------------------------------------------------------ #
# two real processes over the file backend
# ------------------------------------------------------------------ #

_SUBPROC = r"""
import json, sys
import numpy as np
from tidb_tpu_torch.session import Domain, Session

role, pd_dir, cache_dir = sys.argv[1], sys.argv[2], sys.argv[3]
dom = Domain("cpu")
s = Session(dom)
rng = np.random.default_rng(3)
a = rng.integers(1, 50, 400)
b = rng.integers(0, 10, 400)
s.execute("create table t (a bigint, b bigint)")
s.execute("insert into t values "
          + ",".join(f"({x},{y})" for x, y in zip(a, b)))
s.execute(f"set global tidb_tpu_compile_cache_dir = '{cache_dir}'")
s.execute(f"set global tidb_tpu_pd_dir = '{pd_dir}'")
s.execute("set global tidb_tpu_pd = 1")
q = "select sum(a*b) from t where b < 7"
got = s.execute(q).rows[0][0]
m = b < 7
assert got == int((a[m] * b[m]).sum()), (got, role)
dom.pd.tick(force=True)
if role == "b":
    dom.pd.tick(force=True)
from tidb_tpu_torch.compilecache import compile_cache
st = compile_cache().stats()
print(json.dumps({"role": role, "builds": st.get("misses", 0),
                  "warm_loaded": st.get("warm_loaded", 0),
                  "member": dom.pd.member.member_id,
                  "epoch": dom.pd.member.epoch,
                  "peer_warm": dom.pd.registry.peer_warm,
                  "members": sorted(dom.pd.store.members())}))
"""


@pytest.mark.slow
def test_two_processes_share_file_backend(tmp_path):
    """File-backend smoke: process A builds and publishes; process B
    joins the same pd dir, sees A's lease record in the store document,
    and adopts A's published manifest entries."""
    import subprocess
    import sys
    pd_dir = str(tmp_path / "pd")
    cache_dir = str(tmp_path / "cache")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(role):
        out = subprocess.run(
            [sys.executable, "-c", _SUBPROC, role, pd_dir, cache_dir],
            cwd=repo, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        return json.loads(out.stdout.strip().splitlines()[-1])
    ra = run("a")
    rb = run("b")
    assert ra["epoch"] > 0 and rb["epoch"] > ra["epoch"]
    assert os.path.exists(os.path.join(pd_dir, "pd.json"))

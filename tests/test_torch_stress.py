"""The chaos stress harness (testing/stress.py) through the port on the
CPU, against the JAX package's.

- Each ``STRESS_QUERIES`` statement gives the same sorted rows through
  the JAX session over the JAX ``build_stress_domain`` and through the
  port's session over the port's, both from one seed (the join planned
  as the shuffle join in both, as the harness plans it).
- Both harnesses, run over those domains with the same seed, return
  metrics dicts with the same keys, and the same sessions a group and
  a corpus shape, all of them right.
- The port's 64-session smoke at 30,000 rows with ``DEFAULT_CHAOS``
  armed meets the JAX smoke's bars (``tests/test_stress.py``):
  completion 1.0, no wrong or failed statement, every shape complete,
  RU fairness 1.0, no value drift, no more launches than tasks.
- The HBM ledger conserves over 32 and then 16 sessions.
- The full 1000-session rung is ``slow``, as the JAX package's is.

The port's domains sit on 8 logical CPU devices, as the JAX package's
see 8 CPU devices.  The JAX domain's platform is pinned to "tpu" by the
JAX ``build_stress_domain``, so its drain runs: its idle exit is
shortened and awaited when the module ends.
"""

import time

import pytest

import tidb_tpu.executor.plan as jplan
import tidb_tpu.sched.scheduler as jsched_mod
import tidb_tpu_torch.executor.plan as pplan
from tidb_tpu.analysis.calibrate import correction_store as jcorrections
from tidb_tpu.session import Session as JSession
from tidb_tpu.testing import stress as jstress
from tidb_tpu_torch.analysis.calibrate import correction_store
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.testing.stress import (DEFAULT_CHAOS, STRESS_QUERIES,
                                           build_stress_domain,
                                           run_stress_harness)

N_DEVICES = 8
PARITY_ROWS = 12_000


def _wait_until(pred, msg, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(scope="module")
def domains():
    """The JAX and the port stress domains at ``PARITY_ROWS`` rows."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsched_mod, "IDLE_EXIT_S", 0.2)
        jdom, js = jstress.build_stress_domain(n_rows=PARITY_ROWS)
        jdom.stats.auto_analyze_enabled = False
        js.execute("set global tidb_enable_auto_analyze = 0")
        pdom, _ps = build_stress_domain(n_rows=PARITY_ROWS, device="cpu",
                                        n_devices=N_DEVICES)
        yield jdom, pdom
        jsched = jdom.client._sched_obj
        _wait_until(lambda: jsched is None or jsched._thread is None,
                    "the JAX drain's exit")


def _quiet_retries(dom):
    """The scheduler with transient retries that do not sleep, and a
    function that puts it back."""
    sched = dom.client._scheduler()
    assert sched is not None
    saved = sched._retry_sleep
    sched._retry_sleep = lambda sec: None

    def restore(corrections):
        sched._retry_sleep = saved
        sched.breaker.reset()
        corrections().reset()
    return sched, restore


@pytest.mark.parametrize("i", range(len(STRESS_QUERIES)),
                         ids=[f"{t}{i}" for i, (t, _q)
                              in enumerate(STRESS_QUERIES)])
def test_stress_statement_equals_jax(domains, monkeypatch, i):
    """One corpus statement, its rows sorted as the harness compares
    them, equal through both sessions; the join planned as the shuffle
    join in both (the harness's zeroed broadcast threshold)."""
    jdom, pdom = domains
    assert STRESS_QUERIES[i] == jstress.STRESS_QUERIES[i]
    sql = STRESS_QUERIES[i][1]
    monkeypatch.setattr(jplan, "BROADCAST_BUILD_MAX_ROWS", 0)
    monkeypatch.setattr(pplan, "BROADCAST_BUILD_MAX_ROWS", 0)
    want = sorted(map(repr, JSession(jdom).must_query(sql)))
    got = sorted(map(repr, Session(pdom).must_query(sql)))
    assert got == want
    assert want, sql
    if STRESS_QUERIES[i][0] == "shuffle":
        plan = "\n".join(r[0] for r in Session(pdom).execute(
            "explain " + sql).rows)
        assert "CopShuffleJoin" in plan, plan


def test_harness_metrics_equal_jax_shape(domains):
    """Both harnesses over their domains, same seed, chaos armed: the
    same metric keys, the same sessions a group and a shape, and every
    session right in both."""
    jdom, pdom = domains
    outs = []
    for mod, dom, corrections in ((jstress, jdom, jcorrections),
                                  (None, pdom, correction_store)):
        _sched, restore = _quiet_retries(dom)
        try:
            run = mod.run_stress_harness if mod else run_stress_harness
            outs.append(run(dom, n_sessions=24, rate_per_s=400.0))
        finally:
            restore(corrections)
    want, got = outs
    assert list(got) == list(want)
    for out in (want, got):
        assert out["wrong_results"] == 0 and out["failed"] == 0, out
        assert out["completion_rate"] == 1.0, out
    assert got["per_group"] == want["per_group"]
    assert got["per_shape"] == want["per_shape"]
    assert got["chaos"] == want["chaos"] == DEFAULT_CHAOS


def test_stress_smoke_64_sessions_completion_and_zero_wrong():
    """The JAX smoke's bars, on the port at 30,000 rows."""
    dom, _s = build_stress_domain(n_rows=30_000, device="cpu",
                                  n_devices=N_DEVICES)
    _sched, restore = _quiet_retries(dom)
    try:
        out = run_stress_harness(dom, n_sessions=64, rate_per_s=400.0)
    finally:
        restore(correction_store)
    assert out["completion_rate"] == 1.0, out
    assert out["wrong_results"] == 0, out
    assert out["failed"] == 0, out
    tags = {tag for tag, _sql in STRESS_QUERIES}
    assert set(out["per_shape"]) == tags, out["per_shape"]
    for tag, v in out["per_shape"].items():
        assert v["ok"] == v["submitted"], (tag, v)
    assert out["sched_wait_p99_ms"] >= out["sched_wait_p50_ms"] >= 0
    assert 0.0 <= out["fusion_rate"] <= 1.0
    assert out["ru_fairness"] == 1.0
    assert out["calibration_entries"] > 0
    assert out["calibration_observed"] >= 0
    assert out["launches"] <= out["tasks"]
    assert out["value_drifts"] == 0, out


def _drained(led):
    deadline = time.monotonic() + 10.0
    while led.inflight_bytes and time.monotonic() < deadline:
        time.sleep(0.02)
    return led.inflight_bytes == 0


def test_stress_ledger_conserves_under_concurrency():
    """The HBM ledger conserves: launch bytes drain back out, no
    balance goes negative, a second wave adds no residency, and the
    watermark dominates every measured launch peak.  The port measures
    a launch's peak on the card only (``torch.cuda.max_memory_allocated``,
    ``DeviceScheduler._mem_mark``), so on the CPU no launch is measured;
    chip_smoke.py phase 21c holds the measured peaks on the card."""
    dom, _s = build_stress_domain(n_rows=20_000, device="cpu",
                                  n_devices=N_DEVICES)
    sched, restore = _quiet_retries(dom)
    assert sched.hbm_enable
    try:
        out = run_stress_harness(dom, n_sessions=32, rate_per_s=400.0)
        assert out["wrong_results"] == 0, out
        led = sched._ledger_obj
        assert led is not None, "ledger never engaged"
        assert _drained(led)
        assert led.negative_events == 0
        baseline = led.persistent_bytes
        assert baseline > 0
        out2 = run_stress_harness(dom, n_sessions=16, rate_per_s=400.0)
        assert out2["wrong_results"] == 0, out2
        assert _drained(led)
        assert led.persistent_bytes == baseline
        assert led.negative_events == 0
        assert led.watermark_bytes >= led.max_measured_bytes
        assert led.watermark_bytes >= led.persistent_bytes
        assert led.measured_launches == led.max_measured_bytes == 0
    finally:
        restore(correction_store)


@pytest.mark.slow
def test_stress_full_1k_sessions():
    """The full rung at the JAX package's bars: no wrong result,
    completion at least 0.98 through the busy-retry ladder, RU fairness
    below 1.5."""
    dom, _s = build_stress_domain(n_rows=60_000, device="cpu",
                                  n_devices=N_DEVICES)
    _sched, restore = _quiet_retries(dom)
    try:
        out = run_stress_harness(dom, n_sessions=1000, rate_per_s=200.0)
    finally:
        restore(correction_store)
    assert out["wrong_results"] == 0, out
    assert out["completion_rate"] >= 0.98, out
    assert out["ru_fairness"] is not None and out["ru_fairness"] < 1.5

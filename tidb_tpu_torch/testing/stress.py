# ported from tidb_tpu/testing/stress.py @ f4efee1
"""Chaos stress harness: N concurrent sessions over a mixed corpus.

The proving ground for the calibration loop: an open-loop arrival
process (arrivals never wait for completions — the "millions of users"
shape) drives a mixed device corpus — DENSE/scalar aggregates, SORT
group-by, SEGMENT high-NDV group-by, rows-kind filters, and a shuffle
join — through the full admission pipeline with the fault plane
(faults/) armed, across several resource groups.

One library, two rungs:

- the smoke: a 64-session rung asserting completion 1.0 and ZERO wrong
  results with chaos armed (tests/test_torch_stress.py on the CPU);
- the full rung: ~1000 sessions at 200 arrivals/s, landing p50/p99
  scheduler wait, fusion rate, RU fairness, completion rate and the
  calibrated-pricing error in its metrics dict (chip_smoke.py phase 21
  on the card).

Everything is deterministic given the seed (arrival draws, query picks,
the FaultPlan dice) except true thread interleaving.  The statements run
on the ``Domain``'s device: on the card every launch lands there.
"""

from __future__ import annotations

import threading
import time

import numpy as np

# mixed corpus over the stress schema (see build_stress_domain):
# (tag, sql) — tags label the per-shape completion breakdown
STRESS_QUERIES = [
    ("dense", "select sum(p * d) from stress_li "
              "where sd >= 200 and sd < 1500"),
    ("dense", "select count(*), max(p) from stress_li where d >= 5"),
    ("dense", "select min(p), sum(q) from stress_li where q > 10"),
    ("sort", "select d, count(*), sum(p) from stress_li "
             "where q < 40 group by d"),
    ("segment", "select k, count(*) from stress_li group by k"),
    ("rows", "select q, p from stress_li where p > 9900"),
    ("shuffle", "select count(*), sum(p + sp) from stress_li "
                "join stress_sup on d = sd2"),
]

DEFAULT_CHAOS = "seed=11,launch:transient:0.05"


def build_stress_domain(n_rows: int = 60_000, seed: int = 7,
                        device="cuda", n_devices: int = 1):
    """Domain on ``device`` + seeded mixed-corpus tables, result cache
    off so every statement actually dispatches."""
    from ..session import Domain, Session
    rng = np.random.default_rng(seed)
    dom = Domain(device, n_devices)
    s = Session(dom)
    s.execute("create table stress_li (q bigint, d bigint, p bigint, "
              "sd bigint, k bigint)")
    q = rng.integers(1, 50, n_rows)
    d = rng.integers(0, 10, n_rows)
    p = rng.integers(100, 10_000, n_rows)
    sd = rng.integers(0, 2000, n_rows)
    # high-NDV group key: NDV comfortably above SEGMENT_MIN_NDV (32768)
    # so ANALYZE-driven selection takes the radix SEGMENT path
    k = rng.integers(0, 50_000, n_rows)
    step = 10_000
    for lo in range(0, n_rows, step):
        s.execute("insert into stress_li values " + ",".join(
            f"({a},{b},{c},{e},{f})" for a, b, c, e, f in
            zip(q[lo:lo + step], d[lo:lo + step], p[lo:lo + step],
                sd[lo:lo + step], k[lo:lo + step])))
    s.execute("create table stress_sup (sd2 bigint, sp bigint)")
    s.execute("insert into stress_sup values " + ",".join(
        f"({i},{int(v)})" for i, v in
        enumerate(rng.integers(0, 100, 10))))
    s.execute("analyze table stress_li")
    s.execute("set global tidb_tpu_result_cache_entries = 0")
    # (the JAX package pins its client's platform to "tpu" here, so that
    # a CPU mesh still launches; the port keeps no CPU engine choice:
    # every aggregate launches on the Domain's device)
    return dom, s


def _expected_results(dom, queries) -> dict:
    """Oracle answers computed BEFORE chaos arms — the zero-wrong-
    results invariant compares every chaos-run result against these."""
    from ..session import Session
    return {sql: sorted(map(repr, Session(dom).must_query(sql)))
            for _tag, sql in queries}


def run_stress_harness(dom, n_sessions: int = 64,
                       rate_per_s: float = 400.0, n_groups: int = 4,
                       chaos: str = DEFAULT_CHAOS, seed: int = 7,
                       join_timeout_s: float = 600.0,
                       queries=None) -> dict:
    """Run the open-loop mixed-corpus stress rung and return its
    metrics dict.

    Every session is one thread: pick a resource group (round-robin
    over ``n_groups`` equal groups — the RU-fairness denominator), wait
    for its pre-drawn exponential arrival time, run one statement from
    the mixed corpus, compare against the pre-chaos oracle."""
    queries = STRESS_QUERIES if queries is None else queries
    sched = dom.client._scheduler()
    assert sched is not None, "scheduler did not engage"
    # zeroed broadcast threshold for the duration of the run: the join
    # statement plans as a CopShuffleJoin (exchange path).  Scoped
    # save/restore of the MODULE global (the built_tpch_plans idiom) —
    # a sysvar write would leak the zero process-wide to later tests.
    from ..executor import plan as _planmod
    saved_bm = _planmod.BROADCAST_BUILD_MAX_ROWS
    _planmod.BROADCAST_BUILD_MAX_ROWS = 0
    try:
        return _run_stress_inner(dom, sched, queries, n_sessions,
                                 rate_per_s, n_groups, chaos, seed,
                                 join_timeout_s)
    finally:
        _planmod.BROADCAST_BUILD_MAX_ROWS = saved_bm


def _run_stress_inner(dom, sched, queries, n_sessions, rate_per_s,
                      n_groups, chaos, seed, join_timeout_s) -> dict:
    from .. import faults
    from ..faults import FaultPlan
    from ..session import Session
    # groups: equal weight, unlimited RUs — fairness must come from the
    # weighted-fair drain, so max/min completion ratio ~ 1.0 is earned
    s0 = Session(dom)
    gnames = []
    for gi in range(n_groups):
        name = f"stress_g{gi}"
        s0.execute(f"create resource group if not exists {name} "
                   "RU_PER_SEC = 0")
        gnames.append(name)
    expected = _expected_results(dom, queries)

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_per_s, n_sessions))
    picks = rng.integers(0, len(queries), n_sessions)

    base = sched.stats()
    calib0 = base.get("calibration", {})
    mu = threading.Lock()
    counts = {"ok": 0, "wrong": 0, "failed": 0, "busy_retries": 0}
    per_group = {g: {"submitted": 0, "ok": 0} for g in gnames}
    per_tag: dict = {}
    errors: dict = {}

    def _is_backpressure(e: BaseException) -> bool:
        # ServerBusyError(9003) overflow/shed: the error TELLS the
        # client to back off and retry — a real MySQL client does
        return getattr(e, "errno", 0) == 9003

    def run(i: int) -> None:
        tag, sql = queries[picks[i]]
        group = gnames[i % n_groups]
        delay = t0 + arrivals[i] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        with mu:
            per_group[group]["submitted"] += 1
            per_tag.setdefault(tag, {"submitted": 0, "ok": 0})
            per_tag[tag]["submitted"] += 1
        sess = Session(dom)
        sess.execute(f"set resource group {group}")
        got = None
        for attempt in range(200):
            try:
                got = sorted(map(repr, sess.must_query(sql)))
                break
            except Exception as e:   # noqa: BLE001 counted, not raised
                if _is_backpressure(e) and attempt < 199:
                    # overload-graceful: bounded-queue backpressure is
                    # an invitation to retry, not a statement failure
                    with mu:
                        counts["busy_retries"] += 1
                    time.sleep(min(0.02 * (attempt + 1), 0.25))
                    continue
                with mu:
                    counts["failed"] += 1
                    key = type(e).__name__
                    errors[key] = errors.get(key, 0) + 1
                return
        with mu:
            if got == expected[sql]:
                counts["ok"] += 1
                per_group[group]["ok"] += 1
                per_tag[tag]["ok"] += 1
            else:
                counts["wrong"] += 1

    threads = [threading.Thread(target=run, args=(i,),
                                name=f"stress-{i}")
               for i in range(n_sessions)]
    if chaos:
        faults.install(FaultPlan.parse(chaos))
    t0 = time.monotonic()
    st = base
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=join_timeout_s)
        st = sched.stats()      # BEFORE faults.clear(): "injected"
    finally:                    # reads the armed plan's counters
        if chaos:
            faults.clear()
    elapsed = time.monotonic() - t0
    tasks = st["tasks_done"] - base["tasks_done"]
    launches = st["launches"] - base["launches"]
    rates = [g["ok"] / g["submitted"] for g in per_group.values()
             if g["submitted"]]
    calib = st.get("calibration", {}) or {}
    out = {
        "sessions": n_sessions,
        "arrival_rate_per_s": rate_per_s,
        "elapsed_s": round(elapsed, 3),
        "chaos": chaos or None,
        "injected": (st.get("faults") or {}).get("total_injected", 0),
        # correctness + completion (the invariants)
        "completion_rate": round(counts["ok"] / max(n_sessions, 1), 4),
        "wrong_results": counts["wrong"],
        "failed": counts["failed"],
        "busy_retries": counts["busy_retries"],
        "failure_kinds": dict(sorted(errors.items())),
        # latency + batching
        "sched_wait_p50_ms": st["wait_p50_ms"],
        "sched_wait_p99_ms": st["wait_p99_ms"],
        "tasks": tasks,
        "launches": launches,
        "fusion_rate": round(
            (st["fused_tasks"] - base["fused_tasks"]) / max(tasks, 1), 4),
        "coalesce_rate": round(
            (st["coalesced_tasks"] - base["coalesced_tasks"])
            / max(tasks, 1), 4),
        "launch_reduction": round(1.0 - launches / max(tasks, 1), 4),
        # RU fairness: max/min per-group completion ratio (1.0 = fair)
        "ru_fairness": round(max(rates) / max(min(rates), 1e-9), 3)
        if rates else None,
        "per_group": {g: dict(v) for g, v in sorted(per_group.items())},
        "per_shape": {t: dict(v) for t, v in sorted(per_tag.items())},
        # copmeter: recovery + shedding + calibrated-pricing error
        "retried_launches": st["retried_launches"]
        - base["retried_launches"],
        "oom_faults": st.get("oom_faults", 0)
        - base.get("oom_faults", 0),
        "shed_rejects": st.get("shed_rejects", 0)
        - base.get("shed_rejects", 0),
        "rc_exhausted": st.get("rc_exhausted", 0)
        - base.get("rc_exhausted", 0),
        # copnum: ANALYZE-stamped watermark drift observed at sched admit
        # (declared stats interval failed to contain observed min/max)
        "value_drifts": st.get("value_drifts", 0)
        - base.get("value_drifts", 0),
        "calibration_entries": calib.get("entries", 0),
        "calibration_observed": calib.get("observed", 0)
        - (calib0.get("observed", 0) or 0),
        "calibrated_err_pct": calib.get("mean_err_pct"),
    }
    return out


__all__ = ["STRESS_QUERIES", "DEFAULT_CHAOS", "build_stress_domain",
           "run_stress_harness"]

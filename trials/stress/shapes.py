"""Each statement of the stress corpus alone, then the harness at a few
rungs with and without the scheduler's admission wait: the walls that set
how many sessions a second the port serves.

    python trials/stress/shapes.py [--device cuda] [--rows 60000]
        [--rungs 64,1000] [--busy-wait 2.0,0]

Over ``testing.stress.build_stress_domain`` on ``--device`` (one device):
each ``STRESS_QUERIES`` statement's first and warm walls with the
session's split (parse, plan, execute, decode) and the client's (device,
merge and the rest), the join planned as the harness plans it; then
``run_stress_harness`` at each rung (200 arrivals a second,
``DEFAULT_CHAOS``) once under each ``--busy-wait`` (the scheduler's
``busy_wait_s``: how long a submit to a full queue waits for a slot
before the 9003 busy error; 0 answers 9003 at once), its metrics dict on
a line.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=60_000)
    ap.add_argument("--rungs", default="64,1000")
    ap.add_argument("--busy-wait", default="2.0,0")
    ap.add_argument("--warm", type=int, default=5)
    args = ap.parse_args()
    import torch
    from tidb_tpu_torch.executor import plan as pplan
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.testing.stress import (STRESS_QUERIES,
                                               build_stress_domain,
                                               run_stress_harness)
    if args.device == "cuda":
        print(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    dom, _s = build_stress_domain(args.rows, device=args.device)
    print(f"domain rows={args.rows} s={time.perf_counter() - t0:.2f}")
    sess = Session(dom)
    saved = pplan.BROADCAST_BUILD_MAX_ROWS
    pplan.BROADCAST_BUILD_MAX_ROWS = 0
    try:
        for tag, sql in STRESS_QUERIES:
            t1 = time.perf_counter()
            rows = sess.must_query(sql)
            first = time.perf_counter() - t1
            walls = []
            for _ in range(args.warm):
                t1 = time.perf_counter()
                sess.must_query(sql)
                walls.append(time.perf_counter() - t1)
            st = {k: round(v * 1e3, 3) for k, v in sess.timings.items()}
            ct = {k: (round(v * 1e3, 3) if isinstance(v, float) else v)
                  for k, v in dom.client.timings.items()}
            print(f"shape {tag}: out_rows={len(rows)} "
                  f"first_ms={first * 1e3:.3f} "
                  f"warm_ms={statistics.median(walls) * 1e3:.3f} "
                  f"session={st} client={ct}")
    finally:
        pplan.BROADCAST_BUILD_MAX_ROWS = saved
    sched = dom.client._scheduler()
    sched._retry_sleep = lambda sec: None
    for n in (int(x) for x in args.rungs.split(",")):
        for wait in (float(x) for x in args.busy_wait.split(",")):
            sched.busy_wait_s = wait
            out = run_stress_harness(dom, n_sessions=n, rate_per_s=200.0)
            sched.breaker.reset()
            print(f"rung {n} busy_wait_s={wait}: " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

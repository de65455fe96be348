"""Time chip_smoke.py's group_reduce lane sets (phase 4's
``group_reduce_lanes_phase``) of several checkouts in turn on one card:
the way to tell a slower kernel from a slower host.

    python trials/group_reduce/lanes_ab.py DIR [DIR ...]

Each DIR is the root of a checkout (its ``chip_smoke.py`` and
``tidb_tpu_torch``), run in a process of its own in the order given
(e.g. parent, change, change, parent).  Each process builds
``group_reduce.cu`` from its checkout, checks every lane set against its
plain version as phase 4 does, and prints one JSON line of the lane
sets' kernel ms; a table of them follows.
"""

import json
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from tidb_tpu_torch.copr.cuda import group_reduce as gr
cs.build_phase(gr)
out = cs.group_reduce_lanes_phase(torch, gr, torch.device("cuda", 0))
print("LANES " + json.dumps({k: v["ms"] for k, v in out.items()}))
"""


def main() -> int:
    dirs = sys.argv[1:]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    rows = []
    for d in dirs:
        p = subprocess.run([sys.executable, "-c", CHILD, d], cwd=d,
                           capture_output=True, text=True, timeout=600)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("LANES ")]
        if p.returncode or not lines:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            return 1
        rows.append((d, json.loads(lines[-1][len("LANES "):])))
        print(f"{d}: {lines[-1][len('LANES '):]}", flush=True)
    names = list(rows[0][1])
    print("lane set | " + " | ".join(d for d, _ in rows))
    for name in names:
        print(f"{name} | " + " | ".join(f"{r[name]:.4f}" for _, r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

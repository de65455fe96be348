# ported from tidb_tpu/testing/bench_host.py @ 12e5c50
"""Micro-bench: parallel host operators vs serial (P10 worker-pool seam,
projection.go:205 / hash-join probe workers analog).  Run on a multi-core
host: `python -m tidb_tpu_torch.testing.bench_host [--rows N]`.  On a
1-core container the pool clamps to the direct path and this prints
~1.0x parity.

The JAX package's script runs at import; this one runs only from
``main()``, whose row count is a parameter (default 6,000,000, the JAX
script's)."""
import argparse
import time

import numpy as np

from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.executor.physical import (ExecContext, HostProjection,
                                              HostHashJoin, PhysOp,
                                              ResultChunk)
from tidb_tpu_torch.expr import builders as B
from tidb_tpu_torch.expr.ir import ColumnRef
from tidb_tpu_torch.types import dtypes as dt

BI = dt.bigint(False)
ROWS = 6_000_000
CH = 64 * 1024
BUILD_ROWS = 100_000


def main(n: int = ROWS, build_n: int = BUILD_ROWS) -> dict:
    """Time the projection and the hash-join probe over ``n`` rows,
    serial and 8-way; prints both lines and returns the seconds and
    rows of each run."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 1 << 40, n)
    d2 = rng.integers(1, 1 << 20, n)

    class Src(PhysOp):
        out_names = ["a", "b"]
        out_dtypes = [BI, BI]

        def chunks(self, ctx, required_rows=None):
            for lo in range(0, n, CH):
                yield ResultChunk(["a", "b"], [
                    Column(BI, data[lo:lo + CH],
                           np.ones(min(CH, n - lo), bool)),
                    Column(BI, d2[lo:lo + CH],
                           np.ones(min(CH, n - lo), bool))])

    a, b = ColumnRef(BI, 0, "a"), ColumnRef(BI, 1, "b")
    # expensive-ish projection: mixed arithmetic chains
    exprs = [B.arith("mul", B.arith("add", a, b), B.arith("mod", a, b)),
             B.arith("mod", B.arith("mul", a, a), B.arith("add", b,
                                                           B.lit(7))),
             B.arith("add", B.arith("intdiv", a, b), B.arith("mul", b, b))]
    proj = HostProjection(Src(), exprs, out_names=["x", "y", "z"])

    def run(op, conc):
        ctx = ExecContext(None, {"tidb_executor_concurrency": conc})
        t = time.time()
        rows = sum(ch.num_rows for ch in op.chunks(ctx))
        return time.time() - t, rows

    run(proj, 1)
    t1, r1 = run(proj, 1)
    t8, r8 = run(proj, 8)
    print(f"projection: serial {t1*1e3:.0f}ms  8-way {t8*1e3:.0f}ms  "
          f"speedup {t1/t8:.2f}x  rows={r1}")
    assert r1 == r8 == n

    # hash join probe: n probe rows vs build_n build rows
    bk = rng.integers(0, 1 << 20, build_n)

    class BuildSrc(PhysOp):
        out_names = ["k", "w"]
        out_dtypes = [BI, BI]

        def execute(self, ctx):
            return ResultChunk(["k", "w"], [
                Column(BI, bk, np.ones(build_n, bool)),
                Column(BI, bk * 2, np.ones(build_n, bool))])

    join = HostHashJoin("inner", Src(), BuildSrc(), [(1, 0)], [],
                        out_names=["a", "b", "k", "w"],
                        out_dtypes=[BI, BI, BI, BI])
    run(join, 1)
    tj1, rj1 = run(join, 1)
    tj8, rj8 = run(join, 8)
    print(f"hash join:  serial {tj1*1e3:.0f}ms  8-way {tj8*1e3:.0f}ms  "
          f"speedup {tj1/tj8:.2f}x  rows={rj1}")
    assert rj1 == rj8
    return {"projection": (t1, t8, r1), "hash_join": (tj1, tj8, rj1)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    main(ap.parse_args().rows)

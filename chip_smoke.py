#!/usr/bin/env python3
"""Drive the PyTorch port (tidb_tpu_torch) on one CUDA GPU and check it.

    python3 chip_smoke.py            # SF=1: 6,000,000 lineitem rows
    python3 chip_smoke.py --sf 0.05  # a quicker run at a smaller scale
    python3 chip_smoke.py --perm-of DIR   # only scatter_permutation's
                                          # time, of DIR/tidb_tpu_torch

Phases, each printing one line or more; any failure raises and the
script exits non-zero without printing a result:

1. device: the GPU's name and ``nvidia-smi`` name and power limit;
2. build: compile the CUDA kernels from the sources in this checkout;
3. kernels: each kernel at the main path's shape (8,388,608 rows,
   values = arange) on uniform partition keys and on query A's skew
   (28.5% of the rows on the dead rows' tail key) against its plain
   PyTorch version on the card, exactly; kernel, plain,
   library-yardstick and memory-bound times at the kernel's tile; the
   whole pass; ``scatter_permutation`` (4 passes) for B = 2^22 and
   2^23 against the plain partition;
4. reference: a small lineitem through the port on the GPU and through
   its plain path on the CPU, whose per-device states and results must
   be equal;
5. slice: TPC-H lineitem at ``--sf`` and the two high-NDV GROUP BY
   queries through ``CopClient(device="cuda").execute_agg``, results
   equal to a numpy oracle, the kernel launch counts equal to the
   radix passes the client ran;
6. the ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Query A is the grouping inside TPC-H Q18; query B is a corpus query of
the JAX package's TPC-H plan set:
    A: select l_orderkey, sum(l_quantity), count(*) from lineitem
       group by l_orderkey
    B: select l_orderkey, l_suppkey, max(l_extendedprice) from lineitem
       where l_quantity < 45 group by l_orderkey, l_suppkey
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
CUDA_CORE_OPS_PER_S = 67e12      # H100 SXM non-tensor fp32 rate, per op
KERNEL_ROWS = 8_388_608          # padded rows of one device batch at SF=1
REPS = 15


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = REPS, flush=None,
            clean: bool = False) -> float:
    """Median milliseconds of ``fn`` by CUDA events, one launch per
    sample after a warm-up; ``flush`` (a large tensor) is overwritten
    before each sample so inputs come from HBM, not the 50 MB L2.  The
    overwrite leaves the L2 full of dirty lines, which the sample writes
    back as it evicts them, as a pass meets the lines the previous pass
    wrote; ``clean=True`` reads ``flush`` instead, so the L2 holds clean
    lines and the sample pays for its own bytes only."""
    times = []
    for i in range(reps + 1):
        if flush is not None and clean:
            flush.sum()
        elif flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- #
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------- #

LIVE_SHARE_A = 0.715        # live rows of query A's device batch at SF=1
KEY_BITS = 30               # partition key bits below the tail key, B>=2^22


def main_path_keys(torch, dev, dist: str, seed: int = 1):
    """int32 partition keys of the main path's shape: uniform in
    [0, 2^30), or query A's skew, where the dead and pad rows (28.5% of
    the batch at SF=1) all take the tail key 2^30."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    key = torch.randint(0, 1 << KEY_BITS, (KERNEL_ROWS,), generator=gen,
                        device=dev, dtype=torch.int32)
    if dist == "tail skew":
        dead = torch.rand(KERNEL_ROWS, generator=gen, device=dev) \
            >= LIVE_SHARE_A
        key[dead] = 1 << KEY_BITS
    return key


def time_kernels(torch, rk, key, val, flush) -> dict:
    """Each kernel at shift 0 against its plain version, exactly, with
    kernel, plain and library-yardstick times and the memory bound at
    the kernel's tile."""
    n = key.numel()
    tiles = rk.n_tiles(n)
    err = rk.new_err(key.device)
    out = {}

    hist = rk.radix_hist(key, 0)
    plain = rk.radix_hist_plain(key, 0)
    torch.cuda.synchronize()
    err_hist = int((hist - plain).abs().max())
    check(torch.equal(hist, plain), "radix_hist != radix_hist_plain")
    h2 = torch.empty_like(hist)
    ms = cuda_ms(torch, lambda: rk.launch_hist(key, 0, h2, err), flush=flush)
    plain_ms = cuda_ms(torch, lambda: rk.radix_hist_plain(key, 0),
                       flush=flush)
    dig = key & (rk.N_DIGITS - 1)
    flat_key = (torch.arange(n, device=key.device, dtype=torch.int64)
                // rk.KERNEL_TILE) * rk.N_DIGITS + dig
    lib = torch.bincount(flat_key, minlength=tiles * rk.N_DIGITS)
    check(torch.equal(lib.view(tiles, rk.N_DIGITS).to(torch.int32), hist),
          "bincount yardstick != radix_hist")
    lib_ms = cuda_ms(torch, lambda: torch.bincount(
        flat_key, minlength=tiles * rk.N_DIGITS), flush=flush)
    b_ms, b_by = bound_ms(4 * n + 4 * rk.N_DIGITS * tiles, n)
    out["radix_hist"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=err_hist,
                             clean_ms=cuda_ms(torch, lambda: rk.launch_hist(
                                 key, 0, h2, err), flush=flush, clean=True))

    # radix_scatter, given the exclusive offsets of that histogram
    offs = rk.exclusive_offsets(hist)
    got = rk.radix_scatter(key, val, offs, 0)
    plain = rk.radix_scatter_plain(key, val, offs, 0)
    torch.cuda.synchronize()
    err_sc = max(int((g - p).abs().max()) for g, p in zip(got, plain))
    check(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]),
          "radix_scatter != radix_scatter_plain")
    k2, v2 = torch.empty_like(key), torch.empty_like(val)
    ms = cuda_ms(torch, lambda: rk.launch_scatter(key, val, offs, 0, k2, v2,
                                                  err), flush=flush)
    plain_ms = cuda_ms(torch, lambda: rk.radix_scatter_plain(key, val, offs,
                                                             0), flush=flush)
    lib = torch.sort(dig, stable=True).indices
    check(torch.equal(val[lib], got[1]),
          "stable sort yardstick != radix_scatter")
    lib_ms = cuda_ms(torch, lambda: torch.sort(dig, stable=True),
                     flush=flush)
    b_ms, b_by = bound_ms(16 * n + 4 * rk.N_DIGITS * tiles, 4 * n)
    out["radix_scatter"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                max_abs_err=err_sc,
                                clean_ms=cuda_ms(torch, lambda: rk.launch_scatter(
                                    key, val, offs, 0, k2, v2, err),
                                    flush=flush, clean=True))
    check(int(err.item()) == 0, "a timed launch reported an error")

    # the whole pass: wrapper (hist, cumsum, scatter, one error
    # read-back) against the 1-bit plain pass
    full = rk.counting_sort_pass(key, val, 0)
    ref = rk.counting_sort_pass_plain(key, val, 0)
    check(torch.equal(full[0], ref[0]) and torch.equal(full[1], ref[1]),
          "counting_sort_pass != counting_sort_pass_plain")
    out["pass_ms"] = cuda_ms(torch, lambda: rk.counting_sort_pass(key, val,
                                                                  0),
                             flush=flush)
    out["pass_plain_ms"] = cuda_ms(torch, lambda: rk.counting_sort_pass_plain(
        key, val, 0), flush=flush)
    return out


def time_scatter_permutation(torch, radix, dev, flush) -> dict:
    """``scatter_permutation`` (partition key, 4 radix passes, the error
    read-back) at the main path's row count for B = 2^22 and 2^23, held
    against the 1-bit plain partition on the card."""
    from tidb_tpu_torch.copr import dag as D
    n = KERNEL_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    h = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=gen,
                      device=dev, dtype=torch.int64)
    sel = torch.rand(n, generator=gen, device=dev) < LIVE_SHARE_A
    out = {}
    for b in (1 << 22, 1 << 23):
        got = radix.scatter_permutation(h, sel, b, n)
        key = radix.partition_key(h, sel, b)
        want = radix._partition_plain(key, D.radix_key_bits(b), n)
        check(torch.equal(got, want),
              f"scatter_permutation B={b} != the plain partition")
        out[b] = cuda_ms(torch, lambda: radix.scatter_permutation(
            h, sel, b, n), flush=flush)
        print(f"scatter_permutation: n={n} B={b} "
              f"passes={D.radix_passes(b)} exact=True "
              f"ms={out[b]:.4f}")
    return out


def kernel_phase(torch, rk, radix, dev) -> dict:
    """Both kernels on uniform keys and on query A's tail-key skew; the
    ``kernels`` line reports the uniform run."""
    val = torch.arange(KERNEL_ROWS, dtype=torch.int32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MiB
    runs = {}
    for dist in ("uniform", "tail skew"):
        r = runs[dist] = time_kernels(
            torch, rk, main_path_keys(torch, dev, dist), val, flush)
        for name in ("radix_hist", "radix_scatter"):
            k = r[name]
            print(f"kernel {name} [{dist}]: n={KERNEL_ROWS} "
                  f"tile={rk.KERNEL_TILE} exact=True "
                  f"kernel_ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
                  f"library_ms={k['library_ms']:.4f} "
                  f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) "
                  f"of_bound={k['bound_ms'] / k['ms']:.3f} "
                  f"kernel_ms_clean_l2={k['clean_ms']:.4f}")
        print(f"pass counting_sort_pass [{dist}]: n={KERNEL_ROWS} exact=True "
              f"ms={r['pass_ms']:.4f} plain_1bit_ms={r['pass_plain_ms']:.4f}")
    time_scatter_permutation(torch, radix, dev, flush)
    return {name: runs["uniform"][name]
            for name in ("radix_hist", "radix_scatter")}


# --------------------------------------------------------------------- #
# phases 4-5: the slice
# --------------------------------------------------------------------- #

A_COLS = ["l_orderkey", "l_quantity"]
B_COLS = ["l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice"]


def build_query(which: str, num_buckets: int = 0):
    """(aggregation, key metas) of query A or B over the B_COLS / A_COLS
    snapshot layout; ``num_buckets=0`` lets the client start from its
    default bucket space and regrow."""
    from tidb_tpu_torch.copr import dag as D
    from tidb_tpu_torch.copr.aggregate import GroupKeyMeta, sum_out_dtype
    from tidb_tpu_torch.expr import builders as b
    from tidb_tpu_torch.expr.ir import ColumnRef
    from tidb_tpu_torch.types import dtypes as dt
    dec2, i64 = dt.decimal(15, 2), dt.bigint(False)
    if which == "A":
        scan = D.TableScan((0, 1), (i64, dec2))
        aggs = (D.AggDesc(D.AggFunc.SUM, ColumnRef(dec2, 1),
                          sum_out_dtype(dec2)),
                D.AggDesc(D.AggFunc.COUNT, None, i64))
        return (D.Aggregation(scan, (ColumnRef(i64, 0),), aggs,
                              D.GroupStrategy.SCATTER,
                              num_buckets=num_buckets),
                [GroupKeyMeta(i64, 0)])
    scan = D.TableScan((0, 1, 2, 3), (i64, i64, dec2, dec2))
    cond = b.compare("lt", ColumnRef(dec2, 2), b.lit(45))
    aggs = (D.AggDesc(D.AggFunc.MAX, ColumnRef(dec2, 3),
                      dec2.with_nullable(True)),)
    return (D.Aggregation(D.Selection(scan, (cond,)),
                          (ColumnRef(i64, 0), ColumnRef(i64, 1)), aggs,
                          D.GroupStrategy.SCATTER, num_buckets=num_buckets),
            [GroupKeyMeta(i64, 0), GroupKeyMeta(i64, 0)])


def oracle(which: str, cols: dict) -> tuple[list, list]:
    """numpy answer: (key arrays, value arrays), groups in key order."""
    ok = cols["l_orderkey"].data
    qty = cols["l_quantity"].data
    if which == "A":
        u, inv = np.unique(ok, return_inverse=True)
        s = np.zeros(len(u), np.int64)
        np.add.at(s, inv, qty)
        return [u], [s, np.bincount(inv, minlength=len(u))]
    keep = qty < 4500
    keys = np.stack([ok[keep], cols["l_suppkey"].data[keep]], axis=1)
    u, inv = np.unique(keys, axis=0, return_inverse=True)
    mx = np.full(len(u), np.iinfo(np.int64).min)
    np.maximum.at(mx, inv.reshape(-1), cols["l_extendedprice"].data[keep])
    return [u[:, 0], u[:, 1]], [mx]


def result_arrays(res) -> tuple[list, list]:
    keys = [np.asarray(c.data).astype(np.int64) for c in res.key_columns]
    order = np.lexsort(keys[::-1])
    vals = [np.array([int(x) for x in c.data], dtype=np.int64)[order]
            if c.data.dtype == object else np.asarray(c.data)[order]
            for c in res.columns]
    for c in res.columns + res.key_columns:
        check(bool(np.asarray(c.validity).all()), "unexpected NULL output")
    return [k[order] for k in keys], vals


def leaves(tree: dict, prefix: str = ""):
    """(dotted name, tensor) of every leaf of a nested state dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def reference_phase(torch, dev) -> None:
    """A small lineitem through the GPU path and through the plain CPU
    path: per-device states and final results must be equal."""
    from tidb_tpu_torch.parallel.spmd import ShardedCopProgram
    from tidb_tpu_torch.store import CopClient, snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    names, cols = gen_lineitem(0.01, seed=3, columns=B_COLS)
    bycol = dict(zip(names, cols))
    for which in ("A", "B"):
        use = A_COLS if which == "A" else B_COLS
        snap = snapshot_from_columns(use, [bycol[c] for c in use])
        agg, meta = build_query(which, 1 << 16)
        st = {}
        for d in (dev, torch.device("cpu")):
            cols_d, counts = snap.device_cols((d,))
            st[d.type] = ShardedCopProgram(agg, (d,))(cols_d, counts)
        flat = {side: dict(leaves(tree)) for side, tree in st.items()}
        check(flat["cuda"].keys() == flat["cpu"].keys(), "state names")
        for k in flat["cpu"]:
            check(torch.equal(flat["cuda"][k].cpu(), flat["cpu"][k]),
                  f"query {which}: GPU state {k} != CPU plain state")
        gpu = result_arrays(CopClient("cuda").execute_agg(agg, snap, meta))
        cpu = result_arrays(CopClient("cpu", 8).execute_agg(agg, snap, meta))
        want = oracle(which, bycol)
        for got in (gpu, cpu):
            for g, w in zip(got[0] + got[1], want[0] + want[1]):
                check(np.array_equal(g, w), f"query {which}: small result")
        print(f"reference query {which}: rows={len(cols[0])} "
              f"groups={len(want[0][0])} gpu_states==cpu_states=True "
              f"gpu==cpu==numpy=True")


def slice_phase(torch, rk, sf: float) -> dict:
    from tidb_tpu_torch.copr import dag as D
    from tidb_tpu_torch.store import CopClient, snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    t0 = time.perf_counter()
    names, cols = gen_lineitem(sf, seed=0, columns=B_COLS)
    bycol = dict(zip(names, cols))
    n_rows = len(cols[0])
    print(f"data: lineitem sf={sf} rows={n_rows} "
          f"gen_s={time.perf_counter() - t0:.2f}")
    for name in rk.LAUNCHES:           # counts of the main path only
        rk.LAUNCHES[name] = 0
    expected = 0
    for which in ("A", "B"):
        use = A_COLS if which == "A" else B_COLS
        snap = snapshot_from_columns(use, [bycol[c] for c in use])
        agg, meta = build_query(which)
        client = CopClient(device="cuda")
        before = dict(rk.LAUNCHES)
        t0 = time.perf_counter()
        res = client.execute_agg(agg, snap, meta)
        wall = time.perf_counter() - t0
        t = client.timings
        passes = [D.radix_passes(b) for b in t["buckets"]]
        for name in rk.LAUNCHES:
            got = rk.LAUNCHES[name] - before[name]
            check(got == sum(passes),
                  f"query {which}: {name} launched {got} times for "
                  f"{sum(passes)} radix passes")
        expected += sum(passes)
        want = oracle(which, bycol)
        got = result_arrays(res)
        check(len(got[0][0]) == len(want[0][0]),
              f"query {which}: {len(got[0][0])} groups, want "
              f"{len(want[0][0])}")
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            check(np.array_equal(g, w), f"query {which}: result != numpy")
        print(f"slice query {which}: rows={n_rows} groups={len(want[0][0])} "
              f"ms={wall * 1e3:.1f} rows_per_s={n_rows / wall:.0f} "
              f"buckets={t['buckets']} passes={passes} "
              f"hist_launches={sum(passes)} scatter_launches={sum(passes)} "
              f"place_ms={t['place'] * 1e3:.1f} hash_ms={t['hash'] * 1e3:.1f} "
              f"device_ms={t['device'] * 1e3:.1f} "
              f"transfer_ms={t['transfer'] * 1e3:.1f} "
              f"merge_ms={t['merge'] * 1e3:.1f} exact=True")
    counts = dict(rk.LAUNCHES)
    for name, c in counts.items():
        check(c == expected and c > 0, f"{name}: {c} main-path launches")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of the slice phase")
    ap.add_argument("--perm-of", metavar="DIR",
                    help="only time scatter_permutation of the "
                         "tidb_tpu_torch package found in DIR (e.g. an "
                         "unpacked parent commit) and stop")
    args = ap.parse_args()
    if args.perm_of:
        sys.path.insert(0, args.perm_of)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    from tidb_tpu_torch.copr import radix
    from tidb_tpu_torch.copr.cuda import radix_kernel as rk

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"python={sys.version.split()[0]}")
    print(smi)
    if args.perm_of:
        print(f"scatter_permutation of {radix.__file__}")
        flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
        time_scatter_permutation(torch, radix, dev, flush)
        return 0

    t0 = time.perf_counter()
    so = rk.build()
    rk._load()
    regs = [ln.strip() for log in rk.BUILD_LOG for ln in log.splitlines()
            if "registers" in ln or "Compiling entry" in ln
            or "spill" in ln]
    print(f"build: {so.name} seconds={time.perf_counter() - t0:.2f} "
          f"ptxas={' | '.join(regs)}")

    kern = kernel_phase(torch, rk, radix, dev)
    reference_phase(torch, dev)
    counts = slice_phase(torch, rk, args.sf)

    src = "tidb_tpu_torch/copr/cuda/radix_kernel.cu"
    replaces = {"radix_hist": "tidb_tpu/copr/pallas/radix_kernel.py:92",
                "radix_scatter": "tidb_tpu/copr/pallas/radix_kernel.py:105"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], "launches": counts[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in kern.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Row limits of one device batch, at lowered module constants.

The port computes where one device batch passes a limit of its
kernels, as the JAX package computes (with one sort, or one XLA
reduction); each case lowers the constant with ``monkeypatch`` so the
branch runs at a small ``n``, and compares with the JAX package on the
same inputs:

- a float-sum state table over ``MAX_FLOAT_SUM_ROWS`` rows or more
  (the exact limbs of the float-sum lanes) is reduced in chunks under
  it and the chunks' tables combine; within ``FLOAT_RTOL`` of the JAX
  ``_reduce``, every other lane exactly;
- a TopN past ``ops/sort._MAX_ROWS`` rows (the sort's int32
  permutation) takes the top k of each chunk, then of the candidates:
  bit-equal to the JAX package's one sort, ties in row order;
- a SORT or SEGMENT group-by past it runs each device's batch as
  parts, each part's table one more for the host merge; the limb SUMs'
  2^31-row bound (``LIMB_SUM_ROWS``) still raises for the whole batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.copr import exec as jexec
from tidb_tpu.copr.aggregate import GroupKeyMeta as JMeta
from tidb_tpu_torch.copr import exec as port_exec
from tidb_tpu_torch.copr.aggregate import GroupKeyMeta
from tidb_tpu_torch.copr.cuda import group_reduce as gr
from tidb_tpu_torch.copr.cuda.group_reduce import Lane
from tidb_tpu_torch.ops import sort as S
from tidb_tpu_torch.parallel import spmd
from tidb_tpu_torch.store import CopClient

from test_torch_highndv import (_JaxNS, _PortNS, _as_map, _jclient,
                                _mixed_agg, _mixed_snaps)
from test_torch_rows import _execute_both, _topn, _topn_snaps

FLOAT_RTOL = 1e-12


# ------------------------------------------------------------------ #
# float sums past the exact limbs
# ------------------------------------------------------------------ #

def _lane_inputs(n, G, seed=2):
    rng = np.random.default_rng(seed)
    f = rng.normal(0.0, 1e6, n)
    iv = rng.integers(-2 ** 40, 2 ** 40, n)
    m = rng.random(n) < 0.8
    sel = rng.random(n) < 0.9
    gids = None if G == 1 else rng.integers(0, G + 1, n)   # G: the sink
    return f, iv, m & sel, sel, gids


@pytest.mark.parametrize("G", [1, 12, 5000])
def test_float_sum_past_the_limb_rows_reduces_in_chunks(G, monkeypatch):
    n = 10_000
    f, iv, m, sel, gids = _lane_inputs(n, G)
    tf, ti = torch.from_numpy(f), torch.from_numpy(iv)
    tm, tsel = torch.from_numpy(m), torch.from_numpy(sel)
    tg = None if gids is None else torch.from_numpy(gids)
    rows = Lane("count", None, tsel)
    cnt = Lane("count", None, tm)
    plan = {"__rows__": rows,
            "a0": {"sum": Lane("fsum", tf, tm), "cnt": cnt},
            "a1": {"hi": Lane("sum_hi32", ti, tm),
                   "lo": Lane("sum_lo32", ti, tm), "cnt": cnt},
            "a2": {"min": Lane("fmin", tf, tm), "cnt": cnt},
            "a3": {"max": Lane("max", ti, tm), "cnt": cnt}}
    calls = []
    reduce = port_exec.group_reduce_lanes
    monkeypatch.setattr(port_exec, "group_reduce_lanes",
                        lambda *a: calls.append(1) or reduce(*a))
    monkeypatch.setattr(gr, "MAX_FLOAT_SUM_ROWS", 1024)
    got = port_exec.reduce_states(plan, tg, G)
    assert len(calls) == -(-n // 1023)
    jg = None if gids is None else jnp.asarray(gids)

    def jax_reduce(v, mask, how):
        return np.asarray(jexec._reduce(jnp.asarray(v), jnp.asarray(mask),
                                        jg, G, how))
    want = {"__rows__": jax_reduce(np.ones(n, np.int64), sel, "sum"),
            "a0.sum": jax_reduce(f, m, "sum"),
            "cnt": jax_reduce(np.ones(n, np.int64), m, "sum"),
            "a1.hi": jax_reduce(iv >> 32, m, "sum"),
            "a1.lo": jax_reduce(iv & 0xFFFFFFFF, m, "sum"),
            "a2.min": jax_reduce(f, m, "min"),
            "a3.max": jax_reduce(iv, m, "max")}
    err = np.abs(got["a0"]["sum"].numpy() - want["a0.sum"])
    scale = jax_reduce(np.abs(f), m, "sum")
    assert (err <= FLOAT_RTOL * np.maximum(scale, 1.0)).all()
    for name, table in (("__rows__", got["__rows__"]),
                        ("cnt", got["a0"]["cnt"]), ("cnt", got["a1"]["cnt"]),
                        ("a1.hi", got["a1"]["hi"]),
                        ("a1.lo", got["a1"]["lo"]),
                        ("a2.min", got["a2"]["min"]),
                        ("a3.max", got["a3"]["max"])):
        assert np.array_equal(table.numpy(), want[name]), name


def test_float_sum_under_the_limb_rows_is_one_reduction(monkeypatch):
    """Under the limit, and for a table without a float sum, the table
    is one ``group_reduce_lanes`` call."""
    f, iv, m, sel, gids = _lane_inputs(1000, 12)
    tm = torch.from_numpy(m)
    calls = []
    reduce = port_exec.group_reduce_lanes
    monkeypatch.setattr(port_exec, "group_reduce_lanes",
                        lambda *a: calls.append(1) or reduce(*a))
    monkeypatch.setattr(gr, "MAX_FLOAT_SUM_ROWS", 1024)
    tg = torch.from_numpy(gids)
    port_exec.reduce_states(
        {"s": Lane("fsum", torch.from_numpy(f), tm)}, tg, 12)
    f2, iv2, m2, _sel, g2 = _lane_inputs(5000, 12)
    port_exec.reduce_states(
        {"s": Lane("sum", torch.from_numpy(iv2), torch.from_numpy(m2))},
        torch.from_numpy(g2), 12)
    assert len(calls) == 2


# ------------------------------------------------------------------ #
# TopN past the sort's permutation
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("limit", [7, 120])
@pytest.mark.parametrize("case", ["two keys with ties", "DESC float key",
                                  "nullable key ASC"])
def test_topn_past_the_sort_rows_equals_jax(case, limit, monkeypatch):
    """Each device's 1024-row batch sorts as chunks of at most 300
    rows; the rows equal the JAX client's, bit for bit, in order."""
    (jsnap, snap), _ = _topn_snaps(6000, 3)
    sorts = []
    argsort = port_exec.stable_argsort
    monkeypatch.setattr(port_exec, "stable_argsort",
                        lambda keys: sorts.append(keys[0].numel())
                        or argsort(keys))
    monkeypatch.setattr(S, "_MAX_ROWS", 300)
    _execute_both(_topn(_JaxNS, case, limit), _topn(_PortNS, case, limit),
                  jsnap, snap)
    assert max(sorts) <= 300 and len(sorts) > 8


# ------------------------------------------------------------------ #
# SORT and SEGMENT past the sort's permutation
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("strategy", ["SORT", "SEGMENT"])
def test_group_by_past_the_sort_rows_equals_jax(strategy, monkeypatch):
    """Each device's 1024-row batch runs as four parts under 300 rows,
    32 tables merged by ``merge_sorted_states``; the result equals the
    JAX client's."""
    (jsnap, snap), _ = _mixed_snaps(6000, 5)
    keys = ("ik", "fk", "uk")
    jagg, jtypes = _mixed_agg(_JaxNS, keys, strategy, 16)
    agg, types = _mixed_agg(_PortNS, keys, strategy, 16)
    parts = []
    states = spmd.agg_states
    monkeypatch.setattr(spmd, "agg_states",
                        lambda a, cols, sel, ev, aux: parts.append(
                            sel.numel()) or states(a, cols, sel, ev, aux))
    monkeypatch.setattr(S, "_MAX_ROWS", 300)
    client = CopClient("cpu", 8)
    res = client.execute_agg(agg, snap, [GroupKeyMeta(t, 0) for t in types])
    jres = _jclient().execute_agg(jagg, jsnap,
                                  [JMeta(t, 0) for t in jtypes])
    floats = (2, 4)
    assert _as_map(res.key_columns, res.columns, floats) \
        == _as_map(jres.key_columns, jres.columns, floats)
    runs = len(client.timings["buckets"])
    assert len(parts) == 32 * runs and max(parts) <= 300


def test_limb_sum_bound_still_raises_past_the_sort_rows(monkeypatch):
    """A batch of ``LIMB_SUM_ROWS`` rows or more with a limb SUM raises,
    parts or not, as the JAX package's one batch does."""
    (_jsnap, snap), _ = _mixed_snaps(6000, 5)
    agg, types = _mixed_agg(_PortNS, ("ik",), "SORT", 16)
    monkeypatch.setattr(S, "_MAX_ROWS", 300)
    monkeypatch.setattr(port_exec, "LIMB_SUM_ROWS", 1024)
    with pytest.raises(OverflowError, match="limb-exact"):
        CopClient("cpu", 8).execute_agg(
            agg, snap, [GroupKeyMeta(t, 0) for t in types])

# ported from tidb_tpu/analysis/valueflow.py @ 1fb41ee
"""valueflow: whole-plan value-range abstract interpreter.

Reference analog: the range/overflow contracts a compiling engine must
prove BEFORE it emits code — Flare's native-compilation split (PAPERS.md)
keeps the unprovable lane host-side and compiles only what it can prove;
TiDB's own expression layer raises "value is out of range" eagerly on the
host.  A device lane can do neither: a launched torch (or traced jnp)
program does not raise data-dependently, so a scaled-int64 lane that
wraps past 2^63 returns WRONG DIGITS with no error (the gap
``expr/builders._arith_result_type`` documents).  The only correct move
is to prove it before the launch, over the frozen contract DAG, with no
device touch: the same abstract-interpretation discipline as copcost
(shapes/bytes), shardflow (layouts/collectives), and lifetime (buffer
lifetime), now over VALUE INTERVALS.

The port keeps the JAX package's verdicts exactly, parity being the
oracle; intervals live in Python ints.  ``NUM-PRECISION-LOSS`` models
the TPU's f32-only float lane: the port's float lanes compute in
float64, so on the card the rule refuses an int64/decimal cast into a
FLOAT32 lane that the port itself evaluates in float64 (ROADMAP.md,
Queue 3 item 4).

The interpreter carries a per-column interval in the DEVICE integer
representation (decimals are scaled int64, dates are day counts, strings
are dictionary codes) seeded from ANALYZE stats min/max — the
``_stacked_ranges`` narrowing the store already trusts — and widened to
the type domain when stats are absent.  It flows through expression
lowering (add/sub/mul, the div pow10 pre-scale, CAST chains), filters
(comparisons against constants TIGHTEN on the true branch), joins
(expanding joins bound SUM row counts by ``out_capacity``), and
aggregation states, and emits structured findings:

- ``NUM-OVERFLOW-DEVICE``  a device lane whose result interval
                           escapes int64 at stats-attained inputs —
                           today's silent wrap; reroute host-side or
                           widen, never trace it,
- ``NUM-FENCE-UNPROVEN``   a SUM whose per-batch limb bound (or claimed
                           narrow single-word bound) cannot be proven
                           from row-count x interval — the value-aware
                           generalization of the hardcoded 2^31 row
                           fence,
- ``NUM-PRECISION-LOSS``   int64/decimal flowing through an f32-only
                           device lane losing >0 ulp at the proven
                           magnitude (the TPU-has-no-f64 cliff),
- ``NUM-DIV-PRESCALE``     the documented unguarded pow10 pre-scaling
                           multiply of the decimal division lowering.

``proven`` intervals are STATS-ATTAINED (ANALYZE observed both
endpoints), so a proven escape is evidence, not paranoia: findings fire
only on proven intervals, while type-domain/widened intervals stay
sound over-approximations used for safety proofs (narrow SUMs) without
ever false-flagging un-analyzed tables.

The payoff is also perf: a proven-narrow interval lets
``copr/exec._agg_lanes`` emit a SINGLE-WORD int64 SUM state instead of
(hi, lo) limbs — one ``sum`` lane of ``group_reduce_lanes`` in place of
two, half the state bytes, priced by copcost, fused under the
``('agg-narrow', ...)`` contract class — bit identical to the limb path
by construction (sum(hi)<<32 + sum(lo) == sum(v) in two's complement,
and the proof says sum(v) cannot wrap).

Wired at the canonical seams: the gate passes (``value_findings``,
``value_report``), ``Session._plan_select`` (the per-digest proof
REGISTRY records each verified plan), and ``contracts.verify_task`` at
sched submit (registry hit replays the plan-time verdict before any
launch; a poisoned digest stays rejected).  The
runtime half rides the copgauge tradition: ANALYZE stamps observed
min/max watermarks per column, and every launch's declared interval must
contain the observed range — a violation is STATS DRIFT, surfaced on
``/sched`` and as a span attr, never a wrong result (the proofs carry
``NARROW_HEADROOM_ROWS`` of append headroom precisely so drift is a
signal, not a cliff).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..copr import dag as D
from ..expr import ir
from ..parallel.topology import _as_int
from ..types import dtypes as dt
from .contracts import PlanContractError, _fail
from .shardflow import PSUM_LIMB_ROWS, _gate_topologies

K = dt.TypeKind

# ------------------------------------------------------------------ #
# rule ids (gate finding rules — the COST-*/SHARD-* discipline)
# ------------------------------------------------------------------ #

RULE_OVERFLOW = "NUM-OVERFLOW-DEVICE"
RULE_FENCE = "NUM-FENCE-UNPROVEN"
RULE_PRECISION = "NUM-PRECISION-LOSS"
RULE_PRESCALE = "NUM-DIV-PRESCALE"

I64_MIN = -2 ** 63
I64_MAX = 2 ** 63 - 1

# largest magnitude below which EVERY integer is exactly representable
# in float32 — the bound of the f32-only device lane (TPU has no f64:
# jax demotes every float lane to f32 there, so an int64/decimal value
# above this loses >0 ulp the moment it enters a float expression)
F32_EXACT_INT = 2 ** 24

# append headroom multiplied into the stats row count before a narrow
# proof: the proof must survive ordinary growth between ANALYZE runs
# (the watermark check catches drift beyond it, loudly, without a wrong
# result — the narrow state itself stays exact far past the proof line)
NARROW_HEADROOM_ROWS = 1024

# proven-narrow |sum| ceiling: one sign bit of spare room under int64 so
# every psum partial and host re-merge stays provably un-wrapped
NARROW_SUM_BOUND = 2 ** 62


# ------------------------------------------------------------------ #
# the abstract value: a closed interval in device representation
# ------------------------------------------------------------------ #

@dataclass(frozen=True)
class Interval:
    """[lo, hi] over a lane's DEVICE integer representation (scaled
    int64 for decimals, days for dates, codes for strings).  ``proven``
    marks STATS-ATTAINED endpoints (ANALYZE observed them): findings
    fire only on proven intervals; widened type-domain intervals remain
    sound upper bounds for safety proofs but never raise findings."""
    lo: int
    hi: int
    proven: bool = False

    @property
    def mag(self) -> int:
        return max(abs(self.lo), abs(self.hi))

    def union(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi),
                        self.proven and other.proven)


BOOL_IV = Interval(0, 1, False)

# integer-represented kinds valueflow tracks; float lanes and
# host-object columns are untracked (interval = None)
_INT_FAMILY = (K.INT64, K.UINT64, K.DECIMAL, K.DATE, K.DATETIME, K.TIME,
               K.ENUM, K.SET, K.BIT, K.STRING, K.NULL)


def type_domain(t: Optional[dt.DataType]) -> Optional[Interval]:
    """Widest interval of a dtype's device representation — the sound
    fallback when stats are absent.  None = untracked lane (floats,
    vectors, host objects)."""
    if t is None or t.kind not in _INT_FAMILY:
        return None
    if t.kind == K.DECIMAL:
        if t.is_wide_decimal:
            return None                 # host object ints, exact
        p = t.prec if t.prec > 0 else dt.DECIMAL64_MAX_PRECISION
        m = 10 ** min(p, dt.DECIMAL64_MAX_PRECISION) - 1
        return Interval(-m, m)
    if t.kind == K.UINT64:
        return Interval(0, 2 ** 64 - 1)
    if t.kind in (K.DATE, K.STRING):
        ii = np.iinfo(np.int32)
        return Interval(_as_int(ii.min), _as_int(ii.max))
    if t.kind == K.ENUM:
        return Interval(0, len(t.members or ()))
    if t.kind == K.SET:
        return Interval(0, 2 ** len(t.members or ()) - 1)
    if t.kind == K.BIT:
        return Interval(0, 2 ** max(t.prec, 1) - 1)
    if t.kind == K.NULL:
        return Interval(0, 0)
    return Interval(I64_MIN, I64_MAX)


def _clamped(lo: int, hi: int, proven: bool, t: Optional[dt.DataType],
             p: tuple, what: str) -> Interval:
    """Result interval of one arithmetic step: a PROVEN escape past
    int64 is today's silent device wrap — fail loudly; an unproven
    escape clamps to the type domain (sound, silent)."""
    if lo < I64_MIN or hi > I64_MAX:
        if proven:
            _fail(RULE_OVERFLOW, p,
                  f"{what} interval [{lo}, {hi}] escapes int64 at "
                  "stats-attained inputs: the traced lane would wrap "
                  "silently — evaluate host-side, widen, or re-ANALYZE")
        dom = type_domain(t) or Interval(I64_MIN, I64_MAX)
        return Interval(max(lo, dom.lo), min(hi, dom.hi), False)
    return Interval(lo, hi, proven)


def _const_interval(e: ir.Const) -> Optional[Interval]:
    v = e.value
    if isinstance(v, bool):
        v = 1 if v else 0
    if isinstance(v, (int, np.integer)):
        v = _as_int(v)
        return Interval(v, v, True)
    return type_domain(e.dtype)


# ------------------------------------------------------------------ #
# expression lowering over intervals
# ------------------------------------------------------------------ #

def _mul_bounds(a: Interval, b: Interval) -> Tuple[int, int]:
    cands = (a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi)
    return min(cands), max(cands)


def expr_interval(e: ir.Expr, env: tuple, p: tuple) -> Optional[Interval]:
    """Interval of one device-lowered expression over ``env`` (one
    Optional[Interval] per input-schema position).  Mirrors the
    expr/compile lowering: decimal mul adds scales (values are already
    scaled ints, so plain interval multiply is the model), div
    pre-scales by pow10, casts rescale.  Raises PlanContractError on a
    proven violation; unknown ops widen to the type domain (sound)."""
    if isinstance(e, ir.ColumnRef):
        if 0 <= e.index < len(env) and env[e.index] is not None:
            return env[e.index]
        return type_domain(e.dtype)
    if isinstance(e, ir.Const):
        return _const_interval(e)
    if not isinstance(e, ir.Func):
        return type_domain(e.dtype)

    op = e.op
    if op in ("eq", "ne", "lt", "le", "gt", "ge", "and", "or", "xor",
              "not", "isnull", "in"):
        for a in e.args:
            expr_interval(a, env, p)       # flow args for their findings
        return BOOL_IV
    if op in ("add", "sub", "mul", "div", "intdiv", "mod", "neg", "abs",
              "if", "case", "coalesce", "greatest", "least", "cast",
              "round", "floor", "ceil", "truncate", "sign"):
        return _arith_interval(e, env, p)
    # unknown/other scalar functions (date extracts, string ops, ...):
    # the type domain of the result is the sound answer
    for a in e.args:
        expr_interval(a, env, p)
    return type_domain(e.dtype)


def _arith_interval(e: ir.Func, env: tuple, p: tuple) -> Optional[Interval]:
    op = e.op
    args = [expr_interval(a, env, p) for a in e.args]
    if op in ("if",):
        vals = [iv for iv in args[1:] if iv is not None]
        return functools.reduce(Interval.union, vals) if vals else None
    if op in ("case", "coalesce", "greatest", "least"):
        # case: (when, then)* [else] — value positions vary; union every
        # tracked arg (sound: the result is one of them, or NULL)
        vals = [iv for iv in args if iv is not None]
        if not vals or any(iv is None for iv in args):
            return type_domain(e.dtype)
        if op == "greatest":
            return Interval(max(iv.lo for iv in vals),
                            max(iv.hi for iv in vals),
                            all(iv.proven for iv in vals))
        if op == "least":
            return Interval(min(iv.lo for iv in vals),
                            min(iv.hi for iv in vals),
                            all(iv.proven for iv in vals))
        return functools.reduce(Interval.union, vals)
    if op == "cast":
        return _cast_interval(e, args[0], p)
    if op in ("round", "floor", "ceil", "truncate"):
        iv = args[0]
        if iv is None or e.dtype.kind not in _INT_FAMILY:
            return type_domain(e.dtype)
        # magnitude never grows past one scale unit; keep it sound and
        # un-proven (endpoints move by rounding)
        return _clamped(iv.lo - 1, iv.hi + 1, False, e.dtype, p, e.op)
    if op == "sign":
        return Interval(-1, 1, False)

    a = args[0] if args else None
    b = args[1] if len(args) > 1 else None
    if e.dtype.kind not in _INT_FAMILY:
        return None                     # float lane: untracked
    if op == "neg":
        if a is None:
            return type_domain(e.dtype)
        return _clamped(-a.hi, -a.lo, a.proven, e.dtype, p, "negate")
    if op == "abs":
        if a is None:
            return type_domain(e.dtype)
        lo = 0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi))
        return _clamped(lo, a.mag, a.proven, e.dtype, p, "abs")
    if a is None or b is None:
        return type_domain(e.dtype)
    if op == "add":
        return _clamped(a.lo + b.lo, a.hi + b.hi, a.proven and b.proven,
                        e.dtype, p, "add")
    if op == "sub":
        return _clamped(a.lo - b.hi, a.hi - b.lo, a.proven and b.proven,
                        e.dtype, p, "subtract")
    if op == "mul":
        lo, hi = _mul_bounds(a, b)
        return _clamped(lo, hi, a.proven and b.proven, e.dtype, p,
                        "multiply")
    if op == "div":
        return _div_interval(e, a, b, p)
    if op == "intdiv":
        return Interval(-a.mag, a.mag, False)
    if op == "mod":
        m = max(b.mag - 1, 0)
        return Interval(-m, m, False)
    return type_domain(e.dtype)


def _div_interval(e: ir.Func, a: Interval, b: Interval,
                  p: tuple) -> Optional[Interval]:
    """The decimal division lowering pre-scales the dividend by
    pow10(result_scale - scale_a + scale_b) BEFORE the integer divide —
    the documented unguarded multiply (expr/builders.py).  A proven
    escape of that intermediate is NUM-DIV-PRESCALE; the quotient's
    magnitude is bounded by the scaled dividend's (|divisor| >= 1 in
    scaled units once nonzero)."""
    ea, eb = e.args[0], e.args[1]
    if e.dtype.kind != K.DECIMAL:
        return None                     # float division: untracked lane
    sa = ea.dtype.scale if ea.dtype.kind == K.DECIMAL else 0
    sb = eb.dtype.scale if eb.dtype.kind == K.DECIMAL else 0
    k = e.dtype.scale - sa + sb
    if k >= 0:
        lo, hi = a.lo * 10 ** k, a.hi * 10 ** k
        if (lo < I64_MIN or hi > I64_MAX) and a.proven:
            _fail(RULE_PRESCALE, p,
                  f"decimal division pre-scales the dividend by 10^{k} "
                  f"to [{lo}, {hi}], past int64, at stats-attained "
                  "inputs — the traced multiply wraps before the divide "
                  "(host lanes raise via _guard_dec_overflow; device "
                  "lanes cannot)")
        m = min(max(abs(lo), abs(hi)), I64_MAX)
    else:
        dlo, dhi = b.lo * 10 ** (-k), b.hi * 10 ** (-k)
        if (dlo < I64_MIN or dhi > I64_MAX) and b.proven:
            _fail(RULE_PRESCALE, p,
                  f"decimal division pre-scales the divisor by 10^{-k} "
                  f"to [{dlo}, {dhi}], past int64, at stats-attained "
                  "inputs — the traced multiply wraps before the divide")
        m = a.mag
    return Interval(-m, m, False)


def _cast_interval(e: ir.Func, a: Optional[Interval],
                   p: tuple) -> Optional[Interval]:
    src = e.args[0].dtype
    tgt = e.dtype
    if tgt.kind in (K.FLOAT32, K.FLOAT64):
        # the f32-only cliff: on TPU every float lane is f32, which
        # holds integers exactly only below 2^24 — a proven magnitude
        # past that loses real digits the moment it enters the lane
        if tgt.kind == K.FLOAT32 and a is not None and a.proven \
                and src.kind in _INT_FAMILY and a.mag > F32_EXACT_INT:
            _fail(RULE_PRECISION, p,
                  f"{src} value with stats-attained magnitude {a.mag} "
                  f"(> 2^24) cast into an f32-only device lane loses "
                  ">0 ulp — keep the lane integral or accept DOUBLE "
                  "host-side")
        return None
    if tgt.kind not in _INT_FAMILY:
        return None
    if a is None:
        return type_domain(tgt)
    ss = src.scale if src.kind == K.DECIMAL else 0
    ts = tgt.scale if tgt.kind == K.DECIMAL else 0
    d = ts - ss
    if src.kind in _INT_FAMILY and d > 0:
        return _clamped(a.lo * 10 ** d, a.hi * 10 ** d, a.proven, tgt, p,
                        f"cast rescale by 10^{d}")
    if src.kind in _INT_FAMILY and d < 0:
        s = 10 ** (-d)
        return Interval(-(a.mag // s) - 1, a.mag // s + 1, False)
    if src.kind in _INT_FAMILY:
        dom = type_domain(tgt) or Interval(I64_MIN, I64_MAX)
        return Interval(max(a.lo, dom.lo), min(a.hi, dom.hi), a.proven)
    return type_domain(tgt)


# ------------------------------------------------------------------ #
# filter tightening (true-branch comparison narrowing)
# ------------------------------------------------------------------ #

def _tighten(env: tuple, cond: ir.Expr) -> tuple:
    """Tighten column intervals under the TRUE branch of a pushed-down
    filter: ``col <op> const`` (either operand order) and conjunctions.
    Tightening intersects, so proven-ness is preserved — the surviving
    rows' attained range is a subset of the column's."""
    if not isinstance(cond, ir.Func):
        return env
    if cond.op == "and":
        for a in cond.args:
            env = _tighten(env, a)
        return env
    if cond.op not in ("eq", "lt", "le", "gt", "ge"):
        return env
    if len(cond.args) != 2:
        return env
    a, b = cond.args
    op = cond.op
    if isinstance(b, ir.ColumnRef) and isinstance(a, ir.Const):
        a, b = b, a
        op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(op, op)
    if not (isinstance(a, ir.ColumnRef) and isinstance(b, ir.Const)):
        return env
    c = _const_interval(b)
    if c is None or not c.proven or a.index >= len(env):
        return env
    iv = env[a.index] or type_domain(a.dtype)
    if iv is None:
        return env
    v = c.lo
    if op == "eq":
        new = Interval(max(iv.lo, v), min(iv.hi, v), iv.proven)
    elif op == "lt":
        new = Interval(iv.lo, min(iv.hi, v - 1), iv.proven)
    elif op == "le":
        new = Interval(iv.lo, min(iv.hi, v), iv.proven)
    elif op == "gt":
        new = Interval(max(iv.lo, v + 1), iv.hi, iv.proven)
    else:
        new = Interval(max(iv.lo, v), iv.hi, iv.proven)
    if new.lo > new.hi:            # contradiction: filter selects nothing
        new = Interval(new.hi, new.hi, False)
    out = list(env)
    out[a.index] = new
    return tuple(out)


# ------------------------------------------------------------------ #
# DAG flow (memoized on the frozen dag + seeded env)
# ------------------------------------------------------------------ #

def _flow(node: D.CopNode, scan_env: tuple, rows: int, strict: bool,
          path: tuple):
    """Flow one cop node; returns (env, row_bound).  ``scan_env`` is a
    frozen ((offset, Interval), ...) seeding for the leaf TableScan;
    ``rows`` the sound global contributing-row bound (0 = unknown)."""
    p = path + (type(node).__name__,)

    if isinstance(node, D.TableScan):
        seeded = dict(scan_env)
        env = tuple(seeded.get(off) or type_domain(t)
                    for off, t in zip(node.col_offsets, node.col_dtypes))
        return env, rows

    if isinstance(node, D.FusedDag):
        out = ((), rows)
        for m in node.members:
            out = _flow(m, scan_env, rows, strict, p)
        return out

    kids = node.children()
    env, rows = (_flow(kids[0], scan_env, rows, strict, p)
                 if kids else ((), rows))

    if isinstance(node, D.Selection):
        for cond in node.conditions:
            expr_interval(cond, env, p)
            env = _tighten(env, cond)
        return env, rows
    if isinstance(node, D.Projection):
        return tuple(expr_interval(e, env, p) for e in node.exprs), rows
    if isinstance(node, D.Expand):
        for e in node.keys:
            expr_interval(e, env, p)
        env = env + tuple(expr_interval(e, env, p) for e in node.keys)
        env = env + (Interval(0, max(node.levels - 1, 0), False),)
        return env, rows * max(node.levels, 1)
    if isinstance(node, D.LookupJoin):
        expr_interval(node.probe_key, env, p)
        env = env + tuple(type_domain(t) for t in node.build_dtypes)
        if not node.unique and node.out_capacity > 0:
            # the expanding join's regrown output capacity bounds the
            # rows any downstream SUM can consume
            rows = max(rows, node.out_capacity)
        return env, rows
    if isinstance(node, (D.TopN, D.Limit)):
        if isinstance(node, D.TopN):
            for e, _d in (node.sort_keys
                          or (((node.sort_key, node.desc),)
                              if node.sort_key is not None else ())):
                expr_interval(e, env, p)
        if node.limit > 0 and rows > 0:
            rows = min(rows, node.limit)
        return env, rows
    if isinstance(node, D.Aggregation):
        _check_agg(node, env, rows, strict, p)
        return (tuple(type_domain(t) for t in D.output_dtypes(node)),
                rows)
    return env, rows


def _check_agg(node: D.Aggregation, env: tuple, rows: int, strict: bool,
               p: tuple) -> None:
    for g in node.group_by:
        expr_interval(g, env, p)
    for i, a in enumerate(node.aggs):
        if a.arg is None:
            continue
        iv = expr_interval(a.arg, env, p)
        if a.func != D.AggFunc.SUM or a.arg.dtype is None \
                or a.arg.dtype.kind in (K.FLOAT64, K.FLOAT32):
            continue
        if iv is None:
            iv = type_domain(a.arg.dtype) or Interval(I64_MIN, I64_MAX)
        if i in node.narrow_sums:
            # a claimed narrow slot must re-prove under the seeded env:
            # |sum| <= rows x mag must clear the single-word ceiling
            if strict and (rows <= 0
                           or rows * iv.mag >= NARROW_SUM_BOUND):
                _fail(RULE_FENCE, p,
                      f"narrow SUM claim on slot {i} is unprovable: "
                      f"{rows} rows x magnitude {iv.mag} does not clear "
                      f"the 2^62 single-word bound — re-ANALYZE or drop "
                      "the narrow stamp")
        elif strict and rows >= PSUM_LIMB_ROWS \
                and node.strategy not in D.HOST_MERGE_STRATEGIES:
            # value-aware generalization of the 2^31 row fence: past it,
            # the (hi, lo) limb psum stays exact only if the interval
            # proves the hi-limb sum cannot wrap
            if rows * ((iv.mag >> 32) + 1) >= 2 ** 63:
                _fail(RULE_FENCE, p,
                      f"limb-split SUM over {rows} global rows (>= 2^31) "
                      f"with magnitude {iv.mag}: the per-batch limb "
                      "bound is unprovable from row-count x interval — "
                      "repartition, host-merge, or narrow the column")


@functools.lru_cache(maxsize=1024)
def _flow_cached(dag: D.CopNode, scan_env: tuple, rows: int, strict: bool,
                 path: tuple):
    return _flow(dag, scan_env, rows, strict, path)


def verify_dag_values(dag: D.CopNode, scan_env: tuple = (), *,
                      rows: int = 0, strict: bool = False,
                      path: tuple = ()) -> tuple:
    """Flow one cop DAG over value intervals; raises PlanContractError
    with a NUM-* rule on the first proven violation, returns the DAG's
    output env (one Optional[Interval] per output column).  Memoized on
    the frozen (dag, seeding) pair — repeated admission of one program
    costs a dict hit."""
    env, _rows = _flow_cached(dag, tuple(scan_env), _as_int(rows),
                              strict is True, path)
    return env


def narrow_sum_count(dag: D.CopNode) -> int:
    """Proven-narrow SUM slots stamped anywhere in one cop DAG."""
    return sum(len(n.narrow_sums) for n in D.iter_nodes(dag)
               if isinstance(n, D.Aggregation))


# ------------------------------------------------------------------ #
# stats seeding + the narrow proof (planner seam)
# ------------------------------------------------------------------ #

def _table_key(table) -> int:
    # mirror of stats.handle.StatsHandle._key — the registry and the
    # watermark store must agree with the stats cache on identity
    return getattr(table, "table_id", 0) or id(table)   # planlint: ok - stats-cache identity contract


def scan_stats_env(scan: D.TableScan, table, handle) -> tuple:
    """((offset, Interval), ...) seeding for one TableScan from the
    table's ANALYZE stats: int-family columns with a device-kernel
    min/max get PROVEN attained intervals; everything else widens to
    its type domain at flow time."""
    if table is None or handle is None:
        return ()
    ts = handle.get(table)
    if ts is None:
        return ()
    names = getattr(table, "col_names", None)
    if names is None:
        return ()
    out = []
    for off, t in zip(scan.col_offsets, scan.col_dtypes):
        if off >= len(names) or t.kind not in _INT_FAMILY:
            continue
        cs = ts.col(names[off])
        if cs is None or cs.count <= 0:
            continue
        h = cs.hist
        if h.min_val is None or len(h.bounds) == 0:
            continue
        out.append((off, Interval(_as_int(h.min_val),
                                  _as_int(h.bounds[-1]), True)))
    return tuple(out)


def _scan_of(node: D.CopNode) -> Optional[D.TableScan]:
    for n in D.iter_nodes(node):
        if isinstance(n, D.TableScan):
            return n
    return None


def prove_narrow_sums(agg: D.Aggregation, table, handle) -> tuple:
    """SUM slots of one SCALAR/DENSE aggregation provably safe as
    single-word int64 states: stats row count (with append headroom) x
    the flowed argument interval must clear the 2^62 ceiling.  Returns
    the provable slot indexes (empty when stats are absent — the proof
    never speculates).  Called by the planner while stamping the frozen
    DAG; the watermark check guards the proof's stats against drift at
    every launch."""
    if agg.strategy not in (D.GroupStrategy.SCALAR, D.GroupStrategy.DENSE):
        return ()
    if table is None or handle is None:
        return ()
    ts = handle.get(table)
    if ts is None or ts.count <= 0:
        return ()
    scan = _scan_of(agg.child)
    if scan is None:
        return ()
    seed = scan_stats_env(scan, table, handle)
    if not seed:
        return ()
    rows = max(ts.realtime_count, ts.count, 1) * NARROW_HEADROOM_ROWS
    try:
        env, rows = _flow_cached(agg.child, seed, rows, False, ("narrow",))
    except PlanContractError:
        return ()       # the verify pass will surface it; never stamp
    proved = []
    for i, a in enumerate(agg.aggs):
        if a.func != D.AggFunc.SUM or a.arg is None \
                or a.arg.dtype is None \
                or a.arg.dtype.kind in (K.FLOAT64, K.FLOAT32):
            continue
        try:
            iv = expr_interval(a.arg, env, ("narrow",))
        except PlanContractError:
            continue
        if iv is None or not iv.proven:
            continue
        if rows > 0 and rows * iv.mag < NARROW_SUM_BOUND:
            proved.append(i)
    return tuple(proved)


# ------------------------------------------------------------------ #
# per-digest proof registry (plan-verify time -> sched submit time)
# ------------------------------------------------------------------ #

# dag digest -> ("ok", declared) | ("rejected", PlanContractError);
# declared = ((table_key, column, lo, hi), ...) — the intervals the
# plan's proof assumed, compared against observed watermarks per launch
_REGISTRY: dict = {}
_REGISTRY_CAP = 4096


def _register(dag: D.CopNode, verdict: tuple) -> None:
    if len(_REGISTRY) >= _REGISTRY_CAP:
        _REGISTRY.clear()
    _REGISTRY[D.dag_digest(dag)] = verdict


def _declared_of(scan_env: tuple, table, names) -> tuple:
    tk = _table_key(table) if table is not None else 0
    if not tk or names is None:
        return ()
    return tuple((tk, names[off], iv.lo, iv.hi)
                 for off, iv in scan_env if off < len(names))


def registry_verdict(dag: D.CopNode):
    """(verdict, payload) the plan-verify pass recorded for this digest,
    or None — tests and the sched seam read this."""
    return _REGISTRY.get(D.dag_digest(dag))


def clear_registry() -> None:
    _REGISTRY.clear()
    _flow_cached.cache_clear()


# ------------------------------------------------------------------ #
# observed watermarks (the runtime half; ANALYZE stamps, launches check)
# ------------------------------------------------------------------ #

# (table_key, column(lower)) -> (observed_min, observed_max) in device
# representation — stamped by StatsHandle.analyze_table from the SAME
# device-built histogram the proofs read, so declared vs observed can
# only diverge when the data moved after the plan's stats snapshot
_WATERMARKS: dict = {}
_WATERMARKS_CAP = 8192

# lifetime drift counter (read by /sched via the scheduler mirror and
# by the stress smoke)
_DRIFTS = [0]


def stamp_watermarks(ts) -> None:
    """Record per-column observed min/max watermarks from a fresh
    ANALYZE (TableStats).  Called by stats/handle at the end of every
    analyze_table — the runtime validation half of the value proofs."""
    if len(_WATERMARKS) >= _WATERMARKS_CAP:
        _WATERMARKS.clear()
    for name, cs in ts.cols.items():
        h = cs.hist
        if cs.count <= 0 or h.min_val is None or len(h.bounds) == 0:
            continue
        _WATERMARKS[(ts.table_id, name)] = (_as_int(h.min_val),
                                            _as_int(h.bounds[-1]))


def watermark_violations(declared: tuple) -> list:
    """Columns whose CURRENT observed watermark escapes the declared
    plan-time interval — stats drift.  Never an error: the narrow proof
    carries NARROW_HEADROOM_ROWS of slack and the limb path is exact
    regardless; drift is surfaced (span attr, /sched counter) so the
    operator re-ANALYZEs before the slack erodes."""
    out = []
    for tk, name, lo, hi in declared:
        obs = _WATERMARKS.get((tk, str(name).lower()))
        if obs is None:
            continue
        if obs[0] < lo or obs[1] > hi:
            out.append((name, (lo, hi), obs))
    return out


def drift_count() -> int:
    return _DRIFTS[0]


# ------------------------------------------------------------------ #
# admission-time verification (sched submit, via contracts.verify_task)
# ------------------------------------------------------------------ #

def verify_task_values(task) -> None:
    """Admission-time valueflow check of a structured CopTask, BEFORE
    the drain could resolve (launch) a program.  A digest the session
    verified replays its plan-time verdict (a poisoned plan stays
    rejected at submit even if the caller skipped the session seam) and
    checks declared-vs-observed watermarks; an unknown digest flows
    from type domains — sound, find-nothing-spurious."""
    if task.dag is None:
        return
    rec = _REGISTRY.get(D.dag_digest(task.dag))
    if rec is not None:
        if rec[0] == "rejected":
            e = rec[1]
            _fail(e.rule, ("sched",) + tuple(e.path), e.detail)
        drifted = watermark_violations(rec[1])
        if drifted:
            _DRIFTS[0] += len(drifted)
            try:
                task.value_drift = len(drifted)
            except AttributeError:
                pass
        return
    global_rows = 0
    for v, _m in task.cols or ():
        if getattr(v, "ndim", 0) >= 2:
            global_rows = v.shape[0] * v.shape[1]
            break
    verify_dag_values(task.dag, (), rows=global_rows, path=("sched",))


# ------------------------------------------------------------------ #
# plan-level verification (session / gate / EXPLAIN)
# ------------------------------------------------------------------ #

def _verify_cop_op(op, handle, path: tuple) -> int:
    table = getattr(op, "table", None)
    scan = _scan_of(op.dag)
    seed = (scan_stats_env(scan, table, handle)
            if scan is not None else ())
    rows = 0
    if table is not None and handle is not None:
        ts = handle.get(table)
        if ts is not None:
            rows = max(ts.realtime_count, ts.count)
    names = getattr(table, "col_names", None) if table is not None else None
    try:
        verify_dag_values(op.dag, seed, rows=rows, strict=len(seed) > 0,
                          path=path)
    except PlanContractError as e:
        _register(op.dag, ("rejected", e))
        raise
    _register(op.dag, ("ok", _declared_of(seed, table, names)))
    return 1


def verify_plan_values(phys, handle=None, path: tuple = ()) -> int:
    """Flow every device-program operator of a built physical plan over
    value intervals (stats-seeded when ``handle`` has the table
    analyzed, type domains otherwise).  Returns the number of device
    operators flowed; raises PlanContractError on the first proven
    violation.  Each flowed digest lands in the proof registry so sched
    admission replays the verdict and every launch checks watermarks.
    Topology-invariant by construction: intervals bound VALUES, and the
    row bounds are global — the same proof holds under every declared
    host view."""
    flowed = 0
    stack = [phys]
    while stack:
        op = stack.pop()
        name = type(op).__name__
        p = path + (name,)
        if name in ("CopTaskExec", "CopJoinTaskExec"):
            flowed += _verify_cop_op(op, handle, p)
        elif name == "CopShuffleJoinExec":
            spec = op.spec
            for side, tbl in ((spec.left, getattr(op, "left_table", None)),
                              (spec.right,
                               getattr(op, "right_table", None))):
                scan = _scan_of(side)
                seed = (scan_stats_env(scan, tbl, handle)
                        if scan is not None else ())
                verify_dag_values(side, seed, strict=len(seed) > 0,
                                  path=p)
            verify_dag_values(spec.top, (), path=p)
            flowed += 1
        elif name == "CopWindowExec":
            verify_dag_values(op.spec.child, (), path=p)
            flowed += 1
        for c in getattr(op, "children", []) or []:
            if c is not None:
                stack.append(c)
        fb = getattr(op, "fallback", None)
        if fb is not None:
            stack.append(fb)
    return flowed


def plan_narrow_states(phys) -> int:
    """Proven-narrow SUM states across a built plan's device DAGs."""
    total = 0
    stack = [phys]
    while stack:
        op = stack.pop()
        if type(op).__name__ in ("CopTaskExec", "CopJoinTaskExec"):
            total += narrow_sum_count(op.dag)
        for c in getattr(op, "children", []) or []:
            if c is not None:
                stack.append(c)
        fb = getattr(op, "fallback", None)
        if fb is not None:
            stack.append(fb)
    return total


# ------------------------------------------------------------------ #
# gate pass + report
# ------------------------------------------------------------------ #

def value_findings(plans, handle=None, n_devices: int = 8) -> list:
    """NUM-* findings over (sql, built-plan) pairs — the valueflow half
    of the analysis gate, run under both gate topology views for parity
    with shardflow (the value proofs are topology-invariant; the loop
    documents that invariance at zero cost through the memoized flow).
    Finding keys are stable (corpus position + rule) so they baseline
    exactly like lint/cost/shard findings."""
    from .lint import Finding
    out = []
    for idx, (sql, phys) in enumerate(plans):
        qid = f"corpus/q{idx:02d}"
        one_line = " ".join(sql.split())[:60]
        for topo in _gate_topologies(n_devices):
            try:
                verify_plan_values(phys, handle)
            except PlanContractError as e:
                sym = e.path[-1] if e.path else "plan"
                out.append(Finding(
                    e.rule, qid, 0, sym,
                    f"[hosts={topo.n_hosts}] {e.detail} ({one_line})"))
                break
    return out


def value_report(plans, handle=None) -> str:
    """Per-corpus-query value table (``--value-report``): flowed device
    ops, stats-proven scan columns, narrow SUM states, and the verdict
    — the static half of the proven-narrow payoff next to
    --transfer-report's link attribution."""
    lines = ["value-range flow over the plan corpus "
             "(stats-seeded where ANALYZEd, type domains otherwise)",
             f"{'query':<44} {'ops':>4} {'narrow':>7} {'verdict':>9}"]
    for idx, (sql, phys) in enumerate(plans):
        one_line = " ".join(sql.split())
        label = f"q{idx:02d} {one_line[:39]}"
        try:
            flowed = verify_plan_values(phys, handle)
            narrow = plan_narrow_states(phys)
            lines.append(f"{label:<44} {flowed:>4} {narrow:>7} "
                         f"{'proven':>9}")
        except PlanContractError as e:
            lines.append(f"{label:<44} {'-':>4} {'-':>7} {e.rule:>9}")
    return "\n".join(lines)


__all__ = ["Interval", "type_domain", "expr_interval",
           "verify_dag_values", "verify_plan_values",
           "verify_task_values", "prove_narrow_sums", "scan_stats_env",
           "narrow_sum_count", "plan_narrow_states", "value_findings",
           "value_report", "stamp_watermarks", "watermark_violations",
           "drift_count", "registry_verdict", "clear_registry",
           "RULE_OVERFLOW", "RULE_FENCE", "RULE_PRECISION",
           "RULE_PRESCALE", "F32_EXACT_INT", "NARROW_HEADROOM_ROWS",
           "NARROW_SUM_BOUND", "I64_MIN", "I64_MAX"]

# ported from tidb_tpu/analysis/contracts.py @ 02e96d8
"""Plan-contract verification: typed-IR checks BEFORE a launch.

Reference analog: the typed IR verification compiler-first query engines
run between planning and codegen.  The port holds the whole module:

- ``verify_plan``: a built physical plan walked edge by edge, every
  operator's declared contract against its children's (column
  references, dtype families, arities, exchange boundaries), run by the
  session's ``_plan_select`` with shardflow's and valueflow's plan
  passes (``tidb_tpu_verify_plan``, on by default);
- ``verify_dag``: a pushed cop DAG checked bottom-up (column references
  in range and dtype-consistent with the child's declared schema, only
  device-whitelisted ops, no host-object columns or unlowered strings
  on the device, well-formed aggregation capacity shapes), memoized on
  the frozen DAG;
- ``verify_task`` (sched admission): a structured CopTask's stacked
  inputs must match its key's capacity signature and divide over its
  devices — the precondition for in-flight dedup and batch-slot
  coalescing to be shape-safe — then the sharding-flow, value-range and
  donation handshakes (analysis/shardflow, valueflow, lifetime);
- ``fusion_signature`` and ``verify_fusion_group``: the contract class
  of a DAG that may join a cross-query fusion group, and the pre-launch
  check of a group.

Each raises a structured ``PlanContractError`` (a PlanError, so the
session surfaces it like any planner rejection).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

from ..copr import dag as D
from ..expr.ir import ColumnRef, Const, Expr, Func
from ..planner.build import PlanError
from ..types import dtypes as dt

K = dt.TypeKind


class PlanContractError(PlanError):
    """A built plan violates an operator contract.

    Carries the violated rule, the operator path from the plan root, and
    a detail message so tests and EXPLAIN can assert on structure, not
    text."""

    def __init__(self, rule: str, path: Sequence[str], detail: str):
        self.rule = rule
        self.path = tuple(path)
        self.detail = detail
        super().__init__(
            f"plan contract violation [{rule}] at "
            f"{' > '.join(self.path) or '<root>'}: {detail}")


def _fail(rule: str, path, detail: str):
    raise PlanContractError(rule, path, detail)


# --------------------------------------------------------------------- #
# dtype compatibility
# --------------------------------------------------------------------- #

def _family(t: Optional[dt.DataType]) -> str:
    """Coarse representation family: what the value IS on device/host.
    Promotion across families without a declared cast is the silent-
    promotion hazard this gate exists to catch."""
    if t is None:
        return "?"
    if t.is_host_object:
        return "obj"
    if t.is_string:
        return "str"
    if t.kind in (K.FLOAT64, K.FLOAT32):
        return "float"
    return "int"    # ints, scaled decimal64, temporal, enum/set/bit, null


def _compatible(declared: dt.DataType, actual: dt.DataType) -> bool:
    """A ColumnRef's declared dtype vs the producing schema slot.
    Nullability and collation may legitimately drift through rewrites
    (outer-join null extension, collation coercion); kind and physical
    representation may not."""
    if declared.kind == K.NULL or actual.kind == K.NULL:
        return True       # untyped NULL literal slots match anything
    if declared.kind == actual.kind:
        if declared.kind == K.DECIMAL:
            # scaled-int encoding: a scale mismatch reads 1.00 as 100
            return (declared.scale == actual.scale
                    or declared.is_wide_decimal != actual.is_wide_decimal)
        return True
    # distinct kinds: allowed only within one physical family (e.g.
    # DATE read as bigint by a fold) — never int<->float or <->object
    return (_family(declared) == _family(actual)
            and declared.np_dtype() == actual.np_dtype())


# arithmetic ops: int/float/decimal mixing IS declared in this engine —
# the evaluator rescales/promotes from the arg dtypes and the inferred
# result dtype (expr/builders._arith_result_type + expr/compile.py).
# The undeclared promotion the verifier rejects is arithmetic that
# consumes STRING-family args while producing a NON-string: dictionary
# codes are arbitrary ordinals, and the planner routes string operands
# into numeric arithmetic only through a declared cast (or dict_lut).
# String-OUT code arithmetic is the legitimate dictionary-lowering idiom
# (lower_strings combines codes as code1*K+code2 with a derived output
# dictionary) and passes.
_ARITH_OPS = frozenset({"add", "sub", "mul", "div", "intdiv", "mod"})


def _check_expr(e: Expr, schema: Tuple[dt.DataType, ...], path,
                device: bool = False, lowered: bool = False) -> None:
    """One expression tree against its input schema.  `device=True` adds
    the traceable-dense rules (whitelisted ops, lowered strings, no
    host-object values).  `lowered=True` marks a subtree under a
    dict_map/dict_lut (or a node carrying a derived dictionary): there
    the dictionary-lowering idiom legitimately treats codes as ints."""
    if isinstance(e, ColumnRef):
        if not (0 <= e.index < len(schema)):
            _fail("column-ref", path,
                  f"{e} references column {e.index} of a "
                  f"{len(schema)}-column input")
        if not _compatible(e.dtype, schema[e.index]):
            _fail("dtype-mismatch", path,
                  f"{e} declares {e.dtype} but the input schema produces "
                  f"{schema[e.index]} at column {e.index}")
        if device and e.dtype.is_host_object:
            _fail("host-object-on-device", path,
                  f"{e} ({e.dtype}) is a host object array and cannot be "
                  "stacked into device shards")
        return
    if isinstance(e, Const):
        if device and isinstance(e.value, str):
            _fail("unlowered-string", path,
                  f"raw string constant {e.value!r} reached a device "
                  "expression (dictionary lowering did not apply)")
        return
    if isinstance(e, Func):
        if device:
            from ..executor.physical import DEVICE_OPS
            if e.op not in DEVICE_OPS:
                _fail("op-not-device", path,
                      f"op {e.op!r} is not in the device capability "
                      "registry but was pushed into a cop DAG")
            if e.dtype is not None and e.dtype.is_host_object:
                _fail("host-object-on-device", path,
                      f"{e.op} produces {e.dtype}, a host-object type")
        if e.op in _ARITH_OPS and not lowered \
                and _family(e.dtype) != "str":
            for a in e.args:
                if a.dtype is not None and _family(a.dtype) == "str":
                    _fail("undeclared-promotion", path,
                          f"{e.op} produces {e.dtype} from a string-"
                          f"family argument ({a.dtype}) without a "
                          "declared cast — dictionary codes are not "
                          "numbers")
        sub_lowered = (lowered or e.op in ("dict_map", "dict_lut")
                       or getattr(e, "_derived_dict", None) is not None)
        for a in e.args:
            _check_expr(a, schema, path, device, sub_lowered)


# --------------------------------------------------------------------- #
# device DAG verification (memoized on the frozen DAG)
# --------------------------------------------------------------------- #

def verify_dag(root: D.CopNode) -> None:
    """Verify a pushed cop DAG bottom-up.  Memoized: DAG nodes are frozen
    dataclasses (they already key the jit-program cache), so repeated
    admission of the same program costs one dict hit."""
    _verify_dag_cached(root)


@functools.lru_cache(maxsize=1024)
def _verify_dag_cached(root: D.CopNode) -> bool:
    _verify_dag(root, ())
    return True


def _verify_dag(node: D.CopNode, path) -> None:
    p = path + (type(node).__name__,)
    for c in node.children():
        if c is None:
            _fail("arity", p, "missing child node")
        _verify_dag(c, p)

    if isinstance(node, D.TableScan):
        if len(node.col_offsets) != len(node.col_dtypes):
            _fail("arity", p,
                  f"{len(node.col_offsets)} column offsets vs "
                  f"{len(node.col_dtypes)} dtypes")
        if any(o < 0 for o in node.col_offsets):
            _fail("column-ref", p, "negative column offset")
        for t in node.col_dtypes:
            if t.is_host_object:
                _fail("host-object-on-device", p,
                      f"scan reads {t}, a host-object column that never "
                      "ships to device")
        return

    schema = D.output_dtypes(node.children()[0]) if node.children() else ()

    if isinstance(node, D.Selection):
        for cond in node.conditions:
            _check_expr(cond, schema, p, device=True)
    elif isinstance(node, D.Projection):
        if not node.exprs:
            _fail("arity", p, "projection with no expressions")
        for e in node.exprs:
            _check_expr(e, schema, p, device=True)
    elif isinstance(node, D.Expand):
        if node.levels < 1 or node.levels > len(node.keys) + 1:
            _fail("capacity-shape", p,
                  f"levels={node.levels} out of range for "
                  f"{len(node.keys)} rollup keys")
        for e in node.keys:
            _check_expr(e, schema, p, device=True)
    elif isinstance(node, D.Aggregation):
        for g in node.group_by:
            _check_expr(g, schema, p, device=True)
        for a in node.aggs:
            if a.arg is not None:
                _check_expr(a.arg, schema, p, device=True)
            elif a.func not in (D.AggFunc.COUNT,):
                _fail("agg-arg", p, f"{a.func.value} requires an argument")
        if node.strategy == D.GroupStrategy.SCALAR:
            if node.group_by:
                _fail("capacity-shape", p,
                      "SCALAR aggregation with group-by keys")
        elif node.strategy == D.GroupStrategy.DENSE:
            if len(node.domain_sizes) != len(node.group_by):
                _fail("capacity-shape", p,
                      f"DENSE domain_sizes arity {len(node.domain_sizes)} "
                      f"!= group_by arity {len(node.group_by)}")
            if any(s <= 0 for s in node.domain_sizes):
                _fail("capacity-shape", p,
                      f"non-positive dense domain size in "
                      f"{node.domain_sizes}")
        elif node.strategy == D.GroupStrategy.SORT:
            if not node.group_by:
                _fail("capacity-shape", p, "SORT aggregation without keys")
            if node.group_capacity < 0:
                _fail("capacity-shape", p,
                      f"negative group capacity {node.group_capacity}")
        elif node.strategy in D.RADIX_STRATEGIES:
            sname = node.strategy.value.upper()
            if not node.group_by:
                _fail("capacity-shape", p,
                      f"{sname} aggregation without keys")
            b = node.num_buckets
            if b <= 0 or (b & (b - 1)) != 0:
                # the radix partition masks the top log2(B) hash bits and
                # the state table is (B,): a malformed bucket count would
                # trace a garbage-shaped program
                _fail("capacity-shape", p,
                      f"{sname} num_buckets {b} is not a positive power "
                      "of two")
            if node.strategy is D.GroupStrategy.SCATTER \
                    and D.radix_passes(b) > D.MAX_RADIX_PASSES:
                # pass well-formedness: each pass is a full-data
                # reorder, so a bucket space whose bit span prices more
                # than MAX_RADIX_PASSES passes would cost more data
                # movement than the comparator sort it replaces
                _fail("capacity-shape", p,
                      f"SCATTER num_buckets {b} prices "
                      f"{D.radix_passes(b)} radix passes "
                      f"(> {D.MAX_RADIX_PASSES}): malformed bucket "
                      "space")
            if node.prehashed:
                _verify_prehashed(node, schema, p)
        if node.prehashed and node.strategy not in D.RADIX_STRATEGIES:
            _fail("capacity-shape", p,
                  f"prehashed set on a {node.strategy.value} "
                  "aggregation: only the radix strategies "
                  "(SEGMENT/SCATTER) read a hoisted hash column")
        if node.narrow_sums:
            # valueflow-proven single-word SUM states: only in-program
            # (psum-merged) strategies carry them, and only int/decimal
            # SUM slots qualify — a narrow float or COUNT slot would
            # trace a program whose state layout disagrees with the
            # merge/finalize contract
            if node.strategy not in (D.GroupStrategy.SCALAR,
                                     D.GroupStrategy.DENSE):
                _fail("capacity-shape", p,
                      f"narrow_sums on a {node.strategy.value} "
                      "aggregation: only SCALAR/DENSE (in-program psum) "
                      "states take the single-word layout")
            from ..types.dtypes import TypeKind as _K
            for i in node.narrow_sums:
                if i < 0 or i >= len(node.aggs):
                    _fail("capacity-shape", p,
                          f"narrow_sums index {i} out of range for "
                          f"{len(node.aggs)} aggregates")
                a = node.aggs[i]
                if a.func != D.AggFunc.SUM or a.arg is None \
                        or a.arg.dtype is None \
                        or a.arg.dtype.kind in (_K.FLOAT64, _K.FLOAT32):
                    _fail("capacity-shape", p,
                          f"narrow_sums index {i} is not an int/decimal "
                          "SUM: only limb-split SUM states have a narrow "
                          "twin")
    elif isinstance(node, D.TopN):
        keys = node.sort_keys or (((node.sort_key, node.desc),)
                                  if node.sort_key is not None else ())
        if not keys:
            _fail("arity", p, "TopN without sort keys")
        for e, _desc in keys:
            _check_expr(e, schema, p, device=True)
        if node.limit < 0:
            _fail("capacity-shape", p, f"negative limit {node.limit}")
    elif isinstance(node, D.Limit):
        if node.limit < 0:
            _fail("capacity-shape", p, f"negative limit {node.limit}")
    elif isinstance(node, D.LookupJoin):
        if node.kind not in ("inner", "left", "semi", "anti"):
            _fail("arity", p, f"unknown join kind {node.kind!r}")
        _check_expr(node.probe_key, schema, p, device=True)
        if not node.unique and node.out_capacity <= 0:
            _fail("capacity-shape", p,
                  "expanding (non-unique) lookup join without a positive "
                  "out_capacity")
        if node.aux_slot < 0:
            _fail("capacity-shape", p, f"negative aux_slot {node.aux_slot}")
        if node.kind in ("inner", "left"):
            for t in node.build_dtypes:
                if t.is_host_object:
                    _fail("host-object-on-device", p,
                          f"broadcast build column of type {t}")


def _verify_prehashed(node: D.Aggregation, schema, p) -> None:
    """Contract of the prehash hoist (store/client + copr/radix): the
    LAST scan column is the hoisted int64 key hash, the chain below the
    aggregation is a plain TableScan(+Selection) (anything reshaping
    the batch would strand the appended column), and no group key may
    read the hash column itself."""
    cur = node.child
    while isinstance(cur, D.Selection):
        cur = cur.child
    if not isinstance(cur, D.TableScan):
        _fail("capacity-shape", p,
              "prehashed aggregation over a non-scan chain: the hoisted "
              "hash column only rides a TableScan(+Selection) batch")
    if not schema or _family(schema[-1]) != "int":
        _fail("dtype-mismatch", p,
              "prehashed aggregation whose last scan column is not an "
              "int64-family hash lane")
    hash_idx = len(schema) - 1
    for g in node.group_by:
        for ref in (x for x in _walk_refs(g)):
            if ref.index == hash_idx:
                _fail("column-ref", p,
                      "group key reads the hoisted hash column "
                      f"(index {hash_idx}) — keys must read data "
                      "columns only")


def _walk_refs(e: Expr):
    if isinstance(e, ColumnRef):
        yield e
    elif isinstance(e, Func):
        for a in e.args:
            yield from _walk_refs(a)


# physical-plan verification
# --------------------------------------------------------------------- #

def verify_plan(plan) -> int:
    """Walk a built physical plan and check every operator's declared
    contract against its children's.  Returns the number of operators
    checked; raises PlanContractError on the first violation.  Called
    from the session plan path (before any execute or launch) and from
    the analysis gate over the TPC-H plan corpus."""
    from ..executor import physical as X
    return _verify_op(plan, (), X)


def _schema_of(op) -> Tuple[dt.DataType, ...]:
    return tuple(op.out_dtypes)


def _verify_op(op, path, X) -> int:
    c = op.contract() if hasattr(op, "contract") else {}
    p = path + (c.get("op", type(op).__name__),)
    n = 1
    for child in getattr(op, "children", []) or []:
        if child is not None:
            n += _verify_op(child, p, X)

    out = tuple(c.get("out_dtypes", ()))
    names = tuple(c.get("out_names", ()))
    if names and out and len(names) != len(out):
        _fail("arity", p,
              f"{len(names)} output names vs {len(out)} output dtypes")

    if isinstance(op, X.CopTaskExec):
        verify_dag(op.dag)
        if isinstance(op.dag, D.Aggregation):
            want = len(op.key_meta) + len(op.dag.aggs)
            if names and len(names) != want:
                _fail("arity", p,
                      f"aggregation produces {want} columns "
                      f"({len(op.key_meta)} keys + {len(op.dag.aggs)} "
                      f"aggs) but the contract declares {len(names)}")
        else:
            dag_out = D.output_dtypes(op.dag)
            if out and len(out) != len(dag_out):
                _fail("arity", p,
                      f"DAG emits {len(dag_out)} columns but the "
                      f"contract declares {len(out)}")
            for i, (a, b) in enumerate(zip(out, dag_out)):
                if not _compatible(a, b):
                    _fail("dtype-mismatch", p,
                          f"output column {i}: contract declares {a}, "
                          f"DAG produces {b}")
    elif isinstance(op, X.CopJoinTaskExec):
        verify_dag(op.dag)
        builds = (op.builds if op.builds
                  else [{"exec": op.build_exec,
                         "key_index": op.build_key_index}])
        for b in builds:
            bx = b["exec"]
            if bx is None:
                _fail("arity", p, "broadcast join without a build plan")
            ki = b.get("key_index", 0)
            if not (0 <= ki < len(bx.out_dtypes)):
                _fail("column-ref", p,
                      f"build key index {ki} out of range for the "
                      f"{len(bx.out_dtypes)}-column build side")
        if op.fallback is not None:
            n += _verify_op(op.fallback, p, X)
    elif isinstance(op, X.CopShuffleJoinExec):
        n += _verify_shuffle_spec(op.spec, p)
    elif isinstance(op, X.HostSelection):
        schema = _schema_of(op.child)
        for cond in op.conditions:
            _check_expr(cond, schema, p)
    elif isinstance(op, X.HostProjection):
        schema = _schema_of(op.child)
        for e in op.exprs:
            _check_expr(e, schema, p)
    elif isinstance(op, (X.HostSort, X.HostTopN)):
        schema = _schema_of(op.child)
        for e, _desc in op.keys:
            _check_expr(e, schema, p)
    elif isinstance(op, X.HostHashJoin):   # + merge/index-lookup subclasses
        ls, rs = _schema_of(op.left), _schema_of(op.right)
        for lk, rk in op.eq_keys:
            if not (0 <= lk < len(ls)):
                _fail("column-ref", p, f"left join key {lk} out of range")
            if not (0 <= rk < len(rs)):
                _fail("column-ref", p, f"right join key {rk} out of range")
            lf, rf = _family(ls[lk]), _family(rs[rk])
            if lf != rf and "?" not in (lf, rf) \
                    and ls[lk].kind != K.NULL and rs[rk].kind != K.NULL:
                _fail("dtype-mismatch", p,
                      f"join keys disagree on representation family: "
                      f"{ls[lk]} vs {rs[rk]}")
        if out:
            if op.kind in ("semi", "anti"):
                want = len(ls)
            elif op.kind in ("inner", "left", "right", "cross"):
                want = len(ls) + len(rs)
            else:
                want = len(out)
            if len(out) != want:
                _fail("arity", p,
                      f"{op.kind} join of {len(ls)}+{len(rs)} columns "
                      f"declares {len(out)} outputs (expected {want})")
    elif isinstance(op, X.HostSetOp):
        kids = [k for k in op.children if k is not None]
        widths = {len(k.out_dtypes) for k in kids}
        if len(widths) > 1:
            _fail("arity", p,
                  f"set-operation children disagree on column count: "
                  f"{sorted(widths)}")
    return n


def _verify_shuffle_spec(spec: D.ShuffleJoinSpec, path) -> int:
    """Exchange-boundary agreement: both sides' chains, their declared
    schemas, the key exprs, and the post-exchange `top` chain must all
    describe the same columns — the mesh handshake of an MPP shuffle.
    The schema/boundary half lives in analysis/shardflow (the single
    source both this pass and the sharding-flow pass consume — thin
    delegation so the two passes report the same rule and never
    drift)."""
    p = path + ("ShuffleJoinSpec",)
    verify_dag(spec.left)
    verify_dag(spec.right)
    ls, rs = D.output_dtypes(spec.left), D.output_dtypes(spec.right)
    from .shardflow import verify_shuffle_boundary
    verify_shuffle_boundary(spec, path)
    _check_expr(spec.left_key, ls, p, device=True)
    _check_expr(spec.right_key, rs, p, device=True)
    verify_dag(spec.top)
    return 1


# --------------------------------------------------------------------- #
# sched admission verification (capacity-shape handshake)
# --------------------------------------------------------------------- #

def verify_task(task) -> None:
    """Admission-time contract check for a structured CopTask: the
    stacked device inputs must match the task key's capacity signature
    (the precondition for in-flight dedup and batch-slot coalescing to
    be shape-safe) and divide evenly over the mesh's shard axis.  Cheap:
    tuple/shape comparisons plus a memoized DAG walk — runs before the
    scheduler resolves (and thus traces/compiles) the program."""
    if task.key is None or task.dag is None:
        return
    p = ("sched", type(task.dag).__name__)
    verify_dag(task.dag)
    from ..sched.task import _shape_sig, mesh_fingerprint
    if task.key[1] != mesh_fingerprint(task.mesh):
        _fail("mesh-mismatch", p,
              "task key was built against a different mesh than the one "
              "it is being admitted to")
    if task.row_capacity < 0:
        _fail("capacity-shape", p,
              f"negative row capacity {task.row_capacity}")
    sig = _shape_sig(task.cols, task.counts)
    if task.key[3] != sig:
        _fail("capacity-shape", p,
              f"stacked input shapes {sig} disagree with the task key's "
              f"capacity signature {task.key[3]}")
    n_dev = len(task.mesh)
    shapes = {tuple(v.shape[:2]) for v, _m in task.cols
              if getattr(v, "ndim", 0) >= 2}
    if len(shapes) > 1:
        _fail("capacity-shape", p,
              f"stacked columns disagree on (shards, capacity): "
              f"{sorted(shapes)}")
    for s, _cap in shapes:
        if n_dev and s % n_dev != 0:
            _fail("capacity-shape", p,
                  f"{s} shards do not divide over {n_dev} devices on the "
                  "shard axis")
    # sharding-flow handshake (analysis/shardflow): the task's mesh must
    # carry the exchange axis and its DAG must flow clean against the
    # mesh's typed-link topology (implicit reshards, merge routing,
    # psum limb-fence bound) — still before any launch, still memoized
    from .shardflow import verify_task_sharding
    verify_task_sharding(task)
    # value-range handshake (analysis/valueflow): the task's DAG must
    # flow finite, int64-safe intervals — a digest the session proved at
    # plan time is a registry hit; an unknown digest re-flows from type
    # domains.  Still before any launch, still memoized.
    from .valueflow import verify_task_values
    verify_task_values(task)
    if getattr(task, "donate", False):
        # donation-safety handshake (analysis/lifetime): a donating
        # task must be in an EPHEMERAL program class and its inputs
        # must not be live snapshot-cache residents
        from .lifetime import verify_task_donation
        verify_task_donation(task)


# --------------------------------------------------------------------- #
# cross-query fusion verification (the scheduler's fusion-group seam)
# --------------------------------------------------------------------- #

# rows-chain node kinds that may join a rows fusion group: pure scan
# chains only — joins bring aux inputs / extras the fused launch cannot
# carry per member
_ROWS_FUSABLE_NODES = (D.TableScan, D.Selection, D.Projection, D.Expand,
                       D.TopN, D.Limit)


def _rows_fusable(node: D.CopNode) -> bool:
    if not isinstance(node, _ROWS_FUSABLE_NODES):
        return False
    return all(_rows_fusable(c) for c in node.children())


def fusion_signature(dag: D.CopNode) -> Optional[tuple]:
    """Contract-level fusion class of a pushed cop DAG, or None when the
    plan cannot join a cross-query fusion group.  Structural only: the
    DAG's fields, nothing launched.

    Fusable classes (all members of one group share the returned tuple):

    - ``('inprog-agg',)`` — an Aggregation whose whole merge happens
      in-program (SCALAR/DENSE) with no expanding join in the chain
      (extras drive a per-task regrow loop).
    - ``('segment-agg', num_buckets)`` — a SEGMENT (radix-partitioned
      high-NDV) aggregation: host-merged group tables fuse via a
      per-member sharded out_spec, but ONLY among identical bucket
      spaces — the bucket count is part of the signature, so tasks with
      incompatible bucket shapes refuse to group at the key level
      instead of silently degrading to per-program launches.
    - ``('scatter-agg', num_buckets, passes)`` — the SCATTER (multi-
      pass scatter radix partition) twin: bucket space AND priced pass
      count are both part of the class, so members always agree on the
      partition program shape (a regrown bucket space changes both).
    - ``('sort-agg', group_capacity)`` — a SORT aggregation whose
      group-table capacity is a concrete power of two (the capacity-
      bucketed shape classes of the fusion-breadth follow-on: the
      client's regrow discipline only ever produces pow2 capacities,
      so regrow-sized tasks land in shared classes instead of none).
      Capacity 0 (planner left sizing to the client) or a non-pow2
      capacity has no static shape class and stays unfusable.
    - ``('rows',)`` — an extras-free pure scan chain returning rows
      (fusion-breadth follow-on): members fuse with per-member output
      capacities (spmd.FusedRowsProgram)."""
    if not isinstance(dag, D.Aggregation):
        if not _rows_fusable(dag):
            return None
        try:
            verify_dag(dag)
        except PlanContractError:
            return None
        return ("rows",)
    if D.find_expand_join(dag) is not None:
        return None
    if dag.strategy == D.GroupStrategy.SORT:
        cap = dag.group_capacity
        if cap <= 0 or (cap & (cap - 1)) != 0:
            return None     # no static shape class to share
    try:
        verify_dag(dag)
    except PlanContractError:
        return None
    if dag.strategy == D.GroupStrategy.SORT:
        return ("sort-agg", dag.group_capacity)
    if dag.strategy == D.GroupStrategy.SCATTER:
        return ("scatter-agg", dag.num_buckets,
                D.radix_passes(dag.num_buckets))
    if dag.strategy == D.GroupStrategy.SEGMENT:
        return ("segment-agg", dag.num_buckets)
    if dag.narrow_sums:
        # proven-narrow members only fuse with members proving the SAME
        # slots narrow: the fused leaves' state layouts (single word vs
        # limb pair) are baked into the traced program
        return ("agg-narrow", dag.narrow_sums)
    return ("inprog-agg",)


def verify_fusion_group(tasks: Sequence) -> None:
    """Pre-launch contract check of a fusion group: every member must be
    individually fusable and all members must agree on mesh fingerprint,
    capacity signature (stacked input shapes + dtypes), shared scan
    inputs, and empty aux — the preconditions for computing N payloads
    from one scan pass to be shape-safe AND bit-identical to N solo
    runs.  Raises PlanContractError; the scheduler falls back to
    unfused per-program launches on refusal."""
    p = ("sched", "FusedDag")
    if len(tasks) < 2:
        _fail("fusion-group", p, "fusion group needs >= 2 members")
    lead = tasks[0]
    lead_sig = fusion_signature(lead.dag) if lead.dag is not None else None
    for t in tasks:
        if t.key is None or t.dag is None:
            _fail("fusion-group", p, "opaque task in a fusion group")
        sig = fusion_signature(t.dag)
        if sig is None:
            _fail("fusion-class", p,
                  f"member {type(t.dag).__name__} is not in a fusable "
                  "contract class")
        if sig != lead_sig:
            # e.g. a SEGMENT member whose bucket space differs from the
            # group's: refuse loudly instead of silently degrading
            _fail("fusion-class", p,
                  f"member fusion signature {sig} disagrees with the "
                  f"group's {lead_sig} (incompatible strategy or bucket "
                  "shape)")
        if t.key[1] != lead.key[1]:
            _fail("mesh-mismatch", p,
                  "fusion group members were keyed against different "
                  "meshes")
        if t.key[3] != lead.key[3]:
            _fail("capacity-shape", p,
                  f"member capacity signature {t.key[3]} disagrees with "
                  f"the group's {lead.key[3]} (shapes/dtypes must be "
                  "byte-identical to share one scan)")
        if t.input_token != lead.input_token:
            _fail("fusion-input", p,
                  "members read different snapshot residents — a fused "
                  "program computes every payload from ONE scan")
        if t.aux != ():
            _fail("fusion-input", p,
                  "host-materialized aux inputs (join builds) do not "
                  "fuse across queries")


__all__ = ["PlanContractError", "verify_plan", "verify_dag", "verify_task",
           "fusion_signature", "verify_fusion_group"]

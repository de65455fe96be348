# ported from tidb_tpu/planner/build.py @ 9d319cb
"""AST -> logical plan builder (name/type resolution).

Reference analog: pkg/planner/core/logical_plan_builder.go (PlanBuilder) —
resolves identifiers against child schemas, types every expression (into
expr/ir.py IR), splits AVG into SUM/COUNT (SURVEY.md §A.4), rewrites
aggregate queries into LogicalAggregate + projection over its output, and
resolves ORDER BY against aliases/positions/underlying columns with hidden
columns, like the reference's havingWindowAndOrderbyExprResolver.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..copr.dag import AggFunc
from ..expr import builders as B
from ..expr.ir import ColumnRef, Const, Expr, Func
from ..sql import ast as A
from ..types import dtypes as dt
from ..types import temporal as tmp
from ..copr.aggregate import sum_out_dtype
from .logical import (AggItem, CTEStorage, DataSource, LogicalAggregate,
                      LogicalCTEScan, LogicalExpand, LogicalJoin,
                      LogicalLimit, LogicalPlan, LogicalProjection,
                      LogicalSelection, LogicalSetOp, LogicalSort,
                      LogicalTopN, LogicalWindow, Schema, SchemaCol,
                      WindowItem)

K = dt.TypeKind

AGG_FUNCS = {"SUM", "COUNT", "AVG", "MIN", "MAX",
             "STDDEV", "STD", "STDDEV_POP", "STDDEV_SAMP",
             "VARIANCE", "VAR_POP", "VAR_SAMP",
             "BIT_AND", "BIT_OR", "BIT_XOR",
             "GROUP_CONCAT", "ANY_VALUE", "APPROX_COUNT_DISTINCT",
             "JSON_ARRAYAGG", "GROUPING"}

_CMP = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}
_ARITH = {"+": "add", "-": "sub", "*": "mul", "/": "div", "DIV": "intdiv",
          "%": "mod"}


class PlanError(ValueError):
    pass


# Session-installed hook that plans+executes an uncorrelated subquery AST
# and returns its scalar result as a Const (None when absent — e.g. pure
# parser/planner tests).  ContextVar so concurrent server sessions don't
# stomp each other.
import contextvars

SUBQUERY_EXECUTOR: contextvars.ContextVar = contextvars.ContextVar(
    "subquery_executor", default=None)

# Correlated-subquery ident hook: consulted by _b_ident when the local
# schema misses; returns an Expr or None.  Installed (a) during the
# trial build that discovers a subquery's outer references, and (b)
# during per-row apply execution with actual outer values bound.
OUTER_RESOLVER: contextvars.ContextVar = contextvars.ContextVar(
    "outer_resolver", default=None)

# list the session installs per statement; builders append a reason when
# the plan embeds statement-time state (NOW(), scalar subquery results)
# so the plan cache skips it
# session identity visible to scalar functions (DATABASE()/USER()/
# CONNECTION_ID()/LAST_INSERT_ID()): set by the session around planning
SESSION_INFO: contextvars.ContextVar = contextvars.ContextVar(
    "session_info", default=None)

PLAN_TAINTS: contextvars.ContextVar = contextvars.ContextVar(
    "plan_taints", default=None)

# sequence-name resolver installed by the session: name -> SequenceInfo
SEQUENCE_RESOLVER: contextvars.ContextVar = contextvars.ContextVar(
    "sequence_resolver", default=None)


def _taint_plan(reason: str) -> None:
    t = PLAN_TAINTS.get()
    if t is not None:
        t.append(reason)


# --------------------------------------------------------------------- #
# expression building over a schema
# --------------------------------------------------------------------- #

class ExprBuilder:
    """AST expression -> typed IR over `schema`.  Aggregate calls are
    rejected unless an agg_resolver intercepts them (select-list path);
    window calls likewise require a window_resolver."""

    def __init__(self, schema: Schema, agg_resolver=None,
                 window_resolver=None, outer_resolver=None):
        self.schema = schema
        self.agg_resolver = agg_resolver
        self.window_resolver = window_resolver
        # correlated-subquery hook: called with an Ident the local schema
        # can't resolve; returns an Expr bound to the OUTER query or None
        self.outer_resolver = outer_resolver

    def build(self, n: A.Node) -> Expr:
        m = getattr(self, f"_b_{type(n).__name__.lower()}", None)
        if m is None:
            raise PlanError(f"unsupported expression {type(n).__name__}")
        return m(n)

    # ---- leaves ---- #

    def _b_sysvar(self, n: "A.SysVar") -> Expr:
        """@@sysvar / @uservar -> session-resolved constant (plans
        tainted: the value varies per connection/SET)."""
        info = SESSION_INFO.get() or {}
        _taint_plan("sysvar")
        getter = info.get("getuservar" if n.user else "getvar")
        v = getter(n.name, n.scope) if getter is not None else None
        if v is None:
            return Const(dt.null_type(), None)
        if isinstance(v, bool):
            return Const(dt.bigint(False), int(v))
        if isinstance(v, int):
            return Const(dt.bigint(False), v)
        if isinstance(v, float):
            return Const(dt.double(False), v)
        return Const(dt.varchar(False), str(v))

    def _b_ident(self, n: A.Ident) -> Expr:
        if len(n.parts) == 1:
            q, name = None, n.parts[0]
        else:
            q, name = n.parts[-2], n.parts[-1]
        hits = self.schema.find(name, q)
        # NO unqualified fallback on a qualifier miss: that silently
        # bound t.k inside a subquery over u to u.k — wrong results.
        # An outer_resolver (correlated subquery build) may claim it.
        if not hits:
            res = self.outer_resolver or OUTER_RESOLVER.get()
            if res is not None:
                out = res(n)
                if out is not None:
                    return out
            raise PlanError(f"unknown column {'.'.join(n.parts)!r}")
        if len(hits) > 1:
            raise PlanError(f"ambiguous column {name!r}")
        return self.schema.ref(hits[0])

    def _b_lit(self, n: A.Lit) -> Expr:
        if n.kind == "int":
            return B.lit(int(n.value))
        if n.kind == "bool":
            return B.lit(int(n.value))
        if n.kind == "decimal":
            return B.decimal_lit(str(n.value))
        if n.kind == "float":
            return B.lit(float(n.value))
        if n.kind == "str":
            return B.lit(str(n.value))
        if n.kind == "null":
            return B.lit(None)
        if n.kind == "date":
            return B.lit(str(n.value), dt.date())
        if n.kind == "datetime":
            return B.lit(str(n.value), dt.datetime())
        if n.kind == "interval":
            raise PlanError("INTERVAL only valid in +/- with a date")
        raise PlanError(f"unknown literal kind {n.kind}")

    # ---- operators ---- #

    def _b_binary(self, n: A.Binary) -> Expr:
        op = n.op
        if op in ("AND", "OR", "XOR"):
            return B.logic(op.lower(), self.build(n.left), self.build(n.right))
        if op in _CMP:
            a, b = self.build(n.left), self.build(n.right)
            a, b = _coerce_compare(a, b)
            return B.compare(_CMP[op], a, b)
        if op in _ARITH:
            # temporal interval arithmetic
            if isinstance(n.right, A.Lit) and n.right.kind == "interval":
                return self._interval_arith(n)
            lhs, rhs = self.build(n.left), self.build(n.right)
            # MySQL numeric context: strings coerce to double ('12.7'+1)
            if lhs.dtype.is_string:
                lhs = _coerce_to(dt.double(), lhs)
            if rhs.dtype.is_string:
                rhs = _coerce_to(dt.double(), rhs)
            return B.arith(_ARITH[op], lhs, rhs)
        raise PlanError(f"unsupported operator {op}")

    def _interval_arith(self, n: A.Binary) -> Expr:
        base = self.build(n.left)
        iv: A.Lit = n.right
        amt_e = ExprBuilder(self.schema).build(iv.value) \
            if isinstance(iv.value, A.Node) else B.lit(int(iv.value))
        if not isinstance(amt_e, Const):
            raise PlanError("INTERVAL amount must be constant")
        amount = int(str(amt_e.value)) if not isinstance(amt_e.value, int) \
            else amt_e.value
        if n.op == "-":
            amount = -amount
        unit = iv.unit
        if base.dtype.is_string:
            base = _coerce_to(dt.datetime(), base)
        if base.dtype.kind not in (K.DATE, K.DATETIME):
            raise PlanError("INTERVAL arithmetic needs a date operand")
        if isinstance(base, Const) and base.dtype.kind == K.DATE \
                and unit in ("DAY", "MONTH", "YEAR"):
            return _fold_interval_const(base, amount, unit)
        return B.date_add(base, B.lit(amount), unit)

    def _b_unary(self, n: A.Unary) -> Expr:
        if n.op == "NOT":
            return B.logic("not", self.build(n.arg))
        if n.op == "-":
            a = self.build(n.arg)
            if isinstance(a, Const) and a.dtype.is_numeric:
                return Const(a.dtype, -a.value)
            return B.neg(a)
        raise PlanError(f"unsupported unary {n.op}")

    def _b_inexpr(self, n: A.InExpr) -> Expr:
        if any(isinstance(i, A.SubqueryExpr) for i in n.items):
            raise PlanError("IN (subquery) not supported yet")
        t = self.build(n.target)
        items = [_coerce_to(t.dtype, self.build(i)) for i in n.items]
        e = B.in_list(t, items)
        return B.logic("not", e) if n.negated else e

    def _b_betweenexpr(self, n: A.BetweenExpr) -> Expr:
        t = self.build(n.target)
        lo = _coerce_to(t.dtype, self.build(n.low))
        hi = _coerce_to(t.dtype, self.build(n.high))
        e = B.between(t, lo, hi)
        return B.logic("not", e) if n.negated else e

    def _b_likeexpr(self, n: A.LikeExpr) -> Expr:
        t = self.build(n.target)
        p = self.build(n.pattern)
        e = Func(dt.bigint(t.dtype.nullable), "like", (t, p))
        return B.logic("not", e) if n.negated else e

    def _b_isnullexpr(self, n: A.IsNullExpr) -> Expr:
        e = B.is_null(self.build(n.target))
        return B.logic("not", e) if n.negated else e

    def _b_caseexpr(self, n: A.CaseExpr) -> Expr:
        if n.operand is not None:
            op = self.build(n.operand)
            pairs = []
            for c, v in n.branches:
                cv = _coerce_to(op.dtype, self.build(c))
                pairs.append((B.compare("eq", op, cv), self.build(v)))
        else:
            pairs = [(self.build(c), self.build(v)) for c, v in n.branches]
        els = self.build(n.else_) if n.else_ is not None else None
        return B.case_when(pairs, els)

    def _b_castexpr(self, n: A.CastExpr) -> Expr:
        a = self.build(n.arg)
        tn = n.type_name.upper()
        if isinstance(a, Const) and isinstance(a.value, str):
            folded = _fold_const_str_cast(a.value, tn, n)
            if folded is not None:
                return folded
        if tn in ("SIGNED", "SIGNED INTEGER", "INT", "BIGINT"):
            to = dt.bigint()
        elif tn in ("UNSIGNED", "UNSIGNED INTEGER"):
            to = dt.ubigint()
        elif tn in ("DOUBLE", "REAL", "FLOAT"):
            to = dt.double()
        elif tn == "DECIMAL":
            to = dt.decimal(n.prec if n.prec > 0 else 10,
                            n.scale if n.scale >= 0 else 0)
        elif tn == "DATE":
            to = dt.date()
        elif tn in ("DATETIME", "TIMESTAMP"):
            to = dt.datetime()
        elif tn == "TIME":
            if isinstance(a, Const) and isinstance(a.value, str):
                return _time_literal(a)
            to = dt.time()
        elif tn in ("CHAR", "VARCHAR", "NCHAR", "BINARY"):
            # CAST(x AS CHAR[(n)]): string targets route non-string
            # sources to the host cast_char producer; string sources
            # stay and lower as dictionary truncation/passthrough
            ln = n.prec if n.prec > 0 else None
            if a.dtype.is_string:
                if ln is None:
                    return a
                node = Func(dt.varchar(a.dtype.nullable), "cast", (a,))
            else:
                node = Func(dt.varchar(a.dtype.nullable), "cast_char",
                            (a,))
            if ln is not None:
                object.__setattr__(node, "_char_len", int(ln))
            return node
        else:
            raise PlanError(f"unsupported CAST target {tn}")
        if a.dtype.is_string and to.kind in (dt.TypeKind.DATE,
                                             dt.TypeKind.DATETIME):
            # unparseable strings cast to NULL (relaxed MySQL coercion)
            return Func(to.with_nullable(True), "cast", (a,))
        return B.cast(a, to)

    def _b_funccall(self, n: A.FuncCall) -> Expr:
        name = n.name
        if n.over is not None:
            if self.window_resolver is None:
                raise PlanError(f"window function {name} not allowed here")
            return self.window_resolver(n)
        if name in AGG_FUNCS:
            if self.agg_resolver is None:
                raise PlanError(f"aggregate {name} not allowed here")
            return self.agg_resolver(n)
        if name in ("NEXTVAL", "LASTVAL", "SETVAL"):
            # sequence functions (reference: ddl/sequence.go,
            # expression/builtin_func: nextval/lastval/setval)
            resolver = SEQUENCE_RESOLVER.get()
            if resolver is None:
                raise PlanError(f"{name} requires a session context")
            if not n.args or not isinstance(n.args[0], A.Ident):
                raise PlanError(f"{name} needs a sequence name")
            seq = resolver(n.args[0].parts[-1])
            _taint_plan("sequence")      # side-effecting, never plan-cache
            ref = Const(dt.bigint(False), seq)
            if name == "NEXTVAL":
                return Func(dt.bigint(False), "seq_next", (ref,))
            if name == "LASTVAL":
                return Func(dt.bigint(True), "seq_last", (ref,))
            if len(n.args) != 2:
                raise PlanError("SETVAL needs (sequence, value)")
            return Func(dt.bigint(False), "seq_set",
                        (ref, self.build(n.args[1])))
        if name in ("DATE_ADD", "ADDDATE", "DATE_SUB", "SUBDATE"):
            # the INTERVAL argument is not an expression — don't build it
            base = _coerce_to(dt.date(), self.build(n.args[0]))
            return self._date_addsub(name, n, [base])
        if name in ("TIMESTAMPDIFF", "TIMESTAMPADD"):
            # first argument is a bare unit keyword, not an expression
            if not n.args or not isinstance(n.args[0], A.Ident):
                raise PlanError(f"{name} needs a unit keyword")
            unit = n.args[0].parts[-1].upper()
            rest = [self.build(a) for a in n.args[1:]]
            if name == "TIMESTAMPADD":
                base = rest[1]
                if base.dtype.is_string:
                    base = _coerce_to(dt.datetime(), base)
                if not (isinstance(rest[0], Const)
                        and rest[0].value is not None):
                    raise PlanError("TIMESTAMPADD amount must be constant")
                return B.date_add(base, B.lit(int(rest[0].value)), unit)
            return self._timestampdiff(unit, rest[0], rest[1])
        if name == "GET_FORMAT":
            # first argument is a type keyword (DATE/TIME/DATETIME/...)
            if len(n.args) != 2:
                raise PlanError("GET_FORMAT takes (type, standard)")
            kind = (n.args[0].parts[-1].upper()
                    if isinstance(n.args[0], A.Ident)
                    else str(getattr(n.args[0], "value", "")).upper())
            std_e = self.build(n.args[1])
            std = (str(std_e.value).upper()
                   if isinstance(std_e, Const) else "")
            fmt = _GET_FORMATS.get((kind, std))
            return B.lit(fmt) if fmt is not None else B.lit(None)
        args = [self.build(a) for a in n.args
                if not isinstance(a, A.Star)]
        if name in ("YEAR", "MONTH", "QUARTER", "DAYOFWEEK", "WEEKDAY",
                    "DAYOFYEAR", "HOUR", "MINUTE", "SECOND", "MICROSECOND",
                    "TO_DAYS", "UNIX_TIMESTAMP"):
            base = args[0]
            if base.dtype.is_string:
                to = (dt.datetime() if name in ("HOUR", "MINUTE", "SECOND",
                                                "MICROSECOND",
                                                "UNIX_TIMESTAMP")
                      else dt.date())
                base = _coerce_to(to, base)
            return B.temporal_part(name.lower(), base)
        if name == "FROM_DAYS":
            return Func(dt.date(args[0].dtype.nullable), "from_days",
                        (args[0],))
        if name in ("DAY", "DAYOFMONTH"):
            return B.temporal_part("dayofmonth", args[0])
        if name == "LAST_DAY":
            return B.last_day(args[0])
        if name == "DATEDIFF":
            return B.datediff(_coerce_to(dt.date(), args[0]),
                              _coerce_to(dt.date(), args[1]))
        if name == "EXTRACT":
            # parser encodes EXTRACT(unit FROM x) as FuncCall with the unit
            # name stashed first as a string literal
            unit = n.args[0].value if isinstance(n.args[0], A.Lit) else None
            part = {"YEAR": "year", "MONTH": "month", "DAY": "dayofmonth",
                    "QUARTER": "quarter", "HOUR": "hour", "MINUTE": "minute",
                    "SECOND": "second",
                    "MICROSECOND": "microsecond"}.get(str(unit).upper())
            if part is None:
                raise PlanError(f"unsupported EXTRACT unit {unit}")
            return B.temporal_part(part, args[1])
        if name in ("VEC_COSINE_DISTANCE", "VEC_L2_DISTANCE",
                    "VEC_L1_DISTANCE", "VEC_NEGATIVE_INNER_PRODUCT"):
            # vector similarity (reference: types VectorFloat32 +
            # expression vec builtins); args coerce from '[..]' text
            return Func(dt.double(True), name.lower(),
                        (self._vec_arg(args[0], name),
                         self._vec_arg(args[1], name)))
        if name == "VEC_DIMS":
            return Func(dt.bigint(True), "vec_dims",
                        (self._vec_arg(args[0], name),))
        if name == "VEC_L2_NORM":
            return Func(dt.double(True), "vec_l2_norm",
                        (self._vec_arg(args[0], name),))
        if name == "VEC_FROM_TEXT":
            return self._vec_arg(args[0], name)
        if name == "VEC_AS_TEXT":
            return Func(dt.varchar(True), "vec_as_text",
                        (self._vec_arg(args[0], name),))
        if name == "ABS":
            return Func(args[0].dtype, "abs", tuple(args))
        if name in ("CEIL", "CEILING"):
            return B.math_func("ceil", args[0])
        if name == "FLOOR":
            return B.math_func("floor", args[0])
        if name in ("ROUND", "TRUNCATE"):
            d = 0
            if len(args) > 1:
                if not isinstance(args[1], Const):
                    raise PlanError(f"{name} digits must be constant")
                d = int(args[1].value)
            return B.round_func(args[0], d, truncate=(name == "TRUNCATE"))
        if name in ("POW", "POWER"):
            return B.math_func("pow", args[0], args[1])
        if name == "LOG" and len(args) == 2:
            return B.math_func("log", args[0], args[1])
        if name in ("SQRT", "EXP", "LOG", "LOG2", "LOG10", "SIN", "COS",
                    "TAN", "COT", "ASIN", "ACOS", "ATAN", "RADIANS",
                    "DEGREES"):
            op = "ln" if name == "LOG" else name.lower()
            return B.math_func(op, args[0])
        if name == "LN":
            return B.math_func("ln", args[0])
        if name == "ATAN2":
            return B.math_func("atan2", args[0], args[1])
        if name == "SIGN":
            return B.math_func("sign", args[0])
        if name == "PI":
            return B.lit(float(np.pi))
        if name == "MOD":
            return B.arith("mod", args[0], args[1])
        if name in ("GREATEST", "LEAST"):
            return B.greatest_least(name.lower(), args)
        if name in ("UPPER", "UCASE"):
            return self._str_func("upper", args[0])
        if name in ("LOWER", "LCASE"):
            return self._str_func("lower", args[0])
        if name in ("LENGTH", "OCTET_LENGTH"):
            return self._str_func("length", args[0])
        if name in ("CHAR_LENGTH", "CHARACTER_LENGTH"):
            return self._str_func("char_length", args[0])
        if name in ("SUBSTRING", "SUBSTR", "MID"):
            return self._str_func("substring", *args)
        if name == "CONCAT":
            return self._str_func("concat", *args)
        if name in ("TRIM", "LTRIM", "RTRIM", "REVERSE", "REPLACE",
                    "LEFT", "RIGHT", "LPAD", "RPAD", "ASCII", "LOCATE",
                    "INSTR", "REPEAT", "SUBSTRING_INDEX", "MD5", "SHA1",
                    "SHA2", "SOUNDEX", "CRC32", "STRCMP"):
            return self._str_func(name.lower(), *args)
        if name == "HEX" and args[0].dtype.kind == K.STRING:
            return self._str_func("hex", args[0])
        if name == "WEIGHT_STRING":
            if not args[0].dtype.is_string:
                return B.lit(None)     # MySQL: non-string -> NULL
            return self._str_func("weight_string", args[0],
                                  B.lit(args[0].dtype.collation))
        if name == "SHA":
            return self._str_func("sha1", *args)
        if name in ("WEEK", "WEEKOFYEAR"):
            base = args[0]
            if base.dtype.is_string:
                base = _coerce_to(dt.date(), base)
            if base.dtype.kind not in (K.DATE, K.DATETIME):
                raise PlanError(f"{name} needs a date operand")
            mode = 3 if name == "WEEKOFYEAR" else 0
            if name == "WEEK" and len(args) > 1:
                if not (isinstance(args[1], Const)
                        and args[1].value in (0, 3)):
                    raise PlanError("WEEK supports modes 0 and 3")
                mode = int(args[1].value)
            return Func(dt.bigint(base.dtype.nullable), "week",
                        (base, B.lit(mode)))
        if name == "FROM_UNIXTIME" and len(args) == 1:
            return Func(dt.datetime(args[0].dtype.nullable),
                        "from_unixtime", (args[0],))
        if name == "MAKEDATE":
            return Func(dt.date(True), "makedate", (args[0], args[1]))
        if name == "DATE_FORMAT":
            if not (len(args) == 2 and isinstance(args[1], Const)
                    and isinstance(args[1].value, str)):
                raise PlanError("DATE_FORMAT needs a constant format")
            base = args[0]
            if base.dtype.is_string:
                base = _coerce_to(dt.datetime(), base)
            if base.dtype.kind not in (K.DATE, K.DATETIME):
                raise PlanError("DATE_FORMAT needs a date operand")
            return Func(dt.varchar(base.dtype.nullable), "date_format",
                        (base, args[1]))
        if name == "CONCAT_WS":
            if len(args) < 2:
                raise PlanError("CONCAT_WS needs a separator + arguments")
            sep = args[0]
            if not (isinstance(sep, Const) and isinstance(sep.value, str)):
                raise PlanError("CONCAT_WS needs a constant separator")
            items = list(args[1:])
            null_ix = [i for i, a in enumerate(items) if a.dtype.nullable]
            if not null_ix:
                woven: list = []
                for a in items:
                    if woven:
                        woven.append(sep)
                    woven.append(a)
                return self._str_func("concat", *woven)
            # NULL args are SKIPPED (builtin_string.go concatWS): expand
            # the 2^k null patterns of the k nullable args into a CASE —
            # each branch is a plain concat, so the whole expression
            # lowers to merged-dictionary gathers on device
            if len(null_ix) > 4:
                raise PlanError("CONCAT_WS supports at most 4 nullable "
                                "arguments")
            pairs = []
            for pat in range(1, 1 << len(null_ix)):   # >=1 arg NULL
                conds = []
                skip = set()
                for b, i in enumerate(null_ix):
                    if pat >> b & 1:
                        conds.append(B.is_null(items[i]))
                        skip.add(i)
                    else:
                        conds.append(B.logic("not", B.is_null(items[i])))
                cond = conds[0]
                for c in conds[1:]:
                    cond = B.logic("and", cond, c)
                kept = [a for i, a in enumerate(items) if i not in skip]
                woven = []
                for a in kept:
                    if woven:
                        woven.append(sep)
                    woven.append(a)
                val = (self._str_func("concat", *woven) if woven
                       else B.lit(""))
                pairs.append((cond, val))
            woven = []
            for a in items:
                if woven:
                    woven.append(sep)
                woven.append(a)
            return B.case_when(pairs, self._str_func("concat", *woven))
        if name in ("BIN", "OCT") or (name == "HEX"
                                      and args[0].dtype.kind != K.STRING):
            if not args[0].dtype.is_integer:
                raise PlanError(f"{name} needs an integer operand")
            base = {"BIN": 2, "OCT": 8, "HEX": 16}[name]
            return Func(dt.varchar(args[0].dtype.nullable), "int_to_base",
                        (args[0], B.lit(base)))
        if name == "FORMAT":
            if not (len(args) == 2 and isinstance(args[1], Const)):
                raise PlanError("FORMAT needs a constant decimal count")
            return Func(dt.varchar(args[0].dtype.nullable), "format_num",
                        (args[0], args[1]))
        if name in ("DAYNAME", "MONTHNAME"):
            base = args[0]
            if base.dtype.is_string:
                base = _coerce_to(dt.date(), base)
            if base.dtype.kind not in (K.DATE, K.DATETIME):
                raise PlanError(f"{name} needs a date operand")
            if isinstance(base, Const):
                if base.value is None:
                    return Const(dt.null_type(), None)
                from ..types.temporal import days_to_date
                days = int(base.value)
                if base.dtype.kind == K.DATETIME:
                    from ..types.temporal import MICROS_PER_DAY
                    days //= MICROS_PER_DAY
                d0 = days_to_date(days)
                return B.lit(d0.strftime("%A") if name == "DAYNAME"
                             else d0.strftime("%B"))
            from ..expr.lower_strings import _derived_map
            if name == "DAYNAME":
                names_ = ["Monday", "Tuesday", "Wednesday", "Thursday",
                          "Friday", "Saturday", "Sunday"]
                key = Func(dt.bigint(base.dtype.nullable), "weekday",
                           (base,))
            else:
                names_ = ["", "January", "February", "March", "April",
                          "May", "June", "July", "August", "September",
                          "October", "November", "December"]
                key = Func(dt.bigint(base.dtype.nullable), "month",
                           (base,))
            return _derived_map(
                dt.varchar(base.dtype.nullable), key, names_)
        if name == "POSITION":
            return self._str_func("locate", args[0], args[1])
        if name == "ISNULL":
            return B.is_null(args[0])
        if name in ("QUOTE", "TO_BASE64", "FROM_BASE64", "UNHEX",
                    "BIT_LENGTH", "INET_ATON", "REGEXP_SUBSTR",
                    "REGEXP_REPLACE", "REGEXP_INSTR", "REGEXP_LIKE"):
            return self._str_func(name.lower(), *args)
        if name == "INSERT":
            if len(args) != 4:
                raise PlanError("INSERT needs (str, pos, len, newstr)")
            return self._str_func("insert_str", *args)
        if name == "ELT":
            # ELT(n, s1..sk) -> CASE n WHEN i THEN s_i (control-flow
            # rewrite lowers to merged-dictionary gathers on device)
            if len(args) < 2:
                raise PlanError("ELT needs an index + strings")
            pairs = [(B.compare("eq", args[0], B.lit(i)), a)
                     for i, a in enumerate(args[1:], 1)]
            return B.case_when(pairs, None)
        if name == "FIELD":
            if len(args) < 2:
                raise PlanError("FIELD needs a needle + candidates")
            pairs = [(B.compare("eq", args[0], a), B.lit(i))
                     for i, a in enumerate(args[1:], 1)]
            return B.case_when(pairs, B.lit(0))
        if name == "CONV":
            if len(args) != 3 \
                    or not all(isinstance(a, Const) for a in args[1:]):
                raise PlanError("CONV needs (x, const from_base, "
                                "const to_base)")
            x = args[0]
            if not x.dtype.is_string:
                xs = Func(dt.varchar(x.dtype.nullable), "cast_char", (x,))
            else:
                xs = x
            return self._str_func("conv", xs, args[1], args[2])
        if name == "INET_NTOA":
            return Func(dt.varchar(args[0].dtype.nullable), "inet_ntoa",
                        (args[0],))
        if name == "SPACE":
            if not (isinstance(args[0], Const)
                    and args[0].value is not None):
                raise PlanError("SPACE needs a constant count")
            k = max(int(args[0].value), 0)
            return B.lit(" " * min(k, 1 << 20))
        if name == "CHARSET":
            return B.lit("utf8mb4" if args[0].dtype.is_string else
                         "binary")
        if name == "COLLATION":
            return B.lit(args[0].dtype.collation
                         if args[0].dtype.is_string else "binary")
        if name in ("EXPORT_SET", "MAKE_SET"):
            return self._bit_weave(name, args)
        if name == "FIND_IN_SET":
            return self._str_func("find_in_set", args[0], args[1])
        if name in ("JSON_EXTRACT", "JSON_UNQUOTE", "JSON_TYPE",
                    "JSON_VALID", "JSON_LENGTH", "JSON_CONTAINS"):
            need = {"JSON_EXTRACT": (2, 2), "JSON_UNQUOTE": (1, 1),
                    "JSON_TYPE": (1, 1), "JSON_VALID": (1, 1),
                    "JSON_LENGTH": (1, 2), "JSON_CONTAINS": (2, 3)}[name]
            if not need[0] <= len(args) <= need[1]:
                raise PlanError(f"{name} takes {need[0]}"
                                + (f"..{need[1]}" if need[1] != need[0]
                                   else "") + " arguments")
            path_pos = {"JSON_EXTRACT": 1, "JSON_LENGTH": 1,
                        "JSON_CONTAINS": 2}.get(name)
            if path_pos is not None and path_pos < len(args) \
                    and isinstance(args[path_pos], Const) \
                    and isinstance(args[path_pos].value, str):
                from ..utils.jsonfns import JSONPathError, parse_path
                try:
                    parse_path(args[path_pos].value)
                except JSONPathError as e:
                    raise PlanError(str(e))
            return self._str_func(name.lower(), *args)
        if name in ("JSON_SET", "JSON_INSERT", "JSON_REPLACE",
                    "JSON_REMOVE", "JSON_KEYS", "JSON_SEARCH",
                    "JSON_MERGE_PATCH", "JSON_MERGE_PRESERVE",
                    "JSON_MERGE", "JSON_ARRAY_APPEND", "JSON_PRETTY",
                    "JSON_QUOTE", "JSON_VALUE", "JSON_DEPTH",
                    "JSON_CONTAINS_PATH", "JSON_STORAGE_SIZE",
                    "JSON_OVERLAPS"):
            if name == "JSON_SEARCH" and len(args) >= 4 \
                    and isinstance(args[3], Const) \
                    and args[3].value is None:
                # NULL escape means "default escape", not a NULL result
                args = list(args)
                args[3] = B.lit("")
            return self._str_func(name.lower(), *args)
        if name in ("JSON_ARRAY", "JSON_OBJECT"):
            # constant construction folds at plan time (the common form);
            # column args would need a per-row JSON composer
            vals = []
            for a in args:
                if not isinstance(a, Const):
                    raise PlanError(f"{name} supports constant arguments")
                vals.append(a)
            if name == "JSON_ARRAY":
                from ..utils.jsonfns import _dump
                return B.lit(_dump([_jval(v) for v in vals]))
            if len(vals) % 2:
                raise PlanError("JSON_OBJECT needs key/value pairs")
            from ..utils.jsonfns import _dump
            obj = {str(vals[i].value): _jval(vals[i + 1])
                   for i in range(0, len(vals), 2)}
            return B.lit(_dump(obj))
        if name in ("UUID_TO_BIN", "BIN_TO_UUID", "INET6_ATON",
                    "INET6_NTOA", "COMPRESS", "UNCOMPRESS", "IS_UUID",
                    "ORD"):
            return self._str_func(name.lower(), *args)
        if name == "NAME_CONST":
            if len(args) != 2 or not isinstance(args[0], Const):
                raise PlanError("NAME_CONST needs a constant name")
            return args[1]
        if name == "SEC_TO_TIME":
            return B.reinterpret(B.arith("mul", args[0], B.lit(1_000_000)),
                                 dt.time(args[0].dtype.nullable))
        if name == "TIME_TO_SEC":
            return B.arith("intdiv",
                           B.reinterpret(args[0], dt.bigint()),
                           B.lit(1_000_000))
        if name == "MAKETIME":
            s = B.arith("add",
                        B.arith("mul", args[0], B.lit(3600)),
                        B.arith("add", B.arith("mul", args[1], B.lit(60)),
                                args[2]))
            return B.reinterpret(B.arith("mul", s, B.lit(1_000_000)),
                                 dt.time(True))
        if name in ("PERIOD_ADD", "PERIOD_DIFF"):
            # pure integer algebra over YYYYMM periods — device-fusable
            def months(p):
                return B.arith(
                    "add", B.arith("mul",
                                   B.arith("intdiv", p, B.lit(100)),
                                   B.lit(12)),
                    B.arith("mod", p, B.lit(100)))
            if name == "PERIOD_DIFF":
                return B.arith("sub", months(args[0]), months(args[1]))
            ym = B.arith("add", B.arith("sub", months(args[0]), B.lit(1)),
                         args[1])
            return B.arith(
                "add", B.arith("mul", B.arith("intdiv", ym, B.lit(12)),
                               B.lit(100)),
                B.arith("add", B.arith("mod", ym, B.lit(12)), B.lit(1)))
        if name == "TO_SECONDS":
            base = args[0]
            if base.dtype.is_string:
                base = _coerce_to(dt.datetime(), base)
            if base.dtype.kind == K.DATE:
                days = B.arith("add",
                               B.datediff(base, B.lit(0, dt.date())),
                               B.lit(719_528))
                return B.arith("mul", days, B.lit(86_400))
            secs = B.arith("intdiv", B.cast(base, dt.bigint()),
                           B.lit(1_000_000))
            return B.arith("add", secs, B.lit(719_528 * 86_400))
        if name in ("ADDTIME", "SUBTIME", "TIMEDIFF"):
            dual_base = [False]

            def temporal_arg(x, base):
                if not x.dtype.is_string:
                    return x
                # datetime-shaped literals parse as DATETIME; a LEADING
                # '-' is a negative TIME, not a date separator
                if isinstance(x, Const) and isinstance(x.value, str):
                    if "-" in x.value.lstrip()[1:]:
                        return _coerce_to(dt.datetime(), x)
                    return _time_literal(x)
                if base:
                    # non-const string: MySQL decides datetime-vs-time
                    # per VALUE.  Try the datetime parse first and fall
                    # back to TIME — both casts lower to
                    # per-dictionary-value parse LUTs, so datetime-shaped
                    # columns no longer NULL out through CAST(.. AS TIME)
                    dual_base[0] = True
                    dtv = Func(dt.datetime(True), "cast", (x,))
                    tv = Func(dt.time(True), "cast", (x,))
                    return B.ifnull(
                        B.reinterpret(dtv, dt.bigint(True)),
                        B.reinterpret(tv, dt.bigint(True)))
                return _time_literal(x)
            # the base of ADDTIME/SUBTIME (and both TIMEDIFF sides) may
            # be datetime-shaped; ADDTIME's second arg is always a TIME
            a = temporal_arg(args[0], True)
            b = temporal_arg(args[1], name == "TIMEDIFF")
            if a.dtype.kind == K.NULL or b.dtype.kind == K.NULL:
                return B.lit(None)
            if name == "TIMEDIFF":
                out_t = dt.time(True)
            elif dual_base[0]:
                # dual-parsed string base: type follows the dominant
                # datetime reading (MySQL returns a string and formats
                # per value; a static engine type must pick one)
                out_t = dt.datetime(True)
            else:
                out_t = a.dtype.with_nullable(True)
            op = "sub" if name in ("SUBTIME", "TIMEDIFF") else "add"
            return B.reinterpret(
                B.arith(op, B.reinterpret(a, dt.bigint()),
                        B.reinterpret(b, dt.bigint())), out_t)
        if name == "IF":
            return B.if_(args[0], args[1], args[2])
        if name == "IFNULL":
            return B.ifnull(args[0], args[1])
        if name == "COALESCE":
            return B.coalesce(*args)
        if name == "NULLIF":
            return B.if_(B.compare("eq", args[0], args[1]), B.lit(None), args[0])
        if name == "DATE":
            return B.cast(args[0], dt.date())
        if name in ("VERSION",):
            return Const(dt.varchar(False), "8.0.11-tidb-tpu")
        if name in ("USER", "CURRENT_USER", "SESSION_USER", "SYSTEM_USER",
                    "DATABASE", "SCHEMA", "CONNECTION_ID",
                    "LAST_INSERT_ID", "ROW_COUNT", "FOUND_ROWS"):
            info = SESSION_INFO.get() or {}
            _taint_plan("session")       # identity varies per connection
            if name in ("DATABASE", "SCHEMA"):
                db = info.get("db")
                return Const(dt.varchar(True), db) if db \
                    else Const(dt.null_type(), None)
            if name == "CONNECTION_ID":
                return Const(dt.bigint(False), int(info.get("conn_id", 0)))
            if name == "LAST_INSERT_ID":
                return Const(dt.bigint(False),
                             int(info.get("last_insert_id", 0)))
            if name == "ROW_COUNT":
                return Const(dt.bigint(False), int(info.get("row_count",
                                                            -1)))
            if name == "FOUND_ROWS":
                return Const(dt.bigint(False),
                             int(info.get("found_rows", 0)))
            return Const(dt.varchar(False),
                         f"{info.get('user', 'root')}@%")
        if name == "UUID":
            _taint_plan("uuid")          # fresh per execution, never cache
            return Func(dt.varchar(False), "uuid", ())
        if name == "RAND":
            _taint_plan("rand")
            seed = None
            if args and isinstance(args[0], Const) \
                    and args[0].value is not None:
                seed = int(args[0].value)
            return Func(dt.double(False), "rand",
                        (Const(dt.bigint(False), seed),)
                        if seed is not None else ())
        if name == "BENCHMARK":
            return B.lit(0)              # MySQL: returns 0 (timing tool)
        if name == "COERCIBILITY":
            # literals are coercible (4), column values implicit (2)
            return B.lit(4 if isinstance(args[0], Const) else 2)
        if name == "STR_TO_DATE":
            if not (len(args) == 2 and isinstance(args[1], Const)
                    and isinstance(args[1].value, str)):
                raise PlanError("STR_TO_DATE needs a constant format")
            fmt = str(args[1].value)
            has_time = any(t in fmt for t in
                           ("%H", "%i", "%s", "%T", "%k", "%l", "%p",
                            "%r", "%f"))
            out = (dt.datetime(True) if has_time else dt.date(True))
            if isinstance(args[0], Const):
                if not isinstance(args[0].value, str):
                    return Const(dt.null_type(), None)
                from ..expr.lower_strings import _str_to_date_value
                r = _str_to_date_value(args[0].value, fmt)
                if r is None:
                    return Const(dt.null_type(), None)
                return Const(out, r[1] if has_time else r[0])
            return Func(out, "str_to_date", (args[0], args[1]))
        if name in ("UTC_DATE", "UTC_TIMESTAMP"):
            _taint_plan("now")
            import time as _time
            micros = int(_time.time() * 1_000_000)
            if name == "UTC_DATE":
                return Const(dt.date(False), micros // tmp.MICROS_PER_DAY)
            return Const(dt.datetime(False), micros)
        if name in ("NOW", "CURRENT_TIMESTAMP", "SYSDATE", "CURDATE",
                    "CURRENT_DATE"):
            # statement-start clock (MySQL: constant within a statement);
            # taints the plan so the cache never replays a stale clock
            _taint_plan("now")
            import time as _time
            now = _time.time()
            micros = int(now * 1_000_000)
            if name in ("CURDATE", "CURRENT_DATE"):
                return Const(dt.date(False), micros // tmp.MICROS_PER_DAY)
            return Const(dt.datetime(False), micros)
        from ..expr.host_eval import EXTENSION_FUNCS
        ext = EXTENSION_FUNCS.get(name.lower())
        if ext is not None:
            fn, arity = ext
            if arity >= 0 and len(args) != arity:
                raise PlanError(
                    f"function {name} expects {arity} arguments")
            _taint_plan("extension")   # host fn: never cache its plan
            return Func(dt.double(True), f"ext:{name.lower()}",
                        tuple(args))
        raise PlanError(f"unsupported function {name}")

    def _concat_ws_items(self, sep: Expr, items: list) -> Expr:
        """CONCAT_WS semantics over built items: NULL args are SKIPPED
        (builtin_string.go concatWS).  Nullable args expand into the 2^k
        null-pattern CASE so the whole expression lowers to dictionary
        gathers on device (shared by CONCAT_WS and MAKE_SET)."""
        null_ix = [i for i, a in enumerate(items) if a.dtype.nullable]
        if not null_ix:
            woven: list = []
            for a in items:
                if woven:
                    woven.append(sep)
                woven.append(a)
            return self._str_func("concat", *woven)
        if len(null_ix) > 4:
            raise PlanError("CONCAT_WS supports at most 4 nullable "
                            "arguments")
        pairs = []
        for pat in range(1, 1 << len(null_ix)):   # >=1 arg NULL
            conds = []
            skip = set()
            for b, i in enumerate(null_ix):
                if pat >> b & 1:
                    conds.append(B.is_null(items[i]))
                    skip.add(i)
                else:
                    conds.append(B.logic("not", B.is_null(items[i])))
            cond = conds[0]
            for c in conds[1:]:
                cond = B.logic("and", cond, c)
            kept = [a for i, a in enumerate(items) if i not in skip]
            woven = []
            for a in kept:
                if woven:
                    woven.append(sep)
                woven.append(a)
            val = (self._str_func("concat", *woven) if woven
                   else B.lit(""))
            pairs.append((cond, val))
        woven = []
        for a in items:
            if woven:
                woven.append(sep)
            woven.append(a)
        return B.case_when(pairs, self._str_func("concat", *woven))

    def _bit_weave(self, name: str, args) -> Expr:
        """EXPORT_SET(bits,on,off[,sep[,k]]) / MAKE_SET(bits,s1..sk):
        per-bit IF selections woven with the separator — the control-flow
        rewrite keeps device lowering possible for small k and falls to
        the row-wise host path beyond the dictionary-product cap."""
        bits = args[0]
        bt = dt.bigint(bits.dtype.nullable)

        def bit(i: int) -> Expr:
            return B.compare("eq", Func(bt, "mod", (
                Func(bt, "intdiv", (bits, B.lit(1 << i))), B.lit(2))),
                B.lit(1))
        if name == "EXPORT_SET":
            if len(args) < 3:
                raise PlanError("EXPORT_SET needs (bits, on, off, ...)")
            on, off = args[1], args[2]
            sep = args[3] if len(args) > 3 else B.lit(",")
            k = int(args[4].value) if len(args) > 4 \
                and isinstance(args[4], Const) else 64
            k = max(1, min(k, 64))
            woven = []
            for i in range(k):
                if woven:
                    woven.append(sep)
                woven.append(B.if_(bit(i), on, off))
            out = self._str_func("concat", *woven)
            if bits.dtype.nullable:   # EXPORT_SET(NULL, ...) is NULL
                out = B.if_(B.is_null(bits), B.lit(None), out)
            return out
        # MAKE_SET: only strings whose bit is set, comma-joined — the
        # CONCAT_WS NULL-skip shape, capped like it
        items = [B.if_(bit(i), a, B.lit(None)) for i, a in
                 enumerate(args[1:])]
        if len(items) > 4:
            raise PlanError("MAKE_SET supports at most 4 members")
        out = self._concat_ws_items(B.lit(","), items)
        if bits.dtype.nullable:       # MAKE_SET(NULL, ...) is NULL
            out = B.if_(B.is_null(bits), B.lit(None), out)
        return out

    def _timestampdiff(self, unit: str, a: Expr, b: Expr) -> Expr:
        """TIMESTAMPDIFF(unit, a, b) = integer units from a to b,
        truncated toward zero (builtin_time.go timestampDiff) — built
        from existing device temporal ops so it fuses on device."""
        if a.dtype.is_string:
            a = _coerce_to(dt.datetime(), a)
        if b.dtype.is_string:
            b = _coerce_to(dt.datetime(), b)
        if a.dtype.kind not in (K.DATE, K.DATETIME) \
                or b.dtype.kind not in (K.DATE, K.DATETIME):
            raise PlanError("TIMESTAMPDIFF needs date operands")
        nullable = a.dtype.nullable or b.dtype.nullable
        bt = dt.bigint(nullable)

        def us(x: Expr) -> Expr:
            from ..types.temporal import MICROS_PER_DAY
            if x.dtype.kind == K.DATE:
                return Func(bt, "mul", (x, Const(dt.bigint(False),
                                                 MICROS_PER_DAY)))
            return x
        if unit in ("SECOND", "MINUTE", "HOUR", "DAY", "WEEK"):
            per = {"SECOND": 1_000_000, "MINUTE": 60_000_000,
                   "HOUR": 3_600_000_000, "DAY": 86_400_000_000,
                   "WEEK": 7 * 86_400_000_000}[unit]
            diff = Func(bt, "sub", (us(b), us(a)))
            return Func(bt, "intdiv", (diff, Const(dt.bigint(False), per)))
        if unit not in ("MONTH", "QUARTER", "YEAR"):
            raise PlanError(f"unsupported TIMESTAMPDIFF unit {unit}")

        def ym(x: Expr) -> Expr:
            y = Func(bt, "year", (x,))
            m = Func(bt, "month", (x,))
            return Func(bt, "add", (Func(bt, "mul",
                                         (y, Const(dt.bigint(False), 12))),
                                    m))

        def intra(x: Expr) -> Expr:
            # progress within the month: day-of-month * 1 day + time
            from ..types.temporal import MICROS_PER_DAY
            d = Func(bt, "mul", (Func(bt, "dayofmonth", (x,)),
                                 Const(dt.bigint(False), MICROS_PER_DAY)))
            if x.dtype.kind == K.DATE:
                return d
            tod = Func(bt, "add", (Func(bt, "mul", (
                Func(bt, "add", (Func(bt, "mul", (
                    Func(bt, "add", (Func(bt, "mul", (
                        Func(bt, "hour", (x,)),
                        Const(dt.bigint(False), 60))),
                        Func(bt, "minute", (x,)))),
                    Const(dt.bigint(False), 60))),
                    Func(bt, "second", (x,)))),
                Const(dt.bigint(False), 1_000_000))),
                Func(bt, "microsecond", (x,))))
            return Func(bt, "add", (d, tod))
        months = Func(bt, "sub", (ym(b), ym(a)))
        gtz = Func(bt, "gt", (months, Const(dt.bigint(False), 0)))
        ltz = Func(bt, "lt", (months, Const(dt.bigint(False), 0)))
        short = Func(bt, "lt", (intra(b), intra(a)))   # partial month fwd
        over = Func(bt, "gt", (intra(b), intra(a)))    # partial month bwd
        adj = Func(bt, "sub",
                   (B.if_(Func(bt, "and", (gtz, short)),
                          Const(dt.bigint(False), 1),
                          Const(dt.bigint(False), 0)),
                    B.if_(Func(bt, "and", (ltz, over)),
                          Const(dt.bigint(False), 1),
                          Const(dt.bigint(False), 0))))
        months = Func(bt, "sub", (months, adj))
        if unit == "MONTH":
            return months
        per = 3 if unit == "QUARTER" else 12
        return Func(bt, "intdiv", (months, Const(dt.bigint(False), per)))

    def _vec_arg(self, a: Expr, fname: str) -> Expr:
        """Coerce one vector-function argument: vector expressions pass
        through; constant '[..]' text parses at plan time (the implicit
        string->VECTOR cast of types/vector.go)."""
        if a.dtype is not None and getattr(a.dtype, "is_vector", False):
            return a
        if isinstance(a, Const) and isinstance(a.value, str):
            try:
                arr = dt.parse_vector_text(a.value)
            except ValueError as e:
                raise PlanError(str(e))
            return Const(dt.vector(len(arr), nullable=False), arr)
        if isinstance(a, Const) and a.value is None:
            return Const(dt.vector(), None)
        raise PlanError(f"{fname} expects a VECTOR column or a constant "
                        "'[...]' literal")

    def _str_func(self, op: str, *args: Expr) -> Expr:
        """String function with plan-time constant folding and a
        structural check that non-column arguments are constants (the
        dictionary-lowering contract — see expr/lower_strings.py)."""
        from ..expr.lower_strings import (fold_string_func,
                                          string_func_arg_error)
        e = B.str_func(op, *args)
        folded = fold_string_func(e)
        if folded is not None:
            return folded
        if isinstance(e, Func):
            err = string_func_arg_error(e)
            if err is not None:
                raise PlanError(err)
        return e

    def _date_addsub(self, name: str, n: A.FuncCall, args) -> Expr:
        """DATE_ADD/DATE_SUB(base, INTERVAL expr unit) — constant bases
        fold at plan time, runtime bases lower to device date arithmetic."""
        iv = n.args[1]
        if not (isinstance(iv, A.Lit) and iv.kind == "interval"):
            raise PlanError(f"{name} needs an INTERVAL argument")
        amt_e = self.build(iv.value) if isinstance(iv.value, A.Node) \
            else B.lit(int(iv.value))
        base = args[0]
        neg = name in ("DATE_SUB", "SUBDATE")
        if base.dtype.is_string:
            base = _coerce_to(dt.datetime(), base)
        if base.dtype.kind not in (K.DATE, K.DATETIME):
            raise PlanError(f"{name} needs a date operand")
        if isinstance(base, Const) and isinstance(amt_e, Const) \
                and base.dtype.kind == K.DATE \
                and iv.unit in ("DAY", "MONTH", "YEAR"):
            amount = int(amt_e.value) * (-1 if neg else 1)
            return _fold_interval_const(base, amount, iv.unit)
        amt = Func(amt_e.dtype, "neg", (amt_e,)) if neg else amt_e
        return B.date_add(base, amt, iv.unit)

    def _b_star(self, n: A.Star) -> Expr:
        raise PlanError("* only valid as a top-level select item")

    def _b_subqueryexpr(self, n: A.SubqueryExpr) -> Expr:
        """Uncorrelated scalar subquery: evaluated once at plan time via
        the session-installed executor (the reference evaluates these
        during optimization: EvalSubqueryFirstRow, expression_rewriter.go)."""
        fn = SUBQUERY_EXECUTOR.get()
        if fn is None:
            raise PlanError("scalar subquery not supported in this context")
        return fn(n.select)

    def _b_existsexpr(self, n: A.ExistsExpr) -> Expr:
        raise PlanError("EXISTS is only supported as a WHERE-clause "
                        "predicate")


def _fold_interval_const(base: Const, amount: int, unit: str) -> Const:
    if base.dtype.kind == K.DATE:
        days = int(base.value)
        if unit == "DAY":
            return Const(base.dtype, days + amount)
        if unit in ("MONTH", "YEAR"):
            import datetime as _dt
            d = tmp.days_to_date(days)
            months = amount * (12 if unit == "YEAR" else 1)
            mi = d.year * 12 + (d.month - 1) + months
            y, m = divmod(mi, 12)
            import calendar
            day = min(d.day, calendar.monthrange(y, m + 1)[1])
            return Const(base.dtype, tmp.date_to_days(y, m + 1, day))
    raise PlanError(f"INTERVAL {unit} on {base.dtype} not supported")


def _coerce_compare(a: Expr, b: Expr) -> tuple[Expr, Expr]:
    """MySQL-ish implicit casts for comparisons: string literal vs
    temporal/decimal/numeric column resolves at plan time."""
    def conv(s: Expr, target: dt.DataType) -> Expr:
        assert isinstance(s, Const)
        v = s.value
        if target.kind == K.DATE:
            return Const(dt.date(False), tmp.parse_date(str(v)))
        if target.kind == K.DATETIME:
            return Const(dt.datetime(False), tmp.parse_datetime(str(v)))
        if target.kind == K.DECIMAL:
            return B.decimal_lit(str(v))
        if target.kind in (K.INT64, K.UINT64, K.FLOAT64, K.FLOAT32):
            return B.lit(float(v))
        if target.kind == K.ENUM:
            # compare by 1-based member ordinal; absent literal never
            # matches (index -1)
            return Const(dt.bigint(False), dt.enum_index(target, str(v)))
        if target.kind == K.SET:
            return Const(dt.bigint(False), dt.set_mask(target, str(v)))
        if target.kind == K.BIT:
            try:
                return Const(dt.bigint(False), int(v))
            except (TypeError, ValueError):
                return s
        return s

    if isinstance(a, Const) and a.dtype.is_string and not b.dtype.is_string:
        return conv(a, b.dtype), b
    if isinstance(b, Const) and b.dtype.is_string and not a.dtype.is_string:
        return a, conv(b, a.dtype)
    return a, b


def _fold_const_str_cast(s: str, tn: str, n: "A.CastExpr") -> Optional[Expr]:
    """Constant-fold CAST('literal' AS T) with the same relaxed MySQL
    coercion the dictionary lowering applies per distinct value."""
    from ..expr.lower_strings import (_round_half_away, _str_num_prefix,
                                      _str_to_days, _str_to_micros)
    if tn in ("SIGNED", "SIGNED INTEGER", "INT", "BIGINT"):
        return Const(dt.bigint(False), _round_half_away(_str_num_prefix(s)))
    if tn in ("UNSIGNED", "UNSIGNED INTEGER"):
        x = _round_half_away(_str_num_prefix(s)) % (1 << 64)
        return Const(dt.ubigint(False), int(np.uint64(x).astype(np.int64)))
    if tn in ("DOUBLE", "REAL", "FLOAT"):
        return Const(dt.double(False), _str_num_prefix(s))
    if tn == "DATE":
        days = _str_to_days(s)
        return Const(dt.date(True), days) if days is not None \
            else Const(dt.null_type(), None)
    if tn in ("DATETIME", "TIMESTAMP"):
        us = _str_to_micros(s)
        return Const(dt.datetime(True), us) if us is not None \
            else Const(dt.null_type(), None)
    if tn == "DECIMAL":
        from decimal import Decimal, InvalidOperation
        scale = n.scale if n.scale >= 0 else 0
        prec = n.prec if n.prec > 0 else 10
        from ..expr.lower_strings import _NUM_PREFIX
        m = _NUM_PREFIX.match(s)
        txt = m.group(0).strip() if m else ""
        try:
            q = Decimal(txt) if txt else Decimal(0)
        except InvalidOperation:
            q = Decimal(0)
        scaled = int(q.scaleb(scale).to_integral_value(
            rounding="ROUND_HALF_UP"))
        return Const(dt.decimal(prec, scale), scaled)
    if tn in ("CHAR", "VARCHAR", "NCHAR", "BINARY"):
        ln = n.prec if n.prec > 0 else None
        return Const(dt.varchar(False), s if ln is None else s[:ln])
    return None


def _jval(c: Const):
    """Const -> JSON-ready python value (decimal consts decode)."""
    if c.value is None:
        return None
    if c.dtype.kind == K.DECIMAL:
        from ..types import decimal as _dec
        return float(_dec.decode(c.value, c.dtype.scale))
    return c.value


def _time_literal(e: Expr) -> Expr:
    """TIME string const -> micros const (tmp.parse_time abbreviation
    rules: 'HH:MM' = HH:MM:00, bare digits group as [H]HMMSS)."""
    if not (isinstance(e, Const) and isinstance(e.value, str)):
        return B.cast(e, dt.time(True))
    us = tmp.parse_time(e.value)
    if us is None:
        return Const(dt.null_type(), None)
    return Const(dt.time(False), us)


# GET_FORMAT(type, standard) result strings (builtin_time.go getFormat)
_GET_FORMATS = {
    ("DATE", "USA"): "%m.%d.%Y", ("DATE", "JIS"): "%Y-%m-%d",
    ("DATE", "ISO"): "%Y-%m-%d", ("DATE", "EUR"): "%d.%m.%Y",
    ("DATE", "INTERNAL"): "%Y%m%d",
    ("DATETIME", "USA"): "%Y-%m-%d %H.%i.%s",
    ("DATETIME", "JIS"): "%Y-%m-%d %H:%i:%s",
    ("DATETIME", "ISO"): "%Y-%m-%d %H:%i:%s",
    ("DATETIME", "EUR"): "%Y-%m-%d %H.%i.%s",
    ("DATETIME", "INTERNAL"): "%Y%m%d%H%i%s",
    ("TIMESTAMP", "USA"): "%Y-%m-%d %H.%i.%s",
    ("TIMESTAMP", "JIS"): "%Y-%m-%d %H:%i:%s",
    ("TIMESTAMP", "ISO"): "%Y-%m-%d %H:%i:%s",
    ("TIMESTAMP", "EUR"): "%Y-%m-%d %H.%i.%s",
    ("TIMESTAMP", "INTERNAL"): "%Y%m%d%H%i%s",
    ("TIME", "USA"): "%h:%i:%s %p", ("TIME", "JIS"): "%H:%i:%s",
    ("TIME", "ISO"): "%H:%i:%s", ("TIME", "EUR"): "%H.%i.%s",
    ("TIME", "INTERNAL"): "%H%i%s",
}


def _coerce_to(target: dt.DataType, e: Expr) -> Expr:
    if isinstance(e, Const) and e.dtype.is_string and not target.is_string:
        return _coerce_compare(e, ColumnRef(target, 0))[0]
    if e.dtype.is_string and not isinstance(e, Const) \
            and not target.is_string:
        # implicit string->T cast over a column/expression: lowers to a
        # per-dictionary-value parse + gather (builtin_cast.go coercion)
        to = target
        if to.kind in (dt.TypeKind.DATE, dt.TypeKind.DATETIME):
            to = to.with_nullable(True)
        return Func(to, "cast", (e,))
    return e


# --------------------------------------------------------------------- #
# SELECT building
# --------------------------------------------------------------------- #

@dataclass
class BuiltSelect:
    plan: LogicalPlan
    output_names: list[str]


@dataclass
class CTEEntry:
    """One WITH-list binding visible while building a query."""
    name: str
    columns: list[str]
    select: A.Node                       # defining AST (non-recursive)
    def_ctes: dict = None                # CTEs visible at definition site
    storage: Optional[CTEStorage] = None  # set for recursive CTEs
    building: bool = False               # inside the recursive part?


def build_query(stmt: A.Node, catalog, default_db: str,
                ctes: Optional[dict] = None) -> BuiltSelect:
    """Entry: SELECT or set operation, with WITH-list handling
    (reference: PlanBuilder.buildSelect / buildSetOpr / buildWith)."""
    ctes = dict(ctes or {})
    for c in getattr(stmt, "ctes", None) or []:
        key = c.name.lower()
        if getattr(stmt, "recursive", False) and _references_cte(c.select, c.name):
            ctes[key] = _build_recursive_cte(c, catalog, default_db, ctes)
        else:
            ctes[key] = CTEEntry(c.name, list(c.columns), c.select,
                                 def_ctes=dict(ctes))
    if isinstance(stmt, A.SetOpStmt):
        return _build_setop(stmt, catalog, default_db, ctes)
    return build_select(stmt, catalog, default_db, ctes)


def _rewrite_scalar_subqueries(node, child, catalog, default_db, ctes,
                               applies: list):
    """Replace CORRELATED bare scalar subqueries with placeholder idents
    served by a LogicalApply column (rule_decorrelate's apply fallback).
    Uncorrelated subqueries are left for the eager-eval path; IN/EXISTS
    forms are left for the semi/anti-join path."""
    import dataclasses as _dc

    def try_correlated(sub_sel):
        import copy as _copy

        # probe builds run on COPIES: build_select rewrites nested
        # subqueries in place, and a discarded trial must not leave
        # placeholders in the AST the real build (or per-row apply
        # execution) will use.  Nested subqueries are NOT executed during
        # the probe (its only purpose is correlation detection): the
        # eager executor is stubbed to a typed-unknown NULL literal.
        probe_tok = SUBQUERY_EXECUTOR.set(lambda _ast: B.lit(None))
        try:
            build_query(_copy.deepcopy(sub_sel), catalog, default_db,
                        dict(ctes))
            return None          # uncorrelated
        except PlanError:
            # unknown column => correlated; any other error may be an
            # artifact of the stubbed nested executor — the dtype trial
            # below (real executor + dummy outer binding) is authoritative
            pass
        finally:
            SUBQUERY_EXECUTOR.reset(probe_tok)

        def dummy_resolver(ident: A.Ident):
            if len(ident.parts) == 1:
                q, name = None, ident.parts[0]
            else:
                q, name = ident.parts[-2], ident.parts[-1]
            hits = child.schema.find(name, q)
            if not hits:
                return None
            t = child.schema.cols[hits[0]].dtype
            return Const(t.with_nullable(True),
                         "" if t.is_string else 0)

        tok = OUTER_RESOLVER.set(dummy_resolver)
        try:
            built = build_query(_copy.deepcopy(sub_sel), catalog,
                                default_db, dict(ctes))
        finally:
            OUTER_RESOLVER.reset(tok)
        if len(built.plan.schema) != 1:
            raise PlanError("scalar subquery must return one column")
        out_t = built.plan.schema.cols[0].dtype.with_nullable(True)
        name = f"__apply_{len(applies)}"
        applies.append((sub_sel, out_t, name))
        _taint_plan("correlated subquery")
        return A.Ident((name,))

    def maybe_correlated(sub_sel) -> bool:
        """Cheap pre-filter: a subquery whose idents all resolve against
        its own FROM tables cannot be correlated — skip the (expensive)
        probe build.  Bails to True (full probe) on derived tables."""
        tables = []
        stack = [sub_sel.from_]
        while stack:
            f = stack.pop()
            if isinstance(f, A.Join):
                stack += [f.left, f.right]
            elif isinstance(f, A.TableName):
                try:
                    t = catalog.get_table(f.db or default_db, f.name)
                except Exception:
                    return True
                tables.append(((f.alias or f.name).lower(),
                               {c.lower() for c in t.col_names}))
            else:
                return True        # derived table / CTE: full probe
        aliases = {a for a, _c in tables}
        for x in _walk_ast(sub_sel):
            if not isinstance(x, A.Ident):
                continue
            if len(x.parts) >= 2:
                if x.parts[-2].lower() not in aliases:
                    return True
            elif not any(x.parts[-1].lower() in cols
                         for _a, cols in tables):
                return True
        return False

    def walk(n):
        if isinstance(n, A.SubqueryExpr):
            if not maybe_correlated(n.select):
                return n           # provably local: eager path handles it
            repl = try_correlated(n.select)
            return repl if repl is not None else n
        if isinstance(n, A.ExistsExpr):
            return n             # semi/anti-join path
        if isinstance(n, A.InExpr) and any(
                isinstance(i, A.SubqueryExpr) for i in n.items):
            return n             # semi/anti-join path
        if not isinstance(n, A.Node):
            return n
        for f in _dc.fields(n):
            v = getattr(n, f.name)
            if isinstance(v, A.Node):
                setattr(n, f.name, walk(v))
            elif isinstance(v, list):
                setattr(n, f.name, [
                    walk(x) if isinstance(x, A.Node)
                    else tuple(walk(y) if isinstance(y, A.Node) else y
                               for y in x) if isinstance(x, tuple)
                    else x
                    for x in v])
        return n

    return walk(node)


def build_select(sel: A.SelectStmt, catalog, default_db: str,
                 ctes: Optional[dict] = None) -> BuiltSelect:
    ctes = ctes or {}
    if sel.from_ is None:
        return _build_no_table(sel)
    child = _build_from(sel.from_, catalog, default_db, ctes)

    # correlated scalar subqueries -> LogicalApply columns (must wrap the
    # child BEFORE items/where build so placeholders resolve)
    applies: list = []
    if SUBQUERY_EXECUTOR.get() is not None:
        def rw(node):
            return _rewrite_scalar_subqueries(
                node, child, catalog, default_db, ctes, applies)
        if sel.where is not None:
            sel.where = rw(sel.where)
        for it in sel.items:
            if not isinstance(it.expr, A.Star):
                it.expr = rw(it.expr)
        # ORDER BY apply columns only make sense pre-aggregation; a
        # correlated subquery in HAVING would need apply-above-aggregate
        # (per-group evaluation) — unsupported, surfaces unknown-column
        if sel.order_by and not (
                sel.group_by
                or _contains_agg(sel.items, sel.having, sel.order_by)):
            sel.order_by = [(rw(e), desc) for e, desc in sel.order_by]
    if applies:
        from .logical import LogicalApply
        cols = list(child.schema.cols) + [
            SchemaCol(nm, t, "__apply__") for _ast, t, nm in applies]
        child = LogicalApply(child, applies, catalog, default_db,
                             Schema(cols))

    if sel.where is not None:
        # WHERE-clause subquery predicates (IN/EXISTS) become semi/anti
        # joins (rule_decorrelate.go analog); the rest build normally
        plain: list[A.Node] = []
        for cj in _split_where_ast(sel.where):
            joined = _try_subquery_conjunct(cj, child, catalog, default_db,
                                            ctes)
            if joined is not None:
                child = joined
            else:
                plain.append(cj)
        if plain:
            cond = ExprBuilder(child.schema).build(_and_ast(plain))
            child = LogicalSelection(child, _split_cnf(cond))

    # expand stars
    items: list[A.SelectItem] = []
    for it in sel.items:
        if isinstance(it.expr, A.Star):
            q = it.expr.table
            for i, c in enumerate(child.schema.cols):
                if (c.qualifier or "") == "__apply__":
                    continue     # apply columns never appear in SELECT *
                if q is None or (c.qualifier or "").lower() == q.lower():
                    items.append(A.SelectItem(A.Ident((c.qualifier, c.name)
                                                      if c.qualifier else (c.name,)),
                                              c.name))
        else:
            items.append(it)

    has_aggs = sel.group_by or _contains_agg(items, sel.having, sel.order_by)
    has_windows = _contains_window(items)
    if has_aggs and has_windows:
        raise PlanError("window functions over GROUP BY not supported yet")
    if has_aggs:
        plan, names = _build_agg_select(sel, items, child)
    elif has_windows:
        plan, names, wplan = _build_window_select(sel, items, child)
        if sel.having is not None:
            raise PlanError("HAVING without GROUP BY not supported")
        plan = _attach_order_limit(sel, plan, names, wplan)
    else:
        eb = ExprBuilder(child.schema)
        exprs = [eb.build(it.expr) for it in items]
        names = [_item_name(it) for it in items]
        plan = _project(child, exprs, names)
        if sel.having is not None:
            raise PlanError("HAVING without GROUP BY not supported")
        plan = _attach_order_limit(sel, plan, names, child)

    if has_aggs:
        plan = _attach_order_limit(sel, plan, names,
                                   plan.children[0] if plan.children else plan,
                                   agg_mode=True)

    if sel.distinct:
        plan = LogicalAggregate(plan, [plan.schema.ref(i)
                                       for i in range(len(plan.schema))], [],
                                Schema(list(plan.schema.cols)))
    _apply_hints(plan, sel.hints)
    return BuiltSelect(plan, names)


from .logical import find_datasource as _find_ds
from .logical import walk_plan as _walk_plan

_JOIN_METHOD_HINTS = {
    "HASH_JOIN": "hash", "TIDB_HJ": "hash",
    "MERGE_JOIN": "merge", "SM_JOIN": "merge", "TIDB_SMJ": "merge",
    "INL_JOIN": "inl", "INL_HASH_JOIN": "inl", "TIDB_INLJ": "inl",
}


def _apply_hints(plan: LogicalPlan, hints: list) -> None:
    """Annotate the logical plan with optimizer hints (the hintProcessor
    role of planner/core/hints): join method, index choice, join order."""
    if not hints:
        return
    joins = [n for n in _walk_plan(plan) if isinstance(n, LogicalJoin)]
    # innermost joins first: the SMALLEST join containing the hinted table
    # is the one the hint names (preorder would always hit the root)
    joins.sort(key=lambda j: sum(1 for _ in _walk_plan(j)))
    for name, args in hints:
        if name in _JOIN_METHOD_HINTS:
            method = _JOIN_METHOD_HINTS[name]
            for t in args:
                ds = _find_ds(plan, t)
                if ds is not None and not ds.hint_join:
                    ds.hint_join = method   # leaf marker survives reorder
                for j in joins:
                    if _find_ds(j, t) is not None and not j.hint_method:
                        j.hint_method = method
                        break
        elif name == "USE_INDEX" and args:
            ds = _find_ds(plan, args[0])
            if ds is not None:
                ds.hint_use = [a.lower() for a in args[1:]] or None
        elif name == "IGNORE_INDEX" and args:
            ds = _find_ds(plan, args[0])
            if ds is not None:
                ds.hint_ignore = [a.lower() for a in args[1:]]
        elif name == "LEADING" and args and joins:
            # join-reorder reads the hint from the GROUP ROOT (the
            # outermost join of the flattened inner-join group)
            joins[-1].hint_leading = list(args)
        # unknown hints are accepted and ignored (MySQL warning semantics)


def _build_no_table(sel: A.SelectStmt) -> BuiltSelect:
    from .logical import DataSource  # dual table: 1 row, no cols
    eb = ExprBuilder(Schema([]))
    exprs = [eb.build(it.expr) for it in sel.items]
    names = [_item_name(it) for it in sel.items]
    plan = LogicalProjection(DualSource(), exprs,
                             Schema([SchemaCol(n, e.dtype)
                                     for n, e in zip(names, exprs)]))
    return BuiltSelect(plan, names)


class DualSource(LogicalPlan):
    """SELECT without FROM: one row, zero columns."""

    def __init__(self):
        self.schema = Schema([])
        self.children = []


def _item_name(it: A.SelectItem) -> str:
    if it.alias:
        return it.alias
    if isinstance(it.expr, A.Ident):
        return it.expr.parts[-1]
    if isinstance(it.expr, A.FuncCall):
        return f"{it.expr.name.lower()}(...)" if it.expr.args else f"{it.expr.name.lower()}()"
    return "expr"


def _split_cnf(e: Expr) -> list[Expr]:
    if isinstance(e, Func) and e.op == "and":
        return _split_cnf(e.args[0]) + _split_cnf(e.args[1])
    return [e]


# --------------------------------------------------------------------- #
# WHERE-clause subqueries -> semi/anti joins (decorrelation)
# --------------------------------------------------------------------- #

def _split_where_ast(n: A.Node) -> list[A.Node]:
    if isinstance(n, A.Binary) and n.op == "AND":
        return _split_where_ast(n.left) + _split_where_ast(n.right)
    return [n]


def _and_ast(conjs: list[A.Node]) -> A.Node:
    out = conjs[0]
    for c in conjs[1:]:
        out = A.Binary("AND", out, c)
    return out


def _try_subquery_conjunct(c: A.Node, child: LogicalPlan, catalog,
                           default_db: str, ctes) -> Optional[LogicalPlan]:
    """If conjunct `c` is an IN-subquery / [NOT] EXISTS predicate, return
    `child` wrapped in the corresponding semi/anti join; else None."""
    if isinstance(c, A.InExpr) and len(c.items) == 1 \
            and isinstance(c.items[0], A.SubqueryExpr):
        return _build_in_subquery(c, child, catalog, default_db, ctes)
    if isinstance(c, A.ExistsExpr):
        return _build_exists(c.select, child, catalog, default_db, ctes,
                             negated=False)
    if isinstance(c, A.Unary) and c.op == "NOT" \
            and isinstance(c.arg, A.ExistsExpr):
        return _build_exists(c.arg.select, child, catalog, default_db, ctes,
                             negated=True)
    return None


def _build_in_subquery(c: A.InExpr, child: LogicalPlan, catalog,
                       default_db: str, ctes) -> LogicalPlan:
    """x [NOT] IN (SELECT y ...) -> semi / null-aware anti join
    (the reference's null-aware anti join, executor/join/)."""
    sub = build_query(c.items[0].select, catalog, default_db, ctes)
    if len(sub.plan.schema) != 1:
        raise PlanError("IN subquery must return exactly one column")
    target = ExprBuilder(child.schema).build(c.target)
    left = child
    li = None
    post_restore = False
    if isinstance(target, ColumnRef):
        li = target.index
    else:
        # computed target: append it as a hidden join-key column
        refs = [child.schema.ref(i) for i in range(len(child.schema))]
        cols = list(child.schema.cols) + [SchemaCol("__in_key__", target.dtype)]
        left = LogicalProjection(child, refs + [target], Schema(cols))
        li = len(child.schema)
        post_restore = True
    join = LogicalJoin("anti" if c.negated else "semi", left, sub.plan,
                       eq_keys=[(li, 0)], other_conds=[],
                       schema=Schema(list(left.schema.cols)),
                       null_aware=c.negated)
    if post_restore:
        refs = [join.schema.ref(i) for i in range(len(child.schema))]
        return LogicalProjection(join, refs, Schema(list(child.schema.cols)))
    return join


def _build_exists(sub: A.SelectStmt, outer: LogicalPlan, catalog,
                  default_db: str, ctes, negated: bool) -> LogicalPlan:
    """[NOT] EXISTS (SELECT ...) -> semi/anti join, decorrelating
    outer-column references in the subquery WHERE into join keys /
    residual conditions (rule_decorrelate.go analog)."""
    kind = "anti" if negated else "semi"
    out_schema = Schema(list(outer.schema.cols))
    # uncorrelated fast path: the whole subquery builds standalone; only
    # its non-emptiness matters, so LIMIT 1 bounds the cross semi/anti
    # join to a single build row
    try:
        bs = build_query(sub, catalog, default_db, ctes)
        limited = LogicalLimit(bs.plan, 1)
        return LogicalJoin(kind, outer, limited, eq_keys=[], other_conds=[],
                           schema=out_schema)
    except PlanError:
        pass
    if getattr(sub, "from_", None) is None:
        raise PlanError("EXISTS subquery needs a FROM clause")
    if sub.group_by or sub.having is not None or sel_has_limit(sub):
        raise PlanError("correlated EXISTS with GROUP BY/HAVING/LIMIT "
                        "not supported")
    inner = _build_from(sub.from_, catalog, default_db, dict(ctes or {}))
    n_outer = len(outer.schema)
    combined = Schema(list(outer.schema.cols) + list(inner.schema.cols))
    eq_keys: list[tuple[int, int]] = []
    others: list[Expr] = []
    inner_conds: list[Expr] = []
    for cj in (_split_where_ast(sub.where) if sub.where is not None else []):
        try:
            inner_conds += _split_cnf(ExprBuilder(inner.schema).build(cj))
            continue
        except PlanError:
            pass
        e = ExprBuilder(combined).build(cj)   # correlated: may still raise
        k = _eq_key_of(e, n_outer)
        if k is not None:
            eq_keys.append(k)
        else:
            others.append(e)
    if inner_conds:
        inner = LogicalSelection(inner, inner_conds)
    return LogicalJoin(kind, outer, inner, eq_keys=eq_keys,
                       other_conds=others, schema=out_schema)


def sel_has_limit(sub) -> bool:
    return getattr(sub, "limit", None) is not None


def _eq_key_of(e: Expr, n_left: int):
    if (isinstance(e, Func) and e.op == "eq"
            and isinstance(e.args[0], ColumnRef)
            and isinstance(e.args[1], ColumnRef)):
        a, b = e.args[0].index, e.args[1].index
        if a < n_left <= b:
            return (a, b - n_left)
        if b < n_left <= a:
            return (b, a - n_left)
    return None


def _walk_ast(n: A.Node, prune=None):
    """Yield every A.Node reachable from n (depth-first, incl. n itself);
    `prune(x)` true stops descent below x (x itself is still yielded)."""
    stack = [n]
    while stack:
        x = stack.pop()
        if not isinstance(x, A.Node):
            continue
        yield x
        if prune is not None and prune(x):
            continue
        for v in vars(x).values():
            if isinstance(v, A.Node):
                stack.append(v)
            elif isinstance(v, (list, tuple)):
                for i in v:
                    if isinstance(i, A.Node):
                        stack.append(i)
                    elif isinstance(i, tuple):
                        stack.extend(y for y in i if isinstance(y, A.Node))


def _is_window_call(x) -> bool:
    return isinstance(x, A.FuncCall) and x.over is not None


def _agg_scan_prune(x) -> bool:
    """Stop descent below window calls (SUM(x) OVER ... is no aggregate)
    and below subqueries (their aggregates belong to the INNER query)."""
    return _is_window_call(x) or isinstance(x, A.SubqueryExpr) \
        or isinstance(x, A.ExistsExpr)


def _contains_agg(items, having, order_by) -> bool:
    roots = [it.expr for it in items]
    if having is not None:
        roots.append(having)
    roots.extend(e for e, _ in order_by or [])
    return any(
        isinstance(x, A.FuncCall) and x.over is None and x.name in AGG_FUNCS
        for r in roots
        for x in _walk_ast(r, prune=_agg_scan_prune))


def _build_agg_select(sel: A.SelectStmt, items, child) -> tuple[LogicalPlan, list[str]]:
    """GROUP BY / aggregate query: LogicalAggregate + projection on top."""
    ceb = ExprBuilder(child.schema)
    # MySQL: GROUP BY may reference select aliases (and positions)
    group_asts = []
    for g in (sel.group_by or []):
        if isinstance(g, A.Lit) and g.kind == "int":
            pos = int(g.value) - 1
            if not (0 <= pos < len(items)):
                raise PlanError(f"GROUP BY position {pos+1} out of range")
            g = items[pos].expr
        else:
            g = _subst_aliases(g, items)
        group_asts.append(g)
    group_irs = [ceb.build(g) for g in group_asts]

    agg_items: list[AggItem] = []
    agg_cache: dict = {}          # dedup identical agg calls

    def resolve_agg(fc: A.FuncCall) -> Expr:
        """Called by ExprBuilder when it hits SUM/COUNT/...; returns a
        placeholder ColumnRef into the agg output schema."""
        key = repr(fc)
        if key in agg_cache:
            return agg_cache[key]
        name = fc.name
        if name == "GROUPING":
            # GROUPING(k...) is resolved against the rollup keys; it
            # lowers post-agg to bit tests over the Expand gid column
            if not sel.rollup:
                raise PlanError("GROUPING only valid with WITH ROLLUP")
            if not fc.args:
                raise PlanError("GROUPING needs at least one argument")
            pos = []
            for a in fc.args:
                ka = ceb.build(a)
                for gi, g in enumerate(group_irs):
                    if ka == g:
                        pos.append(gi)
                        break
                else:
                    raise PlanError(
                        "GROUPING argument must be a GROUP BY expression")
            out = _GroupingRef(tuple(pos))
            agg_cache[key] = out
            return out
        star = len(fc.args) == 1 and isinstance(fc.args[0], A.Star)
        arg = None if star else ceb.build(fc.args[0])
        if name == "AVG":
            s = _add_agg(agg_items, AggFunc.SUM, arg, fc.distinct)
            c = _add_agg(agg_items, AggFunc.COUNT, arg, fc.distinct)
            sref = _AggRef(s, agg_items[s].out_dtype)
            cref = _AggRef(c, agg_items[c].out_dtype)
            out = B.arith("div", sref, cref)
        elif name == "COUNT":
            i = _add_agg(agg_items, AggFunc.COUNT, arg, fc.distinct)
            out = _AggRef(i, agg_items[i].out_dtype)
        elif name == "APPROX_COUNT_DISTINCT":
            # exact host implementation of the approximate contract
            i = _add_agg(agg_items, AggFunc.COUNT, arg, True)
            out = _AggRef(i, agg_items[i].out_dtype)
        elif name in ("STDDEV", "STD", "STDDEV_POP", "STDDEV_SAMP",
                      "VARIANCE", "VAR_POP", "VAR_SAMP"):
            # moment rewrite (reference: aggfuncs var_pop/stddev classes):
            # SUM(x), SUM(x*x), COUNT(x) — all three push to the device psum
            # path; the final expression runs in the post-agg projection.
            # var_pop = E[x^2] - E[x]^2; _samp scales by n/(n-1) (NULL at
            # n<=1 via the div-by-zero->NULL rule).
            if arg is None or not arg.dtype.is_numeric:
                raise PlanError(f"{name} needs a numeric argument")
            if fc.distinct:
                # MySQL rejects DISTINCT here; the moment rewrite would
                # dedupe x*x instead of x and compute a wrong variance
                raise PlanError(f"DISTINCT not supported for {name}")
            xf = B.cast(arg, dt.double(True))
            s1 = _add_agg(agg_items, AggFunc.SUM, xf, fc.distinct)
            s2 = _add_agg(agg_items, AggFunc.SUM,
                          B.arith("mul", xf, xf), fc.distinct)
            c = _add_agg(agg_items, AggFunc.COUNT, xf, fc.distinct)
            s1r = _AggRef(s1, agg_items[s1].out_dtype)
            s2r = _AggRef(s2, agg_items[s2].out_dtype)
            nr = B.cast(_AggRef(c, agg_items[c].out_dtype), dt.double(True))
            mean = B.arith("div", s1r, nr)
            var_pop = B.arith("sub", B.arith("div", s2r, nr),
                              B.arith("mul", mean, mean))
            if name in ("STDDEV_SAMP", "VAR_SAMP"):
                scale = B.arith("div", nr,
                                B.arith("sub", nr, B.lit(1.0)))
                var = B.arith("mul", var_pop, scale)
            else:
                var = var_pop
            if name in ("STDDEV", "STD", "STDDEV_POP", "STDDEV_SAMP"):
                # clamp tiny negative fp residue before sqrt
                out = B.math_func(
                    "sqrt", B.greatest_least("greatest",
                                             [var, B.lit(0.0)]))
            else:
                out = var
        else:
            f = {"SUM": AggFunc.SUM, "MIN": AggFunc.MIN, "MAX": AggFunc.MAX,
                 "BIT_AND": AggFunc.BIT_AND, "BIT_OR": AggFunc.BIT_OR,
                 "BIT_XOR": AggFunc.BIT_XOR,
                 "GROUP_CONCAT": AggFunc.GROUP_CONCAT,
                 "ANY_VALUE": AggFunc.ANY_VALUE,
                 "JSON_ARRAYAGG": AggFunc.JSON_ARRAYAGG}[name]
            if arg is None:
                raise PlanError(f"{name} needs an argument")
            if fc.distinct and f in (AggFunc.BIT_AND, AggFunc.BIT_OR,
                                     AggFunc.BIT_XOR, AggFunc.ANY_VALUE,
                                     AggFunc.JSON_ARRAYAGG):
                raise PlanError(f"DISTINCT not supported for {name}")
            i = _add_agg(agg_items, f, arg, fc.distinct)
            out = _AggRef(i, agg_items[i].out_dtype)
        agg_cache[key] = out
        return out

    eb = ExprBuilder(child.schema, agg_resolver=resolve_agg)
    raw_items = [eb.build(it.expr) for it in items]
    names = [_item_name(it) for it in items]
    having_ast = _subst_aliases(sel.having, items) if sel.having is not None \
        else None
    raw_having = eb.build(having_ast) if having_ast is not None else None

    # aggregate node schema: group cols then agg cols.  WITH ROLLUP routes
    # the child through LogicalExpand (grouping-sets replication): the agg
    # then groups on the Expand's nullable key columns plus its gid column
    # (reference: logical_expand.go:32 builds the same shape).
    L = len(group_irs)
    if sel.rollup and L:
        n_child = len(child.schema)
        key_names = [_expr_name(g, child.schema) for g in group_irs]
        key_dts = [g.dtype.with_nullable(True) for g in group_irs]
        ex_schema = Schema(
            list(child.schema.cols)
            + [SchemaCol(n, t) for n, t in zip(key_names, key_dts)]
            + [SchemaCol("gid", dt.bigint(False))])
        child = LogicalExpand(child, list(group_irs), L + 1, ex_schema)
        gid_ref = ColumnRef(dt.bigint(False), n_child + L, "gid")
        agg_groups = [ColumnRef(t, n_child + j, n)
                      for j, (n, t) in enumerate(zip(key_names, key_dts))]
        agg_groups.append(gid_ref)
        gcols = ([SchemaCol(n, t) for n, t in zip(key_names, key_dts)]
                 + [SchemaCol("gid", dt.bigint(False))])
    else:
        agg_groups = list(group_irs)
        gcols = [SchemaCol(_expr_name(g, child.schema), g.dtype)
                 for g in group_irs]
    acols = [SchemaCol(f"agg#{i}", a.out_dtype) for i, a in enumerate(agg_items)]
    agg_schema = Schema(gcols + acols)
    agg_plan = LogicalAggregate(child, agg_groups, agg_items, agg_schema)

    n_group = len(agg_groups)

    def remap(e: Expr) -> Expr:
        if isinstance(e, _GroupingRef):
            # GROUPING(k_j...): key j is rolled in level gid iff gid+j >= L;
            # multi-arg packs bits MSB-first (MySQL 8 semantics)
            gout = ColumnRef(dt.bigint(False), n_group - 1, "gid")
            out = None
            k = len(e.positions)
            for i, j in enumerate(e.positions):
                bit = B.cast(
                    B.compare("ge", B.arith("add", gout, B.lit(j)),
                              B.lit(L)), dt.bigint(False))
                if k > 1:
                    bit = B.arith("mul", bit, B.lit(1 << (k - 1 - i)))
                out = bit if out is None else B.arith("add", out, bit)
            return out
        if isinstance(e, _AggRef):
            return ColumnRef(e.dtype, n_group + e.agg_index, f"agg#{e.agg_index}")
        for gi, g in enumerate(group_irs):
            if e == g:
                return ColumnRef(agg_schema.cols[gi].dtype, gi,
                                 agg_schema.cols[gi].name)
        if isinstance(e, ColumnRef):
            raise PlanError(
                f"column {e.name!r} must appear in GROUP BY or an aggregate")
        if isinstance(e, Func):
            from ..expr.ir import clone_func
            return clone_func(e, (remap(a) for a in e.args))
        return e

    final_exprs = [remap(e) for e in raw_items]
    plan: LogicalPlan = agg_plan
    if raw_having is not None:
        plan = LogicalSelection(plan, _split_cnf(remap(raw_having)))
    plan = _project(plan, final_exprs, names)
    # stash for ORDER BY resolution against agg schema
    plan._agg_remap = remap          # type: ignore[attr-defined]
    plan._agg_eb = eb                # type: ignore[attr-defined]
    return plan, names


def _subst_aliases(n: A.Node, items: list[A.SelectItem]) -> A.Node:
    """MySQL HAVING/ORDER BY may reference select aliases: substitute the
    aliased expression AST for bare idents matching an alias."""
    aliases = {it.alias.lower(): it.expr for it in items if it.alias}
    import copy

    def go(x):
        if isinstance(x, A.Ident) and len(x.parts) == 1 \
                and x.parts[0].lower() in aliases:
            return copy.deepcopy(aliases[x.parts[0].lower()])
        if isinstance(x, A.Node):
            for f, v in vars(x).items():
                if isinstance(v, A.Node):
                    setattr(x, f, go(v))
                elif isinstance(v, list):
                    setattr(x, f, [go(i) if isinstance(i, A.Node) else i
                                   for i in v])
            return x
        return x

    return go(copy.deepcopy(n))


class _AggRef(ColumnRef):
    """Placeholder for an aggregate output during select-list building."""

    def __init__(self, agg_index: int, dtype: dt.DataType):
        super().__init__(dtype, 100000 + agg_index, f"agg#{agg_index}")
        object.__setattr__(self, "agg_index", agg_index)


class _GroupingRef(ColumnRef):
    """Placeholder for GROUPING(keys...) during select-list building;
    remapped post-agg to bit tests over the Expand gid column."""

    def __init__(self, positions: tuple):
        super().__init__(dt.bigint(False), 200000 + (positions[0] if
                                                     positions else 0),
                         "grouping")
        object.__setattr__(self, "positions", positions)


def _add_agg(agg_items: list[AggItem], func: AggFunc, arg, distinct: bool) -> int:
    if func == AggFunc.COUNT:
        out_t = dt.bigint(False)
    elif func == AggFunc.SUM:
        out_t = sum_out_dtype(arg.dtype)
    elif func in (AggFunc.BIT_AND, AggFunc.BIT_OR, AggFunc.BIT_XOR):
        out_t = dt.ubigint(False)      # MySQL: unsigned 64-bit, never NULL
    elif func in (AggFunc.GROUP_CONCAT, AggFunc.JSON_ARRAYAGG):
        out_t = dt.varchar(True)
    else:
        out_t = arg.dtype
    agg_items.append(AggItem(func, arg, distinct, out_t))
    return len(agg_items) - 1


def _expr_name(e: Expr, schema: Schema) -> str:
    if isinstance(e, ColumnRef):
        return e.name or f"col#{e.index}"
    return "expr"


def _project(child: LogicalPlan, exprs: list[Expr], names: list[str]) -> LogicalProjection:
    sch = Schema([SchemaCol(n, e.dtype) for n, e in zip(names, exprs)])
    return LogicalProjection(child, exprs, sch)


def _attach_order_limit(sel: A.SelectStmt, plan: LogicalPlan,
                        names: list[str], pre_child: LogicalPlan,
                        agg_mode: bool = False) -> LogicalPlan:
    """ORDER BY: aliases > positions > projection names > underlying cols
    (hidden column appended and trimmed by the executor via output_names)."""
    if sel.order_by:
        assert isinstance(plan, LogicalProjection)
        keys = []
        for e_ast, desc in sel.order_by:
            idx = None
            if isinstance(e_ast, A.Lit) and e_ast.kind == "int":
                idx = int(e_ast.value) - 1
                if not (0 <= idx < len(names)):
                    raise PlanError(f"ORDER BY position {idx+1} out of range")
            elif isinstance(e_ast, A.Ident) and len(e_ast.parts) == 1:
                matches = [i for i, n in enumerate(names)
                           if n.lower() == e_ast.parts[0].lower()]
                if matches:
                    idx = matches[0]
            if idx is None:
                # build over the pre-projection schema; append hidden col
                if agg_mode:
                    remap = plan._agg_remap if hasattr(plan, "_agg_remap") else None
                    eb = plan._agg_eb if hasattr(plan, "_agg_eb") else None
                    if eb is None:
                        raise PlanError("cannot resolve ORDER BY expression")
                    ir = remap(eb.build(e_ast))
                else:
                    ir = ExprBuilder(pre_child.schema).build(e_ast)
                plan.exprs.append(ir)
                plan.schema.cols.append(SchemaCol(f"__order#{len(plan.exprs)}",
                                                  ir.dtype))
                idx = len(plan.exprs) - 1
            keys.append((plan.schema.ref(idx), desc))
        if sel.limit is not None:
            plan = LogicalTopN(plan, keys, sel.limit, sel.offset or 0)
        else:
            plan = LogicalSort(plan, keys)
    elif sel.limit is not None:
        plan = LogicalLimit(plan, sel.limit, sel.offset or 0)
    return plan


# --------------------------------------------------------------------- #
# window functions
# --------------------------------------------------------------------- #

WINDOW_FUNCS = {"ROW_NUMBER", "RANK", "DENSE_RANK", "NTILE", "LAG", "LEAD",
                "FIRST_VALUE", "LAST_VALUE", "SUM", "COUNT", "AVG", "MIN",
                "MAX", "PERCENT_RANK", "CUME_DIST"}


def _contains_window(items) -> bool:
    return any(_is_window_call(x) for it in items
               for x in _walk_ast(it.expr))


class _WinRef(ColumnRef):
    """Placeholder for a window output during select-list building."""

    def __init__(self, win_index: int, dtype: dt.DataType):
        super().__init__(dtype, 200000 + win_index, f"win#{win_index}")
        object.__setattr__(self, "win_index", win_index)


def _build_window_select(sel: A.SelectStmt, items, child):
    """Window query (no GROUP BY): LogicalWindow over child + projection.
    Reference: buildWindowFunctions (planner/core/logical_plan_builder.go)."""
    witems: list[WindowItem] = []
    wcache: dict = {}

    def resolve_window(fc: A.FuncCall) -> Expr:
        key = repr(fc)
        if key in wcache:
            return wcache[key]
        item = _build_window_item(fc, child.schema)
        witems.append(item)
        ref = _WinRef(len(witems) - 1, item.out_dtype)
        wcache[key] = ref
        return ref

    eb = ExprBuilder(child.schema, window_resolver=resolve_window)
    raw = [eb.build(it.expr) for it in items]
    names = [_item_name(it) for it in items]
    n_child = len(child.schema)
    wschema = Schema(list(child.schema.cols)
                     + [SchemaCol(f"win#{i}", w.out_dtype)
                        for i, w in enumerate(witems)])
    wplan = LogicalWindow(child, witems, wschema)

    def remap(e: Expr) -> Expr:
        if isinstance(e, _WinRef):
            return ColumnRef(e.dtype, n_child + e.win_index, e.name)
        if isinstance(e, Func):
            from ..expr.ir import clone_func
            return clone_func(e, (remap(a) for a in e.args))
        return e

    exprs = [remap(e) for e in raw]
    return _project(wplan, exprs, names), names, wplan


def _build_window_item(fc: A.FuncCall, schema: Schema) -> WindowItem:
    name = fc.name
    if name not in WINDOW_FUNCS:
        raise PlanError(f"unsupported window function {name}")
    if fc.distinct:
        raise PlanError("DISTINCT in window functions not supported")
    ceb = ExprBuilder(schema)
    star = any(isinstance(a, A.Star) for a in fc.args)
    args = [ceb.build(a) for a in fc.args if not isinstance(a, A.Star)]
    spec = fc.over
    partition = [ceb.build(p) for p in spec.partition_by]
    order = [(ceb.build(e), desc) for e, desc in spec.order_by]
    frame = spec.frame
    if frame is not None and frame[0] == "range":
        for kind, _ in (frame[1], frame[2]):
            if kind in ("preceding", "following"):
                raise PlanError("RANGE frames with numeric offsets "
                                "not supported (use ROWS)")
    fl = name.lower()
    if fl in ("row_number", "rank", "dense_rank"):
        out = dt.bigint(False)
    elif fl in ("percent_rank", "cume_dist"):
        if not order:
            raise PlanError(f"{name} requires ORDER BY in its window")
        out = dt.double(False)
    elif fl == "ntile":
        if not (args and isinstance(args[0], Const)):
            raise PlanError("NTILE needs a constant argument")
        out = dt.bigint(True)
    elif fl == "count":
        out = dt.bigint(False)
        if star:
            args = []
    elif fl == "sum":
        if not args or not args[0].dtype.is_numeric:
            raise PlanError("SUM window needs a numeric argument")
        out = sum_out_dtype(args[0].dtype).with_nullable(True)
    elif fl == "avg":
        if not args or not args[0].dtype.is_numeric:
            raise PlanError("AVG window needs a numeric argument")
        out = dt.double(True)
    elif fl in ("min", "max"):
        if not args:
            raise PlanError(f"{name} needs an argument")
        if args[0].dtype.is_string:
            from ..utils.collate import is_binary
            if not is_binary(args[0].dtype.collation):
                # the host window path compares raw codes (binary order);
                # wrong under ci — reject rather than return wrong values
                raise PlanError(
                    f"{name} over a non-binary collation is not "
                    "supported in window functions")
        out = args[0].dtype.with_nullable(True)
    else:  # lag/lead/first_value/last_value
        if not args:
            raise PlanError(f"{name} needs an argument")
        if fl in ("lag", "lead"):
            for extra in args[1:]:
                if not isinstance(extra, Const):
                    raise PlanError(f"{name} offset/default must be constant")
        out = args[0].dtype.with_nullable(True)
    return WindowItem(fl, args, partition, order, frame, out)


# --------------------------------------------------------------------- #
# set operations
# --------------------------------------------------------------------- #

def _build_setop(stmt: A.SetOpStmt, catalog, default_db: str,
                 ctes: dict) -> BuiltSelect:
    lb = build_query(stmt.left, catalog, default_db, ctes)
    rb = build_query(stmt.right, catalog, default_db, ctes)
    if len(lb.output_names) != len(rb.output_names):
        raise PlanError("set operation operands have different column counts")
    lplan = _trim_to_outputs(lb)
    rplan = _trim_to_outputs(rb)
    names = list(lb.output_names)
    out_cols = []
    for i, nm in enumerate(names):
        t = _unify_dtype(lplan.schema.cols[i].dtype, rplan.schema.cols[i].dtype)
        out_cols.append(SchemaCol(nm, t))
    schema = Schema(out_cols)
    plan: LogicalPlan = LogicalSetOp(stmt.kind, stmt.all, lplan, rplan, schema)

    if stmt.order_by:
        keys = []
        for e_ast, desc in stmt.order_by:
            idx = None
            if isinstance(e_ast, A.Lit) and e_ast.kind == "int":
                idx = int(e_ast.value) - 1
                if not (0 <= idx < len(names)):
                    raise PlanError(f"ORDER BY position {idx+1} out of range")
            elif isinstance(e_ast, A.Ident) and len(e_ast.parts) == 1:
                m = [i for i, n in enumerate(names)
                     if n.lower() == e_ast.parts[0].lower()]
                if m:
                    idx = m[0]
            if idx is None:
                raise PlanError("set-operation ORDER BY must reference an "
                                "output column name or position")
            keys.append((schema.ref(idx), desc))
        if stmt.limit is not None:
            plan = LogicalTopN(plan, keys, stmt.limit, stmt.offset or 0)
        else:
            plan = LogicalSort(plan, keys)
    elif stmt.limit is not None:
        plan = LogicalLimit(plan, stmt.limit, stmt.offset or 0)
    return BuiltSelect(plan, names)


def _trim_to_outputs(built: BuiltSelect) -> LogicalPlan:
    """Drop hidden ORDER BY columns so the plan's schema == output names."""
    p = built.plan
    n = len(built.output_names)
    if len(p.schema) == n:
        return p
    exprs = [p.schema.ref(i) for i in range(n)]
    return _project(p, exprs, list(built.output_names))


_NUMERIC_KINDS = {K.INT64, K.UINT64, K.FLOAT64, K.FLOAT32, K.DECIMAL}


def _unify_dtype(a: dt.DataType, b: dt.DataType) -> dt.DataType:
    """Result type of a set-operation column (MySQL aggregate_2Fields
    analog, simplified)."""
    nullable = a.nullable or b.nullable
    if a.kind == b.kind:
        if a.kind == K.DECIMAL:
            scale = max(a.scale, b.scale)
            ip = max(a.precision - a.scale, b.precision - b.scale)
            return dt.decimal(min(ip + scale, 65), scale, nullable)
        return a.with_nullable(nullable)
    if a.kind in _NUMERIC_KINDS and b.kind in _NUMERIC_KINDS:
        ks = {a.kind, b.kind}
        if ks & {K.FLOAT64, K.FLOAT32}:
            return dt.double(nullable)
        if K.DECIMAL in ks:
            d = a if a.kind == K.DECIMAL else b
            return dt.decimal(max(d.precision, 20 + d.scale), d.scale, nullable)
        return dt.bigint(nullable)     # int64 + uint64
    if {a.kind, b.kind} == {K.DATE, K.DATETIME}:
        return dt.datetime(nullable)
    raise PlanError(f"cannot unify set-operation column types {a} and {b}")


# --------------------------------------------------------------------- #
# recursive CTEs
# --------------------------------------------------------------------- #

def _references_cte(n: A.Node, name: str) -> bool:
    name = name.lower()
    return any(isinstance(x, A.TableName) and x.db is None
               and x.name.lower() == name for x in _walk_ast(n))


def _flatten_union(n: A.Node) -> list[tuple[A.Node, bool]]:
    """Left-deep UNION chain -> [(operand, all_flag_joining_previous)];
    the first operand's flag is unused."""
    if isinstance(n, A.SetOpStmt):
        if n.kind != "union":
            raise PlanError("recursive CTE must combine parts with UNION")
        if n.order_by or n.limit is not None:
            raise PlanError("ORDER BY/LIMIT not allowed in a recursive CTE body")
        return _flatten_union(n.left) + [(n.right, n.all)]
    return [(n, True)]


def _build_recursive_cte(c: A.CTE, catalog, default_db: str,
                         ctes: dict) -> CTEEntry:
    ops = _flatten_union(c.select)
    is_rec = [_references_cte(ast, c.name) for ast, _ in ops]
    if not any(is_rec):
        return CTEEntry(c.name, list(c.columns), c.select, def_ctes=dict(ctes))
    first_rec = is_rec.index(True)
    if first_rec == 0:
        raise PlanError(f"recursive CTE {c.name!r} needs a non-recursive "
                        "seed SELECT first")
    if not all(is_rec[first_rec:]):
        raise PlanError(f"recursive CTE {c.name!r}: seed parts must precede "
                        "recursive parts")
    # UNION DISTINCT anywhere in the chain => dedup semantics
    distinct = any(not flag for _, flag in ops[1:])
    storage = CTEStorage(c.name, distinct)

    seed_ops = ops[:first_rec]
    seed_ast = seed_ops[0][0]
    for ast, flag in seed_ops[1:]:
        seed_ast = A.SetOpStmt("union", flag, seed_ast, ast)
    sb = build_query(seed_ast, catalog, default_db, ctes)
    names = list(c.columns) if c.columns else list(sb.output_names)
    if len(names) != len(sb.output_names):
        raise PlanError(f"CTE {c.name!r} column list count mismatch")
    seed_plan = _trim_to_outputs(sb)
    storage.schema = Schema([
        SchemaCol(nm, col.dtype.with_nullable(True))
        for nm, col in zip(names, seed_plan.schema.cols)])
    storage.seed_logical = seed_plan

    entry = CTEEntry(c.name, names, c.select, def_ctes=dict(ctes),
                     storage=storage, building=True)
    rec_ctes = dict(ctes)
    rec_ctes[c.name.lower()] = entry
    for ast, _ in ops[first_rec:]:
        rb = build_query(ast, catalog, default_db, rec_ctes)
        if len(rb.output_names) != len(names):
            raise PlanError(f"recursive part of CTE {c.name!r} has wrong "
                            "column count")
        rplan = _trim_to_outputs(rb)
        for sc, rc in zip(storage.schema.cols, rplan.schema.cols):
            try:
                _unify_dtype(sc.dtype, rc.dtype)
            except PlanError:
                raise PlanError(
                    f"recursive part of CTE {c.name!r} column {sc.name!r}: "
                    f"type {rc.dtype} incompatible with seed type {sc.dtype}")
        storage.rec_logicals.append(rplan)
    entry.building = False
    return entry


def _build_cte_ref(entry: CTEEntry, alias: str, catalog,
                   default_db: str) -> LogicalPlan:
    if entry.storage is not None:
        st = entry.storage
        role = "working" if entry.building else "result"
        sch = Schema([SchemaCol(col.name, col.dtype, alias)
                      for col in st.schema.cols])
        return LogicalCTEScan(st, role, sch)
    built = build_query(entry.select, catalog, default_db,
                        entry.def_ctes or {})
    names = entry.columns or built.output_names
    if len(names) != len(built.output_names):
        raise PlanError(f"CTE {entry.name!r} column list count mismatch")
    sub = _trim_to_outputs(built)
    sub.schema = Schema([SchemaCol(nm, col.dtype, alias)
                         for nm, col in zip(names, sub.schema.cols)])
    return sub


# --------------------------------------------------------------------- #
# FROM clause
# --------------------------------------------------------------------- #

def _resolve_as_of(tbl, as_of) -> int:
    """AS OF TIMESTAMP literal -> MVCC read ts (staleread processor.go
    analog): ints are raw logical ts; datetime strings map through the
    store's wallclock->ts samples."""
    if getattr(tbl, "kv", None) is None:
        raise PlanError("AS OF TIMESTAMP needs the KV row store")
    if isinstance(as_of, int):
        return as_of
    import datetime as _dt
    try:
        when = _dt.datetime.fromisoformat(str(as_of))
    except ValueError as e:
        raise PlanError(f"bad AS OF TIMESTAMP literal {as_of!r}: {e}")
    try:
        return tbl.kv.ts_at_time(when.timestamp())
    except Exception as e:
        raise PlanError(str(e))


import threading as _threading

_view_expansion = _threading.local()


def _expand_view(view, alias: str, catalog, db: str,
                 ctes: Optional[dict]) -> LogicalPlan:
    """Inline a view reference as a named subquery (reference:
    core/logical_plan_builder.go BuildDataSourceFromView).  The stored
    SELECT text re-parses and re-plans on every reference; a per-thread
    expansion stack rejects recursive view chains."""
    from ..sql.parser import parse_sql
    stack = getattr(_view_expansion, "stack", frozenset())
    key = (db, view.name.lower())
    if key in stack:
        raise PlanError(f"view {view.name!r} references itself "
                        "(recursive views are invalid)")
    _view_expansion.stack = stack | {key}
    try:
        stmt = parse_sql(view.select_sql)[0]
        # view bodies resolve in their own namespace: a CTE in the
        # referencing query must not shadow a base table named inside
        built = build_query(stmt, catalog, db, {})
    finally:
        _view_expansion.stack = stack
    sub = built.plan
    out_names = list(view.columns) or list(built.output_names)
    if len(out_names) != len(built.output_names):
        raise PlanError(
            f"view {view.name!r} column list has {len(out_names)} names "
            f"for {len(built.output_names)} select columns")
    sch = Schema([SchemaCol(n, c.dtype, alias)
                  for n, c in zip(out_names,
                                  sub.schema.cols[:len(out_names)])])
    sub.schema = sch
    return sub


def _build_from(node: A.Node, catalog, default_db: str,
                ctes: Optional[dict] = None) -> LogicalPlan:
    ctes = ctes or {}
    if isinstance(node, A.TableName):
        alias = node.alias or node.name
        if node.db is None and node.name.lower() in ctes:
            return _build_cte_ref(ctes[node.name.lower()], alias, catalog,
                                  default_db)
        db = node.db or default_db
        view = getattr(catalog, "get_view", lambda *_: None)(db, node.name)
        if view is not None:
            return _expand_view(view, alias, catalog, db, ctes)
        tbl = catalog.get_table(db, node.name)
        sch = Schema([SchemaCol(n, t, alias)
                      for n, t in zip(tbl.col_names, tbl.col_types)])
        ds = DataSource(tbl, alias, sch, list(range(len(tbl.col_names))))
        if node.as_of is not None:
            ds.as_of_ts = _resolve_as_of(tbl, node.as_of)
        for kind, names in getattr(node, "index_hints", []):
            # table-factor hints (FROM t USE INDEX (ix)): same plumbing
            # as the /*+ USE_INDEX */ optimizer hints; FORCE == USE here
            low = [x.lower() for x in names]
            if kind in ("use", "force"):
                if low:
                    ds.hint_use = (ds.hint_use or []) + low
                else:
                    ds.hint_use = []    # USE INDEX (): forbid all indexes
            else:
                ds.hint_ignore = (ds.hint_ignore or []) + low
        return ds
    if isinstance(node, A.SubqueryRef):
        built = build_query(node.select, catalog, default_db, ctes)
        sub = built.plan
        sch = Schema([SchemaCol(n, c.dtype, node.alias)
                      for n, c in zip(built.output_names,
                                      sub.schema.cols[:len(built.output_names)])])
        sub.schema = sch
        return sub
    if isinstance(node, A.Join):
        left = _build_from(node.left, catalog, default_db, ctes)
        right = _build_from(node.right, catalog, default_db, ctes)
        sch = Schema(list(left.schema.cols) + list(right.schema.cols))
        join = LogicalJoin(node.kind, left, right, [], [], sch)
        conds: list[Expr] = []
        if node.using:
            for k in node.using:
                li = left.schema.find(k)
                ri = right.schema.find(k)
                if not li or not ri:
                    raise PlanError(f"USING column {k!r} not found")
                join.eq_keys.append((li[0], ri[0]))
            if join.kind == "cross":
                join.kind = "inner"
        if node.on is not None:
            cond = ExprBuilder(sch).build(node.on)
            conds = _split_cnf(cond)
            if join.kind == "cross":
                join.kind = "inner"
        join.other_conds = conds
        return join
    raise PlanError(f"unsupported FROM clause {type(node).__name__}")


__all__ = ["ExprBuilder", "PlanError", "BuiltSelect", "build_select",
           "build_query", "DualSource", "CTEEntry"]

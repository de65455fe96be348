# ported from tidb_tpu/expr/builders.py @ a9e9482
"""Type-inferring smart constructors for the expression IR: the subset
the ported paths need (literals, comparisons, logic, IS NULL,
arithmetic with MySQL decimal typing, IN, BETWEEN, IF/CASE/COALESCE).
Casts, temporal and string builders come with later slices of the port
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..types import decimal as dec
from ..types import dtypes as dt
from ..types import temporal as tmp
from .ir import Const, Expr, Func

K = dt.TypeKind

COMPARE_OPS = {"eq", "ne", "lt", "le", "gt", "ge"}
LOGIC_OPS = {"and", "or", "not"}
ARITH_OPS = {"add", "sub", "mul", "div", "intdiv", "mod"}


def lit(value, dtype: dt.DataType | None = None) -> Const:
    """Build a literal with device encoding."""
    if value is None:
        return Const(dt.null_type(), None)
    if dtype is None:
        if isinstance(value, bool):
            dtype = dt.bigint(False)
            value = int(value)
        elif isinstance(value, int):
            dtype = dt.bigint(False)
        elif isinstance(value, float):
            dtype = dt.double(False)
        else:
            raise TypeError(f"cannot infer literal type for {value!r}")
    elif dtype.kind == K.DECIMAL and not isinstance(value, (int, np.integer)):
        value = dec.encode(value, dtype.scale)
    elif dtype.kind == K.DATE and isinstance(value, str):
        value = tmp.parse_date(value)
    elif dtype.kind == K.DATETIME and isinstance(value, str):
        value = tmp.parse_datetime(value)
    return Const(dtype.with_nullable(False), value)


def decimal_lit(text: str) -> Const:
    """Numeric literal with a decimal point -> DECIMAL, MySQL-style."""
    s = text.strip()
    body = s.lstrip("+-")
    if "." in body:
        ip, fp = body.split(".", 1)
    else:
        ip, fp = body, ""
    scale = len(fp)
    prec = max(len(ip) + scale, 1)
    d = dt.decimal(prec, scale, nullable=False)
    return Const(d, dec.encode(s, scale))


def _dec_ps(t: dt.DataType) -> tuple[int, int]:
    """(precision, scale) of an operand for decimal type inference;
    integer operands count as (18, 0)."""
    if t.kind == K.DECIMAL:
        p = t.prec if t.prec > 0 else dt.DECIMAL64_MAX_PRECISION
        return p, max(t.scale, 0)
    return dt.DECIMAL64_MAX_PRECISION, 0


def _arith_result_type(op: str, a: dt.DataType, b: dt.DataType) -> dt.DataType:
    """MySQL-style result typing with decimal precision/scale
    propagation, saturated at 18 digits.

    decimal64 contract: precision is capped at DECIMAL64_MAX_PRECISION;
    an operation whose true result needs more digits keeps its scale but
    may overflow int64 at run time.  Device lanes are unguarded, as the
    JAX package's traced lanes are; SUMs stay exact through their limb
    states."""
    nullable = a.nullable or b.nullable or op in ("div", "intdiv", "mod")
    # arithmetic over a wide (aggregation-result) decimal stays wide: the
    # host object-int representation is exact past 18 digits
    wide = (a.kind == K.DECIMAL and a.prec > dt.DECIMAL64_MAX_PRECISION) or \
           (b.kind == K.DECIMAL and b.prec > dt.DECIMAL64_MAX_PRECISION)
    mk = dt.decimal_wide if wide else dt.decimal
    cap = dt.DECIMAL_MAX_PRECISION if wide else dt.DECIMAL64_MAX_PRECISION
    if op == "div":
        # MySQL `/`: decimal out if both exact, else double
        if (a.kind in (K.INT64, K.UINT64, K.DECIMAL)
                and b.kind in (K.INT64, K.UINT64, K.DECIMAL)):
            _, sa = _dec_ps(a)
            return mk(cap, min(sa + dt.DIV_FRAC_INCR, 12), nullable)
        return dt.double(nullable)
    if op == "intdiv":
        return dt.bigint(nullable)
    t = dt.common_numeric_type(a, b)
    if t.kind == K.DECIMAL:
        (pa, sa), (pb, sb) = _dec_ps(a), _dec_ps(b)
        if op == "mul":
            scale, prec = sa + sb, pa + pb
        else:
            scale = max(sa, sb)
            prec = max(pa - sa, pb - sb) + 1 + scale
        prec = min(prec, cap)
        scale = min(scale, prec)
        return mk(prec, scale, nullable)
    return t.with_nullable(nullable)


def arith(op: str, a: Expr, b: Expr) -> Func:
    if op not in ARITH_OPS:
        raise ValueError(f"not an arithmetic operator: {op!r}")
    return Func(_arith_result_type(op, a.dtype, b.dtype), op, (a, b))


def neg(a: Expr) -> Func:
    return Func(a.dtype, "neg", (a,))


def compare(op: str, a: Expr, b: Expr) -> Func:
    if op not in COMPARE_OPS:
        raise ValueError(f"not a comparison: {op!r}")
    nullable = a.dtype.nullable or b.dtype.nullable
    return Func(dt.bigint(nullable), op, (a, b))


def logic(op: str, *args: Expr) -> Func:
    if op not in LOGIC_OPS:
        raise ValueError(f"not a logic operator: {op!r}")
    nullable = any(a.dtype.nullable for a in args)
    return Func(dt.bigint(nullable), op, tuple(args))


def is_null(a: Expr) -> Func:
    return Func(dt.bigint(False), "isnull", (a,))


def if_(cond: Expr, then: Expr, els: Expr) -> Func:
    t = _branch_type([then, els])
    return Func(t, "if", (cond, then, els))


def case_when(pairs: Sequence[tuple[Expr, Expr]], els: Expr | None) -> Func:
    """CASE WHEN c1 THEN v1 ... ELSE e END; args flattened as
    (c1, v1, c2, v2, ..., [else])."""
    vals = [v for _, v in pairs] + ([els] if els is not None else [])
    t = _branch_type(vals)
    args: list[Expr] = []
    for c, v in pairs:
        args += [c, v]
    if els is not None:
        args.append(els)
    return Func(t, "case", tuple(args))


def coalesce(*args: Expr) -> Func:
    t = _branch_type(list(args))
    return Func(t.with_nullable(all(a.dtype.nullable for a in args)),
                "coalesce", args)


def ifnull(a: Expr, b: Expr) -> Func:
    return coalesce(a, b)


def _branch_type(vals: Sequence[Expr]) -> dt.DataType:
    t = vals[0].dtype
    for v in vals[1:]:
        if v.dtype.kind == K.NULL:
            t = t.with_nullable(True)
            continue
        if t.kind == K.NULL:
            t = v.dtype.with_nullable(True)
            continue
        if v.dtype.kind != t.kind or v.dtype.scale != t.scale:
            if t.is_numeric and v.dtype.is_numeric:
                c = dt.common_numeric_type(t, v.dtype)
                if c.kind == K.DECIMAL:
                    sa = t.scale if t.kind == K.DECIMAL else 0
                    sb = v.dtype.scale if v.dtype.kind == K.DECIMAL else 0
                    c = dt.decimal(dt.DECIMAL64_MAX_PRECISION, max(sa, sb))
                t = c.with_nullable(t.nullable or v.dtype.nullable)
            else:
                t = t.with_nullable(t.nullable or v.dtype.nullable)
        else:
            t = t.with_nullable(t.nullable or v.dtype.nullable)
    return t


def in_list(a: Expr, items: Sequence[Expr]) -> Func:
    nullable = a.dtype.nullable or any(i.dtype.nullable for i in items)
    return Func(dt.bigint(nullable), "in", (a, *items))


def between(a: Expr, lo: Expr, hi: Expr) -> Func:
    return logic("and", compare("ge", a, lo), compare("le", a, hi))


__all__ = ["lit", "decimal_lit", "arith", "neg", "compare", "logic",
           "is_null", "if_", "case_when", "coalesce", "ifnull", "in_list",
           "between"]

# ported from tidb_tpu/expr/builders.py @ 9d319cb
"""Type-inferring smart constructors for the expression IR.

Reference analog: pkg/expression function-class construction
(builtin.go:661 funcs registry) + type inference in newBaseBuiltinFunc.
The planner builds all expressions through these so every IR node carries a
resolved DataType (incl. decimal precision/scale per MySQL rules).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..types import dtypes as dt
from ..types import decimal as dec
from ..types import temporal as tmp
from .ir import ColumnRef, Const, Expr, Func

K = dt.TypeKind

COMPARE_OPS = {"eq", "ne", "lt", "le", "gt", "ge"}
LOGIC_OPS = {"and", "or", "not", "xor"}
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
        elif isinstance(value, str):
            dtype = dt.varchar(False)
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
    """Numeric literal with a decimal point → DECIMAL, MySQL-style."""
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
    """(precision, scale) of an operand for decimal type inference; integer
    operands count as (18, 0) unless they're narrow literals."""
    if t.kind == K.DECIMAL:
        p = t.prec if t.prec > 0 else dt.DECIMAL64_MAX_PRECISION
        return p, max(t.scale, 0)
    return dt.DECIMAL64_MAX_PRECISION, 0


def _arith_result_type(op: str, a: dt.DataType, b: dt.DataType) -> dt.DataType:
    """MySQL-style result typing (builtin_arithmetic.go setType analogs) with
    decimal precision/scale propagation, saturated at 18 digits.

    decimal64 contract: precision is capped at DECIMAL64_MAX_PRECISION; an
    operation whose true result needs more digits keeps its scale but may
    overflow int64 at runtime.  SUMs are overflow-proof via limb splitting,
    and host-evaluated scalar add/sub/mul — and the div path's pow10
    pre-scaling multiply — raise OverflowError instead of wrapping
    (expr/compile.Evaluator._guard_dec_overflow).  Still unguarded:
    device-traced (jnp) lanes — a traced program cannot raise
    data-dependently — which is exactly what analysis/valueflow proves
    safe pre-trace (NUM-OVERFLOW-DEVICE / NUM-DIV-PRESCALE)."""
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
    return Func(t.with_nullable(all(a.dtype.nullable for a in args)), "coalesce", args)


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


def cast(a: Expr, to: dt.DataType) -> Expr:
    if a.dtype.kind == to.kind and a.dtype.scale == to.scale:
        return a
    return Func(to.with_nullable(a.dtype.nullable), "cast", (a,))


def reinterpret(a: Expr, to: dt.DataType) -> Expr:
    """Raw int64 reinterpret between numeric and micros-encoded temporal
    types — the internal composition seam for time arithmetic (user CAST
    parses digits per MySQL instead)."""
    return Func(to.with_nullable(a.dtype.nullable), "reinterp", (a,))


def in_list(a: Expr, items: Sequence[Expr]) -> Func:
    nullable = a.dtype.nullable or any(i.dtype.nullable for i in items)
    return Func(dt.bigint(nullable), "in", (a, *items))


def between(a: Expr, lo: Expr, hi: Expr) -> Func:
    return logic("and", compare("ge", a, lo), compare("le", a, hi))


def temporal_part(part: str, a: Expr) -> Func:
    """YEAR(x)/MONTH(x)/DAYOFMONTH(x) etc. over DATE/DATETIME columns."""
    return Func(dt.bigint(a.dtype.nullable), part, (a,))


# ------------------------------------------------------------------ #
# string functions — generic Func nodes here; expr/lower_strings.py
# rewrites them onto dictionary codes at plan-binding time (the TPU
# answer to pkg/expression/builtin_string_vec.go: per-distinct-value
# compute host-side, per-row gather on device)
# ------------------------------------------------------------------ #

STRING_VALUED_FUNCS = {"upper", "lower", "trim", "ltrim", "rtrim", "reverse",
                       "substring", "replace", "concat", "left", "right",
                       "lpad", "rpad", "repeat", "substring_index",
                       "md5", "sha1", "sha2", "hex", "soundex",
                       "json_extract", "json_unquote", "json_type",
                       "insert_str", "quote", "to_base64", "from_base64",
                       "unhex", "regexp_substr", "regexp_replace", "conv",
                       "weight_string", "json_set", "json_insert",
                       "json_replace", "json_remove", "json_keys",
                       "json_search", "json_merge_patch",
                       "json_merge_preserve", "json_merge",
                       "json_array_append", "json_pretty", "json_quote",
                       "json_value", "uuid_to_bin", "bin_to_uuid",
                       "inet6_ntoa", "inet6_aton", "compress",
                       "uncompress"}
STRING_INT_FUNCS = {"length", "char_length", "ascii", "locate", "instr",
                    "find_in_set", "crc32", "strcmp",
                    "json_valid", "json_length", "json_contains",
                    "bit_length", "inet_aton", "regexp_like",
                    "regexp_instr", "json_depth", "json_contains_path",
                    "json_storage_size", "json_overlaps", "is_uuid",
                    "ord"}


def str_func(name: str, *args: Expr) -> Func:
    nullable = any(a.dtype.nullable for a in args)
    if name == "concat" and len(args) > 2:
        # n-ary CONCAT folds to a binary tree so lowering only ever sees
        # pairs (each level's derived dictionary feeds the next)
        out = args[0]
        for a in args[1:]:
            out = str_func("concat", out, a)
        return out
    if name in STRING_INT_FUNCS:
        return Func(dt.bigint(nullable), name, tuple(args))
    assert name in STRING_VALUED_FUNCS, name
    return Func(dt.varchar(nullable), name, tuple(args))


# ------------------------------------------------------------------ #
# math functions (builtin_math_vec.go analogs)
# ------------------------------------------------------------------ #

_DOUBLE_FUNCS = {"sqrt", "exp", "ln", "log2", "log10", "sin", "cos", "tan",
                 "asin", "acos", "atan", "radians", "degrees", "cot"}


def math_func(name: str, *args: Expr) -> Func:
    nullable = any(a.dtype.nullable for a in args)
    if name in ("ceil", "floor"):
        a = args[0]
        out = dt.double(nullable) if a.dtype.is_float else dt.bigint(nullable)
        return Func(out, name, args)
    if name == "sign":
        return Func(dt.bigint(nullable), name, args)
    if name in ("pow", "atan2", "log") or name in _DOUBLE_FUNCS:
        # domain errors (sqrt of negative, log of <=0) yield NULL
        return Func(dt.double(True), name, tuple(args))
    raise AssertionError(name)


def round_func(a: Expr, d: int, truncate: bool = False) -> Func:
    """ROUND(a, d) / TRUNCATE(a, d) with MySQL result typing."""
    op = "truncate" if truncate else "round"
    darg = Const(dt.bigint(False), d)
    if a.dtype.is_float:
        return Func(dt.double(a.dtype.nullable), op, (a, darg))
    if a.dtype.kind == K.DECIMAL:
        s = max(min(d, a.dtype.scale), 0)
        out = dt.decimal(max(a.dtype.prec - (a.dtype.scale - s), 1), s,
                         a.dtype.nullable)
        return Func(out, op, (a, darg))
    return Func(a.dtype, op, (a, darg))   # int: d<0 rounds powers of ten


def greatest_least(name: str, args: Sequence[Expr]) -> Func:
    if any(a.dtype.is_string for a in args):
        if not all(a.dtype.is_string for a in args):
            raise ValueError(f"{name.upper()} over mixed string/non-string "
                             "arguments is not supported")
    t = _branch_type(list(args))
    nullable = any(a.dtype.nullable for a in args)  # MySQL: NULL if any NULL
    return Func(t.with_nullable(nullable), name, tuple(args))


# ------------------------------------------------------------------ #
# temporal functions (builtin_time_vec.go analogs)
# ------------------------------------------------------------------ #

def datediff(a: Expr, b: Expr) -> Func:
    return Func(dt.bigint(a.dtype.nullable or b.dtype.nullable),
                "datediff", (a, b))


def date_add(base: Expr, amount: Expr, unit: str) -> Expr:
    """DATE_ADD/DATE_SUB with a runtime (non-constant) base.

    DAY/WEEK lower to integer day arithmetic; MONTH/QUARTER/YEAR to civil
    decompose-add-clamp (dateadd_months); sub-day units promote DATE to
    DATETIME (MySQL semantics) and add scaled microseconds."""
    unit = unit.upper()
    nullable = base.dtype.nullable or amount.dtype.nullable
    if unit in ("DAY", "WEEK"):
        n = arith("mul", amount, lit(7)) if unit == "WEEK" else amount
        return Func(base.dtype.with_nullable(nullable), "dateadd_days",
                    (base, n))
    if unit in ("MONTH", "QUARTER", "YEAR"):
        mult = {"MONTH": 1, "QUARTER": 3, "YEAR": 12}[unit]
        n = arith("mul", amount, lit(mult)) if mult != 1 else amount
        return Func(base.dtype.with_nullable(nullable), "dateadd_months",
                    (base, n))
    if unit in ("HOUR", "MINUTE", "SECOND", "MICROSECOND"):
        mult = {"HOUR": 3_600_000_000, "MINUTE": 60_000_000,
                "SECOND": 1_000_000, "MICROSECOND": 1}[unit]
        b = cast(base, dt.datetime()) if base.dtype.kind == K.DATE else base
        n = arith("mul", amount, lit(mult)) if mult != 1 else amount
        return Func(dt.datetime(nullable), "dateadd_micros", (b, n))
    raise ValueError(f"unsupported INTERVAL unit {unit}")


def last_day(a: Expr) -> Func:
    return Func(dt.date(a.dtype.nullable), "last_day", (a,))


def dict_map(col: Expr, mapping: np.ndarray) -> Func:
    """Integer code-translation gather: remaps one dictionary's codes into a
    shared (merged) code space so string columns with different dictionaries
    compare/join correctly (the analog of collation sortkey normalization)."""
    return Func(col.dtype, "dict_map",
                (col, Const(dt.bigint(False), mapping.astype(np.int32))))


def dict_lut(col: Expr, lut: np.ndarray, nullable: bool | None = None) -> Func:
    """Boolean lookup-table gather over dictionary codes — how LIKE / IN /
    collation predicates on strings execute on device (SURVEY.md §7)."""
    if nullable is None:
        nullable = col.dtype.nullable
    return Func(dt.bigint(nullable), "dict_lut",
                (col, Const(dt.bigint(False), lut.astype(np.bool_))))


def dict_ilut(col: Expr, lut: np.ndarray, out: dt.DataType) -> Func:
    """Integer lookup-table gather over dictionary codes — how LENGTH /
    ASCII / LOCATE on dict-encoded strings execute on device."""
    return Func(out, "dict_lut", (col, Const(dt.bigint(False),
                                             lut.astype(np.int64))))


__all__ = [
    "COMPARE_OPS", "LOGIC_OPS", "ARITH_OPS",
    "lit", "decimal_lit", "arith", "neg", "compare", "logic", "is_null",
    "if_", "case_when", "coalesce", "ifnull", "cast", "in_list", "between",
    "temporal_part", "dict_lut", "dict_map", "dict_ilut", "str_func",
    "math_func", "round_func", "greatest_least", "datediff", "date_add",
    "last_day", "STRING_VALUED_FUNCS", "STRING_INT_FUNCS",
]

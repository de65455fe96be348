"""The lane cases of the port's device evaluator, without JAX.

``DATA`` holds the seeded columns (NULLs, int8/16/32 physical widths of
BIGINT, DECIMAL and DATE values, negatives, zero divisors, the int64
edges, dates before 1970 and leap days, datetimes, BIGINT UNSIGNED
values past 2^63) and ``CASES`` one builder an expression over them,
each called with a namespace of a package's builders, types and IR
(``_P`` for the port's).  tests/test_torch_evaluator.py holds each case
against the JAX package's evaluator on the CPU; tests/test_torch_cuda.py
holds it on the card against the CPU.
"""

import numpy as np

from tidb_tpu_torch.expr import builders as b
from tidb_tpu_torch.expr import ir
from tidb_tpu_torch.types import dtypes as dt

N = 4096
I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1


class _P:
    b, dt, Func, Const, Ref = b, dt, ir.Func, ir.Const, ir.ColumnRef


def _days(y, m, d):
    import datetime
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _data():
    """The columns: name -> (type maker, numpy data, validity or None)."""
    rng = np.random.default_rng(20261017)
    edges = np.array([0, 1, -1, I64_MIN, I64_MAX, I64_MIN + 1, 7, -7,
                      20240229, 20230231, 19991231235959, 20240229120000,
                      -20240229, 99991231, 123, 10 ** 12], np.int64)
    i = rng.integers(-10 ** 6, 10 ** 6, N)
    i[:len(edges)] = edges
    j = rng.integers(-50, 50, N)
    j[:8] = [0, -1, 1, 0, I64_MIN, 2, -2, 3]
    f = np.round(rng.normal(0, 300, N), 1)
    f[:16] = [0.5, -0.5, 1.5, -2.5, 0.0, -0.0, 2.0 ** 63, -2.0 ** 63 - 4096,
              1e19, -1e19, 3e18, 2.0 ** 64, 1e300, -7.25, 1e-3, 2.675]
    t = rng.uniform(-3, 3, N)
    t[:6] = [0.0, 1.0, -1.0, 0.5, 2.0, -2.0]
    u = rng.integers(0, 2 ** 64 - 1, N, dtype=np.uint64, endpoint=True)
    u[:6] = [0, 1, 2 ** 63, 2 ** 63 - 1, 2 ** 64 - 1, 2 ** 63 + 5]
    w = rng.integers(0, 2 ** 64 - 1, N, dtype=np.uint64, endpoint=True)
    w[:12] = [0, 1, 2 ** 63, 3, 2 ** 64 - 1, 10, 2 ** 63 + 5, 7, 2, 2 ** 62,
              2 ** 63 - 1, 5]
    lo, hi = _days(1900, 1, 1), _days(2050, 12, 31)
    day = rng.integers(lo, hi, N).astype(np.int32)
    day[:10] = [_days(2024, 2, 29), _days(2000, 2, 29), _days(1900, 3, 1),
                _days(1969, 12, 31), _days(1970, 1, 1), _days(1960, 2, 29),
                _days(2023, 1, 31), _days(2024, 12, 31), _days(1904, 1, 3),
                _days(2021, 1, 3)]
    d16 = rng.integers(lo, hi, N).astype(np.int16)
    ts = (rng.integers(lo, hi, N).astype(np.int64) * 86_400_000_000
          + rng.integers(0, 86_400_000_000, N))
    ts[:4] = [0, -1, _days(1955, 6, 1) * 86_400_000_000 + 3_723_000_042,
              _days(2024, 2, 29) * 86_400_000_000 + 86_399_999_999]
    null = lambda p: rng.random(N) >= p       # noqa: E731
    return {
        "i": (lambda P: P.dt.bigint(), i, null(0.1)),
        "j": (lambda P: P.dt.bigint(), j, null(0.1)),
        "n8": (lambda P: P.dt.bigint(False),
               rng.integers(-100, 100, N).astype(np.int8), None),
        "n16": (lambda P: P.dt.bigint(False),
                rng.integers(-3000, 3000, N).astype(np.int16), None),
        "n32": (lambda P: P.dt.bigint(),
                rng.integers(-2 ** 31, 2 ** 31 - 1, N).astype(np.int32),
                null(0.05)),
        "d2": (lambda P: P.dt.decimal(15, 2),
               rng.integers(-10 ** 9, 10 ** 9, N), null(0.1)),
        "d4": (lambda P: P.dt.decimal(12, 4, False),
               np.where(np.arange(N) % 97 == 0, 0,
                        rng.integers(-10 ** 8, 10 ** 8, N)).astype(np.int32),
               None),
        "dn": (lambda P: P.dt.decimal(10, 2, False),
               rng.integers(-30000, 30000, N).astype(np.int16), None),
        "f": (lambda P: P.dt.double(), f, null(0.1)),
        "t": (lambda P: P.dt.double(False), t, None),
        "u": (lambda P: P.dt.ubigint(), u, null(0.1)),
        "w": (lambda P: P.dt.ubigint(False), w, None),
        "day": (lambda P: P.dt.date(), day, null(0.1)),
        "d16": (lambda P: P.dt.date(False), d16, None),
        "ts": (lambda P: P.dt.datetime(), ts, null(0.1)),
        "code": (lambda P: P.dt.varchar(False),
                 rng.integers(0, 6, N).astype(np.int32), None),
    }


DATA = _data()
NAMES = list(DATA)


def col(P, name):
    return P.Ref(DATA[name][0](P), NAMES.index(name), name)


def lit(P, v, t=None):
    return P.b.lit(v, t(P) if t is not None else None)


def ulit(P, v):
    """A BIGINT UNSIGNED literal.  The JAX package's device lanes raise
    OverflowError for a python int past 2^63 - 1 beside a uint64 array
    (jnp parses it as int64), so its side takes the literal as
    ``np.uint64``; the port's takes the python int, as its planner
    gives it."""
    return P.b.lit(np.uint64(v) if getattr(P, "jax", False) else v,
                   P.dt.ubigint(False))


def F(P, op, t, *args):
    return P.Func(t(P), op, tuple(args))


def _cases():
    """name -> builder(P) of one expression over the columns."""
    c = {}

    def add(name, fn):
        c[name] = fn

    # -- arithmetic, every kind and width ----------------------------- #
    for op in ("add", "sub", "mul", "div", "intdiv", "mod"):
        for x, y in (("i", "j"), ("n16", "n8"), ("d2", "d4"), ("d2", "n8"),
                     ("dn", "d4"), ("f", "t"), ("u", "w"), ("i", "u"),
                     ("w", "n16"), ("n32", "dn"), ("i", "t")):
            add(f"{op}({x},{y})",
                lambda P, op=op, x=x, y=y: P.b.arith(op, col(P, x),
                                                     col(P, y)))
    add("div(d2,lit 3)", lambda P: P.b.arith("div", col(P, "d2"),
                                             lit(P, 3)))
    add("mod(lit -7,j)", lambda P: P.b.arith("mod", lit(P, -7), col(P, "j")))
    add("intdiv(u,lit 2^63+5)", lambda P: P.b.arith(
        "intdiv", col(P, "u"), ulit(P, 2 ** 63 + 5)))
    add("add(u,lit 1)", lambda P: P.b.arith("add", col(P, "u"), lit(P, 1)))
    for x in ("i", "n8", "d2", "f", "u"):
        add(f"neg({x})", lambda P, x=x: P.b.neg(col(P, x)))
        add(f"abs({x})", lambda P, x=x: P.Func(col(P, x).dtype, "abs",
                                               (col(P, x),)))

    # -- comparisons --------------------------------------------------- #
    for op in ("eq", "ne", "lt", "le", "gt", "ge"):
        for x, y in (("i", "j"), ("n16", "n8"), ("d2", "d4"), ("f", "d2"),
                     ("u", "w"), ("i", "u"), ("u", "n16"), ("day", "ts"),
                     ("ts", "d16"), ("code", "code")):
            add(f"{op}({x},{y})",
                lambda P, op=op, x=x, y=y: P.b.compare(op, col(P, x),
                                                       col(P, y)))
        add(f"{op}(n16,lit 100000)", lambda P, op=op: P.b.compare(
            op, col(P, "n16"), lit(P, 100000)))
        add(f"{op}(u,lit 2^63+5)", lambda P, op=op: P.b.compare(
            op, col(P, "u"), ulit(P, 2 ** 63 + 5)))
        add(f"{op}(day,lit datetime)", lambda P, op=op: P.b.compare(
            op, col(P, "day"), lit(P, "2000-02-29 12:00:00",
                                   lambda P: P.dt.datetime(False))))

    # -- logic and NULLs ----------------------------------------------- #
    for op in ("and", "or", "xor"):
        add(f"{op}", lambda P, op=op: P.b.logic(
            op, P.b.compare("gt", col(P, "i"), lit(P, 0)),
            P.b.compare("lt", col(P, "f"), lit(P, 0.0))))
        add(f"{op}(int,u)", lambda P, op=op: P.b.logic(
            op, col(P, "j"), col(P, "u")))
    add("not", lambda P: P.b.logic("not", col(P, "d2")))
    add("isnull", lambda P: P.b.is_null(col(P, "ts")))
    add("if", lambda P: P.b.if_(P.b.compare("gt", col(P, "j"), lit(P, 0)),
                                col(P, "d2"), col(P, "n8")))
    add("if(u)", lambda P: P.b.if_(P.b.compare("gt", col(P, "j"), lit(P, 0)),
                                   col(P, "u"), col(P, "w")))
    add("case", lambda P: P.b.case_when(
        [(P.b.compare("lt", col(P, "j"), lit(P, -10)), col(P, "f")),
         (P.b.compare("lt", col(P, "j"), lit(P, 10)), col(P, "dn"))],
        col(P, "t")))
    add("coalesce", lambda P: P.b.coalesce(col(P, "i"), col(P, "n32"),
                                           col(P, "n16")))
    add("in", lambda P: P.b.in_list(col(P, "j"), [lit(P, 3), lit(P, None),
                                                  col(P, "n8")]))
    add("in(u)", lambda P: P.b.in_list(col(P, "u"), [ulit(P, 2 ** 63 + 5),
                                                     ulit(P, 1)]))
    add("dict_lut", lambda P: P.b.dict_lut(
        col(P, "code"), np.array([1, 0, 0, 1, 1, 0], bool)))
    add("dict_map", lambda P: P.b.dict_map(
        col(P, "code"), np.array([5, 4, 3, 2, 1, 0], np.int32)))

    # -- casts ----------------------------------------------------------- #
    casts = [("f", lambda P: P.dt.bigint()), ("f", lambda P: P.dt.ubigint()),
             ("d2", lambda P: P.dt.bigint()), ("d2", lambda P: P.dt.ubigint()),
             ("i", lambda P: P.dt.decimal(18, 2)),
             ("d2", lambda P: P.dt.decimal(15, 0)),
             ("d4", lambda P: P.dt.decimal(18, 6)),
             ("dn", lambda P: P.dt.decimal(10, 1)),
             ("f", lambda P: P.dt.decimal(15, 3)),
             ("u", lambda P: P.dt.decimal(18, 1)),
             ("i", lambda P: P.dt.double()), ("u", lambda P: P.dt.double()),
             ("d2", lambda P: P.dt.double()), ("n8", lambda P: P.dt.double()),
             ("day", lambda P: P.dt.datetime()),
             ("d16", lambda P: P.dt.datetime()),
             ("ts", lambda P: P.dt.date()), ("i", lambda P: P.dt.datetime()),
             ("u", lambda P: P.dt.datetime()),
             ("i", lambda P: P.dt.time()), ("ts", lambda P: P.dt.time()),
             ("day", lambda P: P.dt.date()), ("n16", lambda P: P.dt.ubigint()),
             ("u", lambda P: P.dt.bigint()), ("i", lambda P: P.dt.ubigint())]
    for x, t in casts:
        add(f"cast({x}->{t(_P).kind.name}{t(_P).scale or ''})",
            lambda P, x=x, t=t: P.Func(t(P), "cast", (col(P, x),)))

    # -- math ------------------------------------------------------------ #
    for x in ("f", "d2", "dn", "i", "n16"):
        for fn in ("ceil", "floor", "sign"):
            add(f"{fn}({x})", lambda P, fn=fn, x=x: P.b.math_func(
                fn, col(P, x)))
    add("sign(u)", lambda P: P.b.math_func("sign", col(P, "u")))
    for x, nd in (("f", 0), ("f", 1), ("f", -2), ("d2", 1), ("d2", 0),
                  ("d2", -3), ("dn", 1), ("i", -2), ("i", 0), ("n16", -1),
                  ("t", 2)):
        for tr in (False, True):
            add(f"{'truncate' if tr else 'round'}({x},{nd})",
                lambda P, x=x, nd=nd, tr=tr: P.b.round_func(
                    col(P, x), nd, tr))
    for fn in ("sqrt", "exp", "ln", "log2", "log10", "sin", "cos", "tan",
               "cot", "asin", "acos", "atan", "radians", "degrees"):
        for x in ("f", "t", "d2", "n8"):
            add(f"{fn}({x})", lambda P, fn=fn, x=x: P.b.math_func(
                fn, col(P, x)))
    for fn, x, y in (("pow", "f", "t"), ("pow", "t", "n8"),
                     ("pow", "t", "t"), ("atan2", "f", "t"),
                     ("atan2", "d2", "n8"), ("log", "t", "f"),
                     ("log", "d2", "n8")):
        add(f"{fn}({x},{y})", lambda P, fn=fn, x=x, y=y: P.b.math_func(
            fn, col(P, x), col(P, y)))
    add("log(f)", lambda P: P.b.math_func("log", col(P, "f")))
    for fn in ("greatest", "least"):
        for args in (("i", "j", "n8"), ("f", "d2"), ("d2", "d4", "dn"),
                     ("u", "w"), ("day", "d16")):
            add(f"{fn}{args}", lambda P, fn=fn, args=args:
                P.b.greatest_least(fn, [col(P, a) for a in args]))

    # -- temporal -------------------------------------------------------- #
    for part in ("year", "month", "dayofmonth", "dayofweek", "weekday",
                 "dayofyear", "quarter", "hour", "minute", "second",
                 "microsecond", "to_days", "last_day", "unix_timestamp"):
        for x in ("day", "d16", "ts"):
            t = (lambda P: P.dt.date()) if part == "last_day" \
                else (lambda P: P.dt.bigint())
            add(f"{part}({x})", lambda P, part=part, x=x, t=t: F(
                P, part, t, col(P, x)))
    for x in ("day", "d16", "ts"):
        add(f"week({x})", lambda P, x=x: F(P, "week", lambda P: P.dt.bigint(),
                                           col(P, x)))
        for mode in (0, 3):
            add(f"week({x},{mode})", lambda P, x=x, mode=mode: F(
                P, "week", lambda P: P.dt.bigint(), col(P, x),
                lit(P, mode)))
    for x, y in (("day", "ts"), ("ts", "d16"), ("d16", "day")):
        add(f"datediff({x},{y})", lambda P, x=x, y=y: P.b.datediff(
            col(P, x), col(P, y)))
    for x in ("day", "d16", "ts"):
        for unit, n in (("DAY", "n8"), ("WEEK", "n8"), ("MONTH", "n16"),
                        ("QUARTER", "n8"), ("YEAR", "n8"), ("HOUR", "n8"),
                        ("MICROSECOND", "n32")):
            add(f"date_add({x},{n} {unit})",
                lambda P, x=x, unit=unit, n=n: P.b.date_add(
                    col(P, x), col(P, n), unit))
    for unit in ("DAY", "MONTH", "SECOND"):
        add(f"date_add(day,t {unit})", lambda P, unit=unit: P.b.date_add(
            col(P, "day"), col(P, "t"), unit))
    add("from_days(n32)", lambda P: F(P, "from_days", lambda P: P.dt.date(),
                                      P.b.arith("add", col(P, "n16"),
                                                lit(P, 719528))))
    add("from_unixtime(n32)", lambda P: F(
        P, "from_unixtime", lambda P: P.dt.datetime(), col(P, "n32")))
    add("from_unixtime(d2)", lambda P: F(
        P, "from_unixtime", lambda P: P.dt.datetime(), col(P, "d2")))
    add("makedate(n16,n8)", lambda P: F(P, "makedate", lambda P: P.dt.date(),
                                        col(P, "n16"), col(P, "n8")))
    add("makedate(lit 2024,j)", lambda P: F(
        P, "makedate", lambda P: P.dt.date(), lit(P, 2024), col(P, "j")))
    return c


CASES = _cases()



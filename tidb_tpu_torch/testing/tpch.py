# ported from tidb_tpu/testing/tpch.py @ a9e9482
"""TPC-H lineitem, part and orders generators (numpy, vectorized), the
plan corpus, and SQL sessions over generated tables.

Draws from the same ``np.random.default_rng([seed, tag])`` child streams
as the JAX package's generator, so the same ``sf`` and ``seed`` give the
same values, column for column.  SF=1 is 6,000,000 lineitem rows.

``TPCH_PLAN_QUERIES`` is the JAX package's corpus, verbatim;
``SQL_QUERIES`` names the statements the port's SQL path runs: TPC-H Q1
and Q6 in the specification's text (its INTERVAL arithmetic, with the
validation substitutions) and the corpus's lineitem-only statements.
``JOIN_QUERIES`` names the statements of the join slice: the corpus's
join statements, TPC-H Q19 in the specification's text, the broadcast
step of the MULTICHIP shapes, m:n joins on ``o_custkey``, a left join
with an ``ON`` filter, a correlated EXISTS and a correlated scalar
subquery, and ``TPCH_SHUFFLE_QUERIES``.  ``tpch_sql_session`` is the
counterpart of the JAX package's ``tpch_plan_session``: a port
``Session`` over lineitem and, when asked, part and orders, without
ANALYZE.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

from ..chunk.column import Column, StringDict
from ..types import dtypes as dt

DEC2 = dt.decimal(15, 2)

LINEITEM_NAMES = [
    "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
    "l_extendedprice", "l_discount", "l_tax", "l_returnflag", "l_linestatus",
    "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipinstruct",
    "l_shipmode",
]

SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
SHIPINSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]


def _days(iso: str) -> int:
    """Days since 1970-01-01 (the DATE device encoding)."""
    return (_dt.date.fromisoformat(iso) - _dt.date(1970, 1, 1)).days


_STARTDATE = _days("1992-01-01")
_CURRENTDATE = _days("1995-06-17")


def gen_lineitem(sf: float = 1.0, seed: int = 0,
                 columns: list[str] | None = None
                 ) -> tuple[list[str], list[Column]]:
    """Generate lineitem columns; `columns` restricts output (saves RAM)
    without changing the values of the columns that are produced."""
    n = int(6_000_000 * sf)
    want = set(columns or LINEITEM_NAMES)
    out_names, out_cols = [], []

    def emit(name, col):
        if name in want:
            out_names.append(name)
            out_cols.append(col)

    def crng(tag: int):
        return np.random.default_rng([seed, tag])

    if "l_orderkey" in want:
        orderkey = np.sort(
            crng(1).integers(1, max(int(1_500_000 * sf), 1) * 4 + 1, n))
        emit("l_orderkey", Column.from_numpy(dt.bigint(False), orderkey))
    if {"l_partkey", "l_extendedprice"} & want:
        partkey = crng(2).integers(1, max(int(200_000 * sf), 1) + 1, n)
        emit("l_partkey", Column.from_numpy(dt.bigint(False), partkey))
    if "l_suppkey" in want:
        emit("l_suppkey", Column.from_numpy(
            dt.bigint(False),
            crng(3).integers(1, max(int(10_000 * sf), 1) + 1, n)))
    if "l_linenumber" in want:
        emit("l_linenumber", Column.from_numpy(
            dt.bigint(False), crng(4).integers(1, 8, n)))

    if {"l_quantity", "l_extendedprice"} & want:
        qty = crng(5).integers(1, 51, n)
        emit("l_quantity", Column.from_numpy(DEC2, qty * 100))
        if "l_extendedprice" in want:
            # extendedprice = qty * p_retailprice(partkey), in cents
            retail = 90000 + (partkey % 20001) + 100 * (partkey % 1000)
            emit("l_extendedprice", Column.from_numpy(DEC2, qty * retail))

    if "l_discount" in want:
        emit("l_discount", Column.from_numpy(DEC2, crng(6).integers(0, 11, n)))
    if "l_tax" in want:
        emit("l_tax", Column.from_numpy(DEC2, crng(7).integers(0, 9, n)))

    if {"l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
            "l_receiptdate"} & want:
        rng = crng(8)
        ship = _STARTDATE + rng.integers(1, 122 + 2406, n)  # orderdate+1..121
        receipt = ship + rng.integers(1, 31, n)
        # returnflag: R or A (50/50) if receipt <= currentdate else N;
        # dict order A=0, N=1, R=2
        returned = receipt <= _CURRENTDATE
        ra = rng.random(n) < 0.5
        fdict = StringDict(["A", "N", "R"])
        codes = np.where(returned, np.where(ra, 2, 0), 1).astype(np.int32)
        emit("l_returnflag", Column(dt.varchar(False), codes,
                                    np.ones(n, bool), fdict))
        sdict = StringDict(["F", "O"])   # F=0, O=1
        scodes = (ship > _CURRENTDATE).astype(np.int32)
        emit("l_linestatus", Column(dt.varchar(False), scodes,
                                    np.ones(n, bool), sdict))
        emit("l_shipdate", Column.from_numpy(dt.date(False), ship))
        emit("l_commitdate", Column.from_numpy(dt.date(False),
                                               ship + rng.integers(-30, 31, n)))
        emit("l_receiptdate", Column.from_numpy(dt.date(False), receipt))

    if "l_shipinstruct" in want:
        d = StringDict(SHIPINSTRUCT)
        emit("l_shipinstruct",
             Column(dt.varchar(False),
                    crng(9).integers(0, len(d), n).astype(np.int32),
                    np.ones(n, bool), d))
    if "l_shipmode" in want:
        d = StringDict(SHIPMODES)
        emit("l_shipmode",
             Column(dt.varchar(False),
                    crng(10).integers(0, len(d), n).astype(np.int32),
                    np.ones(n, bool), d))
    return out_names, out_cols


PART_NAMES = ["p_partkey", "p_brand", "p_size", "p_container"]

CONTAINERS = [f"{a} {b}" for a in ["SM", "LG", "MED", "JUMBO", "WRAP"]
              for b in ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]]


def gen_part(sf: float = 1.0, seed: int = 1) -> tuple[list[str], list[Column]]:
    n = int(200_000 * sf)
    rng = np.random.default_rng(seed)
    partkey = np.arange(1, n + 1)
    bdict = StringDict([f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)])
    brands = rng.integers(0, len(bdict), n).astype(np.int32)
    cdict = StringDict(CONTAINERS)
    containers = rng.integers(0, len(cdict), n).astype(np.int32)
    cols = [
        Column.from_numpy(dt.bigint(False), partkey),
        Column(dt.varchar(False), brands, np.ones(n, bool), bdict),
        Column.from_numpy(dt.bigint(False), rng.integers(1, 51, n)),
        Column(dt.varchar(False), containers, np.ones(n, bool), cdict),
    ]
    return PART_NAMES, cols


ORDERS_MINI_NAMES = ["o_orderkey", "o_custkey", "o_totalprice"]


def gen_orders_mini(n: int = 1024, seed: int = 7) -> tuple[list[str], list[Column]]:
    """Small orders table keyed to lineitem's l_orderkey domain — enough
    for multi-join fragment validation (dryrun/Q3 shape)."""
    rng = np.random.default_rng(seed)
    okey = np.arange(1, n + 1)
    cols = [
        Column.from_numpy(dt.bigint(False), okey),
        Column.from_numpy(dt.bigint(False), rng.integers(1, n // 4 + 2, n)),
        Column.from_numpy(DEC2, rng.integers(1000, 500000, n)),
    ]
    return ORDERS_MINI_NAMES, cols



# ------------------------------------------------------------------ #
# the row store's path: TPC-H tables as '|'-separated files for LOAD
# DATA, with the column types of tests/test_tpch_diff.py (its DDL)
# ------------------------------------------------------------------ #

TPCH_DDL = {
    "orders": "(o_orderkey bigint, o_custkey bigint, o_orderstatus varchar(1),"
              " o_totalprice double, o_orderdate date,"
              " o_orderpriority varchar(15), o_clerk varchar(15),"
              " o_shippriority bigint, o_comment varchar(79))",
    "lineitem": "(l_orderkey bigint, l_partkey bigint, l_suppkey bigint,"
                " l_linenumber bigint, l_quantity double,"
                " l_extendedprice double, l_discount double, l_tax double,"
                " l_returnflag varchar(1), l_linestatus varchar(1),"
                " l_shipdate date, l_commitdate date, l_receiptdate date,"
                " l_shipinstruct varchar(25), l_shipmode varchar(10),"
                " l_comment varchar(44))",
}

ORDERS_NAMES = ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
                "o_orderdate", "o_orderpriority", "o_clerk",
                "o_shippriority", "o_comment"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_WORDS = ["blithely", "carefully", "deposits", "final", "furiously",
          "ironic", "packages", "quickly", "regular", "requests", "slyly",
          "accounts", "express", "pending", "special", "theodolites"]


def _text_column(rng, n: int, n_values: int, max_len: int) -> Column:
    """A varchar column of ``n`` comments drawn from ``n_values``
    sentences of the spec's word list, each under ``max_len`` chars."""
    words = np.asarray(_WORDS)
    pool = set()
    while len(pool) < n_values:
        k = int(rng.integers(2, 7))
        pool.add(" ".join(words[rng.integers(0, len(words), k)])[:max_len])
    d = StringDict(sorted(pool))
    codes = rng.integers(0, len(d), n).astype(np.int32)
    return Column(dt.varchar(False), codes, np.ones(n, bool), d)


def gen_orders(sf: float = 1.0, seed: int = 0
               ) -> tuple[list[str], list[Column]]:
    """TPC-H orders at ``sf`` (1,500,000 rows a unit), the nine columns
    of ``TPCH_DDL``.  Keys follow the spec's sparse scheme (the first
    8 of every 32), so they span ``gen_lineitem``'s ``l_orderkey``
    domain, [1, 6,000,000 sf]."""
    n = int(1_500_000 * sf)
    rng = np.random.default_rng([seed, 101])
    k = np.arange(n, dtype=np.int64)
    okey = (k // 8) * 32 + (k % 8) + 1

    def dict_col(values, codes):
        return Column(dt.varchar(False), codes.astype(np.int32),
                      np.ones(n, bool), StringDict(values))
    clerks = [f"Clerk#{i:09d}" for i in range(1, max(int(1000 * sf), 1) + 1)]
    cols = [
        Column.from_numpy(dt.bigint(False), okey),
        Column.from_numpy(dt.bigint(False), rng.integers(
            1, max(int(150_000 * sf), 1) + 1, n)),
        dict_col(["F", "O", "P"], rng.choice(3, n, p=[0.49, 0.49, 0.02])),
        Column.from_numpy(dt.double(False),
                          rng.integers(85_000, 55_000_000, n) / 100.0),
        Column.from_numpy(dt.date(False),
                          _STARTDATE + rng.integers(0, 2406 - 151, n)),
        dict_col(PRIORITIES, rng.integers(0, len(PRIORITIES), n)),
        dict_col(clerks, rng.integers(0, len(clerks), n)),
        Column.from_numpy(dt.bigint(False), np.zeros(n, np.int64)),
        _text_column(rng, n, 1000, 79),
    ]
    return ORDERS_NAMES, cols


def lineitem_comments(n: int, seed: int = 0) -> Column:
    """``l_comment`` for ``n`` lineitem rows (``gen_lineitem`` leaves it
    out: no query of the corpus reads it)."""
    return _text_column(np.random.default_rng([seed, 102]), n, 1000, 44)


def _as_text(col: Column) -> np.ndarray:
    """A column as the text LOAD DATA reads: ``\\N`` for NULL, a DECIMAL
    with its scale's digits, a DATE as ISO, a DOUBLE by ``repr``."""
    k = col.dtype.kind
    data = col.data
    if k == dt.TypeKind.STRING:
        out = np.asarray(col.dictionary.values, dtype=object)[data]
    elif k == dt.TypeKind.DATE:
        out = (np.datetime64("1970-01-01", "D")
               + data.astype("timedelta64[D]")).astype(str).astype(object)
    elif k == dt.TypeKind.DECIMAL:
        p = 10 ** col.dtype.scale
        out = np.asarray([("-" if v < 0 else "") + f"{abs(v) // p}."
                          f"{abs(v) % p:0{col.dtype.scale}d}"
                          for v in data.tolist()], dtype=object)
    elif k == dt.TypeKind.FLOAT64:
        out = np.asarray([repr(v) for v in data.tolist()], dtype=object)
    else:
        out = data.astype(str).astype(object)
    if not col.validity.all():
        out = np.where(col.validity, out, "\\N")
    return out


def write_tbl(path, cols: list[Column]) -> int:
    """Write ``cols`` as a '|'-separated file, a row a line (the dbgen
    ``.tbl`` layout without the trailing separator); returns the rows."""
    texts = [_as_text(c) for c in cols]
    with open(path, "w") as f:
        for lo in range(0, len(texts[0]), 65536):
            f.write("\n".join("|".join(r) for r in zip(
                *[t[lo:lo + 65536] for t in texts])))
            f.write("\n")
    return len(texts[0])

# ------------------------------------------------------------------ #
# plan corpus: the TPC-H-shaped statements every static-analysis gate
# run and tests/test_analysis.py push through analysis.verify_plan.
# Shapes covered: dense scalar/keyed agg, SORT (high-NDV) agg, rollup,
# TopN/Limit, row-returning projections, broadcast lookup join (rows +
# agg + multi-level), semi/anti join, host sort/setop, device window.
# ------------------------------------------------------------------ #

TPCH_PLAN_QUERIES = [
    # Q6: dense scalar aggregation over scan+filter
    """select sum(l_extendedprice * l_discount) as revenue from lineitem
       where l_shipdate >= date '1994-01-01'
         and l_shipdate < date '1995-01-01'
         and l_discount between 0.05 and 0.07 and l_quantity < 24""",
    # Q1: dense keyed aggregation (dict-coded group keys)
    """select l_returnflag, l_linestatus, sum(l_quantity),
              sum(l_extendedprice), avg(l_discount), count(*)
       from lineitem where l_shipdate <= date '1998-09-02'
       group by l_returnflag, l_linestatus
       order by l_returnflag, l_linestatus""",
    # high-NDV group-by: SORT-strategy aggregation (single key: stats NDV
    # stays below the SEGMENT threshold at corpus scale)
    """select l_orderkey, sum(l_extendedprice) from lineitem
       group by l_orderkey""",
    # very-high-NDV group-bys: the per-key stats NDV PRODUCT crosses
    # SEGMENT_MIN_NDV, so these plan as the radix-partitioned SEGMENT
    # strategy (tpch_plan_session ANALYZEs lineitem so the estimates
    # exist at plan time) — the gate keeps them contract-clean and
    # rc-pricing-finite like every other corpus shape
    """select l_orderkey, l_partkey, count(*), sum(l_quantity)
       from lineitem group by l_orderkey, l_partkey""",
    """select l_orderkey, l_suppkey, max(l_extendedprice) from lineitem
       where l_quantity < 45 group by l_orderkey, l_suppkey""",
    # rollup: Expand + grouping sets
    """select l_returnflag, l_linestatus, sum(l_quantity) from lineitem
       group by l_returnflag, l_linestatus with rollup""",
    # device TopN (multi-key) and plain Limit
    """select l_orderkey, l_extendedprice from lineitem
       order by l_extendedprice desc, l_orderkey limit 10""",
    "select l_partkey from lineitem limit 5",
    # row-returning scan chain with projection arithmetic
    """select l_orderkey, l_extendedprice * (1 - l_discount)
       from lineitem where l_quantity < 5""",
    # broadcast lookup join, aggregated (Q19 shape without OR-chains)
    """select p_brand, sum(l_extendedprice) from lineitem, part
       where l_partkey = p_partkey and l_quantity < 10
       group by p_brand""",
    # broadcast lookup join, row-returning
    """select l_orderkey, p_brand from lineitem, part
       where l_partkey = p_partkey and p_size > 40 limit 20""",
    # semi join (IN subquery)
    """select l_orderkey from lineitem
       where l_partkey in (select p_partkey from part where p_size > 45)
       limit 10""",
    # anti join (NOT IN subquery)
    """select count(*) from lineitem
       where l_suppkey not in (select o_custkey from orders)""",
    # multi-table chain: lineitem x orders x part
    """select o_totalprice, p_brand, l_quantity from lineitem, orders, part
       where l_orderkey = o_orderkey and l_partkey = p_partkey
       limit 10""",
    # host sort over join output
    """select o_orderkey, sum(l_extendedprice) as rev from lineitem, orders
       where l_orderkey = o_orderkey
       group by o_orderkey order by rev desc limit 5""",
    # set operation
    """select l_partkey from lineitem where l_quantity < 2
       union select p_partkey from part where p_size = 1""",
    # window function over the sharded table
    """select l_orderkey,
              row_number() over (partition by l_returnflag
                                 order by l_extendedprice desc) as rn
       from lineitem limit 10""",
    # scalar-subquery-free HAVING residue (host filter over agg)
    """select l_returnflag, count(*) as c from lineitem
       group by l_returnflag having count(*) > 1""",
]


# TPC-H Q1 and Q6 as the specification writes them (2.4.1, 2.4.6), with
# the validation substitutions: DELTA = 90; DATE = 1994-01-01,
# DISCOUNT = 0.06, QUANTITY = 24.  The date arithmetic folds on the host.
TPCH_Q1 = """select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus"""

TPCH_Q6 = """select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.06 - 0.01 and 0.06 + 0.01
  and l_quantity < 24"""

# planned with the broadcast threshold forced to 0 so the repartition
# (all_to_all shuffle) join path is exercised by the gate too
TPCH_SHUFFLE_QUERIES = [
    """select count(*), sum(l_quantity + o_totalprice) from lineitem
       join orders on l_orderkey = o_orderkey""",
    """select o_custkey, sum(l_quantity) from lineitem join orders
       on l_orderkey = o_orderkey group by o_custkey""",
]


# the MULTICHIP dryrun's plan shapes (__graft_entry__.dryrun_multichip):
# every distributed step the dry run executes on the 8-vdev mesh, as
# plannable SQL — the shardflow gate pass must analyze each clean with
# finite per-link transfer bytes (the pod-scale exchange shapes the
# multi-host runtime PR will inherit)
MULTICHIP_PLAN_QUERIES = [
    # Q1 psum step: dense keyed agg merged in-program
    """select l_returnflag, l_linestatus, sum(l_quantity), count(*)
       from lineitem where l_shipdate <= date '1998-09-02'
       group by l_returnflag, l_linestatus""",
    # TopN shard-merge step
    """select l_extendedprice from lineitem
       order by l_extendedprice desc limit 5""",
    # broadcast-join step (LookupJoin + psum agg)
    """select count(*), sum(l_extendedprice) from lineitem, part
       where p_partkey = l_partkey and p_size < 25""",
    # rollup Expand fragment
    """select l_returnflag, l_linestatus, count(*) from lineitem
       group by l_returnflag, l_linestatus with rollup""",
    # window repartition (all_to_all on PARTITION BY)
    """select l_linestatus, row_number() over
       (partition by l_linestatus order by l_extendedprice desc)
       from lineitem""",
    # window-over-join fragment
    """select l_linestatus, row_number() over
       (partition by l_linestatus order by l_extendedprice desc)
       from lineitem, part
       where p_partkey = l_partkey and p_size < 25""",
]


# the statements of the port's SQL path, by name: each plans as one cop
# task over lineitem (DENSE, SCALAR, SORT, TopN, Limit, rows) under host
# operators the port runs
SQL_QUERIES = {
    "Q1": TPCH_Q1,
    "Q6": TPCH_Q6,
    "Q6 corpus": TPCH_PLAN_QUERIES[0],
    "Q1 corpus": TPCH_PLAN_QUERIES[1],
    "SORT": TPCH_PLAN_QUERIES[2],
    "SORT two keys": TPCH_PLAN_QUERIES[3],
    "SORT two keys filtered": TPCH_PLAN_QUERIES[4],
    "TopN": TPCH_PLAN_QUERIES[6],
    "Limit": TPCH_PLAN_QUERIES[7],
    "rows": TPCH_PLAN_QUERIES[8],
    "HAVING": TPCH_PLAN_QUERIES[17],
}


# TPC-H Q19 as the specification writes it (2.4.19), with the validation
# substitutions: QUANTITY1 = 1, QUANTITY2 = 10, QUANTITY3 = 20, BRAND1 =
# Brand#12, BRAND2 = Brand#23, BRAND3 = Brand#34
TPCH_Q19 = """select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where (p_partkey = l_partkey
       and p_brand = 'Brand#12'
       and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
       and l_quantity >= 1 and l_quantity <= 1 + 10
       and p_size between 1 and 5
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_partkey = l_partkey
       and p_brand = 'Brand#23'
       and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
       and l_quantity >= 10 and l_quantity <= 10 + 10
       and p_size between 1 and 10
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_partkey = l_partkey
       and p_brand = 'Brand#34'
       and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
       and l_quantity >= 20 and l_quantity <= 20 + 10
       and p_size between 1 and 15
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')"""

# the statements of the join slice, by name, over lineitem, part and
# orders.  Small tables plan each broadcast statement as a CopJoinTask
# (the m:n ones switch to the expanding join when the build keys turn
# out duplicated), the left join with an ON filter as a HostHashJoin,
# the correlated scalar subquery as a HostApply; Q19 and the shuffle
# statements plan as the repartition join (CopShuffleJoin) once the
# build side passes BROADCAST_BUILD_MAX_ROWS (executor/plan.py), or
# with that threshold set to 0
JOIN_QUERIES = {
    "join agg": TPCH_PLAN_QUERIES[9],
    "join rows": TPCH_PLAN_QUERIES[10],
    "semi": TPCH_PLAN_QUERIES[11],
    "anti": TPCH_PLAN_QUERIES[12],
    "three tables": TPCH_PLAN_QUERIES[13],
    "join TopN": TPCH_PLAN_QUERIES[14],
    "broadcast step": MULTICHIP_PLAN_QUERIES[2],
    "Q19": TPCH_Q19,
    "m:n inner": """select count(*), sum(l_extendedprice) from lineitem
                    join orders on l_orderkey = o_custkey""",
    "m:n left": """select count(*), count(o_totalprice) from lineitem
                   left join orders on l_orderkey = o_custkey""",
    "left join ON filter": """select count(*), count(p_size) from lineitem
                              left join part on l_partkey = p_partkey
                              and p_size < 3""",
    "EXISTS": """select count(*) from orders where exists
                 (select 1 from lineitem where l_orderkey = o_orderkey
                  and l_quantity < 5)""",
    "scalar subquery apply": """select o_orderkey,
                                (select count(*) from lineitem
                                 where l_orderkey = o_orderkey) as c
                                from orders order by o_orderkey limit 5""",
    "shuffle": TPCH_SHUFFLE_QUERIES[0],
    "shuffle group by": TPCH_SHUFFLE_QUERIES[1],
}


def sql_session(tables: dict, device="cuda", n_devices: int = 1):
    """A port ``Session`` over a new ``Domain`` on ``device`` with each
    ``name: (names, cols)`` of ``tables`` registered in database
    ``test`` (the columns bulk-loaded, no ANALYZE)."""
    from ..session import Domain, Session
    from ..session.catalog import TableInfo
    dom = Domain(device, n_devices)
    for name, (names, cols) in tables.items():
        t = TableInfo(name, list(names), [c.dtype for c in cols])
        t.register_columns(list(cols))
        dom.catalog.create_table("test", t)
    return Session(dom)


def tpch_sql_session(sf: float = 0.001, seed: int = 42, device="cuda",
                     n_devices: int = 1, columns=None,
                     part_sf: float | None = None,
                     n_orders: int | None = None):
    """A port ``Session`` with lineitem from ``gen_lineitem(sf, seed,
    columns)`` registered on ``device``, without ANALYZE; with part from
    ``gen_part(part_sf, seed=7)`` and orders from
    ``gen_orders_mini(n_orders)`` when those are given, as the JAX
    package's ``tpch_plan_session`` registers them."""
    tables = {"lineitem": gen_lineitem(sf, seed, columns)}
    if part_sf is not None:
        tables["part"] = gen_part(sf=part_sf, seed=7)
    if n_orders is not None:
        tables["orders"] = gen_orders_mini(n_orders)
    return sql_session(tables, device, n_devices)


__all__ = ["gen_lineitem", "gen_part", "gen_orders_mini", "LINEITEM_NAMES",
           "PART_NAMES", "ORDERS_MINI_NAMES", "DEC2", "TPCH_PLAN_QUERIES",
           "TPCH_SHUFFLE_QUERIES", "MULTICHIP_PLAN_QUERIES", "TPCH_Q1",
           "TPCH_Q6", "TPCH_Q19", "SQL_QUERIES", "JOIN_QUERIES",
           "sql_session", "tpch_sql_session", "TPCH_DDL", "ORDERS_NAMES",
           "gen_orders", "lineitem_comments", "write_tbl"]

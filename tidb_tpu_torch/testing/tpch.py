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


# ------------------------------------------------------------------ #
# the eight TPC-H tables at the specification's widths
# ------------------------------------------------------------------ #

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
TYPES = [f"{a} {b} {c}" for a in ["STANDARD", "SMALL", "MEDIUM", "LARGE",
                                  "ECONOMY", "PROMO"]
         for b in ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
         for c in ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]]
# the specification's 92 P_NAME colour words (TPC-H 4.2.3)
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki", "lace",
    "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya",
    "peach", "peru", "pink", "plum", "powder", "puff", "purple", "red",
    "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
_ENDDATE = _days("1998-12-31")

# the tables' DDL as tests/test_tpch_diff.py writes it (DOUBLE money and
# quantities, DATE dates, VARCHAR text)
TPCH_TABLE_DDL = {
    "region": "(r_regionkey bigint, r_name varchar(25), r_comment varchar(120))",
    "nation": "(n_nationkey bigint, n_name varchar(25), n_regionkey bigint,"
              " n_comment varchar(120))",
    "supplier": "(s_suppkey bigint, s_name varchar(25), s_address varchar(40),"
                " s_nationkey bigint, s_phone varchar(15),"
                " s_acctbal double, s_comment varchar(101))",
    "customer": "(c_custkey bigint, c_name varchar(25), c_address varchar(40),"
                " c_nationkey bigint, c_phone varchar(15), c_acctbal double,"
                " c_mktsegment varchar(10), c_comment varchar(117))",
    "part": "(p_partkey bigint, p_name varchar(55), p_mfgr varchar(25),"
            " p_brand varchar(10), p_type varchar(25), p_size bigint,"
            " p_container varchar(10), p_retailprice double,"
            " p_comment varchar(23))",
    "partsupp": "(ps_partkey bigint, ps_suppkey bigint, ps_availqty bigint,"
                " ps_supplycost double, ps_comment varchar(199))",
    "orders": TPCH_DDL["orders"],
    "lineitem": TPCH_DDL["lineitem"],
}


def _str_col(values) -> Column:
    """A varchar column of the strings ``values`` (one a row)."""
    uniq, codes = np.unique(np.asarray(values, dtype=str),
                            return_inverse=True)
    n = len(codes)
    return Column(dt.varchar(False), codes.astype(np.int32).reshape(n),
                  np.ones(n, bool), StringDict(uniq.tolist()))


def _int_col(a) -> Column:
    return Column.from_numpy(dt.bigint(False), np.asarray(a, np.int64))


def _dbl_col(a) -> Column:
    return Column.from_numpy(dt.double(False), np.asarray(a, np.float64))


def _money(rng, lo: float, hi: float, n: int) -> np.ndarray:
    """Uniform cents in [lo, hi], as DOUBLE with two decimals."""
    return rng.integers(int(round(lo * 100)), int(round(hi * 100)) + 1,
                        n) / 100.0


def _phones(rng, nation: np.ndarray) -> list:
    """'CC-LLL-LLL-LLLL', the country code 10 + the nation key."""
    a = rng.integers(100, 1000, (len(nation), 3))
    b = rng.integers(1000, 10000, len(nation))
    return [f"{cc}-{x}-{y}-{z}" for cc, x, y, z in zip(
        (nation + 10).tolist(), a[:, 0].tolist(), a[:, 1].tolist(),
        b.tolist())]


def _comments(rng, n: int, max_len: int, marks=(), p: float = 0.0
              ) -> Column:
    """``n`` comments from a pool of the spec's words; a share ``p`` of
    rows gets ``marks`` (e.g. 'Customer ... Complaints') inside."""
    col = _text_column(rng, n, min(1000, max(n, 16)), max_len)
    if not marks or p <= 0:
        return col
    text = np.asarray(col.dictionary.values, dtype=object)[col.data]
    hit = np.flatnonzero(rng.random(n) < p)
    filler = " ".join(_WORDS[:2])
    for i in hit.tolist():
        text[i] = f"{marks[0]} {filler} {marks[1]}"[:max_len]
    return _str_col(text)


def _ps_supp(partkey: np.ndarray, i, n_supp: int) -> np.ndarray:
    """The ``i``-th of a part's four suppliers: the specification's
    PS_SUPPKEY formula (TPC-H 4.2.3), its per-part stride wrapped under
    ``n_supp / 3`` so that a part's four suppliers stay distinct below
    SF=0.01 too (the same stride as the formula's from there up)."""
    wrap = (n_supp - 1) // 3 - n_supp // 4 + 1
    stride = n_supp // 4 + ((partkey - 1) // n_supp) % wrap
    return (partkey + i * stride) % n_supp + 1


def gen_tpch(sf: float = 1.0, seed: int = 0) -> dict:
    """The eight TPC-H tables at ``sf`` with every column of
    ``TPCH_TABLE_DDL``, as ``{table: (names, columns)}`` (numpy,
    vectorized; SF=1 is 6,000,000-odd lineitem rows).

    The key relations follow the specification, so its joins match:
    four suppliers a part in partsupp, a lineitem's supplier one of its
    part's four, ``l_orderkey`` from orders' sparse keys (1 to 7 lines an
    order), ship and commit dates after ``o_orderdate``, customers whose
    key is a multiple of 3 with no orders, ``o_orderstatus`` and
    ``o_totalprice`` from the order's lines, and ``p_name`` five of the
    spec's colour words (so ``like '%green%'`` selects).  The other text
    columns draw from word pools."""
    def crng(tag):
        return np.random.default_rng([seed, 200 + tag])
    n_supp = max(int(10_000 * sf), 4)
    n_cust = max(int(150_000 * sf), 3)
    n_part = max(int(200_000 * sf), 1)
    n_ord = max(int(1_500_000 * sf), 1)
    out = {}

    rng = crng(1)
    out["region"] = (["r_regionkey", "r_name", "r_comment"], [
        _int_col(np.arange(5)), _str_col(REGIONS), _comments(rng, 5, 120)])
    out["nation"] = (["n_nationkey", "n_name", "n_regionkey", "n_comment"], [
        _int_col(np.arange(25)), _str_col([n for n, _ in NATIONS]),
        _int_col([r for _, r in NATIONS]), _comments(rng, 25, 120)])

    rng = crng(2)
    sk = np.arange(1, n_supp + 1)
    snat = rng.integers(0, 25, n_supp)
    out["supplier"] = (
        ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone",
         "s_acctbal", "s_comment"],
        [_int_col(sk), _str_col([f"Supplier#{k:09d}" for k in sk.tolist()]),
         _comments(rng, n_supp, 40), _int_col(snat),
         _str_col(_phones(rng, snat)), _dbl_col(_money(rng, -999.99,
                                                       9999.99, n_supp)),
         _comments(rng, n_supp, 101, ("Customer", "Complaints"), 0.005)])

    rng = crng(3)
    ck = np.arange(1, n_cust + 1)
    cnat = rng.integers(0, 25, n_cust)
    out["customer"] = (
        ["c_custkey", "c_name", "c_address", "c_nationkey", "c_phone",
         "c_acctbal", "c_mktsegment", "c_comment"],
        [_int_col(ck), _str_col([f"Customer#{k:09d}" for k in ck.tolist()]),
         _comments(rng, n_cust, 40), _int_col(cnat),
         _str_col(_phones(rng, cnat)),
         _dbl_col(_money(rng, -999.99, 9999.99, n_cust)),
         _str_col(np.asarray(SEGMENTS)[rng.integers(0, 5, n_cust)]),
         _comments(rng, n_cust, 117)])

    rng = crng(4)
    pk = np.arange(1, n_part + 1)
    words = np.asarray(COLORS)[rng.integers(0, len(COLORS), (n_part, 5))]
    mfgr = rng.integers(1, 6, n_part)
    retail = (90000 + (pk // 10) % 20001 + 100 * (pk % 1000)) / 100.0
    out["part"] = (
        ["p_partkey", "p_name", "p_mfgr", "p_brand", "p_type", "p_size",
         "p_container", "p_retailprice", "p_comment"],
        [_int_col(pk), _str_col([" ".join(w) for w in words.tolist()]),
         _str_col([f"Manufacturer#{m}" for m in mfgr.tolist()]),
         _str_col([f"Brand#{m}{b}" for m, b in zip(
             mfgr.tolist(), rng.integers(1, 6, n_part).tolist())]),
         _str_col(np.asarray(TYPES)[rng.integers(0, len(TYPES), n_part)]),
         _int_col(rng.integers(1, 51, n_part)),
         _str_col(np.asarray(CONTAINERS)[rng.integers(0, len(CONTAINERS),
                                                      n_part)]),
         _dbl_col(retail), _comments(rng, n_part, 23)])

    rng = crng(5)
    ps_part = np.repeat(pk, 4)
    ps_supp = _ps_supp(ps_part, np.tile(np.arange(4), n_part), n_supp)
    out["partsupp"] = (
        ["ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost",
         "ps_comment"],
        [_int_col(ps_part), _int_col(ps_supp),
         _int_col(rng.integers(1, 10_000, 4 * n_part)),
         _dbl_col(_money(rng, 1.0, 1000.0, 4 * n_part)),
         _comments(rng, 4 * n_part, 199)])

    rng = crng(6)
    k = np.arange(n_ord, dtype=np.int64)
    okey = (k // 8) * 32 + (k % 8) + 1
    # a third of the customers (keys divisible by 3) place no order
    j = rng.integers(0, n_cust - n_cust // 3, n_ord)
    ocust = (j // 2) * 3 + j % 2 + 1
    odate = _STARTDATE + rng.integers(0, _ENDDATE - 151 - _STARTDATE + 1,
                                      n_ord)
    lines = rng.integers(1, 8, n_ord)
    n = int(lines.sum())
    first = np.repeat(np.cumsum(lines) - lines, lines)
    lok = np.repeat(okey, lines)
    lod = np.repeat(odate, lines)
    lnum = np.arange(n) - first + 1
    lpart = rng.integers(1, n_part + 1, n)
    lsupp = _ps_supp(lpart, rng.integers(0, 4, n), n_supp)
    qty = rng.integers(1, 51, n).astype(np.float64)
    price = np.round(qty * retail[lpart - 1], 2)
    disc = rng.integers(0, 11, n) / 100.0
    tax = rng.integers(0, 9, n) / 100.0
    ship = lod + rng.integers(1, 122, n)
    commit = lod + rng.integers(30, 91, n)
    receipt = ship + rng.integers(1, 31, n)
    returned = receipt <= _CURRENTDATE
    rflag = np.where(returned, np.where(rng.random(n) < 0.5, "R", "A"), "N")
    open_ = ship > _CURRENTDATE
    # an order is F when all its lines are, O when none is, else P
    n_open = np.add.reduceat(open_.astype(np.int64),
                             np.cumsum(lines) - lines)
    status = np.where(n_open == 0, "F", np.where(n_open == lines, "O", "P"))
    total = np.round(np.add.reduceat(price * (1 + tax) * (1 - disc),
                                     np.cumsum(lines) - lines), 2)
    clerks = max(int(1000 * sf), 1)
    out["orders"] = (list(ORDERS_NAMES), [
        _int_col(okey), _int_col(ocust), _str_col(status), _dbl_col(total),
        Column.from_numpy(dt.date(False), odate),
        _str_col(np.asarray(PRIORITIES)[rng.integers(0, 5, n_ord)]),
        _str_col([f"Clerk#{c:09d}" for c in rng.integers(
            1, clerks + 1, n_ord).tolist()]),
        _int_col(np.zeros(n_ord, np.int64)),
        _comments(rng, n_ord, 79, ("special", "requests"), 0.01)])

    out["lineitem"] = (
        LINEITEM_NAMES + ["l_comment"],
        [_int_col(lok), _int_col(lpart), _int_col(lsupp), _int_col(lnum),
         _dbl_col(qty), _dbl_col(price), _dbl_col(disc), _dbl_col(tax),
         _str_col(rflag), _str_col(np.where(open_, "O", "F")),
         Column.from_numpy(dt.date(False), ship),
         Column.from_numpy(dt.date(False), commit),
         Column.from_numpy(dt.date(False), receipt),
         _str_col(np.asarray(SHIPINSTRUCT)[rng.integers(0, 4, n)]),
         _str_col(np.asarray(SHIPMODES)[rng.integers(0, 7, n)]),
         _comments(rng, n, 44)])
    return out


# the 22 TPC-H statements and Q15's view as tests/test_tpch_diff.py
# writes them (dates pre-folded into literals, some selectivities tuned to
# small scales; every query's shape as the specification's)
TPCH_22 = {
 1: """select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
        sum(l_extendedprice) as sum_base_price,
        sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
        sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
        avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
        avg(l_discount) as avg_disc, count(*) as count_order
      from lineitem where l_shipdate <= '1998-09-02'
      group by l_returnflag, l_linestatus
      order by l_returnflag, l_linestatus""",
 2: """select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address,
        s_phone, s_comment
      from part, supplier, partsupp, nation, region
      where p_partkey = ps_partkey and s_suppkey = ps_suppkey
        and p_size < 30 and p_type like '%BRASS'
        and s_nationkey = n_nationkey and n_regionkey = r_regionkey
        and r_name = 'EUROPE'
        and ps_supplycost = (select min(ps_supplycost)
              from partsupp, supplier, nation, region
              where p_partkey = ps_partkey and s_suppkey = ps_suppkey
                and s_nationkey = n_nationkey
                and n_regionkey = r_regionkey and r_name = 'EUROPE')
      order by s_acctbal desc, n_name, s_name, p_partkey limit 100""",
 3: """select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
        o_orderdate, o_shippriority
      from customer, orders, lineitem
      where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
        and l_orderkey = o_orderkey and o_orderdate < '1995-03-15'
        and l_shipdate > '1995-03-15'
      group by l_orderkey, o_orderdate, o_shippriority
      order by revenue desc, o_orderdate, l_orderkey limit 10""",
 4: """select o_orderpriority, count(*) as order_count from orders
      where o_orderdate >= '1993-07-01' and o_orderdate < '1993-10-01'
        and exists (select * from lineitem
                    where l_orderkey = o_orderkey
                      and l_commitdate < l_receiptdate)
      group by o_orderpriority order by o_orderpriority""",
 5: """select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
      from customer, orders, lineitem, supplier, nation, region
      where c_custkey = o_custkey and l_orderkey = o_orderkey
        and l_suppkey = s_suppkey and c_nationkey = s_nationkey
        and s_nationkey = n_nationkey and n_regionkey = r_regionkey
        and r_name = 'ASIA' and o_orderdate >= '1994-01-01'
        and o_orderdate < '1996-01-01'
      group by n_name order by revenue desc, n_name""",
 6: """select sum(l_extendedprice * l_discount) as revenue from lineitem
      where l_shipdate >= '1994-01-01' and l_shipdate < '1995-01-01'
        and l_discount between 0.05 and 0.07 and l_quantity < 24""",
 7: """select supp_nation, cust_nation, l_year, sum(volume) as revenue
      from (select n1.n_name as supp_nation, n2.n_name as cust_nation,
                   year(l_shipdate) as l_year,
                   l_extendedprice * (1 - l_discount) as volume
            from supplier, lineitem, orders, customer, nation n1, nation n2
            where s_suppkey = l_suppkey and o_orderkey = l_orderkey
              and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
              and c_nationkey = n2.n_nationkey
              and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
                or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
              and l_shipdate between '1995-01-01' and '1996-12-31')
           as shipping
      group by supp_nation, cust_nation, l_year
      order by supp_nation, cust_nation, l_year""",
 8: """select o_year,
        sum(case when nation = 'BRAZIL' then volume else 0 end)
          / sum(volume) as mkt_share
      from (select year(o_orderdate) as o_year,
                   l_extendedprice * (1 - l_discount) as volume,
                   n2.n_name as nation
            from part, supplier, lineitem, orders, customer,
                 nation n1, nation n2, region
            where p_partkey = l_partkey and s_suppkey = l_suppkey
              and l_orderkey = o_orderkey and o_custkey = c_custkey
              and c_nationkey = n1.n_nationkey
              and n1.n_regionkey = r_regionkey and r_name = 'AMERICA'
              and s_nationkey = n2.n_nationkey
              and o_orderdate between '1995-01-01' and '1996-12-31'
              and p_size < 40) as all_nations
      group by o_year order by o_year""",
 9: """select nation, o_year, sum(amount) as sum_profit
      from (select n_name as nation, year(o_orderdate) as o_year,
                   l_extendedprice * (1 - l_discount)
                     - ps_supplycost * l_quantity as amount
            from part, supplier, lineitem, partsupp, orders, nation
            where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
              and ps_partkey = l_partkey and p_partkey = l_partkey
              and o_orderkey = l_orderkey and s_nationkey = n_nationkey
              and p_name like '%green%') as profit
      group by nation, o_year order by nation, o_year desc""",
 10: """select c_custkey, c_name,
         sum(l_extendedprice * (1 - l_discount)) as revenue, c_acctbal,
         n_name, c_address, c_phone, c_comment
       from customer, orders, lineitem, nation
       where c_custkey = o_custkey and l_orderkey = o_orderkey
         and o_orderdate >= '1993-10-01' and o_orderdate < '1994-10-01'
         and l_returnflag = 'R' and c_nationkey = n_nationkey
       group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
                c_comment
       order by revenue desc, c_custkey limit 20""",
 11: """select ps_partkey, sum(ps_supplycost * ps_availqty) as value
       from partsupp, supplier, nation
       where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
         and n_name = 'GERMANY'
       group by ps_partkey
       having sum(ps_supplycost * ps_availqty) >
         (select sum(ps_supplycost * ps_availqty) * 0.01
          from partsupp, supplier, nation
          where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
            and n_name = 'GERMANY')
       order by value desc, ps_partkey""",
 12: """select l_shipmode,
         sum(case when o_orderpriority = '1-URGENT'
                    or o_orderpriority = '2-HIGH'
                  then 1 else 0 end) as high_line_count,
         sum(case when o_orderpriority <> '1-URGENT'
                   and o_orderpriority <> '2-HIGH'
                  then 1 else 0 end) as low_line_count
       from orders, lineitem
       where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
         and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
         and l_receiptdate >= '1994-01-01' and l_receiptdate < '1996-01-01'
       group by l_shipmode order by l_shipmode""",
 13: """select c_count, count(*) as custdist
       from (select c_custkey, count(o_orderkey) as c_count
             from customer left outer join orders
               on c_custkey = o_custkey
                  and o_comment not like '%special%requests%'
             group by c_custkey) as c_orders
       group by c_count order by custdist desc, c_count desc""",
 14: """select 100.00 * sum(case when p_type like 'PROMO%'
                                 then l_extendedprice * (1 - l_discount)
                                 else 0 end)
           / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
       from lineitem, part
       where l_partkey = p_partkey and l_shipdate >= '1995-01-01'
         and l_shipdate < '1996-01-01'""",
 16: """select p_brand, p_type, p_size,
         count(distinct ps_suppkey) as supplier_cnt
       from partsupp, part
       where p_partkey = ps_partkey and p_brand <> 'Brand#45'
         and p_type not like 'MEDIUM POLISHED%'
         and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
         and ps_suppkey not in (select s_suppkey from supplier
                                where s_comment like '%Customer%Complaints%')
       group by p_brand, p_type, p_size
       order by supplier_cnt desc, p_brand, p_type, p_size""",
 17: """select sum(l_extendedprice) / 7.0 as avg_yearly
       from lineitem, part
       where p_partkey = l_partkey and p_brand = 'Brand#11'
         and l_quantity < (select 0.5 * avg(l2.l_quantity)
                           from lineitem l2
                           where l2.l_partkey = p_partkey)""",
 18: """select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
         sum(l_quantity)
       from customer, orders, lineitem
       where o_orderkey in (select l_orderkey from lineitem
                            group by l_orderkey
                            having sum(l_quantity) > 150)
         and c_custkey = o_custkey and o_orderkey = l_orderkey
       group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
       order by o_totalprice desc, o_orderdate, o_orderkey limit 100""",
 19: """select sum(l_extendedprice * (1 - l_discount)) as revenue
       from lineitem, part
       where (p_partkey = l_partkey and p_brand = 'Brand#11'
              and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
              and l_quantity >= 1 and l_quantity <= 30
              and p_size between 1 and 15
              and l_shipmode in ('AIR', 'REG AIR')
              and l_shipinstruct = 'DELIVER IN PERSON')
          or (p_partkey = l_partkey and p_brand = 'Brand#22'
              and p_container in ('MED BAG', 'MED BOX', 'MED PKG',
                                  'MED PACK')
              and l_quantity >= 1 and l_quantity <= 40
              and p_size between 1 and 20
              and l_shipmode in ('AIR', 'REG AIR')
              and l_shipinstruct = 'DELIVER IN PERSON')""",
 20: """select s_name, s_address from supplier, nation
       where s_suppkey in
           (select ps_suppkey from partsupp
            where ps_partkey in (select p_partkey from part
                                 where p_name like '%forest%')
              and ps_availqty > (select 0.5 * sum(l_quantity)
                                 from lineitem
                                 where l_partkey = ps_partkey
                                   and l_suppkey = ps_suppkey
                                   and l_shipdate >= '1994-01-01'
                                   and l_shipdate < '1996-01-01'))
         and s_nationkey = n_nationkey and n_name = 'CANADA'
       order by s_name""",
 21: """select s_name, count(*) as numwait
       from supplier, lineitem l1, orders, nation
       where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
         and o_orderstatus = 'F'
         and l1.l_receiptdate > l1.l_commitdate
         and exists (select * from lineitem l2
                     where l2.l_orderkey = l1.l_orderkey
                       and l2.l_suppkey <> l1.l_suppkey)
         and not exists (select * from lineitem l3
                         where l3.l_orderkey = l1.l_orderkey
                           and l3.l_suppkey <> l1.l_suppkey
                           and l3.l_receiptdate > l3.l_commitdate)
         and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA'
       group by s_name order by numwait desc, s_name limit 100""",
 22: """select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
       from (select substr(c_phone, 1, 2) as cntrycode, c_acctbal
             from customer
             where substr(c_phone, 1, 2) in
                     ('13', '31', '23', '29', '30', '18', '17')
               and c_acctbal > (select avg(c_acctbal) from customer
                                where c_acctbal > 0.00
                                  and substr(c_phone, 1, 2) in
                                    ('13', '31', '23', '29', '30', '18',
                                     '17'))
               and not exists (select * from orders
                               where o_custkey = c_custkey)) as custsale
       group by cntrycode order by cntrycode""",
}

TPCH_Q15_VIEW = """create view revenue0 (supplier_no, total_revenue) as
  select l_suppkey, sum(l_extendedprice * (1 - l_discount))
  from lineitem
  where l_shipdate >= '1996-01-01' and l_shipdate < '1996-04-01'
  group by l_suppkey"""
TPCH_Q15 = """select s_suppkey, s_name, s_address, s_phone, total_revenue
  from supplier, revenue0
  where s_suppkey = supplier_no
    and total_revenue = (select max(total_revenue) from revenue0)
  order by s_suppkey"""


def pushed_ops(session, sql: str) -> set:
    """The expression ops that ``sql``'s physical plan evaluates inside
    its cop tasks (on the device), from the session's own planner."""
    from ..executor.physical import CopJoinTaskExec, CopTaskExec
    from ..expr.ir import Func
    from ..sql.parser import parse_sql
    _built, phys = session._plan_select(parse_sql(sql)[0])
    ops, stack = set(), [phys]
    while stack:
        op = stack.pop()
        stack.extend(getattr(op, "children", ()) or ())
        if getattr(op, "build_exec", None) is not None:
            stack.append(op.build_exec)
        if not isinstance(op, (CopTaskExec, CopJoinTaskExec)):
            continue
        nodes = [op.dag]
        while nodes:
            node = nodes.pop()
            nodes.extend(node.children())
            exprs = []
            for attr in ("conditions", "exprs", "group_by", "keys"):
                exprs.extend(getattr(node, attr, ()) or ())
            exprs.extend(a.arg for a in getattr(node, "aggs", ()) or ()
                         if a.arg is not None)
            while exprs:
                e = exprs.pop()
                if isinstance(e, Func):
                    ops.add(e.op)
                    exprs.extend(e.args)
    return ops


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


__all__ = ["gen_lineitem", "gen_part", "gen_orders_mini", "gen_tpch",
           "TPCH_TABLE_DDL", "TPCH_22", "TPCH_Q15_VIEW", "TPCH_Q15",
           "pushed_ops",
           "LINEITEM_NAMES",
           "PART_NAMES", "ORDERS_MINI_NAMES", "DEC2", "TPCH_PLAN_QUERIES",
           "TPCH_SHUFFLE_QUERIES", "MULTICHIP_PLAN_QUERIES", "TPCH_Q1",
           "TPCH_Q6", "TPCH_Q19", "SQL_QUERIES", "JOIN_QUERIES",
           "sql_session", "tpch_sql_session", "TPCH_DDL", "ORDERS_NAMES",
           "gen_orders", "lineitem_comments", "write_tbl"]

# ported from tidb_tpu/planner/advisor.py @ 9be2bf6
"""Index advisor (pkg/planner/indexadvisor analog, heuristic cut).

Mines the statement summary's sample SQL: for single-table SELECTs,
equality predicates on columns that no public index covers become index
candidates, scored by the digest's execution count.  Surfaced via
`ADMIN RECOMMEND INDEX`.
"""

from __future__ import annotations

from ..sql import ast as A
from ..sql.parser import parse_sql


def _eq_cols(node, out: list) -> None:
    """Collect column names compared by equality to literals in a WHERE
    conjunction (the sargable-predicate walk, simplified)."""
    if isinstance(node, A.Binary):
        if node.op == "AND":
            _eq_cols(node.left, out)
            _eq_cols(node.right, out)
            return
        if node.op == "=":
            for a, b in ((node.left, node.right), (node.right, node.left)):
                if isinstance(a, A.Ident) and isinstance(b, A.Lit):
                    out.append(a.parts[-1].lower())


def recommend_indexes(domain, db: str) -> list[tuple]:
    """[(table, columns, est_benefit_execs, sample_sql)] recommendations."""
    scores: dict[tuple, dict] = {}
    for digest, execs, _avg, _mx, _rows, sample, *_extra in \
            domain.stmt_summary.summary_rows():
        try:
            stmts = parse_sql(sample)
        except Exception:
            continue
        for stmt in stmts:
            if not isinstance(stmt, A.SelectStmt) or stmt.where is None \
                    or not isinstance(stmt.from_, A.TableName):
                continue
            tname = stmt.from_.name
            try:
                tbl = domain.catalog.get_table(stmt.from_.db or db, tname)
            except Exception:
                continue
            if getattr(tbl, "is_memtable", False):
                continue
            cols: list = []
            _eq_cols(stmt.where, cols)
            cols = [c for c in cols if c in
                    {n.lower() for n in tbl.col_names}]
            if not cols:
                continue
            # drop candidates already served by an index prefix
            covered = {ix.columns[0].lower()
                       for ix in getattr(tbl, "indexes", [])
                       if ix.state == "public"}
            cols = sorted(set(cols) - covered)
            if not cols:
                continue
            key = (tname, tuple(cols))
            s = scores.setdefault(key, {"execs": 0, "sample": sample})
            s["execs"] += execs
    return [(t, ",".join(cs), s["execs"], s["sample"])
            for (t, cs), s in sorted(scores.items(),
                                     key=lambda kv: -kv[1]["execs"])]


__all__ = ["recommend_indexes"]

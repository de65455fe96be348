# ported from tidb_tpu/sql/bind.py @ 6233200
"""Placeholder scanning/binding for prepared statements.

Reference analog: the param-marker handling of pkg/parser (ParamMarkerExpr)
+ expression.ParamMarker binding in plan cache — here params are bound by
splicing SQL literals before parse, shared by the wire-protocol
COM_STMT_EXECUTE path and SQL-level EXECUTE ... USING.
"""

from __future__ import annotations


def scan_sql(sql: str):
    """Yield (char, masked) where masked chars are inside string literals,
    backtick identifiers, or comments — a '?' there is not a placeholder
    (mirrors the lexer's string/comment handling)."""
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch in ("'", '"', "`"):
            quote = ch
            yield ch, True
            i += 1
            while i < n:
                yield sql[i], True
                if sql[i] == "\\" and quote != "`" and i + 1 < n:
                    i += 1
                    yield sql[i], True
                elif sql[i] == quote:
                    i += 1
                    break
                i += 1
            continue
        if ch == "#" or (ch == "-" and sql[i:i + 2] == "--"):
            while i < n and sql[i] != "\n":
                yield sql[i], True
                i += 1
            continue
        if ch == "/" and sql[i:i + 2] == "/*":
            end = sql.find("*/", i + 2)
            end = n if end < 0 else end + 2
            while i < end:
                yield sql[i], True
                i += 1
            continue
        yield ch, False
        i += 1


def count_placeholders(sql: str) -> int:
    return sum(1 for ch, masked in scan_sql(sql)
               if ch == "?" and not masked)


def strip_placeholders(sql: str) -> str:
    """Replace ? with a literal so the statement parses at PREPARE time."""
    return "".join("0" if ch == "?" and not masked else ch
                   for ch, masked in scan_sql(sql))


def bind_placeholders(sql: str, params: list) -> str:
    out = []
    it = iter(params)
    for ch, masked in scan_sql(sql):
        if ch == "?" and not masked:
            out.append(sql_literal(next(it)))
        else:
            out.append(ch)
    return "".join(out)


def sql_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        return repr(v)
    import decimal as pydec
    if isinstance(v, pydec.Decimal):
        return str(v)
    s = str(v).replace("\\", "\\\\").replace("'", "\\'")
    return f"'{s}'"


__all__ = ["scan_sql", "count_placeholders", "strip_placeholders",
           "bind_placeholders", "sql_literal"]

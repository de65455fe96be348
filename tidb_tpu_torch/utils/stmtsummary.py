# ported from tidb_tpu/utils/stmtsummary.py @ 6233200
"""Statement digests (pkg/parser/digester.go analog): the SQL text with
literals and comments normalized out.

The JAX package's module also holds the statement summary and the slow
query log (pkg/util/stmtsummary, executor/adapter_slow_log.go); the port
has only the digest, which plan bindings key on.  Statement recording,
``SHOW STATEMENTS_SUMMARY`` and ``SHOW SLOW_QUERIES`` arrive with ROADMAP.md,
Queue 1 entry 7.
"""

from __future__ import annotations

import re

_NUM = re.compile(r"\b\d+(?:\.\d+)?\b")
_WS = re.compile(r"\s+")
_IN_LIST = re.compile(r"\(\s*\?(?:\s*,\s*\?)+\s*\)")


def _strip_strings_and_comments(sql: str) -> str:
    """One left-to-right pass replacing string literals with ? and
    removing comments — regex passes cannot order these correctly (a
    quote inside a comment, or comment markers inside a string, corrupt
    each other's extents)."""
    out = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in "'\"":
            q = c
            i += 1
            while i < n:
                if sql[i] == "\\":
                    i += 2
                    continue
                if sql[i] == q:
                    if i + 1 < n and sql[i + 1] == q:   # '' escape
                        i += 2
                        continue
                    i += 1
                    break
                i += 1
            out.append("?")
            continue
        if (sql.startswith("--", i)
                and (i + 2 >= n or sql[i + 2].isspace())) or c == "#":
            # MySQL: '--' starts a comment only when followed by
            # whitespace — 'a--1' is subtraction, not a comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            out.append(" ")
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            i = n if j < 0 else j + 2
            out.append(" ")
            continue
        out.append(c)
        i += 1
    return "".join(out)


def normalize_sql(sql: str) -> str:
    """Literal-free normalized form (digester.go analog).  Comments —
    including /*+ hint */ blocks — do not participate in the digest, so a
    hinted statement matches its unhinted original (bindinfo contract)."""
    s = _strip_strings_and_comments(sql)
    s = _NUM.sub("?", s)
    s = _WS.sub(" ", s).strip().lower()
    s = _IN_LIST.sub("(...)", s)   # collapse IN/VALUES lists
    return s


__all__ = ["normalize_sql"]

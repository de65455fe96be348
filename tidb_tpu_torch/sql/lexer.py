# ported from tidb_tpu/sql/lexer.py @ 9d319cb
"""SQL lexer.

Reference analog: pkg/parser's lexer (lexer.go, misc.go keyword table).
Hand-written scanner over a MySQL-dialect subset: identifiers (plain and
backtick-quoted), case-insensitive keywords, integer/decimal/float literals,
single/double-quoted strings with '' and backslash escapes, operators,
`--`/`#`/`/* */` comments.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "OFFSET", "AS", "AND", "OR", "NOT", "XOR", "IN", "BETWEEN", "LIKE",
    "IS", "NULL", "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE", "END",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "ON",
    "USING", "ASC", "DESC", "DISTINCT", "ALL", "UNION", "EXCEPT",
    "INTERSECT", "CREATE", "TABLE", "DROP", "INSERT", "INTO", "VALUES",
    "UPDATE", "SET", "DELETE", "PRIMARY", "KEY", "UNIQUE", "INDEX", "IF",
    "EXISTS", "DATABASE", "DATABASES", "USE", "SHOW", "TABLES", "EXPLAIN",
    "ANALYZE", "DATE", "TIME", "TIMESTAMP", "INTERVAL", "YEAR", "MONTH",
    "DAY", "HOUR", "MINUTE", "SECOND", "CAST", "CONVERT", "DIV", "MOD",
    "DESCRIBE", "DESC", "BEGIN", "COMMIT", "ROLLBACK", "START",
    "TRANSACTION", "DEFAULT", "AUTO_INCREMENT", "COMMENT", "ENGINE",
    "CHARSET", "COLLATE", "CHARACTER", "SUBSTRING", "TRUNCATE", "GLOBAL",
    "SESSION", "VARIABLES", "COLUMNS", "ADMIN", "CHECK", "WITH", "ALTER",
    "ADD", "KEYS", "COLUMN",
    "RECURSIVE", "OVER", "PARTITION", "ROWS", "RANGE", "UNBOUNDED",
    "PRECEDING", "FOLLOWING", "CURRENT", "ROW", "WINDOW",
    "USER", "GRANT", "REVOKE", "GRANTS", "IDENTIFIED", "PRIVILEGES", "TO",
    "FLUSH", "PASSWORD", "FOR",
    "REPLACE", "IGNORE", "LOAD", "DATA", "INFILE", "LOCAL", "FIELDS",
    "TERMINATED", "ENCLOSED", "OPTIONALLY", "LINES",
    "BINDING", "BINDINGS",
}

# multi-char operators first (maximal munch)
OPERATORS = ["<=>", "<<", ">>", "<>", "!=", "<=", ">=", "||", "&&", ":=",
             "=", "<", ">", "+", "-", "*", "/", "%", "(", ")", ",", ".",
             ";", "|", "&", "^", "~", "@"]


@dataclass(frozen=True)
class Token:
    kind: str      # 'kw' | 'ident' | 'int' | 'decimal' | 'float' | 'str' | 'op' | 'eof'
    text: str      # uppercased for kw
    pos: int


class LexError(ValueError):
    pass


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i) or c == "#":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise LexError(f"unterminated comment at {i}")
            if sql.startswith("/*+", i):
                # optimizer hint comment (parser_driver hint analog):
                # surface the body as one token for the hint parser
                toks.append(Token("hint", sql[i + 3:j].strip(), i))
            i = j + 2
            continue
        if c == "`":
            j = i + 1
            while j < n and sql[j] != "`":
                j += 1
            if j >= n:
                raise LexError(f"unterminated identifier at {i}")
            toks.append(Token("ident", sql[i + 1:j], i))
            i = j + 1
            continue
        if c in "'\"":
            s, j = _scan_string(sql, i)
            toks.append(Token("str", s, i))
            i = j
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            tok, j = _scan_number(sql, i)
            toks.append(tok)
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            up = word.upper()
            if up in KEYWORDS:
                toks.append(Token("kw", up, i))
            else:
                toks.append(Token("ident", word, i))
            i = j
            continue
        for op in OPERATORS:
            if sql.startswith(op, i):
                toks.append(Token("op", op, i))
                i += len(op)
                break
        else:
            raise LexError(f"unexpected character {c!r} at {i}")
    toks.append(Token("eof", "", n))
    return toks


def _scan_string(sql: str, i: int) -> tuple[str, int]:
    quote = sql[i]
    out = []
    j = i + 1
    n = len(sql)
    while j < n:
        c = sql[j]
        if c == "\\" and j + 1 < n:
            nxt = sql[j + 1]
            out.append({"n": "\n", "t": "\t", "0": "\0", "r": "\r"}.get(nxt, nxt))
            j += 2
            continue
        if c == quote:
            if j + 1 < n and sql[j + 1] == quote:  # '' escape
                out.append(quote)
                j += 2
                continue
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise LexError(f"unterminated string at {i}")


def _scan_number(sql: str, i: int) -> tuple[Token, int]:
    j = i
    n = len(sql)
    seen_dot = seen_exp = False
    while j < n:
        c = sql[j]
        if c.isdigit():
            j += 1
        elif c == "." and not seen_dot and not seen_exp:
            seen_dot = True
            j += 1
        elif c in "eE" and not seen_exp and j > i:
            if j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                seen_exp = True
                j += 2
            else:
                break
        else:
            break
    text = sql[i:j]
    if seen_exp:
        kind = "float"
    elif seen_dot:
        kind = "decimal"   # MySQL: exact numeric literal
    else:
        kind = "int"
    return Token(kind, text, i), j


__all__ = ["Token", "tokenize", "LexError", "KEYWORDS"]

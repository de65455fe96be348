# ported from tidb_tpu/utils/jsonfns.py @ df101aa
"""JSON builtin implementations over JSON text values.

Reference analog: pkg/types/json_binary*.go + pkg/expression/builtin_json*.
JSON columns store normalized text dict-encoded like VARCHAR, so every
JSON_* builtin evaluates ONCE per distinct value over the dictionary
(expr/lower_strings.py) and runs as a gather on device — the same
per-distinct-value trick as the string builtins.

Path grammar (subset of MySQL JSON path): `$`, `.member`, `."quoted"`,
`[N]`.  Multiple-path and wildcard forms are not supported.
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional

_STEP = re.compile(
    r"""\.(?:([A-Za-z_][A-Za-z0-9_]*)|"((?:[^"\\]|\\.)*)")|\[(\d+)\]""")


class JSONPathError(ValueError):
    pass


def parse_path(path: str):
    if not path.startswith("$"):
        raise JSONPathError(f"bad JSON path {path!r}")
    steps = []
    i = 1
    while i < len(path):
        m = _STEP.match(path, i)
        if m is None:
            raise JSONPathError(f"bad JSON path {path!r} at {i}")
        if m.group(3) is not None:
            steps.append(int(m.group(3)))
        else:
            steps.append(m.group(1) if m.group(1) is not None
                         else m.group(2).encode().decode("unicode_escape"))
        i = m.end()
    return steps


def _loads(text: str):
    return json.loads(text)


def _walk(doc: Any, steps) -> tuple[bool, Any]:
    for s in steps:
        if isinstance(s, int):
            if isinstance(doc, list) and 0 <= s < len(doc):
                doc = doc[s]
            elif s == 0 and not isinstance(doc, list):
                continue         # MySQL: $[0] of a scalar is the scalar
            else:
                return False, None
        else:
            if isinstance(doc, dict) and s in doc:
                doc = doc[s]
            else:
                return False, None
    return True, doc


def _dump(v: Any) -> str:
    return json.dumps(v, separators=(", ", ": "), ensure_ascii=False)


def extract(text: str, path: str) -> Optional[str]:
    """JSON text of the value at `path`, or None (SQL NULL) on a miss or
    invalid input document."""
    try:
        doc = _loads(text)
    except ValueError:
        return None
    ok, v = _walk(doc, parse_path(path))
    return _dump(v) if ok else None


def unquote(text: str) -> str:
    """JSON_UNQUOTE: strip quotes of a JSON string literal; other values
    pass through unchanged."""
    t = text.strip()
    if len(t) >= 2 and t[0] == '"' and t[-1] == '"':
        try:
            v = _loads(t)
            if isinstance(v, str):
                return v
        except ValueError:
            pass
    return text


def jtype(text: str) -> Optional[str]:
    try:
        v = _loads(text)
    except ValueError:
        return None
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "INTEGER"
    if isinstance(v, float):
        return "DOUBLE"
    if isinstance(v, str):
        return "STRING"
    if isinstance(v, list):
        return "ARRAY"
    return "OBJECT"


def valid(text: str) -> int:
    try:
        _loads(text)
        return 1
    except ValueError:
        return 0


def jlength(text: str, path: str = "$") -> Optional[int]:
    try:
        doc = _loads(text)
    except ValueError:
        return None
    ok, v = _walk(doc, parse_path(path))
    if not ok:
        return None
    if isinstance(v, dict) or isinstance(v, list):
        return len(v)
    return 1


def _contained(target: Any, cand: Any) -> bool:
    """MySQL JSON_CONTAINS semantics."""
    if isinstance(target, list):
        if isinstance(cand, list):
            return all(any(_contained(t, c) for t in target) for c in cand)
        return any(_contained(t, cand) for t in target)
    if isinstance(target, dict) and isinstance(cand, dict):
        return all(k in target and _contained(target[k], v)
                   for k, v in cand.items())
    return type(target) is type(cand) and target == cand or \
        (isinstance(target, (int, float))
         and isinstance(cand, (int, float))
         and not isinstance(target, bool) and not isinstance(cand, bool)
         and target == cand)


def contains(text: str, candidate: str, path: str = "$") -> Optional[int]:
    try:
        doc = _loads(text)
        cand = _loads(candidate)
    except ValueError:
        return None
    ok, v = _walk(doc, parse_path(path))
    if not ok:
        return None
    return int(_contained(v, cand))


__all__ = ["extract", "unquote", "jtype", "valid", "jlength", "contains",
           "parse_path", "JSONPathError"]


# ------------------------------------------------------------------ #
# modification + search family (reference: pkg/types/json_binary_functions.go)

def _set_at(doc, steps, value, mode: str):
    """Set value at path; mode 'set'|'insert'|'replace'.  Returns doc."""
    if not steps:
        return value if mode in ("set", "replace") else doc
    cur = doc
    for i, s in enumerate(steps[:-1]):
        ok, nxt = _walk(cur, [s])
        if not ok:
            return doc           # intermediate missing: no-op (MySQL)
        cur = nxt
    last = steps[-1]
    if isinstance(last, int):
        if isinstance(cur, list):
            if 0 <= last < len(cur):
                if mode in ("set", "replace"):
                    cur[last] = value
            elif mode in ("set", "insert"):
                cur.append(value)
        return doc
    if isinstance(cur, dict):
        if last in cur:
            if mode in ("set", "replace"):
                cur[last] = value
        elif mode in ("set", "insert"):
            cur[last] = value
    return doc


def _parse_value(v):
    """A const argument as a JSON value.  SQL strings stay JSON STRINGS
    (MySQL: JSON_SET('{}','$.a','[1,2]') stores the text, not an array);
    non-string scalars pass through."""
    if isinstance(v, (int, float, bool)) or v is None:
        return v
    return str(v)


def modify(text: str, mode: str, *pairs) -> Optional[str]:
    """JSON_SET/INSERT/REPLACE: pairs = (path, value, path, value...)."""
    try:
        doc = _loads(text)
    except ValueError:
        return None
    for i in range(0, len(pairs) - 1, 2):
        try:
            steps = parse_path(str(pairs[i]))
        except JSONPathError:
            return None
        doc = _set_at(doc, steps, _parse_value(pairs[i + 1]), mode)
    return _dump(doc)


def remove(text: str, *paths) -> Optional[str]:
    try:
        doc = _loads(text)
    except ValueError:
        return None
    for p in paths:
        try:
            steps = parse_path(str(p))
        except JSONPathError:
            return None
        if not steps:
            return None          # MySQL errors on '$'; NULL here
        ok, parent = _walk(doc, steps[:-1])
        if not ok:
            continue
        last = steps[-1]
        if isinstance(last, int) and isinstance(parent, list) \
                and 0 <= last < len(parent):
            del parent[last]
        elif isinstance(last, str) and isinstance(parent, dict) \
                and last in parent:
            del parent[last]
    return _dump(doc)


def keys(text: str, path: str = "$") -> Optional[str]:
    try:
        doc = _loads(text)
        ok, v = _walk(doc, parse_path(path))
    except (ValueError, JSONPathError):
        return None
    if not ok or not isinstance(v, dict):
        return None
    return _dump(list(v.keys()))


def depth(text: str) -> Optional[int]:
    try:
        doc = _loads(text)
    except ValueError:
        return None

    def d(v):
        if isinstance(v, dict):
            return 1 + max((d(x) for x in v.values()), default=0)
        if isinstance(v, list):
            return 1 + max((d(x) for x in v), default=0)
        return 1
    return d(doc)


def search(text: str, one_or_all: str, target: str,
           escape=None, *paths) -> Optional[str]:
    """JSON_SEARCH(doc, one|all, pattern[, escape[, path...]]): % / _
    wildcards with an optional escape char, scoped to `paths`."""
    import re as _re
    try:
        doc = _loads(text)
    except ValueError:
        return None
    esc = str(escape) if escape not in (None, "") else "\\"
    out = []
    i = 0
    while i < len(target):
        c = target[i]
        if c == esc and i + 1 < len(target):
            out.append(_re.escape(target[i + 1]))
            i += 2
            continue
        out.append(".*" if c == "%" else "." if c == "_"
                   else _re.escape(c))
        i += 1
    rx = _re.compile("^" + "".join(out) + "$", _re.S)
    scopes = None
    if paths:
        try:
            scopes = [parse_path(str(p)) for p in paths]
        except JSONPathError:
            return None
    hits: list[str] = []

    def in_scope(steps) -> bool:
        if scopes is None:
            return True
        return any(steps[:len(sc)] == sc for sc in scopes)

    def render(steps) -> str:
        out = "$"
        for s in steps:
            if isinstance(s, int):
                out += f"[{s}]"
            elif _re.search(r"\W", s):
                out += f'."{s}"'
            else:
                out += f".{s}"
        return out

    def walk(v, steps):
        if isinstance(v, str) and rx.match(v) and in_scope(steps):
            hits.append(render(steps))
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(x, steps + [k])
        elif isinstance(v, list):
            for i2, x in enumerate(v):
                walk(x, steps + [i2])
    walk(doc, [])
    if not hits:
        return None
    if one_or_all.lower() == "one":
        return _dump(hits[0])
    return _dump(hits[0] if len(hits) == 1 else hits)


def merge_patch(text: str, *others) -> Optional[str]:
    def patch(a, b):
        if not isinstance(b, dict):
            return b
        if not isinstance(a, dict):
            a = {}
        for k, v in b.items():
            if v is None:
                a.pop(k, None)
            else:
                a[k] = patch(a.get(k), v)
        return a
    try:
        doc = _loads(text)
        for o in others:
            doc = patch(doc, _loads(str(o)))
    except ValueError:
        return None
    return _dump(doc)


def merge_preserve(text: str, *others) -> Optional[str]:
    def merge(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            for k, v in b.items():
                a[k] = merge(a[k], v) if k in a else v
            return a
        la = a if isinstance(a, list) else [a]
        lb = b if isinstance(b, list) else [b]
        return la + lb
    try:
        doc = _loads(text)
        for o in others:
            doc = merge(doc, _loads(str(o)))
    except ValueError:
        return None
    return _dump(doc)


def array_append(text: str, *pairs) -> Optional[str]:
    try:
        doc = _loads(text)
    except ValueError:
        return None
    for i in range(0, len(pairs) - 1, 2):
        try:
            steps = parse_path(str(pairs[i]))
        except JSONPathError:
            return None
        ok, v = _walk(doc, steps)
        if not ok:
            continue
        val = _parse_value(pairs[i + 1])
        if isinstance(v, list):
            v.append(val)
        elif not steps:
            doc = [doc, val]
        else:
            _set_at(doc, steps, [v, val], "replace")
    return _dump(doc)


def contains_path(text: str, one_or_all: str, *paths) -> Optional[int]:
    try:
        doc = _loads(text)
    except ValueError:
        return None
    hits = 0
    for p in paths:
        try:
            ok, _v = _walk(doc, parse_path(str(p)))
        except JSONPathError:
            return None
        hits += bool(ok)
    return int(hits == len(paths) if one_or_all.lower() == "all"
               else hits > 0)


def pretty(text: str) -> Optional[str]:
    try:
        return json.dumps(_loads(text), indent=2, ensure_ascii=False)
    except ValueError:
        return None


def storage_size(text: str) -> Optional[int]:
    try:
        _loads(text)
    except ValueError:
        return None
    return len(text.encode())


def quote(text: str) -> str:
    return json.dumps(text, ensure_ascii=False)


def overlaps(text: str, other: str) -> Optional[int]:
    try:
        a, b = _loads(text), _loads(str(other))
    except ValueError:
        return None
    la = a if isinstance(a, list) else [a]
    lb = b if isinstance(b, list) else [b]
    if isinstance(a, dict) and isinstance(b, dict):
        return int(any(k in b and b[k] == v for k, v in a.items()))
    return int(any(x in lb for x in la))


def value_at(text: str, path: str) -> Optional[str]:
    """JSON_VALUE default (RETURNING omitted): unquoted scalar text."""
    try:
        got = extract(text, path)
    except JSONPathError:
        return None
    return None if got is None else unquote(got)

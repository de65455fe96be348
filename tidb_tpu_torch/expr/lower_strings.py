# ported from tidb_tpu/expr/lower_strings.py @ 9d319cb
"""Lower string predicates onto dictionary codes.

Reference analog: pkg/util/collate (collation-aware compares) and the string
builtins in pkg/expression/builtin_string_vec.go / builtin_like.go.  The TPU
design dictionary-encodes strings at columnarization time with a *sorted*
dictionary (chunk/column.py StringDict), so:

- `col <cmp> 'literal'`  →  integer compare of codes against a threshold
  resolved host-side via binary search (lower/upper bound),
- `col LIKE 'pat%'`, `col IN (...)`  →  a boolean lookup table computed once
  host-side over the (small) dictionary, gathered on device (`dict_lut`).

This pass runs at plan-binding time, when the target table snapshot (and its
dictionaries) is known — the analog of ToPB serialization binding a plan to
a region (SURVEY.md §A.1).
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np

from ..chunk.column import StringDict
from ..types import dtypes as dt
from . import builders as B
from .ir import ColumnRef, Const, Expr, Func

K = dt.TypeKind


def like_to_regex(pattern: str, escape: str = "\\") -> re.Pattern:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _dict_for(e: Expr, dicts: dict[int, StringDict]) -> Optional[StringDict]:
    if isinstance(e, ColumnRef) and e.dtype.is_string:
        return dicts.get(e.index)
    # dict_map nodes produced by string-function lowering carry the derived
    # output dictionary, so e.g. WHERE UPPER(c) = 'X' lowers end-to-end
    d = getattr(e, "_derived_dict", None)
    if d is not None:
        return d
    return None


def expr_out_dict(e: Expr, dicts: dict[int, StringDict]) -> Optional[StringDict]:
    """Output dictionary of a lowered string-valued expression (column
    passthrough or a derived dictionary from string-function lowering) —
    how planners propagate dictionaries through Projections."""
    return _dict_for(e, dicts)


def _const_str(e: Expr) -> Optional[str]:
    if isinstance(e, Const) and isinstance(e.value, str):
        return e.value
    return None


_CMP_SWAP = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}


def _eff_collation(*exprs: Optional[Expr]) -> str:
    """Effective collation of a comparison (simplified coercibility: any
    non-binary column collation wins; literals are coercible)."""
    from ..utils.collate import is_binary
    for x in exprs:
        if x is not None and x.dtype.is_string \
                and not is_binary(x.dtype.collation):
            return x.dtype.collation
    return "binary"


def _lower_cmp_ci(dtype: dt.DataType, op: str, col: Expr, s: str,
                  d: StringDict, collation: str) -> Expr:
    """Collation-aware column-vs-literal compare: codes remap through the
    collation rank LUT (util/collate Compare/Key collapsed into one
    dictionary pass)."""
    from ..utils.collate import rank_table
    rt = rank_table(d, collation)
    ic = lambda v: Const(dt.bigint(False), int(v))
    if op in ("eq", "ne"):
        r = rt.rank_of(s)
        lut = rt.ranks == r          # r == -1 matches nothing
        if op == "ne":
            lut = ~lut
        return B.dict_lut(col, _pad_lut(lut), nullable=dtype.nullable)
    ranks = B.dict_map(col, rt.ranks)
    if op == "lt":
        return Func(dtype, "lt", (ranks, ic(rt.lower_bound(s))))
    if op == "le":
        return Func(dtype, "lt", (ranks, ic(rt.upper_bound(s))))
    if op == "gt":
        return Func(dtype, "ge", (ranks, ic(rt.upper_bound(s))))
    return Func(dtype, "ge", (ranks, ic(rt.lower_bound(s))))


def lower_strings(e: Expr, dicts: dict[int, StringDict]) -> Expr:
    """Rewrite string predicates AND string functions to code-space ops.

    String-valued functions (UPPER, SUBSTRING, CONCAT, ...) over
    dict-encoded columns compute per-DISTINCT-value host-side over the
    (small) dictionary, producing a derived output dictionary + a code
    translation that runs as one gather on device — the TPU redesign of
    pkg/expression/builtin_string_vec.go's per-row loops.  Non-string
    nodes recurse."""
    if not isinstance(e, Func):
        return e
    from .ir import clone_func
    args = tuple(lower_strings(a, dicts) for a in e.args)
    e = clone_func(e, args)

    from .builders import STRING_INT_FUNCS, STRING_VALUED_FUNCS
    if e.op in STRING_VALUED_FUNCS:
        lowered = _lower_str_valued(e, args, dicts)
        if lowered is not None:
            return lowered
        return e
    if e.op in STRING_INT_FUNCS:
        lowered = _lower_str_int(e, args, dicts)
        if lowered is not None:
            return lowered
        return e

    if e.op in B.COMPARE_OPS and len(args) == 2:
        coll = _eff_collation(args[0], args[1])
        # column-vs-column string compare: if the two sides use different
        # dictionaries (or a non-binary collation), remap both into a
        # merged code/rank space first (codes are only comparable within
        # one dictionary and one collation).
        da, db = _dict_for(args[0], dicts), _dict_for(args[1], dicts)
        if da is not None and db is not None \
                and (da is not db or coll != "binary"):
            from ..utils.collate import merged_rank_maps
            map_a, map_b = merged_rank_maps(da, db, coll)
            return Func(e.dtype, e.op,
                        (B.dict_map(args[0], map_a), B.dict_map(args[1], map_b)))

        col, s, op = None, None, e.op
        d = _dict_for(args[0], dicts)
        if d is not None and _const_str(args[1]) is not None:
            col, s = args[0], _const_str(args[1])
        else:
            d = _dict_for(args[1], dicts)
            if d is not None and _const_str(args[0]) is not None:
                col, s, op = args[1], _const_str(args[0]), _CMP_SWAP[e.op]
        if col is not None:
            if coll != "binary":
                return _lower_cmp_ci(e.dtype, op, col, s, d, coll)
            return _lower_cmp(e.dtype, op, col, s, d)

    if e.op == "like":
        d = _dict_for(args[0], dicts)
        p = _const_str(args[1])
        if d is not None and p is not None:
            coll = _eff_collation(args[0])
            if coll != "binary":
                # ci LIKE: casefold both sides — MySQL LIKE is character-
                # wise with NO pad-space and no accent folding
                from ..utils.collate import like_key
                rx = like_to_regex(like_key(p, coll))
                lut = np.fromiter(
                    (rx.match(like_key(v, coll)) is not None
                     for v in d.values), dtype=bool, count=len(d))
            else:
                rx = like_to_regex(p)
                lut = np.fromiter((rx.match(v) is not None
                                   for v in d.values),
                                  dtype=bool, count=len(d))
            return B.dict_lut(args[0], _pad_lut(lut))

    if e.op in ("greatest", "least") and e.dtype.is_string:
        lowered = _lower_gl_strings(e, args, dicts)
        if lowered is not None:
            return lowered
        return e

    if e.op in ("coalesce", "if", "case") and e.dtype.is_string:
        lowered = _lower_cond_strings(e, args, dicts)
        if lowered is not None:
            return lowered
        return e

    if e.op in ("cast", "cast_char"):
        lowered = _lower_cast_strings(e, args, dicts)
        if lowered is not None:
            return lowered
        return e

    if e.op == "str_to_date":
        lowered = _lower_str_to_date(e, args, dicts)
        if lowered is not None:
            return lowered
        return e

    if e.op == "in" and _dict_for(args[0], dicts) is not None:
        d = _dict_for(args[0], dicts)
        has_null = any(isinstance(a, Const) and a.value is None for a in args[1:])
        items = [_const_str(a) for a in args[1:]
                 if not (isinstance(a, Const) and a.value is None)]
        if all(s is not None for s in items):
            coll = _eff_collation(args[0])
            if coll != "binary":
                from ..utils.collate import sortkey
                keys = {sortkey(s, coll) for s in items}
                lut = np.fromiter((sortkey(v, coll) in keys
                                   for v in d.values), dtype=bool,
                                  count=len(d)) if len(d) \
                    else np.zeros(1, bool)
            else:
                lut = np.zeros(max(len(d), 1), dtype=bool)
                for s in items:
                    c = d.code_of(s)
                    if c >= 0:
                        lut[c] = True
            match = B.dict_lut(args[0], _pad_lut(lut))
            if has_null:
                # x IN (..., NULL): TRUE on match, else NULL
                return B.case_when([(match, B.lit(1))], None)
            return match

    return e


def _pad_lut(lut: np.ndarray) -> np.ndarray:
    return lut if len(lut) else np.zeros(1, dtype=bool)


# ------------------------------------------------------------------ #
# string functions over dictionary codes
# ------------------------------------------------------------------ #

def _const_scalar(a: Expr):
    """Python value of a non-NULL scalar Const (str or int), else None."""
    if isinstance(a, Const) and isinstance(a.value, (str, int)) \
            and not isinstance(a.value, bool):
        return a.value
    return None


def _mysql_substring(s: str, pos: int, length: Optional[int]) -> str:
    if pos == 0:
        return ""
    start = pos - 1 if pos > 0 else len(s) + pos
    if start < 0:
        return ""
    end = len(s) if length is None else start + max(length, 0)
    return s[start:end]


def _str_valued_impl(op: str, consts: list):
    """Per-dictionary-value python implementation of a string-valued
    function with constant non-column arguments."""
    if op == "upper":
        return lambda v: v.upper()
    if op == "lower":
        return lambda v: v.lower()
    if op in ("trim", "ltrim", "rtrim"):
        r = str(consts[0]) if consts else None

        def _trim(v, op=op, r=r):
            if not r:
                return {"trim": v.strip(" "), "ltrim": v.lstrip(" "),
                        "rtrim": v.rstrip(" ")}[op]
            # MySQL TRIM(remstr ...): removes whole-string occurrences
            if op in ("trim", "ltrim"):
                while v.startswith(r):
                    v = v[len(r):]
            if op in ("trim", "rtrim"):
                while v.endswith(r):
                    v = v[:-len(r)]
            return v
        return _trim
    if op == "reverse":
        return lambda v: v[::-1]
    if op == "json_extract":
        from ..utils.jsonfns import extract
        path = str(consts[0])
        return lambda v: extract(v, path)
    if op == "json_unquote":
        from ..utils.jsonfns import unquote
        return unquote
    if op == "json_type":
        from ..utils.jsonfns import jtype
        return jtype
    if op in ("json_set", "json_insert", "json_replace"):
        from ..utils.jsonfns import modify
        mode = op[5:]
        return lambda v: modify(v, mode, *consts)
    if op == "json_remove":
        from ..utils.jsonfns import remove
        return lambda v: remove(v, *consts)
    if op == "json_keys":
        from ..utils.jsonfns import keys
        path = str(consts[0]) if consts else "$"
        return lambda v: keys(v, path)
    if op == "json_search":
        from ..utils.jsonfns import search
        one_all, target = str(consts[0]), str(consts[1])
        rest = consts[2:]              # [escape[, path...]]
        return lambda v: search(v, one_all, target, *rest)
    if op == "json_merge_patch":
        from ..utils.jsonfns import merge_patch
        return lambda v: merge_patch(v, *consts)
    if op in ("json_merge_preserve", "json_merge"):
        from ..utils.jsonfns import merge_preserve
        return lambda v: merge_preserve(v, *consts)
    if op == "json_array_append":
        from ..utils.jsonfns import array_append
        return lambda v: array_append(v, *consts)
    if op == "json_pretty":
        from ..utils.jsonfns import pretty
        return pretty
    if op == "json_quote":
        from ..utils.jsonfns import quote
        return quote
    if op == "json_value":
        from ..utils.jsonfns import value_at
        path = str(consts[0])
        return lambda v: value_at(v, path)
    if op == "uuid_to_bin":
        import uuid as _uuid
        # MySQL swap_flag: store time-high + time-mid + time-low first so
        # v1 UUIDs index chronologically (builtin_miscellaneous.go)
        swap = bool(consts and consts[0])

        def _u2b(v):
            try:
                b = _uuid.UUID(v).bytes
            except ValueError:
                return None
            if swap:
                b = b[6:8] + b[4:6] + b[0:4] + b[8:]
            return b.hex()
        return _u2b
    if op == "bin_to_uuid":
        import uuid as _uuid
        swap = bool(consts and consts[0])

        def _b2u(v):
            try:
                b = bytes.fromhex(v)
                if swap:            # undo the time-swapped storage order
                    b = b[4:8] + b[2:4] + b[0:2] + b[8:]
                return str(_uuid.UUID(bytes=b))
            except ValueError:
                return None
        return _b2u
    if op == "inet6_ntoa":
        import ipaddress

        def _i6n(v):
            try:
                return str(ipaddress.ip_address(bytes.fromhex(v)))
            except ValueError:
                return None
        return _i6n
    if op == "inet6_aton":
        import ipaddress

        def _i6a(v):
            try:
                return ipaddress.ip_address(v).packed.hex()
            except ValueError:
                return None
        return _i6a
    if op == "compress":
        import zlib

        def _cmp(v):
            import struct as _st
            b = v.encode()
            if not b:
                return ""
            return (_st.pack("<I", len(b)) + zlib.compress(b)).hex()
        return _cmp
    if op == "uncompress":
        import zlib

        def _unc(v):
            if v == "":
                return ""
            try:
                raw = bytes.fromhex(v)
                return zlib.decompress(raw[4:]).decode()
            except (ValueError, zlib.error):
                return None
        return _unc
    if op == "substring":
        pos = consts[0]
        length = consts[1] if len(consts) > 1 else None
        return lambda v: _mysql_substring(v, pos, length)
    if op == "replace":
        frm, to = str(consts[0]), str(consts[1])
        return (lambda v: v.replace(frm, to)) if frm else (lambda v: v)
    if op == "left":
        n = max(int(consts[0]), 0)
        return lambda v: v[:n]
    if op == "right":
        n = int(consts[0])
        return (lambda v: v[-n:]) if n > 0 else (lambda v: "")
    if op == "lpad":
        n, pad = int(consts[0]), str(consts[1])
        return lambda v: (v[:n] if len(v) >= n or not pad
                          else (pad * n)[:n - len(v)] + v)
    if op == "rpad":
        n, pad = int(consts[0]), str(consts[1])
        return lambda v: (v[:n] if len(v) >= n or not pad
                          else v + (pad * n)[:n - len(v)])
    if op == "repeat":
        n = int(consts[0])
        return lambda v: v * n if n > 0 else ""
    if op == "substring_index":
        delim, count = str(consts[0]), int(consts[1])

        def _si(v, delim=delim, count=count):
            if not delim or count == 0:
                return ""
            parts = v.split(delim)
            if count > 0:
                return delim.join(parts[:count])
            return delim.join(parts[count:])
        return _si
    if op == "md5":
        import hashlib
        return lambda v: hashlib.md5(v.encode()).hexdigest()
    if op == "sha1":
        import hashlib
        return lambda v: hashlib.sha1(v.encode()).hexdigest()
    if op == "sha2":
        import hashlib
        bits = int(consts[0]) if consts else 256
        algo = {0: "sha256", 224: "sha224", 256: "sha256",
                384: "sha384", 512: "sha512"}.get(bits)
        if algo is None:
            return lambda v: None          # MySQL: invalid bits -> NULL
        return lambda v, a=algo: hashlib.new(a, v.encode()).hexdigest()
    if op == "hex":
        return lambda v: v.encode("utf-8").hex().upper()
    if op == "insert_str":
        pos, ln, new = int(consts[0]), int(consts[1]), str(consts[2])

        def _ins(v, pos=pos, ln=ln, new=new):
            # MySQL INSERT: out-of-range pos returns the original string
            if pos < 1 or pos > len(v):
                return v
            end = len(v) if ln < 0 else min(pos - 1 + ln, len(v))
            return v[:pos - 1] + new + v[end:]
        return _ins
    if op == "quote":
        def _quote(v):
            out = ["'"]
            for ch in v:
                if ch in ("'", "\\"):
                    out.append("\\" + ch)
                elif ch == "\0":
                    out.append("\\0")
                elif ch == "\x1a":
                    out.append("\\Z")
                else:
                    out.append(ch)
            out.append("'")
            return "".join(out)
        return _quote
    if op == "to_base64":
        import base64
        return lambda v: base64.b64encode(v.encode()).decode()
    if op == "from_base64":
        import base64

        def _fb64(v):
            try:
                return base64.b64decode(v, validate=True).decode(
                    "utf-8", errors="replace")
            except ValueError:       # binascii.Error: invalid codec input
                return None          # MySQL: invalid input -> NULL
        return _fb64
    if op == "unhex":
        def _unhex(v):
            try:
                return bytes.fromhex(v).decode("utf-8", errors="replace")
            except ValueError:
                return None
        return _unhex
    if op == "regexp_substr":
        pat = str(consts[0])
        try:
            rx = re.compile(pat, re.IGNORECASE)   # ci default collation
        except re.error:
            return lambda v: None

        def _rsub(v, rx=rx):
            m = rx.search(v)
            return m.group(0) if m else None
        return _rsub
    if op == "regexp_replace":
        pat, repl = str(consts[0]), str(consts[1])
        try:
            rx = re.compile(pat, re.IGNORECASE)
        except re.error:
            return lambda v: None
        return lambda v, rx=rx, repl=repl: rx.sub(repl, v)
    if op == "conv":
        fb, tb = int(consts[0]), int(consts[1])
        if not (2 <= abs(fb) <= 36 and 2 <= abs(tb) <= 36):
            return lambda v: None
        digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:abs(fb)]

        def _conv(v, fb=fb, tb=tb, digits=digits):
            # parse the longest valid prefix in base |fb| (MySQL relaxed)
            t = v.strip().lower()
            neg = t.startswith("-")
            if neg or t.startswith("+"):
                t = t[1:]
            acc = 0
            seen = False
            for ch in t:
                dv = digits.find(ch)
                if dv < 0:
                    break
                acc = acc * abs(fb) + dv
                seen = True
            if not seen:
                return "0"
            if neg:
                acc = -acc
            u = acc % (1 << 64)        # MySQL: unsigned 64-bit wrap
            out_digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
            if u == 0:
                return "0"
            out = []
            base = abs(tb)
            while u:
                out.append(out_digits[u % base])
                u //= base
            return "".join(reversed(out))
        return _conv
    if op == "weight_string":
        # the value's collation sortkey (util/collate codec.Key analog);
        # the reference returns raw weight bytes — here the printable
        # sortkey, which preserves the defining property (equal weight
        # strings <=> collation-equal values, same order)
        coll = str(consts[0]) if consts else "utf8mb4_bin"

        def _wk(v, coll=coll):
            from ..utils.collate import sortkey
            return sortkey(v, coll)
        return _wk
    if op == "soundex":
        def _soundex(v):
            codes = {**dict.fromkeys("BFPV", "1"),
                     **dict.fromkeys("CGJKQSXZ", "2"),
                     **dict.fromkeys("DT", "3"), "L": "4",
                     **dict.fromkeys("MN", "5"), "R": "6"}
            s = [c for c in v.upper() if c.isalpha()]
            if not s:
                return ""
            out = [s[0]]
            prev = codes.get(s[0], "")
            for c in s[1:]:
                code = codes.get(c, "")
                if code and code != prev:
                    out.append(code)
                prev = code if c not in "HW" else prev
            return ("".join(out) + "000")[:4]
        return _soundex
    return None


def _derived_map(out_dtype: dt.DataType, col: Expr, values: list[str]) -> Func:
    """dict_map node carrying a derived output dictionary: `values[code]`
    is the function result for source code `code`."""
    new = StringDict(sorted(set(values)))
    mapping = np.fromiter((new.code_of(v) for v in values), np.int32,
                          count=len(values)) if values \
        else np.zeros(1, np.int32)
    node = Func(out_dtype, "dict_map",
                (col, Const(dt.bigint(False), mapping)))
    object.__setattr__(node, "_derived_dict", new)
    return node


def _derived_map_nullable(out_dtype: dt.DataType, col: Expr,
                          values: list[Optional[str]]) -> Expr:
    """_derived_map where some per-value results are SQL NULL (JSON path
    misses): codes whose result is None gate to NULL via a miss LUT."""
    if not any(v is None for v in values):
        return _derived_map(out_dtype, col, values)  # type: ignore[arg-type]
    filled = [v if v is not None else "" for v in values]
    base = _derived_map(out_dtype.with_nullable(True), col, filled)
    miss = np.fromiter((v is None for v in values), bool,
                       count=len(values)) if values else np.zeros(1, bool)
    node = Func(out_dtype.with_nullable(True), "if",
                (B.dict_lut(col, miss), Const(dt.null_type(), None), base))
    object.__setattr__(node, "_derived_dict",
                       getattr(base, "_derived_dict", None))
    return node


def _derived_ilut_nullable(out_dtype: dt.DataType, col: Expr,
                           values: list[Optional[int]]) -> Expr:
    """Int LUT gather where some per-value results are SQL NULL."""
    filled = np.asarray([v if v is not None else 0 for v in values] or [0],
                        np.int64)
    base = B.dict_ilut(col, filled, out_dtype.with_nullable(True))
    if not any(v is None for v in values):
        return base
    miss = np.fromiter((v is None for v in values), bool,
                       count=len(values)) if values else np.zeros(1, bool)
    return Func(out_dtype.with_nullable(True), "if",
                (B.dict_lut(col, miss), Const(dt.null_type(), None), base))


def fold_string_func(e: Expr) -> Optional[Const]:
    """Constant-fold a string-function tree whose leaves are all scalar
    Consts (post-order), e.g. UPPER('abc') or CONCAT('a', 'b', col-less).
    Returns None when any argument is non-constant."""
    if not isinstance(e, Func):
        return None
    from .builders import STRING_INT_FUNCS, STRING_VALUED_FUNCS
    if e.op not in STRING_VALUED_FUNCS and e.op not in STRING_INT_FUNCS:
        return None
    vals = []
    for a in e.args:
        if isinstance(a, Func):
            a = fold_string_func(a)
            if a is None:
                return None
        if not isinstance(a, Const):
            return None
        if a.value is None:
            return Const(e.dtype.with_nullable(True), None)
        vals.append(a.value)
    if e.op == "concat":
        return Const(e.dtype, "".join(str(v) for v in vals))
    if e.op in STRING_INT_FUNCS:
        if e.op in ("json_valid", "json_length", "json_contains"):
            from ..utils import jsonfns
            if e.op == "json_valid":
                r = jsonfns.valid(str(vals[0]))
            elif e.op == "json_length":
                r = jsonfns.jlength(str(vals[0]),
                                    str(vals[1]) if len(vals) > 1 else "$")
            else:
                r = jsonfns.contains(
                    str(vals[0]), str(vals[1]),
                    str(vals[2]) if len(vals) > 2 else "$")
            if r is None:
                return Const(e.dtype.with_nullable(True), None)
            return Const(e.dtype, int(r))
        if e.op in ("bit_length", "inet_aton", "regexp_like",
                    "regexp_instr", "json_depth", "json_contains_path",
                    "json_storage_size", "json_overlaps", "is_uuid",
                    "ord"):
            fn = _str_int_impl(e.op, vals[1:])
            r = fn(str(vals[0])) if fn else None
            if r is None:
                return Const(e.dtype.with_nullable(True), None)
            return Const(e.dtype, int(r))
        if e.op == "find_in_set":
            parts = str(vals[1]).split(",") if vals[1] != "" else []
            needle = str(vals[0])
            r = parts.index(needle) + 1 if needle in parts else 0
            return Const(e.dtype, int(r))
        if e.op == "crc32":
            import zlib
            return Const(e.dtype, zlib.crc32(str(vals[0]).encode()))
        if e.op == "strcmp":
            a_, b_ = str(vals[0]), str(vals[1])
            return Const(e.dtype, (a_ > b_) - (a_ < b_))
        if e.op == "length":
            r = len(str(vals[0]).encode("utf-8"))
        elif e.op == "char_length":
            r = len(str(vals[0]))
        elif e.op == "ascii":
            s = str(vals[0])
            r = ord(s[0]) if s else 0
        elif e.op == "locate":
            pos = int(vals[2]) if len(vals) > 2 else 1
            if pos < 1:             # MySQL: LOCATE(.., pos < 1) is 0
                r = 0
            else:
                r = str(vals[1]).find(str(vals[0]), pos - 1) + 1
        else:  # instr
            r = str(vals[0]).find(str(vals[1])) + 1
        return Const(e.dtype, int(r))
    fn = _str_valued_impl(e.op, vals[1:])
    if fn is None:
        return None
    r = fn(str(vals[0]))
    if r is None:                  # e.g. JSON_EXTRACT path miss
        return Const(e.dtype.with_nullable(True), None)
    return Const(e.dtype, r)


def string_func_arg_error(e: Func) -> Optional[str]:
    """Structural check at plan time: non-column arguments of string
    functions must be constants (the dictionary-lowering contract);
    returns an error message or None."""
    from .builders import STRING_INT_FUNCS, STRING_VALUED_FUNCS
    if e.op not in STRING_VALUED_FUNCS and e.op not in STRING_INT_FUNCS:
        return None
    if e.op == "concat":
        return None
    if e.op in ("find_in_set", "strcmp"):
        # either argument may be the per-row column (not both)
        n_const = sum(isinstance(a, Const) for a in e.args)
        if n_const == 0:
            return (f"{e.op.upper()}: one of the two arguments must be a "
                    "constant")
        return None
    col_pos = 1 if e.op == "locate" else 0
    for i, a in enumerate(e.args):
        if i == col_pos:
            continue
        if not isinstance(a, Const):
            return (f"{e.op.upper()}: argument {i + 1} must be a constant "
                    "(only the string column may vary per row)")
    return None


def _lower_str_valued(e: Func, args, dicts) -> Optional[Expr]:
    if e.op == "concat":
        return _lower_concat(e, args, dicts)
    col = args[0]
    d = _dict_for(col, dicts)
    if d is None:
        return None
    consts = []
    for a in args[1:]:
        c = _const_scalar(a)
        if c is None:
            if isinstance(a, Const) and a.value is None:
                return Const(e.dtype.with_nullable(True), None)
            return None
        consts.append(c)
    fn = _str_valued_impl(e.op, consts)
    if fn is None:
        return None
    vals = [fn(v) for v in d.values]
    if any(v is None for v in vals):
        return _derived_map_nullable(e.dtype, col, vals)
    return _derived_map(e.dtype, col, vals)


_CONCAT_MAX_PRODUCT = 1 << 16


def _lower_concat(e: Func, args, dicts) -> Optional[Expr]:
    """CONCAT over one or two dict columns + scalar constants.  Two
    columns use a product code space (capped) — codeA*|B|+codeB."""
    parts = []          # ("col", expr, dict) | ("const", str)
    cols = []
    for a in args:
        d = _dict_for(a, dicts)
        if d is not None:
            parts.append(("col", a, d))
            cols.append((a, d))
            continue
        c = _const_scalar(a)
        if c is None:
            if isinstance(a, Const) and a.value is None:
                return Const(e.dtype.with_nullable(True), None)
            return None
        parts.append(("const", str(c), None))
    if len(cols) == 1:
        _ca, da = cols[0]
        vals = []
        for v in da.values:
            vals.append("".join(v if p[0] == "col" else p[1] for p in parts))
        return _derived_map(e.dtype, cols[0][0], vals)
    if len(cols) == 2:
        (ca, da), (cb, db) = cols
        if len(da) * len(db) > _CONCAT_MAX_PRODUCT or not len(da) or not len(db):
            return None
        code = Func(dt.bigint(e.dtype.nullable), "add",
                    (Func(dt.bigint(e.dtype.nullable), "mul",
                          (ca, Const(dt.bigint(False), len(db)))), cb))
        vals = []
        for va in da.values:
            for vb in db.values:
                out = []
                seen_a = False
                for p in parts:
                    if p[0] == "const":
                        out.append(p[1])
                    elif not seen_a:
                        out.append(va)
                        seen_a = True
                    else:
                        out.append(vb)
                vals.append("".join(out))
        return _derived_map(e.dtype, code, vals)
    return None


def _lower_gl_strings(e: Func, args, dicts) -> Optional[Expr]:
    """GREATEST/LEAST over strings: remap every argument into one merged
    sorted code space (codes then order lexicographically, so integer
    max/min is string max/min); result carries the merged dictionary."""
    values = set()
    metas = []           # (kind, dict|str)
    for a in args:
        d = _dict_for(a, dicts)
        if d is not None:
            values.update(d.values)
            metas.append(("col", a, d))
            continue
        s = _const_str(a)
        if s is None:
            return None
        values.add(s)
        metas.append(("const", s, None))
    merged = StringDict(sorted(values))
    new_args = []
    for kind, a, d in metas:
        if kind == "const":
            new_args.append(Const(dt.bigint(False), merged.code_of(a)))
            continue
        mapping = np.fromiter((merged.code_of(v) for v in d.values),
                              np.int32, count=len(d)) \
            if len(d) else np.zeros(1, np.int32)
        new_args.append(Func(a.dtype, "dict_map",
                             (a, Const(dt.bigint(False), mapping))))
    from .ir import clone_func
    node = clone_func(e, new_args)
    object.__setattr__(node, "_derived_dict", merged)
    return node


# ------------------------------------------------------------------ #
# implicit/explicit casts over dictionary codes (builtin_cast.go +
# pkg/types conversion rules, re-designed as per-distinct-value host
# parses feeding one device gather)
# ------------------------------------------------------------------ #

_NUM_PREFIX = re.compile(r"\s*[-+]?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?")
_DATE_RX = re.compile(r"(\d{4})[-/.](\d{1,2})[-/.](\d{1,2})")
_DATE_COMPACT_RX = re.compile(r"(\d{4})(\d{2})(\d{2})")


def _str_num_prefix(s: str) -> float:
    """MySQL string->number coercion: value of the leading numeric
    prefix, 0 when there is none ('2024-01-31' -> 2024.0, 'abc' -> 0)."""
    m = _NUM_PREFIX.match(s)
    if m is None or not m.group(0).strip():
        return 0.0
    try:
        return float(m.group(0))
    except ValueError:
        return 0.0


def _str_to_days(s: str) -> Optional[int]:
    """Parse a date (or the date part of a datetime) string to
    days-since-epoch; None when unparseable (MySQL: NULL + warning)."""
    from ..types.temporal import date_to_days
    s = s.strip()
    for sep in (" ", "T"):
        if sep in s:
            s = s.split(sep, 1)[0]
            break
    m = _DATE_RX.fullmatch(s) or _DATE_COMPACT_RX.fullmatch(s)
    if m is None:
        return None
    try:
        return date_to_days(int(m.group(1)), int(m.group(2)),
                            int(m.group(3)))
    except ValueError:
        return None


def _str_to_micros(s: str) -> Optional[int]:
    """Parse a datetime string to micros-since-epoch; a bare date means
    midnight; None when unparseable."""
    from ..types.temporal import MICROS_PER_DAY, MICROS_PER_SEC
    s = s.strip()
    dpart, tpart = s, ""
    for sep in (" ", "T"):
        if sep in s:
            dpart, tpart = s.split(sep, 1)
            break
    days = _str_to_days(dpart)
    if days is None:
        return None
    micros = days * MICROS_PER_DAY
    if tpart:
        parts = tpart.split(":")
        try:
            h = int(parts[0])
            mi = int(parts[1]) if len(parts) > 1 else 0
            sec = parts[2] if len(parts) > 2 else "0"
            if "." in sec:
                sp, fp = sec.split(".", 1)
                frac = int((fp + "000000")[:6])
                si = int(sp) if sp else 0
            else:
                frac, si = 0, int(sec)
            if not (0 <= h < 24 and 0 <= mi < 60 and 0 <= si < 62):
                return None
            micros += ((h * 60 + mi) * 60 + si) * MICROS_PER_SEC + frac
        except ValueError:
            return None
    return micros


def _round_half_away(x: float) -> int:
    import math
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def _lower_cast_strings(e: Func, args, dicts) -> Optional[Expr]:
    """CAST with a string on either side.

    - dict string -> number/temporal: per-distinct-value host parse
      feeding an int/float LUT gather (invalid dates are NULL; numbers
      take the numeric prefix, MySQL's relaxed coercion).
    - dict string -> CHAR(n): truncation through a derived dictionary.
    Non-dict string sources and non-string casts return None (op_cast /
    op_cast_char handle them)."""
    src = args[0]
    dst = e.dtype
    d = _dict_for(src, dicts)
    if d is None:
        return None
    if not src.dtype.is_string:
        return None
    if dst.kind == K.DATE:
        vals = [_str_to_days(v) for v in d.values]
        return _derived_ilut_nullable(dst, src, vals)
    if dst.kind == K.DATETIME:
        vals = [_str_to_micros(v) for v in d.values]
        return _derived_ilut_nullable(dst, src, vals)
    if dst.kind == K.TIME:
        from ..types.temporal import parse_time
        vals = [parse_time(v) for v in d.values]
        return _derived_ilut_nullable(dst, src, vals)
    if dst.kind in (K.INT64, K.UINT64):
        lut = []
        for v in d.values:
            x = _round_half_away(_str_num_prefix(v))
            if dst.kind == K.UINT64:
                # MySQL wraps negatives mod 2^64; keep the bit pattern
                x = int(np.uint64(x % (1 << 64)).astype(np.int64))
            else:
                x = max(min(x, (1 << 63) - 1), -(1 << 63))
            lut.append(x)
        return B.dict_ilut(src, np.asarray(lut or [0], np.int64), dst)
    if dst.kind in (K.FLOAT64, K.FLOAT32):
        lut = np.asarray([_str_num_prefix(v) for v in d.values] or [0.0],
                         np.float64)
        if dst.kind == K.FLOAT32:
            lut = lut.astype(np.float32)
        return Func(dst, "dict_lut", (src, Const(dt.double(False), lut)))
    if dst.kind == K.DECIMAL:
        from decimal import Decimal, InvalidOperation
        scale = dst.scale
        lut = []
        for v in d.values:
            m = _NUM_PREFIX.match(v)
            txt = m.group(0).strip() if m else ""
            try:
                q = Decimal(txt) if txt else Decimal(0)
            except InvalidOperation:
                q = Decimal(0)
            scaled = q.scaleb(scale).to_integral_value(rounding="ROUND_HALF_UP")
            lut.append(int(scaled))
        return B.dict_ilut(src, np.asarray(lut or [0], np.int64), dst)
    if dst.is_string:
        # CAST(str AS CHAR[(n)]): passthrough, truncating when a length
        # was given (dt carries it in prec)
        n = getattr(e, "_char_len", None)
        if n is None:
            return src
        vals = [v[:n] for v in d.values]
        return _derived_map(dst, src, vals)
    return None


_MYSQL_STRPTIME = {
    "%Y": "%Y", "%y": "%y", "%m": "%m", "%c": "%m", "%d": "%d",
    "%e": "%d", "%H": "%H", "%k": "%H", "%h": "%I", "%I": "%I",
    "%l": "%I", "%i": "%M", "%s": "%S", "%S": "%S", "%f": "%f",
    "%p": "%p", "%b": "%b", "%M": "%B", "%a": "%a", "%W": "%A",
    "%j": "%j", "%T": "%H:%M:%S", "%r": "%I:%M:%S %p", "%%": "%%",
}


def _str_to_date_value(s: str, fmt: str):
    """STR_TO_DATE per-value parse -> (days|micros, is_datetime) or None
    (MySQL: unparseable -> NULL).  MySQL specifiers map onto strptime."""
    import datetime as _dt

    from ..types.temporal import MICROS_PER_DAY, MICROS_PER_SEC
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt):
            tok = fmt[i:i + 2]
            py = _MYSQL_STRPTIME.get(tok)
            if py is None:
                return None
            out.append(py)
            i += 2
        else:
            out.append(fmt[i])
            i += 1
    try:
        d = _dt.datetime.strptime(s.strip(), "".join(out))
    except ValueError:
        return None
    days = (_dt.date(d.year, d.month, d.day)
            - _dt.date(1970, 1, 1)).days
    micros = (days * MICROS_PER_DAY
              + ((d.hour * 60 + d.minute) * 60 + d.second)
              * MICROS_PER_SEC + d.microsecond)
    return days, micros


def _lower_str_to_date(e: Func, args, dicts) -> Optional[Expr]:
    """STR_TO_DATE(col, 'fmt') over a dict column or constant: per-value
    strptime feeding an int LUT gather (builtin_time.go strToDate)."""
    fmt = _const_str(args[1])
    if fmt is None:
        return None
    want_dt = e.dtype.kind == K.DATETIME

    def conv(v: str):
        r = _str_to_date_value(v, fmt)
        if r is None:
            return None
        return r[1] if want_dt else r[0]
    s0 = _const_str(args[0])
    if s0 is not None:
        r = conv(s0)
        return Const(e.dtype if r is not None else dt.null_type(), r)
    d = _dict_for(args[0], dicts)
    if d is None:
        return None
    vals = [conv(v) for v in d.values]
    return _derived_ilut_nullable(e.dtype, args[0], vals)


def _cond_value_slots(op: str, n: int) -> list[int]:
    """Indices of VALUE-producing args of a conditional (the rest are
    boolean conditions): coalesce -> all; if(c,t,e) -> 1,2; case with
    (c1,v1,...,else?) -> odd indices plus trailing else."""
    if op == "coalesce":
        return list(range(n))
    if op == "if":
        return [1, 2]
    has_else = n % 2 == 1
    slots = list(range(1, n - (1 if has_else else 0), 2))
    if has_else:
        slots.append(n - 1)
    return slots


def _lower_cond_strings(e: Func, args, dicts) -> Optional[Expr]:
    """COALESCE/IF/CASE over strings: codes are only comparable within one
    dictionary, so value branches drawing from different dict columns (or
    string literals) must remap into ONE merged sorted code space before
    the integer select runs; the node then carries the merged dictionary
    (reference: builtin_control.go caseWhen/if/ifnull over strings —
    re-designed as a host-side dictionary merge + device gathers)."""
    slots = _cond_value_slots(e.op, len(args))
    values: set[str] = set()
    metas = []                      # (slot, kind, expr, dict|str|None)
    for i in slots:
        a = args[i]
        d = _dict_for(a, dicts)
        if d is not None:
            values.update(d.values)
            metas.append((i, "col", a, d))
            continue
        s = _const_str(a)
        if s is not None:
            values.add(s)
            metas.append((i, "const", a, s))
            continue
        if isinstance(a, Const) and a.value is None:
            metas.append((i, "null", a, None))
            continue
        return None                 # non-dict string source: host fallback
    merged = StringDict(sorted(values))
    new_args = list(args)
    for i, kind, a, d in metas:
        if kind == "const":
            new_args[i] = Const(dt.bigint(False), merged.code_of(d))
        elif kind == "col":
            mapping = np.fromiter((merged.code_of(v) for v in d.values),
                                  np.int32, count=len(d)) \
                if len(d) else np.zeros(1, np.int32)
            new_args[i] = Func(a.dtype, "dict_map",
                               (a, Const(dt.bigint(False), mapping)))
    from .ir import clone_func
    node = clone_func(e, tuple(new_args))
    object.__setattr__(node, "_derived_dict", merged)
    return node


def _str_int_impl(op: str, consts: list):
    """Per-value python impl of the NEW int-valued string functions
    (bit_length/inet_aton/regexp_like/regexp_instr); the long-standing
    ones keep their dedicated branches below."""
    if op == "bit_length":
        return lambda v: 8 * len(v.encode("utf-8"))
    if op == "inet_aton":
        def _aton(v):
            parts = v.split(".")
            if not 1 <= len(parts) <= 4 or any(not p.isdigit()
                                               for p in parts):
                return None
            vals = [int(p) for p in parts]
            if any(x > 255 for x in vals[:-1]) \
                    or vals[-1] >= 1 << (8 * (5 - len(parts))):
                return None
            acc = 0
            for x in vals[:-1]:
                acc = (acc << 8) | x
            return (acc << (8 * (5 - len(parts)))) | vals[-1]
        return _aton
    if op in ("regexp_like", "regexp_instr"):
        pat = str(consts[0])
        try:
            rx = re.compile(pat, re.IGNORECASE)
        except re.error:
            return lambda v: None
        if op == "regexp_like":
            return lambda v, rx=rx: 1 if rx.search(v) else 0
        return lambda v, rx=rx: (
            (m.start() + 1) if (m := rx.search(v)) else 0)
    if op == "json_depth":
        from ..utils.jsonfns import depth
        return depth
    if op == "json_contains_path":
        from ..utils.jsonfns import contains_path
        one_all = str(consts[0]) if consts else "one"
        paths = [str(c) for c in consts[1:]]
        return lambda v: contains_path(v, one_all, *paths)
    if op == "json_storage_size":
        from ..utils.jsonfns import storage_size
        return storage_size
    if op == "json_overlaps":
        from ..utils.jsonfns import overlaps
        other = str(consts[0]) if consts else "null"
        return lambda v: overlaps(v, other)
    if op == "is_uuid":
        import uuid as _uuid

        def _isu(v):
            try:
                _uuid.UUID(v)
                return 1
            except ValueError:
                return 0
        return _isu
    if op == "ord":
        def _ord(v):
            if not v:
                return 0
            b = v[0].encode("utf-8")
            acc = 0
            for x in b:
                acc = acc * 256 + x
            return acc
        return _ord
    return None


def _lower_str_int(e: Func, args, dicts) -> Optional[Expr]:
    """LENGTH/CHAR_LENGTH/ASCII/LOCATE/INSTR over a dict column -> int LUT
    gather."""
    if e.op in ("length", "char_length", "ascii"):
        col = args[0]
        d = _dict_for(col, dicts)
        if d is None:
            return None
        if e.op == "length":
            lut = [len(v.encode("utf-8")) for v in d.values]
        elif e.op == "char_length":
            lut = [len(v) for v in d.values]
        else:
            lut = [ord(v[0]) if v else 0 for v in d.values]
        return B.dict_ilut(col, np.asarray(lut if lut else [0], np.int64),
                           e.dtype)
    if e.op in ("locate", "instr"):
        if e.op == "locate":
            sub, col = args[0], args[1]
            pos = _const_scalar(args[2]) if len(args) > 2 else 1
        else:
            col, sub = args[0], args[1]
            pos = 1
        d = _dict_for(col, dicts)
        needle = _const_scalar(sub)
        if d is None or needle is None or not isinstance(pos, int):
            return None
        if pos < 1:                 # MySQL: LOCATE(.., pos < 1) is 0
            return Const(e.dtype, 0)
        start = int(pos) - 1
        lut = [v.find(str(needle), start) + 1 for v in d.values]
        return B.dict_ilut(col, np.asarray(lut if lut else [0], np.int64),
                           e.dtype)
    if e.op == "crc32":
        import zlib
        col = args[0]
        d = _dict_for(col, dicts)
        if d is None:
            return None
        lut = [zlib.crc32(v.encode()) for v in d.values]
        return B.dict_ilut(col, np.asarray(lut if lut else [0], np.int64),
                           e.dtype)
    if e.op == "strcmp":
        # one side a dict column, the other a string constant (binary
        # byte order, like the reference's strcmp over binary collation)
        for ci, flip in ((0, 1), (1, -1)):
            d = _dict_for(args[ci], dicts)
            s = _const_str(args[1 - ci])
            if d is not None and s is not None:
                lut = [flip * ((v > s) - (v < s)) for v in d.values]
                return B.dict_ilut(
                    args[ci], np.asarray(lut if lut else [0], np.int64),
                    e.dtype)
        return None
    if e.op == "find_in_set":
        def fis(needle: str, lst: str) -> int:
            # MySQL: empty LIST never matches, but an empty NEEDLE does
            # match an empty element ('a,,b' position 2)
            if lst == "":
                return 0
            parts = lst.split(",")
            return parts.index(needle) + 1 if needle in parts else 0

        needle_c, lst_c = _const_scalar(args[0]), _const_scalar(args[1])
        d0 = _dict_for(args[0], dicts)
        d1 = _dict_for(args[1], dicts)
        if d0 is not None and lst_c is not None:
            lut = [fis(v, str(lst_c)) for v in d0.values]
            return B.dict_ilut(args[0],
                               np.asarray(lut or [0], np.int64), e.dtype)
        if d1 is not None and needle_c is not None:
            lut = [fis(str(needle_c), v) for v in d1.values]
            return B.dict_ilut(args[1],
                               np.asarray(lut or [0], np.int64), e.dtype)
        return None
    if e.op in ("bit_length", "inet_aton", "regexp_like",
                "regexp_instr", "json_depth", "json_contains_path",
                "json_storage_size", "json_overlaps", "is_uuid", "ord"):
        col = args[0]
        d = _dict_for(col, dicts)
        if d is None:
            return None
        consts = [_const_scalar(a) for a in args[1:]]
        if any(c is None for c in consts):
            return None
        fn = _str_int_impl(e.op, consts)
        if fn is None:
            return None
        vals = [fn(v) for v in d.values]
        return _derived_ilut_nullable(e.dtype, col, vals)
    if e.op in ("json_valid", "json_length", "json_contains"):
        from ..utils import jsonfns
        col = args[0]
        d = _dict_for(col, dicts)
        if d is None:
            return None
        consts = [_const_scalar(a) for a in args[1:]]
        if any(c is None for c in consts):
            return None
        if e.op == "json_valid":
            vals = [jsonfns.valid(v) for v in d.values]
        elif e.op == "json_length":
            path = str(consts[0]) if consts else "$"
            vals = [jsonfns.jlength(v, path) for v in d.values]
        else:
            cand = str(consts[0])
            path = str(consts[1]) if len(consts) > 1 else "$"
            vals = [jsonfns.contains(v, cand, path) for v in d.values]
        return _derived_ilut_nullable(e.dtype, col, vals)
    return None


def _lower_cmp(dtype: dt.DataType, op: str, col: Expr, s: str, d: StringDict) -> Expr:
    ic = lambda code: Const(dt.bigint(False), int(code))
    if op == "eq":
        return Func(dtype, "eq", (col, ic(d.code_of(s))))
    if op == "ne":
        return Func(dtype, "ne", (col, ic(d.code_of(s))))
    if op == "lt":
        return Func(dtype, "lt", (col, ic(d.lower_bound(s))))
    if op == "le":
        return Func(dtype, "lt", (col, ic(d.upper_bound(s))))
    if op == "gt":
        return Func(dtype, "ge", (col, ic(d.upper_bound(s))))
    if op == "ge":
        return Func(dtype, "ge", (col, ic(d.lower_bound(s))))
    raise AssertionError(op)


__all__ = ["lower_strings", "like_to_regex", "expr_out_dict"]

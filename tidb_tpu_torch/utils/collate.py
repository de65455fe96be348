# ported from tidb_tpu/utils/collate.py @ 9d319cb
"""Collation sortkeys + rank LUTs over string dictionaries.

Reference analog: pkg/util/collate (20.5k LoC of per-collation Compare/Key
implementations).  The TPU redesign needs none of the per-row compare code:
strings are dictionary codes, so a collation becomes ONE host-side pass
over the (small) dictionary producing an int rank LUT — device compares
stay integer compares, exactly like the binary path (SURVEY.md §7).

The registry mirrors the reference's collation matrix
(pkg/util/collate/collate.go newCollationEnabled set):

============================  ====  ======  ======  ==========
collation                     case  accent  pad     expansion
============================  ====  ======  ======  ==========
*_bin / binary                 yes   yes    PAD*     —
utf8mb4_general_ci             no    no     PAD      per-char (ß='s')
utf8mb4_unicode_ci / 520_ci    no    no     PAD      full (ß='ss')
utf8mb4_0900_ai_ci             no    no     NO PAD   full (ß='ss')
utf8mb4_0900_as_ci             no    yes    NO PAD   —
utf8mb4_0900_as_cs/_bin        yes   yes    NO PAD   —
latin1_swedish_ci etc.         no    no     PAD      per-char
============================  ====  ======  ======  ==========

(*) binary collations compare raw bytes; PAD is irrelevant.
"""

from __future__ import annotations

import unicodedata
from bisect import bisect_left, bisect_right
from dataclasses import dataclass

import numpy as np

from ..chunk.column import StringDict

BINARY = ("binary", "utf8mb4_bin", "utf8_bin", "latin1_bin", "ascii_bin",
          "utf8mb4_0900_bin", "utf8mb4_0900_as_cs")


@dataclass(frozen=True)
class CollationSpec:
    name: str
    charset: str
    binary: bool = False       # raw code order (case+accent sensitive)
    accent_ci: bool = True     # strip accents (NFKD, drop combining)
    pad: bool = True           # PAD SPACE (trailing spaces ignored)
    expand: bool = True        # full casefold (ß -> ss); else per-char
    is_default: bool = False


def _c(name, charset, **kw):
    return CollationSpec(name, charset, **kw)


COLLATIONS: dict[str, CollationSpec] = {c.name: c for c in [
    _c("binary", "binary", binary=True, pad=False, is_default=True),
    _c("utf8mb4_bin", "utf8mb4", binary=True, is_default=True),
    _c("utf8_bin", "utf8", binary=True, is_default=True),
    _c("latin1_bin", "latin1", binary=True),
    _c("ascii_bin", "ascii", binary=True, is_default=True),
    _c("utf8mb4_general_ci", "utf8mb4", expand=False),
    _c("utf8_general_ci", "utf8", expand=False),
    _c("utf8mb4_unicode_ci", "utf8mb4"),
    _c("utf8_unicode_ci", "utf8"),
    _c("utf8mb4_unicode_520_ci", "utf8mb4"),
    _c("utf8mb4_0900_ai_ci", "utf8mb4", pad=False),
    _c("utf8mb4_0900_as_ci", "utf8mb4", accent_ci=False, pad=False,
       expand=False),
    _c("utf8mb4_0900_as_cs", "utf8mb4", binary=True, pad=False),
    _c("utf8mb4_0900_bin", "utf8mb4", binary=True, pad=False),
    _c("latin1_swedish_ci", "latin1", expand=False, is_default=True),
    _c("ascii_general_ci", "ascii", expand=False),
    _c("gbk_bin", "gbk", binary=True),
    _c("gbk_chinese_ci", "gbk", expand=False),
]}


def spec_of(name: str) -> CollationSpec:
    got = COLLATIONS.get(name)
    if got is not None:
        return got
    # unknown names: _bin/_cs suffixes behave binary, _ci case-fold —
    # tolerant like the reference's fallback to binary collator
    if name.endswith("_ci"):
        return CollationSpec(name, "utf8mb4", expand=False)
    return CollationSpec(name, "utf8mb4", binary=True)


def is_binary(name: str) -> bool:
    return spec_of(name).binary


def _strip_accents(s: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFKD", s)
                   if not unicodedata.combining(c))


def _fold_per_char(s: str) -> str:
    """general_ci-style single-weight fold: each character maps to ONE
    weight (the first char of its uppercase form), so 'ß' folds to 'S'
    ('ß'='s' under general_ci, != 'ss' — MySQL's documented quirk)."""
    out = []
    for ch in s:
        u = ch.upper()
        out.append(u[0] if u else ch)
    return "".join(out)


def sortkey(s: str, collation: str) -> str:
    """Collation sort key: equal keys collate equal; key order == collation
    order (codec.Key analog, computed per dictionary value not per row)."""
    spec = spec_of(collation)
    if spec.binary:
        return s
    if spec.pad:
        s = s.rstrip(" ")                  # PAD SPACE
    if spec.accent_ci:
        s = _strip_accents(s)
    return s.casefold() if spec.expand else _fold_per_char(s).lower()


class RankTable:
    """Dense ranks of a dictionary's values under a collation: codes with
    equal sortkeys share a rank, rank order == collation order."""

    def __init__(self, d: StringDict, collation: str):
        self.collation = collation
        keys = [sortkey(v, collation) for v in d.values]
        self.sorted_keys = sorted(set(keys))
        idx = {k: i for i, k in enumerate(self.sorted_keys)}
        self.ranks = (np.fromiter((idx[k] for k in keys), np.int32,
                                  count=len(keys))
                      if keys else np.zeros(1, np.int32))

    def rank_of(self, s: str) -> int:
        """Exact rank of a literal's sortkey, or -1 if absent."""
        k = sortkey(s, self.collation)
        i = bisect_left(self.sorted_keys, k)
        if i < len(self.sorted_keys) and self.sorted_keys[i] == k:
            return i
        return -1

    def lower_bound(self, s: str) -> int:
        return bisect_left(self.sorted_keys, sortkey(s, self.collation))

    def upper_bound(self, s: str) -> int:
        return bisect_right(self.sorted_keys, sortkey(s, self.collation))


def rank_table(d: StringDict, collation: str) -> "RankTable":
    """Per-dictionary cached RankTable (dictionaries are immutable and
    shared across chunks; streaming paths ask per chunk per key)."""
    rt = d._rank_cache.get(collation)
    if rt is None:
        rt = d._rank_cache[collation] = RankTable(d, collation)
    return rt


def like_key(s: str, collation: str) -> str:
    """LIKE-compare normalization: MySQL LIKE is character-wise with NO
    pad-space (unlike ordinary ci compares), so only casefold — never
    rstrip, and no NFKD expansion (it would change `_` wildcard widths)."""
    if is_binary(collation):
        return s
    return s.casefold()


def merged_rank_maps(da: StringDict, db: StringDict, collation: str):
    """Rank maps for two dictionaries into one shared collation-rank
    space (cross-dictionary ci compares/joins)."""
    ka = [sortkey(v, collation) for v in da.values]
    kb = [sortkey(v, collation) for v in db.values]
    merged = sorted(set(ka) | set(kb))
    idx = {k: i for i, k in enumerate(merged)}
    ma = (np.fromiter((idx[k] for k in ka), np.int32, count=len(ka))
          if ka else np.zeros(1, np.int32))
    mb = (np.fromiter((idx[k] for k in kb), np.int32, count=len(kb))
          if kb else np.zeros(1, np.int32))
    return ma, mb


CHARSET_MAXLEN = {"utf8mb4": 4, "utf8": 3, "latin1": 1, "ascii": 1,
                  "binary": 1, "gbk": 2}


def all_collations() -> list[CollationSpec]:
    """SHOW COLLATION / information_schema.collations rows."""
    return list(COLLATIONS.values())


def collation_rows() -> list[tuple]:
    """(name, charset, id, default, compiled, sortlen, pad) — the ONE
    row builder behind SHOW COLLATION and information_schema.COLLATIONS."""
    return [(c.name, c.charset, i + 1, "Yes" if c.is_default else "",
             "Yes", 1, "PAD SPACE" if c.pad else "NO PAD")
            for i, c in enumerate(sorted(all_collations(),
                                         key=lambda c: c.name))]


def charset_rows() -> list[tuple]:
    """(charset, default_collation, description, maxlen) — behind SHOW
    CHARACTER SET and information_schema.CHARACTER_SETS."""
    seen: dict[str, str] = {}
    for c in sorted(all_collations(), key=lambda c: c.name):
        if c.charset not in seen or c.is_default:
            seen[c.charset] = c.name
    return [(cs, dflt, f"{cs} charset", CHARSET_MAXLEN.get(cs, 4))
            for cs, dflt in sorted(seen.items())]


__all__ = ["sortkey", "is_binary", "RankTable", "rank_table", "like_key",
           "merged_rank_maps", "CollationSpec", "COLLATIONS", "spec_of",
           "all_collations", "collation_rows", "charset_rows",
           "CHARSET_MAXLEN"]

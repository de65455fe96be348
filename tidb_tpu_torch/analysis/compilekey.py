# ported from tidb_tpu/analysis/compilekey.py @ 6298005
"""copforge key derivation: restart-stable program variant keys.

Reference analog: the digest-keyed persisted-executable pattern of
compiler-first serving engines (PAPERS.md: Flare keeps compilation off
the hot path; the O(1)-caching inference stack keys persisted
executables by a content digest).  ``copr.dag.dag_digest`` is ``hash()``
of a frozen dataclass tree — perfect for the in-process jit cache, but
Python salts string hashes per process, so that digest DIES with the
process.  A compiled executable persisted across restarts needs a key
every field of which is derivable from content alone.

This module lives next to ``lifetime.py`` deliberately: the DonationPlan
is part of the variant key BY CONSTRUCTION (``variant_key`` derives the
donation signature itself from the dag + program shape), so a donating
and a non-donating build of the same plan can never collide in the
persistent cache — jax bakes input aliasing into the executable, and
loading the wrong variant would delete the caller's arrays.

Key anatomy (every part checked again at load time — a stale or
mismatched entry is rejected, never silently deserialized):

- ``digest``        restart-stable sha256 of the canonical dag encoding
- ``family``        same, with regrow capacities (group_capacity /
                    num_buckets / join out_capacity) zeroed — the warm
                    pool's capacity-reuse index
- ``mesh_fp``       axis names + shape + device ids (sched/task
                    fingerprint, hashed)
- ``capacity_sig``  program shape class: builder kind, row capacity,
                    batch slot count
- ``donation_sig``  DonationPlan slot classes + donate_argnums actually
                    baked into the executable
- ``backend_fp``    jax/jaxlib versions + platform + device kind +
                    device count (an XLA upgrade invalidates everything)
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..copr import dag as D

# fields that only size regrow loops: two dags differing ONLY here run
# the same plan family, so the client's paging/regrow re-entry can round
# up to a capacity the warm pool already holds
_CAPACITY_FIELDS = ("group_capacity", "num_buckets", "out_capacity")


def _encode(obj, h, skip_capacity: bool) -> None:
    """Feed one canonical byte stream per value into hasher ``h``.
    Deterministic across processes: no ``id()``, no ``hash()``, no
    unsorted dict iteration — the TPU-DIGEST discipline."""
    if obj is None:
        h.update(b"N")
    elif isinstance(obj, bool):
        h.update(b"b1" if obj else b"b0")
    elif isinstance(obj, int):
        h.update(b"i" + str(obj).encode())
    elif isinstance(obj, float):
        h.update(b"f" + repr(obj).encode())
    elif isinstance(obj, str):
        h.update(b"s" + obj.encode("utf-8", "surrogatepass"))
    elif isinstance(obj, bytes):
        h.update(b"y" + obj)
    elif isinstance(obj, enum.Enum):
        h.update(b"e" + type(obj).__name__.encode())
        _encode(obj.value, h, skip_capacity)
    elif isinstance(obj, np.ndarray):
        h.update(b"a" + str(obj.shape).encode() + obj.dtype.str.encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, np.generic):
        h.update(b"g" + obj.dtype.str.encode() + obj.tobytes())
    elif isinstance(obj, (tuple, list)):
        h.update(b"t" + str(len(obj)).encode())
        for v in obj:
            _encode(v, h, skip_capacity)
    elif isinstance(obj, (set, frozenset)):
        h.update(b"S")
        for v in sorted(repr(x) for x in obj):
            h.update(v.encode())
    elif dataclasses.is_dataclass(obj):
        h.update(b"d" + type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            if skip_capacity and f.name in _CAPACITY_FIELDS:
                continue
            h.update(b"." + f.name.encode())
            _encode(getattr(obj, f.name), h, skip_capacity)
    else:
        # last resort (plain value objects): repr is assumed canonical
        h.update(b"r" + repr(obj).encode())


@functools.lru_cache(maxsize=2048)
def stable_digest(dag: D.CopNode) -> str:
    """Restart-stable content digest of a cop DAG (hex, 16 chars) —
    the persistent twin of ``copr.dag.dag_digest``."""
    h = hashlib.sha256()
    _encode(dag, h, skip_capacity=False)
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=2048)
def family_digest(dag: D.CopNode) -> str:
    """Digest with regrow capacities zeroed: every capacity variant of
    one plan shares a family, so the client can prefer a capacity the
    warm pool already compiled over the minimal pow2 regrow step."""
    h = hashlib.sha256()
    _encode(dag, h, skip_capacity=True)
    return h.hexdigest()[:16]


__all__ = ["stable_digest", "family_digest"]

# ported from tidb_tpu/analysis/compilekey.py @ 02e96d8
"""copforge key derivation: restart-stable program variant keys.

Reference analog: the digest-keyed persisted-executable pattern of
compiler-first serving engines (PAPERS.md: Flare keeps compilation off
the hot path; the O(1)-caching inference stack keys persisted
executables by a content digest).  ``copr.dag.dag_digest`` is ``hash()``
of a frozen dataclass tree — perfect for the in-process jit cache, but
Python salts string hashes per process, so that digest DIES with the
process.  A compiled executable persisted across restarts needs a key
every field of which is derivable from content alone.

Key anatomy (the port's program cache, compilecache/, memoizes its
program objects under it and persists its parts in the warm manifest):

- ``digest``        restart-stable sha256 of the canonical dag encoding
- ``family``        same, with regrow capacities (group_capacity /
                    num_buckets / join out_capacity) zeroed — the warm
                    pool's capacity-reuse index
- ``mesh_fp``       the device tuple's fingerprint (type, index, count
                    of logical devices: sched/task), hashed
- ``capacity_sig``  program shape class: builder kind, row capacity,
                    batch slot count, program knobs outside the dag
- ``donation_sig``  DonationPlan slot classes + the donate_argnums the
                    program applies (analysis/lifetime), so a donating
                    and a non-donating program of one plan never share
                    a key
- ``backend_fp``    torch version + device type and CUDA capability +
                    logical device count + a hash of the kernel sources
                    under ``copr/cuda/`` (a kernel edit invalidates every
                    manifest entry)
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

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


@functools.lru_cache(maxsize=64)
def mesh_fingerprint_hex(devices) -> str:
    """Hashed form of the device tuple's fingerprint (sched/task
    ``mesh_fingerprint``): equal across rebuilt tuples and restarts."""
    if devices is None:
        return "nomesh"
    from ..sched.task import mesh_fingerprint
    return hashlib.sha256(
        repr(mesh_fingerprint(devices)).encode()).hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def _kernel_sources_hash() -> str:
    """sha256 over the kernel sources and headers under ``copr/cuda/``."""
    h = hashlib.sha256()
    src = Path(__file__).resolve().parents[1] / "copr" / "cuda"
    for f in sorted(src.glob("*.cu")) + sorted(src.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=16)
def _backend_fp(dev_type: str, dev_index, n: int) -> str:
    import torch
    cap = ""
    if dev_type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev_index or 0)
        cap = f"sm_{major}{minor}"
    return "/".join((torch.__version__, dev_type, cap, str(n),
                     _kernel_sources_hash()))


def backend_fingerprint(devices=None) -> str:
    """torch version + device type and CUDA capability + logical device
    count + the kernel sources' hash: a torch upgrade, another card or a
    kernel edit invalidates every persisted manifest entry."""
    if not devices:
        return _backend_fp("cpu", None, 1)
    d0 = devices[0]
    return _backend_fp(d0.type, d0.index, len(devices))


@dataclass(frozen=True)
class CompileKey:
    """Builder-level variant key of one cacheable device program."""
    digest: str          # stable dag digest
    family: str          # capacity-stripped digest (warm-capacity index)
    mesh_fp: str
    capacity_sig: str    # program kind / row capacity / slot count
    donation_sig: str    # DonationPlan classes + applied donate_argnums
    backend_fp: str
    capacity: int = 0    # regrow knob value (family capacity index)

    def parts(self) -> dict:
        """The fields the manifest records and re-verifies on a read."""
        return {"digest": self.digest, "family": self.family,
                "mesh_fp": self.mesh_fp,
                "capacity_sig": self.capacity_sig,
                "donation_sig": self.donation_sig,
                "backend_fp": self.backend_fp,
                "capacity": self.capacity}

    def entry_hex(self, shape_sig: str = "") -> str:
        """Identity of ONE program object.  The port's programs take any
        input shape, so ``shape_sig`` is empty (the JAX package appends
        the concrete call signature of a compiled executable)."""
        h = hashlib.sha256()
        for part in (self.digest, self.family, self.mesh_fp,
                     self.capacity_sig, self.donation_sig,
                     self.backend_fp, shape_sig):
            h.update(part.encode())
            h.update(b"|")
        return h.hexdigest()[:32]


def variant_key(dag: D.CopNode, devices, program: str,
                row_capacity: int = 0, n_slots: int = 0,
                donate_argnums: Tuple[int, ...] = (),
                extra: Tuple = ()) -> CompileKey:
    """The persistent variant key of one spmd program kind.  The
    donation signature comes from the DAG's own DonationPlan — callers
    cannot omit it, so the donating variant keys apart by construction.
    ``extra`` carries program knobs outside the dag (fused-rows member
    capacities)."""
    from .lifetime import donation_plan
    plan = donation_plan(dag, program)
    donation_sig = (f"{plan.describe()}|argnums="
                    f"{tuple(int(a) for a in donate_argnums)}")
    if isinstance(dag, D.Aggregation):
        capacity = dag.state_capacity or 0
    elif isinstance(dag, D.FusedDag):
        capacity = 0
    else:
        capacity = int(row_capacity)
    cap_sig = (f"{program}/rc={int(row_capacity)}/k={int(n_slots)}"
               f"/x={tuple(extra)}")
    return CompileKey(digest=stable_digest(dag), family=family_digest(dag),
                      mesh_fp=mesh_fingerprint_hex(devices),
                      capacity_sig=cap_sig, donation_sig=donation_sig,
                      backend_fp=backend_fingerprint(devices),
                      capacity=capacity)


__all__ = ["CompileKey", "stable_digest", "family_digest",
           "mesh_fingerprint_hex", "backend_fingerprint", "variant_key"]

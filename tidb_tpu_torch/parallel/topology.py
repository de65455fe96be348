# ported from tidb_tpu/parallel/topology.py @ 6298005
"""Mesh topology as typed links: intra-chip, same-host ICI, cross-host DCI.

In the port the byte counts by link class that copcost and shardflow
reach are copied (``TransferBreakdown``, ``MeshTopology``,
``topology_for``, ``single_host``) with the declared host view
(``set_host_view``, ``host_view``: the ``tidb_tpu_topology_hosts``
sysvar); there are no rates here.  For the port the classes
mean: ``intra`` the bytes that stay on one card (its logical devices
share it, so an exchange between them is a copy in its memory) or cross
PCIe between host and card; ``ici`` the bytes between cards of one host
(NVLink); ``dci`` the bytes between hosts.  The port runs on one card
today (ROADMAP.md, Queue 1 entry 9), where its logical devices are
still priced as the JAX package prices its devices, so that every
``LaunchCost`` equals the reference's.

Reference analog: TiFlash's MPP exchange discipline prices an exchange by
where its bytes travel — intra-node shuffle (executor/shuffle.go) is not
the same resource as the gRPC streams between nodes
(physical_exchange_sender.go).  On a TPU pod the same three-tier split
exists in hardware: on-chip HBM traffic, the inter-chip ICI mesh inside
one host's tray, and the data-center network (DCI/DCN) between hosts —
each roughly an order of magnitude scarcer than the last.

This module is the STATIC half of pod-scale exchange awareness
(DrJAX's cost-transparent mapped primitives are the reference for
keeping the decomposition visible to analysis): it models the mesh as a
``MeshTopology`` derived from metadata alone — axis names, device count,
and a declared host axis — and classifies collective traffic per link
class WITHOUT touching a device.  The abstract interpreter
(analysis/shardflow) and the cost model (analysis/copcost) consume it to
verify collectives and roll transfer bytes up per link class pre-trace.

Deliberately jax-free (the copcost/contracts discipline): everything here
is pure arithmetic over ints and names, so the analysis gate and sched
admission can price topologies that do not exist on this machine — the
``(host=2, device=4)`` reshaped view of the 8-vdev CPU mesh is how tier-1
exercises the DCI tier without a second host.

Host blocking is contiguous (jax.devices() orders devices host-major
under jax.distributed): device d lives on host ``d // devices_per_host``.
Single-host meshes degenerate cleanly: every cross-device byte is ICI,
DCI is identically zero.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Tuple

# the data-parallel scan/exchange axis every SPMD program shards over.
# mesh.py re-exports this; traced modules must reference the symbol, not
# a string literal (lint rule TPU-SHARD-CONST) so a topology rename
# cannot silently desynchronize programs from the analysis.
SHARD_AXIS = "shard"
# the declared host dimension of a reshaped multi-host view: a
# (host=H, device=D/H) factorization of the flat shard axis.  Purely a
# topology-view name — programs keep collecting over SHARD_AXIS; the
# view only changes how the bytes CLASSIFY.
HOST_AXIS = "host"

LINK_INTRA = "intra"     # on-chip / host<->device (PCIe) local traffic
LINK_ICI = "ici"         # same-host inter-chip interconnect
LINK_DCI = "dci"         # cross-host data-center interconnect

LINK_CLASSES = (LINK_INTRA, LINK_ICI, LINK_DCI)

# host-merge routing disciplines the static analysis understands: the
# planned multi-host discipline routes each host's device states to that
# host ("per_host"); funneling every device's states through ONE
# coordinator host is the anti-pattern shardflow rejects on multi-host
# topologies (SHARD-MERGE-COORDINATOR).
MERGE_PER_HOST = "per_host"
MERGE_COORDINATOR = "coordinator"


def _as_int(v) -> int:
    """Narrow host metadata (device counts, sysvar values, np ints) to
    a plain int — this module is listed TRACED for lint purposes but
    never sees a tracer, so the one concretization lives here."""
    return int(v)        # planlint: ok - host metadata, never a tracer


@dataclass(frozen=True)
class TransferBreakdown:
    """Bytes of one launch (or one collective edge) per link class.

    ``intra`` carries host<->device transfer (the PCIe/H2D/D2H bytes the
    legacy ``LaunchCost.transfer_bytes`` already prices) plus any
    same-chip copies; ``ici``/``dci`` carry the inter-chip collective
    payload split by whether the (src, dst) pair shares a host."""
    intra: int = 0
    ici: int = 0
    dci: int = 0

    @property
    def total(self) -> int:
        return self.intra + self.ici + self.dci

    @property
    def collective(self) -> int:
        """Bytes that actually cross a chip boundary."""
        return self.ici + self.dci

    def combined(self, other: "TransferBreakdown") -> "TransferBreakdown":
        return TransferBreakdown(self.intra + other.intra,
                                 self.ici + other.ici,
                                 self.dci + other.dci)

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.intra, self.ici, self.dci)

    def as_dict(self) -> dict:
        return {LINK_INTRA: self.intra, LINK_ICI: self.ici,
                LINK_DCI: self.dci}

    @staticmethod
    def from_tuple(t) -> "TransferBreakdown":
        if not t:
            return TransferBreakdown()
        return TransferBreakdown(_as_int(t[0]), _as_int(t[1]),
                                 _as_int(t[2]))


@dataclass(frozen=True)
class MeshTopology:
    """Typed-link view of one device mesh.

    ``axis_names`` are the PROGRAM-visible mesh axes (what collectives
    name); ``n_hosts`` is the declared host factorization of the flat
    device space.  The reshaped multi-host view never renames the
    program axes — a (host=2, device=4) view of an 8-device 'shard'
    mesh still runs collectives over 'shard'; the view decides only
    which hops of those collectives cross DCI."""
    axis_names: Tuple[str, ...]
    n_devices: int
    n_hosts: int = 1

    def __post_init__(self):
        if self.n_devices <= 0:
            raise ValueError(f"n_devices {self.n_devices} must be positive")
        if self.n_hosts <= 0:
            raise ValueError(f"n_hosts {self.n_hosts} must be positive")
        if self.n_devices % self.n_hosts != 0:
            # the all_to_all split/concat discipline requires the host
            # blocking to divide the device space evenly — an uneven
            # factorization would mis-route whole buckets
            raise ValueError(
                f"{self.n_devices} devices do not divide over "
                f"{self.n_hosts} hosts: the (host, device) view must "
                "factor the shard axis evenly")

    # ------------------------------------------------------------- #
    # structure
    # ------------------------------------------------------------- #

    @property
    def devices_per_host(self) -> int:
        return self.n_devices // self.n_hosts

    @property
    def multi_host(self) -> bool:
        return self.n_hosts > 1

    def has_axis(self, name: str) -> bool:
        return name in self.axis_names

    def host_of(self, device: int) -> int:
        """Host owning device ``device`` under contiguous blocking."""
        return device // self.devices_per_host

    def link_of(self, src: int, dst: int) -> str:
        """Link class one byte travels from device ``src`` to ``dst``."""
        if src == dst:
            return LINK_INTRA
        if self.host_of(src) == self.host_of(dst):
            return LINK_ICI
        return LINK_DCI

    # ------------------------------------------------------------- #
    # collective classification (uniform traffic models)
    # ------------------------------------------------------------- #

    def split_all_to_all(self, bucket_bytes: int) -> TransferBreakdown:
        """One all_to_all exchange where every device sends a
        ``bucket_bytes`` bucket to every destination (the hash-partition
        exchange of parallel/exchange.py): each device keeps its own
        bucket on-chip, ships ``devices_per_host - 1`` buckets over ICI
        and the rest over DCI.  Totals cover the whole mesh."""
        d, dph = self.n_devices, self.devices_per_host
        b = max(_as_int(bucket_bytes), 0)
        return TransferBreakdown(
            intra=d * b,
            ici=d * (dph - 1) * b,
            dci=d * (d - dph) * b)

    def split_all_gather(self, shard_bytes: int) -> TransferBreakdown:
        """One all_gather of a per-device ``shard_bytes`` shard (the
        broadcast exchange): every device's shard travels to each of its
        D-1 peers."""
        d, dph = self.n_devices, self.devices_per_host
        b = max(_as_int(shard_bytes), 0)
        return TransferBreakdown(
            intra=0,
            ici=d * (dph - 1) * b,
            dci=d * (d - dph) * b)

    def split_psum(self, state_bytes: int) -> TransferBreakdown:
        """One psum merge of per-device partial states of
        ``state_bytes`` (the in-program aggregate merge, incl. the
        psum-gather MIN/MAX trick whose slot array replays every
        device's partial to every peer).  Modeled as one gather round —
        the same (src, dst) pair classification as all_gather; real
        all-reduce schedules (ring, tree) move a small constant factor
        of this, which calibration (analysis/calibrate) absorbs per digest."""
        return self.split_all_gather(state_bytes)

    def split_host_merge(self, per_device_bytes: int,
                         route: str = MERGE_PER_HOST) -> TransferBreakdown:
        """Device->host transfer of per-device group tables (the
        SORT/SEGMENT/SCATTER host merge).  ``per_host`` routing pulls
        each host's own devices over PCIe — pure intra bytes, the
        discipline the multi-host runtime must follow.  ``coordinator``
        routing funnels every remote host's states over DCI to one
        merge host — priced here so the analysis can show WHY shardflow
        rejects it on multi-host topologies."""
        d, dph = self.n_devices, self.devices_per_host
        b = max(_as_int(per_device_bytes), 0)
        if route == MERGE_PER_HOST or not self.multi_host:
            return TransferBreakdown(intra=d * b)
        return TransferBreakdown(intra=dph * b, dci=(d - dph) * b)


# --------------------------------------------------------------------- #
# topology derivation: mesh metadata + the declared host view
# --------------------------------------------------------------------- #

# declared host factorization (sysvar tidb_tpu_topology_hosts): lets a
# single-host device list present a multi-host view for analysis — the
# tier-1 seam for the DCI tier.  None = derive from the devices.
_HOST_VIEW: Optional[int] = None
_VIEW_MU = threading.Lock()


def set_host_view(n_hosts: Optional[int]) -> None:
    """Declare the host factorization analysis should assume; None (or
    a non-positive count) reverts to deriving it from the devices."""
    global _HOST_VIEW
    with _VIEW_MU:
        _HOST_VIEW = _as_int(n_hosts) \
            if n_hosts and _as_int(n_hosts) > 0 else None


def host_view() -> Optional[int]:
    with _VIEW_MU:
        return _HOST_VIEW


def _mesh_hosts(_mesh) -> int:
    """Distinct host count of a device list.  The port runs in one
    process, so every ``torch.device`` of it lives on this host (the JAX
    package reads each device's ``process_index``)."""
    return 1


def topology_for(mesh=None, *, n_devices: Optional[int] = None,
                 n_hosts: Optional[int] = None,
                 axis_names: Optional[Tuple[str, ...]] = None
                 ) -> MeshTopology:
    """MeshTopology of a device list (or of explicit metadata when no
    device list is at hand — the gate analyzes topologies this process
    does not own).

    Precedence for the host count: explicit ``n_hosts`` argument, then
    the declared host view (``tidb_tpu_topology_hosts``), then the
    device list's hosts, else 1.  A declared view that does not divide
    the device count falls back to single-host rather than poisoning
    every analysis with a structural error."""
    if mesh is not None and n_devices is None:
        n_devices = len(mesh)
    if axis_names is None:
        axis_names = (SHARD_AXIS,)
    if n_devices is None or n_devices <= 0:
        n_devices = 1
    if n_hosts is None:
        n_hosts = host_view()
    if n_hosts is None:
        n_hosts = _mesh_hosts(mesh) if mesh is not None else 1
    if n_hosts <= 0 or n_devices % n_hosts != 0:
        n_hosts = 1
    return MeshTopology(tuple(axis_names), _as_int(n_devices),
                        _as_int(n_hosts))


def single_host(n_devices: int,
                axis_names: Tuple[str, ...] = (SHARD_AXIS,)) -> MeshTopology:
    """The degenerate all-ICI topology every pre-shardflow analysis
    implicitly assumed."""
    return MeshTopology(tuple(axis_names), max(_as_int(n_devices), 1), 1)


__all__ = ["SHARD_AXIS", "HOST_AXIS", "LINK_INTRA", "LINK_ICI", "LINK_DCI",
           "LINK_CLASSES", "MERGE_PER_HOST", "MERGE_COORDINATOR",
           "TransferBreakdown", "MeshTopology", "topology_for",
           "single_host", "set_host_view", "host_view"]

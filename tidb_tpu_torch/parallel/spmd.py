# ported from tidb_tpu/parallel/spmd.py @ 02e96d8
"""Coprocessor fan-out over the port's devices.

The JAX package runs one ``shard_map`` program over its mesh; the port
runs the same device function once per logical device, each over its
contiguous block of the stacked (S, C) shards, flattened into one batch
of S/D * C rows with a live-row mask.  Of the JAX program kinds these
are the two aggregation kinds and the rows kind:

- ``merge_kind == "psum"`` (SCALAR, DENSE): the devices' partial states
  merge on the card, field by field, as ``psum``/``pmin``/``pmax`` merge
  them over the mesh (``_collective_merge``), and one merged state dict
  comes back;
- ``merge_kind == "host"`` (SORT, SEGMENT, SCATTER): each device
  returns its own group table, stacked along a leading device axis for
  the client's host merge; a device batch past the sort's int32
  permutation (``ops/sort._MAX_ROWS`` rows) runs as consecutive parts
  under it, each part's table one more entry on that axis;
- ``kind == "rows"`` (a root that is not an Aggregation): each device
  runs the DAG and compacts its live rows into ``row_capacity`` slots
  (``copr/exec.compact``); the per-device ``(cols, count)`` come back
  stacked along a leading device axis, for the client's paging loop.

A DAG with a broadcast join (``LookupJoin``) reads its build sides as
``aux_cols`` groups: one copy on the card, read by every logical
device, as the JAX program's replicated ``P()`` input.  A program with
an expanding (m:n) join also returns the devices' extras, ``join_total``
stacked one a device as ``shard_map`` returns it, for the client's
regrow of the join capacity.

Programs are memoized by their restart-stable variant key through the
program cache (compilecache/, analysis/compilekey): ``get_sharded_
program`` and the ``get_*`` functions below return one shared object a
key.  The device scheduler (sched/) launches three more program kinds:

- ``BatchedCopProgram``: K tasks of one SCALAR or DENSE program over
  different snapshots of one shape as ONE call.  ``jax.vmap`` has no
  counterpart over the hand-written kernels, so the K slots run as one
  reduction: the (S, C) inputs stack into (S, K, C) (``_stack_slots``,
  padded to a power-of-two slot count by repeating the last slot), each
  logical device flattens its block into one batch, every row's group
  id is offset by its slot times the plan's group count G (G = 1 for
  SCALAR: copr/exec ``Slots``), and ONE ``group_reduce_lanes`` call a
  logical device reduces every slot's lanes over K·G groups; the states
  merge across the devices, then split (K·G,) -> (K, G) per slot.  The
  limb-exactness fence stays per slot, at one slot's S·C rows.  Only
  chains of row-wise nodes batch (TableScan, Selection, Projection, and
  an Expand under a DENSE rollup, which reduces level by level):
  ``batchable``;
- ``BatchedRowsProgram``: K tasks of one extras-free row chain of
  row-wise nodes, each slot compacted on its own (one cumsum along each
  slot's rows of the (S, K, C) mask), so every waiter's paging loop sees
  its own counts;
- ``FusedCopProgram`` / ``FusedRowsProgram``: N different chains over
  ONE snapshot scan as one program call: each member program runs over
  the same resident tensors (no copy) and the members' states (or rows,
  at per-member capacities) come back one entry a member, for the
  scheduler to demux, with one synchronize for all.  The JAX program's
  XLA common-subexpression elimination of the shared scan and
  predicates across members has no eager counterpart: each member
  evaluates its own chain.

Every program kind carries the DAG's ``DonationPlan``
(analysis/lifetime, ``self.donation``) and derives its
``_donate_argnums`` from it, as the JAX package's programs derive
``donate_argnums``: a solo or fused program donates only when it is
built for launch-unique inputs (``donate=True``, the client's streamed
batches), the batched kinds always donate their fresh slot stacks, and
an explicit override is re-verified (``verify_donation`` raises
``DonationError`` before any launch).  Where XLA aliases a donated input
into an output, a donating port program hands the input's device memory
back to the caching allocator once its kernels are queued
(``release_donated``, after ``record_stream`` on the kernels' stream),
instead of at the end of the caller's batch.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..analysis.lifetime import (ARG_AUX, ARG_COLS, ARG_COUNTS,
                                 donation_plan, verify_donation)
from ..copr import dag as D
from ..copr.aggregate import _MERGE
from ..copr import exec as _exec
from ..copr.exec import (Slots, _ensure_array, _exec_node, _sel_array,
                         agg_states, compact)
from ..ops.sortkeys import as_int64_bits
from ..expr.compile import Evaluator
from ..ops import sort as _sort
from ..types.dtypes import TypeKind as K


def _collective_merge(per_dev: Sequence[dict]) -> dict:
    """Merge the devices' partial-state dicts on the card: sum for the
    count/limb/sum fields, min and max for MIN/MAX (a NaN is kept)."""
    def go(name, arrs):
        g = torch.stack(arrs)
        how = _MERGE[name]
        if how == "sum":
            return g.sum(0, dtype=g.dtype)
        return _exec.minmax(g, how)

    out: dict = {}
    for k, v in per_dev[0].items():
        if isinstance(v, dict):
            out[k] = {f: go(f, [st[k][f] for st in per_dev]) for f in v}
        else:
            out[k] = go(k, [st[k] for st in per_dev])
    return out


def _flatten_block(cols, counts):
    """(S_local, C) blocks -> one (S_local*C,) batch + live-row mask."""
    s, c = cols[0][0].shape
    base_sel = (torch.arange(c, device=counts.device)[None, :]
                < counts[:, None]).reshape(-1)
    flat = [(v.reshape(-1), None if m is None else m.reshape(-1))
            for v, m in cols]
    return flat, base_sel


def _stack(trees: list):
    """Stack per-device outputs (state dicts, or the rows kind's
    ``(cols, count)``) leaf by leaf along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def _donation_argnums(dag, program: str, donate: bool,
                      override) -> tuple:
    """The program-side donation seam: ``donate_argnums`` comes ONLY
    from the DAG's DonationPlan (analysis/lifetime), and any explicit
    override is re-verified before any launch, so a seeded unsafe plan
    raises DonationError before a launch could release an input."""
    if override is not None:
        argnums = tuple(override)
        verify_donation(dag, argnums, program)
        return argnums
    if not donate:
        return ()
    return donation_plan(dag, program).donate_argnums


def release_donated(argnums: tuple, cols, counts, aux=()) -> int:
    """Give the donated inputs of a launch whose kernels are queued back
    to the caching allocator: each tensor is recorded on the current
    (the kernels') stream, so no later allocation reuses its block
    before those kernels end, then its storage shrinks to nothing.  Only
    storage torch owns is released (on the CPU a batch's stacks may be
    numpy's).  Returns the bytes released."""
    tensors = []
    if ARG_COLS in argnums:
        for v, m in cols:
            tensors += [v, m]
    if ARG_COUNTS in argnums:
        tensors.append(counts)
    if ARG_AUX in argnums:
        for grp in aux:
            for v, m in grp:
                tensors += [v, m]
    freed = 0
    seen: set = set()
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        if st.data_ptr() in seen or not st.resizable() or st.nbytes() == 0:
            continue
        seen.add(st.data_ptr())
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))
        freed += st.nbytes()
        st.resize_(0)
    return freed


class ShardedCopProgram:
    """The program over the devices: ``__call__(stacked_cols, counts,
    aux_cols)`` -> the merged partial states (``merge_kind == "psum"``),
    the per-device states with a leading device axis (``merge_kind ==
    "host"``), or for a row-returning DAG (``kind == "rows"``)
    ``([(data (D, cap), valid (D, cap)), ...], count (D,))``; with
    ``has_extras``, ``(that, extras)``, each extra stacked a device."""

    def __init__(self, dag_root: D.CopNode, devices: Sequence[torch.device],
                 row_capacity: int = 0, donate: bool = False,
                 donate_argnums=None):
        self.root = dag_root
        self.row_capacity = row_capacity
        self.agg = dag_root if isinstance(dag_root, D.Aggregation) else None
        self.kind = "agg" if self.agg is not None else "rows"
        self.devices = tuple(devices)
        self.host_merge = (self.agg is not None
                           and self.agg.strategy in D.HOST_MERGE_STRATEGIES)
        self.merge_kind = "host" if self.host_merge else "psum"
        # int/decimal SUMs produce (hi, lo) limb states whose summed merge
        # is int64-exact only below 2^31 global rows; float sums, counts,
        # host-merged (object-int) programs and proven-narrow SUMs (one
        # int64 word, with a whole-table no-wrap proof) are exempt
        self._limb_sums = self.agg is not None and any(
            a.func == D.AggFunc.SUM and a.arg is not None
            and a.arg.dtype.kind not in (K.FLOAT64, K.FLOAT32)
            and i not in self.agg.narrow_sums
            for i, a in enumerate(self.agg.aggs))
        self._psum_limb_fence = self._limb_sums and not self.host_merge
        # a program with an expanding join also returns the devices'
        # extras (the true join output size) for the client's regrow
        self.has_extras = D.find_expand_join(dag_root) is not None
        # buffer donation (analysis/lifetime): the donating variant is
        # built for launch-unique inputs (the streamed path) only, and
        # the plan forbids donation outright for loop-carried regrow
        # programs (rows paging, SORT/SEGMENT regrow, expanding joins)
        self.donation = donation_plan(dag_root, "solo")
        self._donate_argnums = _donation_argnums(
            dag_root, "solo", donate, donate_argnums)

    def _device_fn(self, cols, counts, device, aux):
        """The device's outputs as ``[(out, extras)]``: one entry, or one
        a part of a host-merged batch run in parts."""
        flat, base_sel = _flatten_block(cols, counts)
        flat = [(v, True if m is None else m) for v, m in flat]
        ev = Evaluator(device)
        if self.host_merge:
            runs = [agg_states(self.agg, part, sel, ev, aux)
                    for part, sel in self._row_parts(flat, base_sel)]
            return [(st, batch.extras) for st, batch in runs]
        if self.agg is not None:
            st, batch = agg_states(self.agg, flat, base_sel, ev, aux)
            return [(st, batch.extras)]
        batch = _exec_node(self.root, flat, base_sel, ev, aux)
        return [(compact(batch, self.row_capacity), batch.extras)]

    def _row_parts(self, flat, sel) -> list:
        """A host-merged aggregation's device batch as ``[(cols, sel)]``:
        itself, or past ``ops/sort._MAX_ROWS`` rows consecutive parts
        under it.  The limb SUMs' bound still holds for the whole
        batch, as in the JAX package, whose batch is one sort."""
        n, lim = sel.shape[0], _sort._MAX_ROWS
        if n <= lim:
            return [(flat, sel)]
        if self._limb_sums and n >= _exec.LIMB_SUM_ROWS:
            raise OverflowError(
                f"shard batch of {n} rows exceeds the 2^31 limb-exact "
                "SUM bound; use more/smaller shards")
        return [([(v[lo:lo + lim], m if m is True else m[lo:lo + lim])
                  for v, m in flat], sel[lo:lo + lim])
                for lo in range(0, n, lim)]

    def __call__(self, stacked_cols: Sequence, counts: torch.Tensor,
                 aux_cols: Sequence = ()):
        if self._psum_limb_fence and stacked_cols:
            _limb_fence(*stacked_cols[0][0].shape[:2])
        n_dev = len(self.devices)
        s = counts.shape[0]
        if s % n_dev:
            raise ValueError(f"{s} shards do not split over {n_dev} devices")
        per = s // n_dev
        aux = tuple(tuple((v, True if m is None else m) for v, m in grp)
                    for grp in aux_cols)
        runs = []
        for d, device in enumerate(self.devices):
            blk = slice(d * per, (d + 1) * per)
            cols = [(v[blk], None if m is None else m[blk])
                    for v, m in stacked_cols]
            runs += self._device_fn(cols, counts[blk], device, aux)
        outs = [out for out, _ in runs]
        out = _stack(outs) if self.agg is None or self.host_merge \
            else _collective_merge(outs)
        if self._donate_argnums:
            release_donated(self._donate_argnums, stacked_cols, counts,
                            aux_cols)
        if self.has_extras:
            return out, {k: torch.stack([torch.as_tensor(ex[k])
                                         for _, ex in runs])
                         for k in runs[0][1]}
        return out


def _limb_fence(s: int, c: int) -> None:
    """The limb-exactness fence of the merge: summed (hi, lo) SUM limbs
    stay int64-exact only while the global row capacity is < 2^31 (see
    copr/exec._agg_lanes)."""
    if s * c >= 2 ** 31:
        raise OverflowError(
            f"global capacity {s}x{c} exceeds the 2^31 limb-exact "
            "SUM bound for the merge across devices")


def _resolve(dag, devices, program: str, build, row_capacity: int = 0,
             n_slots: int = 0, extra: tuple = (), donate: bool = False):
    """The program of (dag, devices, kind) through the program cache; a
    donating variant keys apart by its plan's ``donate_argnums``."""
    from ..analysis.compilekey import variant_key
    from ..compilecache import compile_cache
    argnums = _donation_argnums(dag, program, donate, None)
    key = variant_key(dag, devices, program, row_capacity=row_capacity,
                      n_slots=n_slots, donate_argnums=argnums, extra=extra)
    return compile_cache().resolve(key, build)


def get_sharded_program(dag_root: D.CopNode, devices,
                        row_capacity: int = 0,
                        donate: bool = False) -> ShardedCopProgram:
    """The shared ``ShardedCopProgram`` of (dag, devices, row capacity);
    the donating variant (launch-unique inputs) caches apart."""
    devices = tuple(devices)
    donate = True if donate else False
    return _resolve(dag_root, devices, "solo",
                    lambda: ShardedCopProgram(dag_root, devices,
                                              row_capacity, donate),
                    row_capacity=row_capacity, donate=donate)


# --------------------------------------------------------------------- #
# cross-query fusion: N chains over one scan
# --------------------------------------------------------------------- #

class FusedCopProgram:
    """N compatible aggregation chains over ONE shared scan as a single
    program call (the scheduler's fusion seam): ``__call__(cols,
    counts)`` -> one output a member, each as its ``ShardedCopProgram``
    returns it (merged states, or per-device tables for a host-merged
    member).  Members qualify when they are extras-free aggregations (an
    expanding join's regrow loop re-runs programs per task)."""

    def __init__(self, fused: D.FusedDag, devices, donate: bool = False,
                 donate_argnums=None):
        if len(fused.members) < 2:
            raise ValueError("fusion needs at least two member chains")
        self.fused = fused
        self.devices = tuple(devices)
        self.members = tuple(get_sharded_program(m, self.devices)
                             for m in fused.members)
        # donation over the FUSED dag: the plan re-derives from every
        # member (one loop-carried member makes the shared scan
        # loop-carried; a shared aux slot is persistent)
        self.donation = donation_plan(fused, "fused")
        self._donate_argnums = _donation_argnums(
            fused, "fused", donate, donate_argnums)
        for p in self.members:
            if p.kind != "agg" or p.has_extras:
                raise ValueError(
                    "only extras-free agg chains fuse (member "
                    f"{type(p.root).__name__} is {p.kind}"
                    f"{'+extras' if p.has_extras else ''})")

    def __call__(self, stacked_cols: Sequence, counts: torch.Tensor,
                 aux_cols: Sequence = ()) -> tuple:
        outs = tuple(p(stacked_cols, counts, aux_cols)
                     for p in self.members)
        if self._donate_argnums:
            release_donated(self._donate_argnums, stacked_cols, counts,
                            aux_cols)
        return outs


def get_fused_program(fused: D.FusedDag, devices,
                      donate: bool = False) -> FusedCopProgram:
    devices = tuple(devices)
    donate = True if donate else False
    return _resolve(fused, devices, "fused",
                    lambda: FusedCopProgram(fused, devices, donate),
                    donate=donate)


class FusedRowsProgram:
    """N compatible ROW-returning chains over ONE shared scan with
    PER-MEMBER output capacities: each member keeps its own compaction
    buffer and live count, so every waiter's paging loop still sees its
    own counts.  Only extras-free chains qualify."""

    def __init__(self, fused: D.FusedDag, devices, row_capacities: tuple,
                 donate_argnums=None):
        if len(fused.members) < 2:
            raise ValueError("fusion needs at least two member chains")
        if len(row_capacities) != len(fused.members):
            raise ValueError("one row capacity per member chain")
        # per-member paging loops re-feed the shared scan: the plan is
        # loop-carried, so only a (verified) override could donate
        self.donation = donation_plan(fused, "fused-rows")
        self._donate_argnums = _donation_argnums(
            fused, "fused-rows", False, donate_argnums)
        self.fused = fused
        self.devices = tuple(devices)
        self.members = tuple(
            get_sharded_program(m, self.devices, cap)
            for m, cap in zip(fused.members, row_capacities))
        for p in self.members:
            if p.kind != "rows" or p.has_extras:
                raise ValueError(
                    "only extras-free row chains fuse (member "
                    f"{type(p.root).__name__} is {p.kind}"
                    f"{'+extras' if p.has_extras else ''})")

    def __call__(self, stacked_cols: Sequence, counts: torch.Tensor,
                 aux_cols: Sequence = ()) -> tuple:
        return tuple(p(stacked_cols, counts, aux_cols)
                     for p in self.members)


def get_fused_rows_program(fused: D.FusedDag, devices,
                           row_capacities: tuple) -> FusedRowsProgram:
    devices = tuple(devices)
    caps = tuple(int(c) for c in row_capacities)
    return _resolve(fused, devices, "fused-rows",
                    lambda: FusedRowsProgram(fused, devices, caps),
                    extra=caps)


# --------------------------------------------------------------------- #
# batch slots: K tasks of one program over different inputs
# --------------------------------------------------------------------- #

_ROW_WISE = (D.TableScan, D.Selection, D.Projection)


def _row_wise(node: D.CopNode) -> bool:
    return isinstance(node, _ROW_WISE) and all(
        _row_wise(c) for c in node.children())


def batchable(prog: ShardedCopProgram) -> bool:
    """May K tasks of ``prog`` over different inputs run as one batched
    call?  An extras-free SCALAR or DENSE aggregation, or row chain,
    whose nodes all work row by row (a Limit, a TopN, a join or a
    materialized Expand would mix the slots of one flattened batch); a
    DENSE rollup's Expand reduces level by level and batches too."""
    if prog.has_extras:
        return False
    if prog.kind == "rows":
        return _row_wise(prog.root)
    if prog.host_merge:
        return False
    ch = prog.agg.child
    if isinstance(ch, D.Expand) \
            and prog.agg.strategy == D.GroupStrategy.DENSE:
        ch = ch.child
    return _row_wise(ch)


def _pow2_slots(n_slots: int) -> int:
    return max(2, 1 << (n_slots - 1).bit_length())


def _stack_slots(cols_list, counts_list, n_slots):
    """Stack K tasks' (S, C) inputs along a batch-slot dim -> (S, K, C),
    padding short batches by repeating the last slot: one program per
    power-of-two slot count instead of one per K."""
    k = len(cols_list)
    pads = list(cols_list) + [cols_list[-1]] * (n_slots - k)
    cnts = list(counts_list) + [counts_list[-1]] * (n_slots - k)
    stacked = []
    for j in range(len(pads[0])):
        v = torch.stack([c[j][0] for c in pads], dim=1)
        m = None if pads[0][j][1] is None else \
            torch.stack([c[j][1] for c in pads], dim=1)
        stacked.append((v, m))
    return stacked, torch.stack(list(cnts), dim=1)


def _slot_blocks(stacked, counts, devices):
    """Each logical device's (S/D, K, C) block: ``[(cols, counts,
    device)]``."""
    n_dev = len(devices)
    s = counts.shape[0]
    if s % n_dev:
        raise ValueError(f"{s} shards do not split over {n_dev} devices")
    per = s // n_dev
    out = []
    for d, device in enumerate(devices):
        blk = slice(d * per, (d + 1) * per)
        out.append(([(v[blk], None if m is None else m[blk])
                     for v, m in stacked], counts[blk], device))
    return out


def _flatten_slots(cols, counts):
    """(S_local, K, C) blocks -> one (S_local*K*C,) batch, its live-row
    mask and each row's slot id (copr/exec ``Slots``)."""
    s, k, c = cols[0][0].shape
    dev = counts.device
    base_sel = (torch.arange(c, device=dev)[None, None, :]
                < counts[:, :, None]).reshape(-1)
    flat = [(v.reshape(-1), True if m is None else m.reshape(-1))
            for v, m in cols]
    ids = torch.arange(k, dtype=torch.int32, device=dev).view(1, k, 1) \
        .expand(s, k, c).reshape(-1)
    return flat, base_sel, Slots(ids, k)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class BatchedCopProgram:
    """K tasks of one SCALAR or DENSE program over different inputs of
    one shape as ONE call: ``__call__(cols_list, counts_list)`` -> one
    merged state dict a task, each as ``ShardedCopProgram`` returns it
    (the module docstring gives the design: one ``group_reduce_lanes``
    call a logical device over K·G groups)."""

    def __init__(self, dag_root: D.CopNode, devices, n_slots: int,
                 donate: bool = True):
        self.base = get_sharded_program(dag_root, devices)
        if self.base.kind != "agg" or not batchable(self.base):
            raise ValueError("only row-wise SCALAR/DENSE agg plans batch")
        # the (S, K, C) slot stacks are fresh copies built per launch: the
        # lifetime plan donates them unconditionally, K tasks' worth of
        # stacked inputs released at the launch
        self.donation = donation_plan(dag_root, "batched")
        self._donate_argnums = _donation_argnums(
            dag_root, "batched", donate, None)
        self.agg = self.base.agg
        self.devices = self.base.devices
        self.n_slots = n_slots
        self.groups = 1 if self.agg.strategy == D.GroupStrategy.SCALAR \
            else self.agg.num_groups

    def __call__(self, cols_list: Sequence, counts_list: Sequence) -> list:
        k = len(cols_list)
        if self.base._psum_limb_fence and cols_list[0]:
            # per slot, at one slot's global capacity, as the solo run
            _limb_fence(*cols_list[0][0][0].shape[:2])
        stacked, counts = _stack_slots(cols_list, counts_list, self.n_slots)
        outs = []
        for cols, cnt, device in _slot_blocks(stacked, counts,
                                              self.devices):
            flat, base_sel, slots = _flatten_slots(cols, cnt)
            st, _batch = agg_states(self.agg, flat, base_sel,
                                    Evaluator(device), (), slots=slots)
            outs.append(st)
        merged = _collective_merge(outs)
        if self._donate_argnums:
            release_donated(self._donate_argnums, stacked, counts)
        K, G = self.n_slots, self.groups
        if self.agg.strategy == D.GroupStrategy.SCALAR:
            return [_tree_map(lambda t, i=i: t.view(K)[i], merged)
                    for i in range(k)]
        return [_tree_map(lambda t, i=i: t.view(K, G)[i], merged)
                for i in range(k)]


def get_batched_program(dag_root: D.CopNode, devices,
                        n_slots: int) -> BatchedCopProgram:
    devices = tuple(devices)
    n_slots = _pow2_slots(n_slots)
    return _resolve(dag_root, devices, "batched",
                    lambda: BatchedCopProgram(dag_root, devices, n_slots),
                    n_slots=n_slots, donate=True)   # donates the stacks


def _compact_slots(batch, capacity: int, s: int, k: int, c: int):
    """``copr/exec.compact`` of each slot on its own: each slot's live
    rows (in the (shard, row) order of its solo run) packed to the front
    of its own ``capacity`` buffer by one cumsum along the slot's rows;
    ``([(data (K, cap), valid (K, cap)), ...], count (K,))``."""
    n = s * k * c
    dev = batch.cols[0][0].device if batch.cols else None

    def by_slot(t):                 # (S*K*C,) -> (K, S*C)
        return t.reshape(s, k, c).transpose(0, 1).reshape(k, s * c)
    sel = by_slot(_sel_array(batch.sel, n, dev))
    pos = torch.cumsum(sel, 1) - 1
    base = (torch.arange(k, device=dev) * (capacity + 1))[:, None]
    idx = (torch.where(sel & (pos < capacity), pos, capacity)
           + base).reshape(-1)
    out_cols = []
    for v, m in batch.cols:
        v = _ensure_array(v, n, dev)
        if v.dtype == torch.bool:
            v = v.to(torch.int64)
        bits = by_slot(as_int64_bits(v)).reshape(-1)
        data = torch.zeros((k * (capacity + 1),), dtype=bits.dtype,
                           device=dev)
        data.index_put_((idx,), bits)
        valid = torch.zeros((k * (capacity + 1),), dtype=torch.bool,
                            device=dev)
        valid.index_put_((idx,),
                         by_slot(_sel_array(m, n, dev)).reshape(-1))
        out_cols.append(
            (data.view(k, capacity + 1)[:, :capacity].view(v.dtype),
             valid.view(k, capacity + 1)[:, :capacity]))
    return out_cols, sel.sum(1, dtype=torch.int64)


class BatchedRowsProgram:
    """K tasks of one extras-free row chain over different inputs of one
    shape as ONE call: ``__call__(cols_list, counts_list)`` -> one
    ``([(data (D, cap), valid (D, cap)), ...], count (D,))`` a task, as
    ``ShardedCopProgram`` returns it, each slot compacted on its own."""

    def __init__(self, dag_root: D.CopNode, devices, row_capacity: int,
                 n_slots: int, donate: bool = True):
        self.base = get_sharded_program(dag_root, devices, row_capacity)
        if self.base.kind != "rows" or not batchable(self.base):
            raise ValueError("only extras-free row-wise row plans batch")
        # each paging re-entry re-stacks its own members: the stacks die
        # with the launch, never re-read
        self.donation = donation_plan(dag_root, "batched-rows")
        self._donate_argnums = _donation_argnums(
            dag_root, "batched-rows", donate, None)
        self.root = dag_root
        self.devices = self.base.devices
        self.row_capacity = row_capacity
        self.n_slots = n_slots

    def __call__(self, cols_list: Sequence, counts_list: Sequence) -> list:
        k = len(cols_list)
        stacked, counts = _stack_slots(cols_list, counts_list, self.n_slots)
        outs = []
        for cols, cnt, device in _slot_blocks(stacked, counts,
                                              self.devices):
            s_loc, kk, c = cols[0][0].shape
            flat, base_sel, _slots = _flatten_slots(cols, cnt)
            batch = _exec_node(self.root, flat, base_sel,
                               Evaluator(device), ())
            outs.append(_compact_slots(batch, self.row_capacity,
                                       s_loc, kk, c))
        if self._donate_argnums:
            release_donated(self._donate_argnums, stacked, counts)
        out_cols, out_counts = _stack(outs)     # (D, K, cap) / (D, K)
        return [([(v[:, i], m[:, i]) for v, m in out_cols],
                 out_counts[:, i]) for i in range(k)]


def get_batched_rows_program(dag_root: D.CopNode, devices,
                             row_capacity: int,
                             n_slots: int) -> BatchedRowsProgram:
    devices = tuple(devices)
    n_slots = _pow2_slots(n_slots)
    return _resolve(dag_root, devices, "batched-rows",
                    lambda: BatchedRowsProgram(dag_root, devices,
                                               row_capacity, n_slots),
                    row_capacity=row_capacity, n_slots=n_slots, donate=True)


__all__ = ["ShardedCopProgram", "get_sharded_program", "batchable",
           "BatchedCopProgram", "get_batched_program",
           "BatchedRowsProgram", "get_batched_rows_program",
           "FusedCopProgram", "get_fused_program",
           "FusedRowsProgram", "get_fused_rows_program",
           "release_donated"]

# ported from tidb_tpu/parallel/exchange.py @ e08c981
"""MPP exchange operators over the port's logical devices.

The JAX package runs an exchange inside one ``shard_map`` program:
each device buckets its rows by destination into fixed-capacity send
buffers and ``lax.all_to_all`` swaps bucket d of every device to device
d.  The port runs its device function once a logical device
(parallel/spmd.py), and one loop over the devices cannot stop half way
for a collective.  So an exchange is two steps, each over every device:

1. ``send_buckets``: each device's rows into its ``(n_dev, capacity)``
   send buffers (one buffer a column);
2. ``all_to_all``: the devices' buffers stacked as ``(src, dst, cap)``
   and read as ``(dst, src, cap)``, so device d receives bucket d of
   every source, in source order, as ``lax.all_to_all(split_axis=0,
   concat_axis=0)`` delivers it.

``all_to_all_exchange`` runs both over every device and returns what
the JAX function returns on each.  The logical devices share one card,
so step 2 is one copy on it (none for one device); several GPUs would
swap the buffers over NCCL or peer copies (ROADMAP.md, Queue 1 item 4).

A row's position inside its destination bucket is its stable rank among
the rows bound there: the reference takes it from a cumsum over an
``(n, n_dev)`` one-hot; the port takes the same cumsum one destination
at a time (``cumsum(pid == d)``), O(n) memory for any device count and
no host read.  Fixed bucket capacities keep the shapes static; the
largest bucket is returned so the client can regrow and re-run.
Unsent rows park at a sink slot one past the buffer (torch raises on an
out-of-range scatter where XLA drops it).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.sortkeys import as_int64_bits

# Knuth multiplicative hashing over int64 keys: 0x9E3779B97F4A7C15 as
# the int64 of the same bits (an int64 product wraps as the uint64 one)
_HASH_MULT = 0x9E3779B97F4A7C15 - (1 << 64)
_LOW31 = (1 << 31) - 1


def hash_partition_ids(keys: torch.Tensor, n_parts: int) -> torch.Tensor:
    """int64 keys -> partition id in ``[0, n_parts)``: ``(key * M) >> 33``
    in uint64, on the int64 bits (torch has no uint64 ``>>``: an
    arithmetic shift, then the low 31 bits)."""
    h = keys.to(torch.int64) * _HASH_MULT
    return ((h >> 33) & _LOW31) % n_parts


def send_buckets(cols: Sequence, valid, keys: torch.Tensor, n_dev: int,
                 capacity: int):
    """One device's side of a HashPartition exchange: its rows bucketed
    by ``hash_partition_ids(keys)``.  ``cols``: ``[(value, mask |
    True)]``; ``valid``: the rows to send (bool tensor or True).
    Returns ``(send_cols, send_valid, overflow, max_count)``: each
    column as ``(value (n_dev, cap), mask (n_dev, cap) | True)``, the
    sent slots, the rows dropped for capacity and the largest bucket's
    row count (0-d int64 tensors)."""
    n = keys.shape[0]
    dev = keys.device
    if valid is True:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    pid = torch.where(valid, hash_partition_ids(keys, n_dev), n_dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    counts = []
    for d in range(n_dev):
        mine = pid == d
        pos = torch.where(mine, torch.cumsum(mine, 0) - 1, pos)
        counts.append(mine.sum(dtype=torch.int64))
    counts = torch.stack(counts)
    sent = valid & (pos < capacity)
    sink = n_dev * capacity
    flat_idx = torch.where(sent, pid * capacity + pos, sink)

    def scatter(v):
        buf = torch.zeros(sink + 1, dtype=v.dtype, device=dev)
        buf.index_put_((flat_idx,), v)
        return buf[:sink].reshape(n_dev, capacity)

    send_valid = scatter(sent)
    send_cols = [(scatter(as_int64_bits(v)).view(v.dtype),
                  True if m is True else scatter(sent & m)) for v, m in cols]
    overflow = (counts - capacity).clamp(min=0).sum()
    return send_cols, send_valid, overflow, counts.max()


def all_to_all(bufs: Sequence[torch.Tensor]) -> list:
    """Device d's received rows, ``(n_dev * cap,)``: bucket d of every
    source device's ``(n_dev, cap)`` send buffer ``bufs[src]``, in source
    order."""
    if len(bufs) == 1:
        return [bufs[0].reshape(-1)]
    stacked = torch.stack(list(bufs))          # (src, dst, cap)
    return list(stacked.transpose(0, 1).reshape(len(bufs), -1))


def all_to_all_exchange(per_dev: Sequence, n_dev: int, capacity: int):
    """The HashPartition exchange over the logical devices.  ``per_dev``
    holds each device's ``(cols, valid, keys)``; returns each device's
    ``(recv_cols, recv_valid, overflow, max_count)`` as the JAX
    function returns them inside its program: ``n_dev * capacity``
    received rows a column, a column's mask the received validity where
    it was True, the device's own overflow and largest send bucket."""
    sends = [send_buckets(c, v, k, n_dev, capacity) for c, v, k in per_dev]
    recv_valid = all_to_all([s[1] for s in sends])
    recv_cols = []
    for j in range(len(sends[0][0])):
        vals = all_to_all([s[0][j][0] for s in sends])
        if sends[0][0][j][1] is True:
            masks = recv_valid
        else:
            masks = all_to_all([s[0][j][1] for s in sends])
        recv_cols.append(list(zip(vals, masks)))
    return [([col[d] for col in recv_cols], recv_valid[d], s[2], s[3])
            for d, s in enumerate(sends)]


def broadcast_gather(per_dev: Sequence) -> list:
    """Broadcast exchange: every device receives all rows.  ``per_dev``
    holds each device's ``(cols, valid)``; returns the one gathered
    ``(cols, valid)`` every device reads (the devices share the card)."""
    n_cols = len(per_dev[0][0])
    cols = []
    for j in range(n_cols):
        v = torch.cat([c[j][0] for c, _ in per_dev])
        ms = [c[j][1] for c, _ in per_dev]
        cols.append((v, True if all(m is True for m in ms) else torch.cat(
            [torch.ones_like(per_dev[i][0][j][0], dtype=torch.bool)
             if m is True else m for i, m in enumerate(ms)])))
    valid = torch.cat([v for _, v in per_dev])
    return cols, valid


__all__ = ["hash_partition_ids", "send_buckets", "all_to_all",
           "all_to_all_exchange", "broadcast_gather"]

# ported from tidb_tpu/copr/exec.py @ a9e9482
# (only in the port: the stable multi-key sort the JAX package takes from
# lax.sort at tidb_tpu/copr/exec.py:340 and :579, tidb_tpu/copr/segment.py:178)
"""Stable multi-key argsort over int32 and int64 keys.

``stable_argsort(keys)`` returns the int64 permutation that
``lax.sort(tuple(keys) + (arange(n),), num_keys=len(keys))[-1]`` returns:
the rows ordered lexicographically by the keys in priority order, each
compared as a signed integer, ties kept in row order.

It is an LSD radix sort.  Keys go from last to first, each sorted by
its digits from least to most significant with the permutation as the
passes' int32 value, so between keys the next key is gathered by the
current permutation once, not once a pass.  A key's passes are one
onesweep sort (``copr/cuda/onesweep.py``): one histogram of all its
digits in one read, then one stable counting-sort pass a digit whose
tile offsets come from a decoupled look-back, the last pass storing the
permutation only; through the hand-written kernels on a CUDA tensor and
through their plain versions on a CPU tensor (no switch, no fallback).

Digits that are constant over every row are skipped: in unsigned order
(after the sign flip) every value of ``[min, max]`` shares the bits
above the highest bit in which ``min`` and ``max`` differ, so one
``torch.aminmax`` and one host read a key give the passes that can be
skipped.  A 0/1 flag costs one pass, a constant key none; a key of b
significant bits costs ceil(b / 8).

``PASSES["stable_argsort"]`` counts the passes run and
``PASSES["stable_argsort_keys"]`` the keys that had any, on either
device: on a CUDA tensor each such key is one ``radix_hist_all64``
launch and each pass one ``radix_onesweep64`` launch.
``stable_argsort_plain`` is the same sort through the plain 1-bit
passes of ``radix_kernel.counting_sort_pass_plain`` on any device, the
independent on-card reference.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..copr import dag as D

PASSES = {"stable_argsort": 0, "stable_argsort_keys": 0}

_MASK64 = (1 << 64) - 1
_MAX_ROWS = 2 ** 31 - 1        # the permutation rides as int32


def key_passes(lo: int, hi: int) -> int:
    """Counting-sort passes an int64 key with values in ``[lo, hi]``
    needs: its digits up to the highest bit in which ``lo`` and ``hi``
    differ."""
    diff = (lo ^ hi) & _MASK64
    if diff == 0:
        return 0
    return (diff.bit_length() - 1) // D.RADIX_BITS + 1


def plan_passes(keys: Sequence[torch.Tensor]) -> list:
    """Passes of each key, from one ``aminmax`` a key and one host read
    of all of them."""
    if not keys or keys[0].numel() == 0:
        return [0] * len(keys)
    ends = torch.stack([torch.stack(torch.aminmax(k)).to(torch.int64)
                        for k in keys]).cpu().tolist()
    return [key_passes(lo, hi) for lo, hi in ends]


def stable_argsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The int64 permutation that sorts the rows by ``keys`` (1-d int32
    or int64 tensors of one length on one device, in priority order),
    stably: each key one onesweep sort, through the kernels on CUDA and
    their plain versions on the CPU."""
    from ..copr.cuda import onesweep
    return _lsd_argsort(keys, onesweep.onesweep_sort)


def stable_argsort_plain(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The same sort through the plain 1-bit passes on any device (the
    on-card reference of ``stable_argsort``)."""
    from ..copr.cuda import radix_kernel as rk

    def sort_key(k, val, passes, err, wide):
        if val is None:
            val = torch.arange(k.numel(), dtype=torch.int32, device=k.device)
        for p in range(passes):
            k, val = rk.counting_sort_pass_plain(k, val, p * D.RADIX_BITS)
        return val.to(torch.int64) if wide else val
    return _lsd_argsort(keys, sort_key)


def _lsd_argsort(keys, sort_key) -> torch.Tensor:
    """``sort_key(key, val, passes, err, wide)`` returns the int32 values
    (int64 if ``wide``) after ``passes`` stable passes of the int64
    ``key``; ``val`` None stands for the row indices.  The last key
    sorted returns the int64 permutation itself."""
    from ..copr.cuda import radix_kernel as rk
    keys = list(keys)
    if not keys:
        raise ValueError("stable_argsort needs at least one key")
    n, dev = keys[0].numel(), keys[0].device
    for k in keys:
        if k.dim() != 1 or k.numel() != n or k.device != dev:
            raise ValueError("keys must be 1-d tensors of one length on "
                             "one device")
        if k.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"keys must be int32 or int64, got {k.dtype}")
    if n > _MAX_ROWS:
        raise ValueError(f"{n} rows exceed the int32 permutation")
    plan = plan_passes(keys)
    if not any(plan):
        return torch.arange(n, dtype=torch.int64, device=dev)
    last = min(i for i, p in enumerate(plan) if p)   # the last one sorted
    err = rk.new_err(dev) if dev.type == "cuda" else None
    perm = None
    for i in reversed(range(len(keys))):
        if plan[i] == 0:
            continue
        k = (keys[i] if perm is None else keys[i][perm]).to(torch.int64)
        perm = sort_key(k.contiguous(), perm, plan[i], err, i == last)
        PASSES["stable_argsort"] += plan[i]
        PASSES["stable_argsort_keys"] += 1
    if err is not None:
        rk.read_err(err, "stable_argsort")
    return perm


__all__ = ["PASSES", "stable_argsort", "stable_argsort_plain", "plan_passes",
           "key_passes"]

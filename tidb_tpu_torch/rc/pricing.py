# ported from tidb_tpu/rc/pricing.py @ 02e96d8
"""RU pricing: convert a launch's static LaunchCost into request units.

Reference analog: the RU model of pkg/resourcegroup (tikv's
resource_control request-unit coefficients price read bytes + CPU).
Here the priced quantity is DEVICE work, and the static cost model
(analysis/copcost.LaunchCost) supplies it BEFORE any trace: peak
resident HBM bytes, host<->device transfer bytes, and a FLOP estimate —
the linear-algebra view of query cost (LAQP, arXiv:2306.08367) reduced
to three weighted terms.  Pricing therefore happens at ADMISSION, which
is what lets the scheduler drain enforce a group's token bucket before
launching anything (rc/controller).

Fused/coalesced groups price the shared scan once: the lead member pays
full price, each rider sharing the lead's resident scan pays only its
marginal bytes (peak minus the shared input residency — the same
marginal-bytes split the HBM-budget drain cap uses).

Coefficients are module constants (not sysvars): they define the RU
*unit* and changing them re-denominates every bucket in flight.

Closed-loop calibration (copmeter, analysis/calibrate): with
``tidb_tpu_cost_calibration`` on, the LaunchCost a task carries into
``task_rus`` is the CORRECTED one — the scheduler replaces ``task.cost``
at admission with the digest's clamped measured corrections (the static
cost stays on ``task.cost_static``), so pricing self-tunes per digest
without this module changing: the clamp bounds the swing to [1/8, 8]
and ``MIN_TASK_RU`` still floors every task, so calibrated pricing can
never undercut the per-request floor.
"""

from __future__ import annotations

import math
from typing import Optional

# 1 RU per 64 KiB transferred — the reference's read-byte coefficient
# (tikv resource_control: ~64KiB/RU for reads); transfer is the scarce
# PCIe/ICI resource a launch consumes exactly once.
RU_PER_TRANSFER_BYTE = 1.0 / (64 << 10)
# Per-link collective rates (shardflow, parallel/topology): same-host
# ICI collective bytes price like any transfer; cross-host DCI bytes
# are the pod's scarcest resource and price 4x — so admission and
# fairness stay honest when the declared host view splits a mesh
# (ROADMAP: "price cross-host transfer bytes separately from on-chip
# ICI").  The multiplier is a unit definition, not a sysvar, for the
# same re-denomination reason as the base coefficients.
RU_PER_ICI_BYTE = RU_PER_TRANSFER_BYTE
RU_PER_DCI_BYTE = 4.0 * RU_PER_TRANSFER_BYTE
# Residency is cheaper than transfer: the bytes sit in HBM for the
# launch but mostly alias the shared snapshot upload.  1 RU per MiB.
RU_PER_RESIDENT_BYTE = 1.0 / (1 << 20)
# 1 RU per 10 MFLOP: on-chip arithmetic is the cheapest resource.
RU_PER_FLOP = 1.0 / 10e6
# Every admitted task costs at least one RU (the reference's per-request
# floor) so unlimited metadata queries still drain a finite bucket.
MIN_TASK_RU = 1.0


def cost_rus(cost, *, shared_scan: bool = False) -> float:
    """RUs of one launch priced from its LaunchCost.  ``shared_scan``
    prices a rider whose resident scan input is already paid for by the
    launch lead (fusion / in-flight dedup): only its marginal bytes —
    payload, intermediates, outputs — count."""
    resident = cost.peak_hbm_bytes
    transfer = cost.transfer_bytes
    if shared_scan:
        resident = max(resident - cost.input_bytes, 0)
        transfer = max(transfer - cost.input_bytes, 0)
    # per-link collective terms (shardflow): a rider's merge/exchange
    # collectives are its OWN payload, never part of the shared scan,
    # so they price unscaled either way
    ici = getattr(cost, "ici_bytes", 0)
    dci = getattr(cost, "dci_bytes", 0)
    rus = (resident * RU_PER_RESIDENT_BYTE
           + transfer * RU_PER_TRANSFER_BYTE
           + ici * RU_PER_ICI_BYTE
           + dci * RU_PER_DCI_BYTE
           + cost.flops * RU_PER_FLOP)
    if not math.isfinite(rus):
        return float(MIN_TASK_RU)
    return max(float(MIN_TASK_RU), rus)


def task_rus(task, lead=None) -> float:
    """RUs of one CopTask at the drain.  Structured tasks price from
    their admission-time LaunchCost; a rider sharing ``lead``'s input
    token prices at its marginal bytes.  Opaque tasks (shuffle/window
    closures own their capacities) fall back to the legacy row estimate
    — still pre-launch, still floored at one RU."""
    cost = getattr(task, "cost", None)
    if cost is None:
        return max(float(MIN_TASK_RU), task.est_rows / 100.0 + 1.0)
    shared = (lead is not None and lead is not task
              and task.input_token is not None
              and task.input_token == lead.input_token)
    return cost_rus(cost, shared_scan=shared)


def statement_rus(rows_touched: int) -> float:
    """Host-side fallback charge for statements that never launched a
    device program (the pre-rc row-count formula, kept ONLY for the
    host path — device work is priced by cost_rus at admission)."""
    return max(float(MIN_TASK_RU), rows_touched / 100.0 + 1.0)


def split_device_time(costs: list, total_ns: int) -> list:
    """Attribute one measured launch wall time across its members,
    proportional to each member's marginal bytes (the shared scan is
    the lead's; riders weight by what they ADDED).  ``costs`` is a list
    of per-member weights (bytes); zero/unknown weights split evenly.
    Returns per-member ns summing to ``total_ns``."""
    n = len(costs)
    if n == 0:
        return []
    weights = [max(float(c or 0), 0.0) for c in costs]
    tot = sum(weights)
    if tot <= 0:
        share = total_ns // n
        out = [share] * n
        out[0] += total_ns - share * n
        return out
    out = [int(total_ns * w / tot) for w in weights]
    out[0] += total_ns - sum(out)
    return out


def plan_rus(cost) -> Optional[float]:
    """RU price of a whole built plan's rolled-up LaunchCost (the
    analysis gate's pricing-rot check).  None when the plan implies no
    device work at all (host-only statements are not RU-priced)."""
    if not cost.transfer_bytes and not cost.flops:
        return None
    return cost_rus(cost)


__all__ = ["cost_rus", "task_rus", "statement_rus", "split_device_time",
           "plan_rus", "RU_PER_TRANSFER_BYTE", "RU_PER_RESIDENT_BYTE",
           "RU_PER_ICI_BYTE", "RU_PER_DCI_BYTE",
           "RU_PER_FLOP", "MIN_TASK_RU"]

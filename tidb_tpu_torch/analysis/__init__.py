# ported from tidb_tpu/analysis/__init__.py @ 1fb41ee
"""The static analysis of a plan, without a launch.

The port holds these passes of the JAX package's ``analysis/``:

- ``contracts``: every physical operator declares a contract (output
  dtypes, row-capacity shape, locality); ``verify_plan`` walks built
  plans edge by edge and rejects inconsistent ones with a structured
  PlanContractError before any launch, ``verify_task`` re-checks a task
  at the device scheduler's admission, and EXPLAIN reports
  ``contract: ok`` for a verified plan;
- ``copcost``: the shape and memory abstract interpreter (``dag_cost``,
  ``plan_cost``, ``task_cost``) the strategy choice, the admission
  budget, RU pricing and EXPLAIN's ``est. device bytes`` footer read;
- ``calibrate``: the per-digest correction store the drain feeds;
- ``compilekey``: the restart-stable digests and ``CompileKey``;
- ``shardflow``: the sharding-layout and collective-transfer
  interpreter over the typed-link topology (``parallel/topology``, the
  declared host view of ``tidb_tpu_topology_hosts``): implicit
  reshards, unknown axes, coordinator-routed merges, the limb psum
  fence and DCI blow-ups are refused before any launch, and transfer
  bytes roll up per link class (EXPLAIN's ``transfer:`` footer);
- ``valueflow``: the value-range interpreter over stats-seeded integer
  intervals: silent int64 wraps, unprovable SUM fences, the f32
  precision cliff and the decimal division's pre-scale are refused
  before any launch, and an analyzed table's provably narrow SUMs run
  as one int64 word (``narrow_sums``);
- ``lifetime``: the buffer-lifetime pass classifying every program
  input slot (PERSISTENT / LOOP-CARRIED / EPHEMERAL) into the
  ``DonationPlan`` the spmd programs derive ``donate_argnums`` from.

The session runs ``verify_plan``, ``verify_plan_sharding`` and
``verify_plan_values`` in ``_plan_select`` behind
``tidb_tpu_verify_plan`` (on by default).  The linter, the concurrency
model and ``python -m`` come later (ROADMAP.md, Queue 1 entry 11b);
``lint`` holds only the gate's ``Finding`` record.
"""

from .calibrate import (BoundedLRU, Correction, CorrectionStore,
                        clamp_factor, correction_store)
from .contracts import (PlanContractError, verify_dag, verify_plan,
                        verify_task)
from .copcost import CostError, LaunchCost, plan_cost, task_cost
from .lifetime import (BufferClass, DonationError, DonationPlan,
                       donation_plan, verify_donation)
from .lint import Finding
from .shardflow import (plan_transfer, verify_dag_sharding,
                        verify_plan_sharding, verify_task_sharding)

__all__ = ["PlanContractError", "verify_plan", "verify_dag", "verify_task",
           "CostError", "LaunchCost", "plan_cost", "task_cost",
           "BufferClass", "DonationError", "DonationPlan",
           "donation_plan", "verify_donation",
           "BoundedLRU", "Correction", "CorrectionStore",
           "correction_store", "clamp_factor",
           "plan_transfer", "verify_dag_sharding", "verify_plan_sharding",
           "verify_task_sharding",
           "Finding"]

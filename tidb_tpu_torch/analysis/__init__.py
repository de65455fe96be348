# ported from tidb_tpu/analysis/__init__.py @ 02e96d8
"""The static cost model of a plan and the contract checks, without a
launch.

The port holds the parts of the JAX package's ``analysis/`` that the
planner's high-NDV strategy choice (``executor/plan.py
_arbitrate_strategy``) and the device scheduler's admission (sched/)
reach: ``contracts`` (``verify_dag``, the scheduler's ``verify_task``
and the fusion checks), ``copcost`` (the shape and memory abstract
interpreter: ``dag_cost``, ``plan_cost``, ``task_cost`` and the
admission budget), ``calibrate`` (the correction store the drain feeds
and ``arbitrated_ms`` reads) and ``compilekey`` (the restart-stable
digests and ``CompileKey``).  The analysis gates (lint, shardflow,
valueflow, lifetime, concurrency and ``python -m``) come later
(ROADMAP.md, Queue 1 entry 11).
"""

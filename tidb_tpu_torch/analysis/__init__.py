# ported from tidb_tpu/analysis/__init__.py @ 6298005
"""The static cost model of a plan, without tracing.

The port holds the parts of the JAX package's ``analysis/`` that the
planner's high-NDV strategy choice reaches (``executor/plan.py
_arbitrate_strategy``): ``contracts`` (the plan-contract error; its
verifiers come with their callers), ``copcost`` (the shape and memory
abstract interpreter: ``dag_cost`` and ``plan_cost``), ``calibrate``
(``arbitrated_ms`` and the correction store's read side) and
``compilekey`` (the restart-stable DAG digests).  The analysis gates (lint, shardflow, valueflow, lifetime,
concurrency and ``python -m``) come later (ROADMAP.md, Queue 1 entry
11).
"""

"""tidb_tpu_torch: the PyTorch/CUDA port of ``tidb_tpu``.

A second package beside the JAX one, module for module: each module
here carries a first line naming its counterpart in ``tidb_tpu/`` and
the commit it was taken from.  The port imports ``torch``, ``numpy``
and the standard library only; it never imports ``jax`` or anything of
``tidb_tpu``.

Entry points run on the GPU (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``), where every hand-written kernel is
replaced by its plain PyTorch version.  Asking for CUDA on a machine
without a GPU raises.

What is ported so far: the coprocessor client
(``store.client.CopClient``: ``execute_agg`` for the SCALAR, DENSE,
SORT, SEGMENT and SCATTER strategies, ``execute_rows`` for TopN, Limit
and filtered projections, both with broadcast joins fused into the
program, and ``execute_shuffle_agg``/``execute_shuffle_rows`` for the
repartition join over the logical devices) over a
``store.columnar.ColumnarSnapshot``, on the hand-written CUDA kernels
of ``copr/cuda/``; and above it the SELECT path from SQL text: the
parser (``sql/``), the planner (``planner/``, with the join reorder),
the executor (``executor/``: the device joins, the host join
operators and the index readers), the catalog and a ``session.Session``
whose plans are the JAX package's with auto-analyze off (every device
evaluator lane, rollup, views, sequences, partitioned tables, set
operations and CTEs among them); and beneath the session the row
store: the native MVCC engine (``native/kvstore.cpp``, built with g++
at first use by ``store/kv.py``), the row codec, the
catalog on KV, the write statements, transactions and the online DDL
(``ddl/``).  What the port does not run yet raises
``NotImplementedError`` naming its ROADMAP.md item (below).
"""

# ROADMAP.md items of the paths the port does not run yet, named by the
# NotImplementedError each raises
HOST_BASE = "Queue 1 item 1, sub-step 1: the rest of the host base"
SHOW = "Queue 1 item 1, sub-step 2d: the SHOW statements"
PLAN_CACHE = "Queue 1 item 1, sub-step 5: the plan cache and bindings"
PLANNER = "Queue 1 item 1, sub-step 7: the cascades planner"
EXCHANGE = "Queue 1 item 4: slice 8, multiple GPUs, windows and exchanges"
STATS = "Queue 1 item 5: slice 9, ANALYZE and statistics"
ANALYSIS = "Queue 1 item 7: slice 11, the analysis gates"
CONTROL = "Queue 1 item 8: slice 12, the control and observability planes"
HOST_SURFACE = "Queue 1 item 9: slice 13, the rest of the host surface"


def unported(what: str, where: str = "Queue 1") -> NotImplementedError:
    """The error a path of the JAX package that the port does not run yet
    raises: ``what`` arrives with the ROADMAP.md item ``where``."""
    return NotImplementedError(
        f"{what} arrives with a later slice of the port (ROADMAP.md, "
        f"{where})")

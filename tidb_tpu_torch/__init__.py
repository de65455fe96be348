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
program, ``execute_shuffle_agg``/``execute_shuffle_rows`` for the
repartition join and ``execute_window`` for the window functions, both
over the logical devices) over a ``store.columnar.ColumnarSnapshot``,
on the hand-written CUDA kernels of ``copr/cuda/``; and above it the
SELECT path from SQL text: the parser (``sql/``), the planner
(``planner/``, with the join reorder and the selectivity and index
costs from statistics), the executor (``executor/``: the device joins
and windows, the host join and window operators and the index readers,
the high-NDV strategy chosen by the cost model of ``analysis/``), the
catalog and a ``session.Session`` whose plans are the JAX package's
(every device evaluator lane, rollup, views, sequences, partitioned
tables, set operations and CTEs among them), with ANALYZE (``stats/``,
its kernel on the card), the inline auto-analyze and the SHOW
statements; and beneath the session the row store: the native MVCC
engine (``native/kvstore.cpp``, built with g++ at first use by
``store/kv.py``), the row codec, the catalog on KV, the write
statements, transactions and the online DDL (``ddl/``).  Above the
session the port is a server: the MySQL wire protocol and the HTTP
status API (``server/``, ``python -m tidb_tpu_torch serve --device
cuda|cpu``, ``dump`` and ``import``), with users and grants
(``privilege/``), KILL, prepared statements and the plan cache
(``planner/plan_cache.py``, ``sql/bind.py``), optimizer hints and plan
bindings (``planner/bindinfo.py``), the audit plugins (``plugin/``) and
the TOML configuration (``config.py``).  The client is resilient as the
JAX package's is: a table past ``device_mem_cap`` streams through the
card's memory in batches (pinned host stacks, a copy stream), a launch
that runs out of device memory walks the OOM ladder (half-size streamed
batches, then the host engines of ``copr/hostagg.py`` over the native
primitives of ``native/hostops.cpp``), a quarantined program the
quarantine ladder, region errors retry with the placement healed, the
fault plane (``faults/``) injects faults at its seams, repeated
statements hit the result cache, and ``store/remote.py`` fans a DAG out
to store processes (``store/server.py``, numpy on the host) over the
framed RPC of ``store/rpc.py``.  What the port does not run yet
raises ``NotImplementedError`` naming its ROADMAP.md item (below).
"""

# ROADMAP.md items of the paths the port does not run yet, named by the
# NotImplementedError each raises
HOST_BASE = "Queue 1 item 1, sub-step 1: the rest of the host base"
PLANNER = "Queue 1 item 1, sub-step 7: the cascades planner"
EXCHANGE = "Queue 1 item 4: several physical GPUs"
SCHED = "Queue 1 item 6: slice 10, admission and programs"
ANALYSIS = "Queue 1 item 7: slice 11, the analysis gates"
CONTROL = "Queue 1 item 8: slice 12, the control and observability planes"
HOST_SURFACE = "Queue 1 item 9: slice 13, the rest of the host surface"


def unported(what: str, where: str = "Queue 1") -> NotImplementedError:
    """The error a path of the JAX package that the port does not run yet
    raises: ``what`` arrives with the ROADMAP.md item ``where``."""
    return NotImplementedError(
        f"{what} arrives with a later slice of the port (ROADMAP.md, "
        f"{where})")

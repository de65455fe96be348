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
framed RPC of ``store/rpc.py``.  Every launch of the client goes through
the device admission scheduler (``sched/``, on by default; bypassed by
``TIDB_TPU_SCHED_DISABLE=1`` or ``tidb_tpu_sched_queue_depth = 0``): a
bounded weighted-fair queue (MySQL error 9003 when full) that coalesces
identical in-flight tasks, runs K tasks of one program over different
tables as one batched program (``parallel/spmd.BatchedCopProgram``: one
``group_reduce_lanes`` call a logical device for all K) and different
chains over one scan as one fused call, holds an adaptive micro-batch
window, supervises launches (retry, demux, the circuit breaker, the OOM
bisection) and debits resource-group RU buckets (``rc/``) at the drain;
programs are memoized by restart-stable keys in the program cache
(``compilecache/``), whose manifest persists their capacities and the
measured launch-time corrections (``analysis/calibrate``).  Every
statement is observed as the JAX package observes it (``obs/``): a span
tree rooted at ``session.ExecuteStmt`` (on by default,
``tidb_tpu_trace``), stitched from the client's ``cop.dispatch``,
``cop.transfer`` and ``cop.host_merge`` and the scheduler drain's
``sched.*`` spans, kept by the flight recorder and served at ``/trace``;
the roofline store divides each warm launch's bytes and operations by
its device time from CUDA events against the card's datasheet peaks;
``/hbm`` and ``/profile`` (``torch.profiler``), ``EXPLAIN ANALYZE``,
``TRACE``, ``PLAN REPLAYER DUMP``, the statement summary and slow log
(``SHOW STATEMENTS_SUMMARY``, ``SHOW SLOW_QUERIES``, ``SHOW STATUS``),
the opt-in telemetry report and the JSON functions (``utils/``).  Every
SELECT's plan passes the plan-time gates before any launch
(``analysis/contracts.verify_plan``, ``shardflow`` and ``valueflow``,
behind ``tidb_tpu_verify_plan``): a plan whose device lanes would wrap
is refused with ``PlanContractError``, an analyzed table's provably
narrow SUMs run as one int64 word, and a launch over a streamed batch
releases its inputs at the launch (``analysis/lifetime``).  Servers
that share one card coordinate through the coordination plane
(``pd/``, ``tidb_tpu_pd = 1``; ``tidb_tpu_pd_dir`` for separate
processes): one RU budget split by debt-weighted shares, program claims
and quarantine tombstones, and the calibration, over member leases that
degrade to local operation, never to an error.  A Domain's background
workers run on the timer framework (``timer/``: GC, TTL of ``ttl/``,
auto-analyze, the workload repository; ``Domain.start_background``);
the distributed task framework (``dxf/``) runs ANALYZE and CSV import as
resumable tasks and spreads ADD INDEX's backfill over store processes;
the ``information_schema`` memtables, ``ADMIN RECOMMEND INDEX``
(``planner/advisor.py``) and the extension points (``extension/``)
answer.  The ecosystem tools are embedded APIs over a Domain's row
store (``tools/``): BR's snapshot backup, restore and log backup with
point-in-time restore (``tools/br.py``), Lightning's direct import and
its global-sort import through sorted runs on disk
(``tools/lightning.py``, ``tools/external_sort.py``) and Dumpling's
export (``tools/dump.py``), in the JAX package's file formats; a
session with ``tidb_enable_cascades_planner`` on plans through the
memo search of ``planner/cascades/``.  What the port does not run yet
raises ``NotImplementedError`` naming its ROADMAP.md item (below).
"""

# ROADMAP.md items of the paths the port does not run yet, named by the
# NotImplementedError each raises
EXCHANGE = "Queue 1 item 4: several physical GPUs"
ANALYSIS = ("Queue 1 item 7: slice 11, the rest of the analysis gates "
            "(concurrency, lint and analysis/__main__)")
# the resource-group statements, /resource and /locksan
CONTROL = "Queue 1 item 8: slice 12, the control plane"
# testing/stress.py, with the control plane's items
HOST_SURFACE = "Queue 1 item 9: slice 13, testing/stress.py"


def unported(what: str, where: str = "Queue 1") -> NotImplementedError:
    """The error a path of the JAX package that the port does not run yet
    raises: ``what`` arrives with the ROADMAP.md item ``where``."""
    return NotImplementedError(
        f"{what} arrives with a later slice of the port (ROADMAP.md, "
        f"{where})")

#!/usr/bin/env python3
"""Drive the PyTorch port (tidb_tpu_torch) on one CUDA GPU and check it.

    python3 chip_smoke.py            # SCATTER queries at SF=1, the
                                     # DENSE/SCALAR main path at SF=10,
                                     # the slice-4 statements at SF=1,
                                     # SQL: Q1, Q6 at SF=10, the corpus
                                     # statements at SF=1; joins at
                                     # SF=10 and SF=1; the store at
                                     # SF=0.1; the SELECT surface: the
                                     # lanes and rollup at SF=10, the
                                     # 22 TPC-H statements at SF=0.01;
                                     # the tools and cascades over the
                                     # eight tables at SF=0.1; resource
                                     # control at SF=10, the stress
                                     # harness over 60,000 rows
    python3 chip_smoke.py --sf 0.05 --main-sf 0.1 --s4-sf 0.05   # quicker
    python3 chip_smoke.py --perm-of DIR   # only scatter_permutation's
                                          # time, of DIR/tidb_tpu_torch

Phases, each printing one line or more; any failure raises and the
script exits non-zero without printing a result:

1. device: the GPU's name and ``nvidia-smi`` name and power limit;
2. build: compile the CUDA kernels from the sources in this checkout,
   one ``nvcc`` per source, all at once;
3. radix kernels: each at the SCATTER path's shape (8,388,608 rows,
   values = arange) on uniform partition keys and on query A's skew
   (28.5% of the rows on the dead rows' tail key) against its plain
   PyTorch version on the card, exactly; kernel, plain,
   library-yardstick and memory-bound times at the kernel's tile; the
   whole pass; ``scatter_permutation`` (4 passes) for B = 2^22 and
   2^23 against the plain partition;
3b. sort kernels: the int64 instantiation of both radix kernels on a
   uniform 64-bit key at the same row count, exactly against its plain
   versions (the per-pass reference, on no query path); the onesweep
   kernels ``radix_hist_all64`` (8 digits) and ``radix_onesweep64``
   (shift 0) on a uniform 64-bit key, on query A's skew (28.5% of the
   rows at INT64_MAX) and on one value everywhere, each exactly against
   its plain version and the per-pass kernels, with kernel, plain, library
   (``torch.bincount`` once a digit; ``torch.sort`` of the digit) and
   bound times; then ``stable_argsort`` on one uniform 64-bit key (8
   passes), on a 23-bit key (3 passes after the digit skip) and on
   TopN's key set, exactly against its plain version, the library sort
   (``torch.sort(stable=True)`` a key, LSD) and the per-pass sort (one
   ``counting_sort_pass`` a digit), with their times and the bound at
   24 bytes a row a pass, its launches one ``radix_hist_all64`` a key
   and one ``radix_onesweep64`` a pass;
4. group_reduce: the one-lane call (``group_reduce``, one lane of the
   lanes kernel) at the main path's row count (67,108,864, one SF=10
   device batch) on a random mask, for G in {1, 12, 4096, 1,000,000,
   2^23 with rows in the sink slot}, sum/min/max over int64 and float64
   and min/max over int16, each against its plain version on the card
   (integers and float min/max exactly, float sums within ``FSUM_RTOL``
   of the slot's sum of |v|, and bit-equal between two launches), with
   kernel, plain, library-yardstick (``index_add_``,
   ``scatter_reduce_``) and memory-bound times; then the lane sets of
   the paths, each one launch (``group_reduce_lanes``): Q1's nine lanes
   (G = 12, its sources at their placed dtypes), "Q1 narrow"'s seven
   (the same rows, the two plain column SUMs one ``sum`` word each, as
   valueflow proves them over the analyzed SF=10 lineitem), Q6's three
   (SCALAR),
   SORT's and SEGMENT's three (8,388,608 rows, 6,000,000 live, G = 2^22
   and 2^23, int64 gids in segment order and in a random order), each
   exactly against ``group_reduce_lanes_plain``, with kernel, plain,
   library (one ``index_add_`` of the stacked lane matrix), bound and
   a one-lane launch a state field with its eager transforms, as the
   callers made them before the lane sets;
5. reference: a small lineitem through the port on the GPU and through
   its plain path on the CPU, for the SCATTER queries A and B, TPC-H Q1,
   Q6 and Q19, and the slice-4 statements (SORT and SEGMENT also over a
   DOUBLE key with -0.0 and NaN), whose states (or compacted rows) and
   results must be equal;
6. SCATTER slice: TPC-H lineitem at ``--sf`` and the two high-NDV GROUP
   BY queries through ``CopClient(device="cuda").execute_agg``, results
   equal to a numpy oracle, the radix kernel launches equal to the radix
   passes the client ran and the group_reduce launches to one a
   program run (every lane of a state table in one launch);
7. main path: lineitem at ``--main-sf`` (the nine columns Q1, Q6 and
   Q19 read) and TPC-H Q1, Q6 and Q19 through
   ``CopClient(device="cuda").execute_agg``, results equal to a numpy
   oracle with the predicates of bench.py's np_q1 / np_q6 / np_q19 and
   exact Python-int sums, and one group_reduce launch a query (Q1's nine
   lanes, Q6's and Q19's three);
8. slice 4: lineitem at ``--s4-sf`` (five columns) and the five
   statements of ``build_s4`` through ``CopClient(device="cuda")``
   (SORT and SEGMENT by ``execute_agg``, TopN, Limit and a filtered
   projection by ``execute_rows``), each equal to a numpy oracle,
   ``radix_onesweep64``'s launches (counted by the C entry where it
   issues each one) equal to the passes ``stable_argsort`` planned,
   ``radix_hist_all64``'s to the keys it sorted, no per-pass radix
   kernel launched, and one group_reduce launch a regrow round;
9. sql: TPC-H Q1 and Q6 in the specification's text (INTERVAL
   arithmetic) as SQL over phase 7's lineitem (``--main-sf``), and the
   corpus's lineitem-only statements (the Q6 and Q1 variants, the SORT
   group-bys on one and two keys, TopN, Limit, the filtered projection
   and HAVING) over lineitem at ``--s4-sf``, each through the port's
   ``Session`` on ``cuda:0``: equal to its numpy oracle (integers and
   decimals exactly, an AVG within half a unit of its last decimal
   place) and, for the statements phases 7 and 8 run as DAGs, to that
   run's result; each launching its hand kernels (``group_reduce`` for
   the aggregations, the onesweep pair for the sorts; Limit and the
   projection have none), no plain version of them running; each with
   its first and warm wall times, parse and plan ms, the client's
   split, the host operators' ms, the decode ms and the warm SQL
   overhead (the last call's wall less the client's);
10. joins: through the port's ``Session`` on ``cuda:0`` (one logical
   device), over lineitem at ``--main-sf`` (phase 7's columns and the
   join keys), part from ``gen_part`` and orders from
   ``gen_orders_mini`` (1,500,000 rows, under the broadcast cap): the
   aggregated broadcast join by ``p_brand``, the row-returning join, the
   ``IN`` semi join, the ``NOT IN`` anti join, the broadcast step of the
   MULTICHIP shapes, TPC-H Q19 in the specification's text (a
   repartition join with lineitem as the build side) and the first
   ``TPCH_SHUFFLE_QUERIES`` statement over orders of the scale's order
   count (a repartition join); at ``--s4-sf`` the m:n inner and left
   joins on ``o_custkey``, the three-table statement, the host sort over
   a join and the host hash join with an ``ON`` filter, then both
   ``TPCH_SHUFFLE_QUERIES`` statements on eight logical devices of the
   card (broadcast budget 0), so the exchange moves rows between them.
   Each equals its numpy oracle (a lookup array by key for a unique
   join, per-key counts for m:n, the three OR branches over the part
   attributes gathered by ``l_partkey`` for Q19), is planned as stated,
   launches its hand kernels (``group_reduce``, the onesweep pair for
   the build sort and the SORT aggregation) with no plain version run
   and no host fallback of a join taken, and prints first and warm ms,
   the client's split (``place``, ``build``, ``device``, ``transfer``,
   ``merge`` or ``assemble``) and its join, exchange and table
   capacities; the aggregated broadcast join's probe steps
   (``searchsorted``, the gathers, and the m:n join's ``expand_slots``
   at ``--s4-sf``) print their device ms beside their memory bounds;
11. store: through one port ``Domain(device="cuda", data_dir=...)`` in
   a temporary directory, CREATE TABLE lineitem and orders with the
   types of tests/test_tpch_diff.py, LOAD DATA of each from the
   generator's '|' files (lineitem at SF=0.05, ``STORE_SF``: 300,000
   rows, a cut the host row codec and the script's time limit force;
   orders at its count), TPC-H
   Q1 and Q6 in the spec's text, a join of the two and a TopN; one
   transaction of UPDATE, DELETE and INSERT, then COMMIT; the statements
   again, each against a numpy oracle of the written rows; online
   CREATE INDEX on ``l_orderkey`` with ADMIN CHECK TABLE, and point reads
   through ``IndexLookUp`` equal to the scan's rows; a rolled-back
   transaction that leaves no trace; five write/read rounds over orders
   with ``torch.cuda.memory_allocated`` after the fifth within one
   placement of the first; the Domain closed and reopened over its
   directory, its committed counts and sums read back.  It prints load
   rows/s, each statement's first and warm ms with the client's split
   (``place`` is the re-placement after a write), the UPDATE, DELETE,
   COMMIT and index ms, the memory after each round and the hand
   kernels' launches (``group_reduce``, the onesweep pair for TopN), no
   plain version of them run;
12. select surface, through one port ``Session`` on ``cuda:0``:
   12a, over phase 7's lineitem (``--main-sf``), twelve statements whose
   filters, group keys and aggregate arguments hold every family of the
   device evaluator's lanes (decimal and double ``/``, ``DIV``, ``%``,
   ``CAST`` to signed, unsigned, double, decimal and datetime, DATE
   against DATETIME, BIGINT UNSIGNED compare and arithmetic, ``XOR``,
   ``ROUND``, ``TRUNCATE``, ``SQRT``, ``LN``, ``POW``, ``GREATEST``,
   ``SIGN``, ``YEAR``, ``QUARTER``, ``DAYOFWEEK``, ``DATEDIFF``,
   ``DATE_ADD ... INTERVAL n MONTH``, ``LAST_DAY``), each with its lanes
   inside its cop task (``testing.tpch.pushed_ops`` over the session's
   own plan) and its result equal to a numpy oracle (integers, decimals
   and dates exactly, double sums within ``SELECT_FRTOL``); 12b, TPC-H
   Q1's grouping ``WITH ROLLUP`` (two keys, three levels) and a one-key
   rollup with ``GROUPING()``, each equal to the union of its levels'
   numpy oracles, one ``group_reduce`` launch a level, its peak
   ``torch.cuda.max_memory_allocated`` beside the bytes a materialized
   ``levels x n`` expand would take; 12c, the eight tables of
   ``testing.tpch.gen_tpch`` at ``--tpch-sf`` (default 0.01: TPC-H Q20's
   correlated subquery runs as a host apply a correlated value, whose
   time grows as the square of the scale) and the 22 statements of
   ``TPCH_22`` with Q15 through its view, each equal to sqlite3 over the
   same rows (``tests/test_sqlite_diff.py``'s ``rows_equal`` rule).
   Each statement prints its first and warm ms, the client's split
   summed over its cop calls, and, for 12c, its plan's top operators and
   whether the device or the host sets its wall; the phase's hand-kernel
   launches are counted, no plain version of them runs and no join
   takes its host plan;
13. windows and statistics, through port ``Session``s on ``cuda:0``:
   13a, over 12a's session and placement of phase 7's lineitem on one
   logical device (each window program at ``2N`` rows rounded up to a
   power of two), the top three lines a day by ``row_number``, and
   ``rank``/``dense_rank`` and whole-partition ``SUM``/``AVG`` (a
   DECIMAL AVG) a ship mode on one day; 13b, ``rank`` over
   ``gen_orders_mini(1,500,000)`` on eight logical devices under an
   outer ``rk = 1``; 13c, ANALYZE of orders (a full build on the card,
   its statistics equal to a numpy oracle of the kernel's semantics:
   counts, NDV, bounds, cumulative counts, repeats, TopN, the CM
   counters and the KMV minima), of the SF=10 lineitem and of phase 8's
   lineitem (both sampled by the handle's rule), ``SHOW STATS_META``,
   ``STATS_HISTOGRAMS`` and ``STATS_TOPN``, and two high-NDV GROUP BYs
   (orders by ``o_custkey``, phase 8's lineitem by ``l_orderkey``) whose
   strategy the cost model chooses from those statistics and the
   correction store the scheduler fed with the measured launches of
   phases 1-13 (not empty).  Every result
   equals a numpy oracle; every window plan is a ``CopWindow`` on the
   card; no join takes its host plan, the strategy choice never falls
   back, no plain kernel version runs, the onesweep launches equal the
   passes ``stable_argsort`` planned and ``group_reduce`` runs once a
   device a program run of a window with aggregates and twice a column
   an ANALYZE.  Each statement prints its first and warm ms and the
   client's split (a GROUP BY slower than ``HIGH_NDV_ONCE_S`` runs
   once), the window statements their exchange capacities and peak
   ``max_memory_allocated``;
14. the server, over 13a's ``Domain`` (the SF=10 lineitem placed on the
   card, with orders from ``gen_orders_mini(1,500,000)`` registered
   beside it), the port's ``MySQLServer`` on 127.0.0.1, port 0, reached
   only through the wire (``server/client.Client``; ``testing/
   mysql_client`` for one caching_sha2 login over TLS): (1) TPC-H Q1 and
   Q6 over ``COM_QUERY``, rows equal to phase 9's check and to the text
   of the in-process ``Session``'s rows, first and warm wire ms beside
   the in-process warm ms (their difference the wire overhead) and the
   plan ms on a plan-cache miss and on a hit; (2) Q6 with its dates,
   discount and quantity as ``?``, five ``COM_STMT_EXECUTE``s over three
   parameter sets, each equal to a numpy oracle, exactly two plan-cache
   hits; (3) a filtered projection of ~109,000 lineitem rows read in text
   and through a read-only cursor (``COM_STMT_FETCH``, the TLS login),
   equal to numpy, with rows/s; (4) ``CREATE USER``, ``GRANT SELECT`` on
   orders, that user's SELECT on lineitem denied (errno 1105, the
   privilege error's message) and its ``SHOW GRANTS``; (5) ``KILL QUERY``
   from a second connection once ``SHOW PROCESSLIST`` lists the victim
   and it has begun, the victim a host hash join of orders and lineitem
   (``SERVER_VICTIM``, over a second long uninterrupted) whose probe
   passes the host operators' cancellation points: errno 1105 "Query
   execution was interrupted" within 2 s, and its connection answers the
   next query; (6) four connections running Q6 twenty times each at
   once, every result exact, with statements/s beside one connection's;
   (7) ``python -m tidb_tpu_torch serve --port 0 --status-port 0`` on
   ``cuda`` as a child process: ``import`` of 10,000 rows, an aggregate
   on the card equal to numpy, ``dump``, ``/status`` and ``/metrics``,
   SIGINT and exit code 0 within 10 s.  Steps 1-5 count their hand
   kernels' launches, step 6 checks that they grew; no plain version
   runs;
15. resilience, with every client's result cache off in phases 1-14
   (their warm calls run on the card) and each entry of any client into
   the OOM or the quarantine ladder counted from the start: (a) TPC-H Q1
   and Q6 through SQL over 13a's Domain under ``SET GLOBAL
   tidb_tpu_device_mem_cap`` at a quarter of the lineitem snapshot's
   ``device_bytes()``, and the SORT group-by over the ``--s4-sf``
   lineitem through ``CopClient`` under a quarter of its own, each
   streamed in at least four batches, equal to its resident run and to
   the numpy oracle, one ``group_reduce`` launch a batch program run,
   with each batch's host-stack, H2D and device ms and the ms the stream
   waited for it after the batch before it (CUDA events: copies and
   kernels share one stream, so H2D never overlaps compute); (c) Q6
   over the ``--s4-sf`` lineitem with a placement of 8 shards on 4 stores (4
   logical devices) through an injected STORE_UNAVAILABLE and
   REGION_MISS, healed, equal to numpy, with ``last_retries`` and
   ``last_heals``; (d) the result cache: Q1 over 13a's Domain a miss
   then a hit (no launch), and a table of ``RC_ROWS`` rows a miss, a hit
   and after an INSERT a miss with the new row; (e) two store processes
   (``RemoteCluster``, no GPU: ``nvidia-smi`` lists none of them) over
   lineitem at ``REMOTE_SF``: Q1 equal to the card's, again after store
   0 exits mid-query, and with both dead through the local client on
   the card; (b, last) Q1 over a fresh snapshot of the ``--main-sf``
   lineitem under ``torch.cuda.set_per_process_memory_fraction`` at
   ``OOM_HEADROOM`` of the resident run's peak: a real CUDA OOM answered
   by the half-size streamed batches on the card (the ``stream`` rung,
   one ``group_reduce`` launch a batch planned; the host rung is off),
   equal to numpy, ``oom_recovered`` 1, the fraction restored in a
   ``finally``; no ladder serves a statement
   outside (b), and the native host library (``copr/nativeops``) is
   built;
16. admission and programs: every launch of phases 1-15 already went
   through the device scheduler (``sched/``, on by default); over 13a's
   Domain (the SF=10 lineitem placed) and two lineitem tables of one
   shard shape at ``ADMISSION_SF`` registered beside it: (a) 8 threads
   x Q6 through SQL, queued under ``pause()`` and released, with the
   launches, ``coalesced_launches``, the program cache's misses (none
   new) and the wall of the 8 beside 8 solo walls; (b) Q6 over the two
   tables at once: one batched launch (``batched_launches``), one
   ``group_reduce_lanes`` call a logical device for both slots, the
   batched program's ms beside the two solo programs', each slot's
   states equal to its solo run's and the batched K·G reduction equal
   to ``group_reduce_lanes_plain`` on the card; (c) Q1 and Q6 over the
   analyzed SF=10 scan at once: they prove different SUM slots narrow,
   so the fusion contract launches them apart (the JAX package's rule);
   then Q6 with the corpus's Q6 (one narrow class): one fused launch
   (``fused_launches``), the fused program's ms beside the solo sum,
   each member's result equal to its solo run's; (d) queue depth 2, two statements queued: the third gets
   MySQL error 9003 in process and over the wire; (e) phase 14's
   4 x 20 Q6 over the wire with the scheduler on: statements/s at one
   and four connections and the coalesced launches.  Every result
   equals its numpy oracle or its solo run;
17. observability (every statement of phases 9-16 was traced: the
   span tree is on by default), over 13a's Domain and a fresh
   connection, every trace kept: (a) TPC-H Q1 at SF=10 through SQL,
   equal to numpy, its span tree from the flight recorder printed, with
   ``session.ExecuteStmt``, ``cop.dispatch``, ``sched.queue`` and
   ``sched.launch`` (recorded by the drain thread, carrying
   ``device_ms`` from the launch's CUDA events beside ``measured_ms``,
   the drain's enqueue wall), ``cop.transfer`` and ``cop.host_merge``;
   (b) phase 8's SORT GROUP BY (its DAG over the ``--s4-sf`` lineitem)
   through ``CopClient.execute_agg`` under a ``Tracer`` region, equal
   to numpy in groups and sum, launching ``group_reduce`` and the
   onesweep pair, its tree printed; (c) ``EXPLAIN ANALYZE`` of Q1: its
   rows printed, the top operator's and the cop task's ``actRows``
   equal to Q1's oracle groups, the cop task's time beside the launch's
   device ms; (d) the roofline (``obs/roofline``): its peak source (on
   an ``H100 80GB HBM3`` NVIDIA's datasheet, on another card the device
   microbench), Q1's, Q6's and the SORT's digests and the digests
   furthest from their peak, each with its bytes share clamped at 100%
   and unclamped, at least three; (e) ``/profile?ms=1500`` through the
   status server with ``tidb_tpu_profile`` on: CPU and CUDA activities,
   five Q6 calls inside the window, the exported Chrome trace's kernel
   events, at least one ``group_reduce`` kernel; (f) warm Q6 medians
   with ``tidb_tpu_trace`` on and off, interleaved; (g) ``SHOW
   SLOW_QUERIES`` at a zero threshold, its trace id found in the
   flight recorder;
18. the plan-time gates and buffer lifetime, on 13a's Domain: (a) the
   statements of ROADMAP.md Queue 3 item 1 over two small analyzed
   tables, first with ``tidb_tpu_verify_plan`` off (a session variable:
   each runs on the card and returns the wrapped digits its device lane
   computes), then on: each refused with the JAX session's
   ``PlanContractError`` rule before any launch; (b) Q1 and Q6 at
   ``--main-sf`` over the analyzed lineitem: the plans' ``narrow_sums``
   (Q1's column SUMs are proven narrow), each launch's distinct lanes
   equal to ``expected_lanes``, the results equal to numpy bit for bit,
   the warm wall, the plan ms on a plan cache miss (the gates run) and
   on a hit, and the launch's CUDA-event device ms; (d) watermark
   drift: a row written past an analyzed column's watermark, a new
   ANALYZE, and the cached plan's old proof counted in ``/sched``'s
   ``value_drifts`` with the exact result, a fresh plan quiet; (e)
   EXPLAIN of Q1 and Q6 with ``contract: ok``, the ``est. device
   bytes`` footer and Q1's strategy line; (f) 15a's streamed Q1 with
   its ``DonationPlan``: donating, not donating, donating again, the
   donated launches and the peak ``max_memory_allocated`` above the
   run's start.  (c) is phase 4's "Q1 narrow" lane set;
19. the coordination plane and the background workers: (a) 13a's
   Domain (A) and a second Domain (B) over an analyzed SF=0.1 lineitem
   on the same card, joined with ``tidb_tpu_pd = 1`` on the in-process
   backend: the warm Q6 median of ``PD_Q6_REPS`` calls with pd off and
   on and their launches (equal), ``/pd`` listing both members and the
   leased shares of one limited group summing to its RU budget, a
   correction of A's warm Q1 reaching B's own correction store after a
   forced tick, a launch breaker tripped in A (a ``launch:poison``
   fault) whose tombstone purges B's entry of that digest from B's own
   program cache (present after A's trip, gone after B's tick), the
   median claim + release round trip, Q1 and Q6 on both equal to
   numpy, and the ``group_reduce`` launches of those Q1 and Q6 calls;
   (b) two ``python -m tidb_tpu_torch serve`` processes with one
   ``tidb_tpu_pd_dir`` (a ``--config`` file), each loading an
   SF=``SERVE_PD_SF`` lineitem by LOAD DATA (``SERVE_PD_SF_CUT`` when
   the script reaches phase 19 past ``SERVE_PD_LATE_S``, the cut
   printed): Q6 over the wire equal to
   numpy in each, server 0's warm Q6 for ``PD_WIRE_S`` a leg with pd
   on, off and on again over the file backend (median, mean, max and
   the ticks its statements paid), each ``/pd`` listing both leases
   live, then one
   killed: the survivor's ``/pd`` shows the lease lost within
   ``PD_LEASE_TTL_S`` plus one sync while its Q6 keeps answering
   exactly; (c) A's background workers (``start_background``, the
   timers' first round): the TTL sweep of a ``TTL_ROWS``-row DATETIME
   table (``trigger("ttl")``) and an aggregate over the kept rows equal
   to numpy, the auto-analyze timer (``tidb_enable_auto_analyze`` on
   for its trigger) rebuilding lineitem's statistics while four
   threads send Q6 (every Q6 exact, the statistics equal to
   13c's), a DXF ``analyze`` task over two tables and
   ``information_schema.dist_tasks``, ``ADMIN RECOMMEND INDEX`` after
   point lookups, then ``Domain.close`` stopping the timer thread; the
   ``radix_hist_all64``, ``radix_onesweep64`` and ``group_reduce``
   launches of 19c, counted from 0;
20. the ecosystem tools and the cascades planner, on a new KV-backed
   Domain on the card, over ``gen_tpch(TOOLS_SF)``'s eight tables
   written as CSV (``TOOLS_SF_CUT`` when the script reaches phase 20
   past ``TOOLS_LATE_S``, the arrival past which the phase at this
   host's pace would end after ``TOOLS_END_S``; the cut printed): (a)
   ``tools.import_csv`` of each table (``TOOLS_THREADS`` threads, rows/s
   a table) and ``global_sort_import`` of orders into another database
   under a memory budget that spills several runs (counted); Q1 and Q6
   equal to numpy; with the result cache on, a further chunk of lineitem
   imported into the non-empty table: Q6 gives the new exact answer, no
   cache hit; (b) BR: ``backup`` of the database and ``restore`` under
   another name (seconds and MB/s), Q1 and Q6 on the restored tables
   equal to 20a's; ``log_backup_start`` on the global-sort orders,
   UPDATE, DELETE and INSERT, ``log_backup_tick``; ``restore_pitr`` to
   the tick equal to the source table and to the base equal to the
   backup; (c) ``dump_database`` of that orders in the ``sql`` and
   ``csv`` formats, the CSV dump imported into a fresh table with the
   source's count and sums; (d) ANALYZE of the tables TPC-H Q3, Q5, Q10
   and Q12 read, then each statement with
   ``tidb_enable_cascades_planner`` off and on, equal to each other and
   to sqlite, ``search`` called directly on each optimized plan (the
   join methods it chose printed), the plan ms of each leg on its miss,
   then the warm walls of both legs over ``TOOLS_WARM`` rounds in
   alternating order, and whether their EXPLAINs are the same; the
   ``group_reduce`` launches of each sub-phase (and 20d's onesweep
   launches), counted from 0;
21. resource control and the chaos stress harness: (a) on 13a's
   Domain, ``CREATE``, ``CREATE ... IF NOT EXISTS``, ``ALTER`` and
   ``DROP RESOURCE GROUP`` against ``information_schema.resource_groups``
   and four statements refused with ``PlanError`` (``DROP`` of
   ``default`` among them); Q6's RU price read from an unthrottled
   group's debits, then ``RC_CALLS`` warm Q6 in a group of
   ``RC_RATE_Q6`` Q6 prices a second with the overdraft at 0, which
   wait at least ``RC_BLOCK_S`` for the refill while as many in
   ``default`` do not; a Q6 in a ``PRIORITY = HIGH`` group and a Q1 in
   a ``LOW`` one queued together under ``pause()``, each group given
   device ms and RUs, the per-digest map filled; a read-only Q1 in a
   ``KILL`` group raising ``RunawayError`` (errno 8253); a Q6 whose
   ``SWITCH_GROUP`` moves its debit to the target; ``/resource``
   through the status server; every Q1 and Q6 equal to numpy; (b)
   ``testing.stress.build_stress_domain(STRESS_ROWS)`` on the card, the
   64-session smoke at the JAX package's bars (completion 1.0, no
   failure or wrong result, every shape complete, RU fairness 1.0, no
   value drift, launches at most the tasks), then the full rung
   (``STRESS_SESSIONS`` sessions at ``STRESS_RATE`` arrivals a second
   over four groups, ``DEFAULT_CHAOS`` armed: no wrong result,
   completion at least 0.98, RU fairness below 1.5; only the smoke
   when the script reaches 21b past ``STRESS_LATE_S``, the cut
   printed), each metrics dict printed on a line, the ``group_reduce``,
   ``radix_hist_all64`` and ``radix_onesweep64`` launches of its
   sessions counted from 0 (each above 0; ``radix_hist`` and
   ``radix_scatter`` too, where the cost model sends the high-NDV
   group-by to the SCATTER partition), no plain kernel version, no
   ladder and no join fallback serving a statement; (c) the HBM ledger
   over two more waves (``STRESS_WAVES``) on (b)'s Domain: launch bytes
   drained, no negative balance, no residency added by the second wave,
   the watermark above every measured launch peak (the card's peak
   counter reset first, so launches are measured);
22. the ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.  A ``phase ...: s=`` line after
   each phase gives its seconds and, of them, the script's own host
   work by kind (``host_s``: in phases 9, 11, 12 and 13 its oracles,
   table generation, file writing and sqlite; ``host_work``).  An
   answer checked once is passed on (phase 7's ``main_res``, phase 8's
   ``s4_res``), not computed again.

Query A is the grouping inside TPC-H Q18; query B is a corpus query of
the JAX package's TPC-H plan set:
    A: select l_orderkey, sum(l_quantity), count(*) from lineitem
       group by l_orderkey
    B: select l_orderkey, l_suppkey, max(l_extendedprice) from lineitem
       where l_quantity < 45 group by l_orderkey, l_suppkey
Q1, Q6 and Q19 are the DAGs of __graft_entry__._q1_dag, bench._q6_dag
and bench._q19_dag, built with the port's builders.  The slice-4
statements are the corpus's SORT, SEGMENT, TopN, Limit and
row-returning statements (see ``build_s4``).
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

T_START = time.perf_counter()      # the script's start, for the late guards

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
CUDA_CORE_OPS_PER_S = 67e12      # H100 SXM non-tensor fp32 rate, per op
KERNEL_ROWS = 8_388_608          # padded rows of one device batch at SF=1
MAIN_ROWS = 67_108_864           # padded rows of one device batch at SF=10
REPS = 15


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


# the script's own host work since the last phase's end, by kind: its
# oracles, table generation, file writing and sqlite in phases 9, 11, 12
# and 13 (the port's work is the rest of a phase's seconds)
HOST_S: dict = {}
_HOST = threading.local()


class host_work:
    """Adds the seconds inside it to ``HOST_S[kind]``, as a ``with``
    block or as a decorator; a use inside another on the same thread
    counts once, in the outer one's kind."""

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        depth = getattr(_HOST, "depth", 0)
        _HOST.depth = depth + 1
        if depth == 0:
            _HOST.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _HOST.depth -= 1
        if _HOST.depth == 0:
            HOST_S[self.kind] = (HOST_S.get(self.kind, 0.0)
                                 + time.perf_counter() - _HOST.t0)

    def __call__(self, fn):
        @functools.wraps(fn)
        def timed(*a, **k):
            with host_work(self.kind):
                return fn(*a, **k)
        return timed


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = REPS, flush=None,
            clean: bool = False, prep=None) -> float:
    """Median milliseconds of ``fn`` by CUDA events, one launch per
    sample after a warm-up; ``flush`` (a large tensor) is overwritten
    before each sample so inputs come from HBM, not the 50 MB L2.  The
    overwrite leaves the L2 full of dirty lines, which the sample writes
    back as it evicts them, as a pass meets the lines the previous pass
    wrote; ``clean=True`` reads ``flush`` instead, so the L2 holds clean
    lines and the sample pays for its own bytes only.  ``prep`` runs
    before each sample, outside the timed window (a workspace to zero)."""
    times = []
    for i in range(reps + 1):
        if prep is not None:
            prep()
        if flush is not None and clean:
            flush.sum()
        elif flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- #
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------- #

LIVE_SHARE_A = 0.715        # live rows of query A's device batch at SF=1
KEY_BITS = 30               # partition key bits below the tail key, B>=2^22


def main_path_keys(torch, dev, dist: str, seed: int = 1):
    """int32 partition keys of the main path's shape: uniform in
    [0, 2^30), or query A's skew, where the dead and pad rows (28.5% of
    the batch at SF=1) all take the tail key 2^30."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    key = torch.randint(0, 1 << KEY_BITS, (KERNEL_ROWS,), generator=gen,
                        device=dev, dtype=torch.int32)
    if dist == "tail skew":
        dead = torch.rand(KERNEL_ROWS, generator=gen, device=dev) \
            >= LIVE_SHARE_A
        key[dead] = 1 << KEY_BITS
    return key


def time_kernels(torch, rk, key, val, flush) -> dict:
    """Each kernel at shift 0 against its plain version, exactly, with
    kernel, plain and library-yardstick times and the memory bound at
    the kernel's tile, for an int32 or int64 key (the result's names end
    in ``64`` for int64)."""
    n = key.numel()
    w = key.element_size()
    tile = rk.KERNEL_TILE
    tiles = rk.n_tiles(n, tile)
    sfx = "64" if w == 8 else ""
    err = rk.new_err(key.device)
    out = {}

    hist = rk.radix_hist(key, 0)
    plain = rk.radix_hist_plain(key, 0)
    torch.cuda.synchronize()
    err_hist = int((hist - plain).abs().max())
    check(torch.equal(hist, plain), f"radix_hist{sfx} != radix_hist_plain")
    h2 = torch.empty_like(hist)
    ms = cuda_ms(torch, lambda: rk.launch_hist(key, 0, h2, err), flush=flush)
    plain_ms = cuda_ms(torch, lambda: rk.radix_hist_plain(key, 0),
                       flush=flush)
    dig = key & (rk.N_DIGITS - 1)
    flat_key = (torch.arange(n, device=key.device, dtype=torch.int64)
                // tile) * rk.N_DIGITS + dig
    lib = torch.bincount(flat_key, minlength=tiles * rk.N_DIGITS)
    check(torch.equal(lib.view(tiles, rk.N_DIGITS).to(torch.int32), hist),
          f"bincount yardstick != radix_hist{sfx}")
    lib_ms = cuda_ms(torch, lambda: torch.bincount(
        flat_key, minlength=tiles * rk.N_DIGITS), flush=flush)
    b_ms, b_by = bound_ms(w * n + 4 * rk.N_DIGITS * tiles, n)
    out["radix_hist" + sfx] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
        bound_by=b_by, max_abs_err=err_hist,
        clean_ms=cuda_ms(torch, lambda: rk.launch_hist(key, 0, h2, err),
                         flush=flush, clean=True))

    # radix_scatter, given the exclusive offsets of that histogram
    offs = rk.exclusive_offsets(hist)
    got = rk.radix_scatter(key, val, offs, 0)
    plain = rk.radix_scatter_plain(key, val, offs, 0)
    torch.cuda.synchronize()
    err_sc = max(int((g - p).abs().max()) for g, p in zip(got, plain))
    check(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]),
          f"radix_scatter{sfx} != radix_scatter_plain")
    k2, v2 = torch.empty_like(key), torch.empty_like(val)
    ms = cuda_ms(torch, lambda: rk.launch_scatter(key, val, offs, 0, k2, v2,
                                                  err), flush=flush)
    plain_ms = cuda_ms(torch, lambda: rk.radix_scatter_plain(key, val, offs,
                                                             0), flush=flush)
    lib = torch.sort(dig, stable=True).indices
    check(torch.equal(val[lib], got[1]),
          f"stable sort yardstick != radix_scatter{sfx}")
    lib_ms = cuda_ms(torch, lambda: torch.sort(dig, stable=True),
                     flush=flush)
    b_ms, b_by = bound_ms(2 * (w + 4) * n + 4 * rk.N_DIGITS * tiles, 4 * n)
    out["radix_scatter" + sfx] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
        bound_by=b_by, max_abs_err=err_sc,
        clean_ms=cuda_ms(torch, lambda: rk.launch_scatter(
            key, val, offs, 0, k2, v2, err), flush=flush, clean=True))
    check(int(err.item()) == 0, "a timed launch reported an error")

    # the whole pass: wrapper (hist, cumsum, scatter, one error
    # read-back) against the 1-bit plain pass
    full = rk.counting_sort_pass(key, val, 0)
    ref = rk.counting_sort_pass_plain(key, val, 0)
    check(torch.equal(full[0], ref[0]) and torch.equal(full[1], ref[1]),
          f"counting_sort_pass{sfx} != counting_sort_pass_plain")
    out["pass_ms"] = cuda_ms(torch, lambda: rk.counting_sort_pass(key, val,
                                                                  0),
                             flush=flush)
    out["pass_plain_ms"] = cuda_ms(torch, lambda: rk.counting_sort_pass_plain(
        key, val, 0), flush=flush)
    return out


def time_scatter_permutation(torch, radix, dev, flush) -> dict:
    """``scatter_permutation`` (partition key, 4 radix passes, the error
    read-back) at the main path's row count for B = 2^22 and 2^23, held
    against the 1-bit plain partition on the card."""
    from tidb_tpu_torch.copr import dag as D
    n = KERNEL_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    h = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=gen,
                      device=dev, dtype=torch.int64)
    sel = torch.rand(n, generator=gen, device=dev) < LIVE_SHARE_A
    out = {}
    for b in (1 << 22, 1 << 23):
        got = radix.scatter_permutation(h, sel, b, n)
        key = radix.partition_key(h, sel, b)
        want = radix._partition_plain(key, D.radix_key_bits(b), n)
        check(torch.equal(got, want),
              f"scatter_permutation B={b} != the plain partition")
        out[b] = cuda_ms(torch, lambda: radix.scatter_permutation(
            h, sel, b, n), flush=flush)
        print(f"scatter_permutation: n={n} B={b} "
              f"passes={D.radix_passes(b)} exact=True "
              f"ms={out[b]:.4f}")
    return out


def kernel_phase(torch, rk, radix, dev) -> dict:
    """Both kernels on uniform keys and on query A's tail-key skew; the
    ``kernels`` line reports the uniform run."""
    val = torch.arange(KERNEL_ROWS, dtype=torch.int32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MiB
    runs = {}
    for dist in ("uniform", "tail skew"):
        r = runs[dist] = time_kernels(
            torch, rk, main_path_keys(torch, dev, dist), val, flush)
        for name in ("radix_hist", "radix_scatter"):
            k = r[name]
            print(f"kernel {name} [{dist}]: n={KERNEL_ROWS} "
                  f"tile={rk.KERNEL_TILE} exact=True "
                  f"kernel_ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
                  f"library_ms={k['library_ms']:.4f} "
                  f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) "
                  f"of_bound={k['bound_ms'] / k['ms']:.3f} "
                  f"kernel_ms_clean_l2={k['clean_ms']:.4f}")
        print(f"pass counting_sort_pass [{dist}]: n={KERNEL_ROWS} exact=True "
              f"ms={r['pass_ms']:.4f} plain_1bit_ms={r['pass_plain_ms']:.4f}")
    time_scatter_permutation(torch, radix, dev, flush)
    return {name: runs["uniform"][name]
            for name in ("radix_hist", "radix_scatter")}


# --------------------------------------------------------------------- #
# phase 3b: the onesweep kernels and stable_argsort
# --------------------------------------------------------------------- #

SORT_PASS_BYTES = 24    # a row a onesweep pass: 8 + 4 read, 8 + 4 written
SORT_HIST_BYTES = 8     # a row a key: radix_hist_all64 reads the key once
SORT_LAST_BYTES = 8     # a row a key: its last pass stores no key
SORT_GATHER_BYTES = 20  # a row a key gather: index, key read, key written
PER_PASS_BYTES = 32     # a row a per-pass pass: 8 read by radix_hist64, 12
                        # read and 12 written by radix_scatter64
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def onesweep_keys(torch, dev) -> dict:
    """int64 keys of one SF=1 device batch for the onesweep kernels: one
    uniform 64-bit key, query A's skew on SEGMENT's hash (28.5% of the
    rows, the dead ones, at INT64_MAX) and one value everywhere (a
    single digit at every shift)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    n = KERNEL_ROWS
    uni = torch.randint(I64_MIN, I64_MAX, (n,), generator=gen, device=dev,
                        dtype=torch.int64)
    skew = uni.clone()
    skew[torch.rand(n, generator=gen, device=dev) >= LIVE_SHARE_A] = I64_MAX
    return {"uniform 64-bit": uni, "tail skew": skew,
            "one value": torch.full((n,), -0x2A5A5A5A5A5A5A5A,
                                    dtype=torch.int64, device=dev)}


def time_onesweep(torch, os1, rk, key, val, flush) -> dict:
    """``radix_hist_all64`` (8 digits) and ``radix_onesweep64`` (shift 0)
    exactly against their plain versions and the per-pass kernels,
    with kernel, plain, library and bound times."""
    n = key.numel()
    dev = key.device
    out = {}
    hist = os1.radix_hist_all64(key, 8)
    plain = os1.radix_hist_all64_plain(key, 8)
    torch.cuda.synchronize()
    err_h = int((hist - plain).abs().max())
    check(torch.equal(hist, plain), "radix_hist_all64 != its plain version")
    for p in range(8):
        check(torch.equal(hist[p], rk.radix_hist(key, 8 * p).sum(
            0, dtype=torch.int32)), f"radix_hist_all64 digit {p} != the "
              "radix_hist64 summed")
    h2 = torch.empty_like(hist)
    digits = [(key ^ I64_MIN) >> (8 * p) & 255 for p in range(8)]
    for p in range(8):
        check(torch.equal(torch.bincount(digits[p], minlength=256).to(
            torch.int32), hist[p]), "bincount yardstick != radix_hist_all64")
    b_ms, b_by = bound_ms(8 * n + 8 * 256 * 4, 8 * n)
    out["radix_hist_all64"] = dict(
        ms=cuda_ms(torch, lambda: os1.launch_hist_all(key, 8, h2),
                   flush=flush, prep=h2.zero_),
        plain_ms=cuda_ms(torch, lambda: os1.radix_hist_all64_plain(key, 8),
                         reps=3, flush=flush),
        library_ms=cuda_ms(torch, lambda: [torch.bincount(
            d, minlength=256) for d in digits], flush=flush),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err_h)
    del digits

    hp = hist[0]
    got = os1.radix_onesweep64(key, val, hp, 0)
    plain = os1.radix_onesweep64_plain(key, val, hp, 0)
    ref = rk.counting_sort_pass(key, val, 0)
    torch.cuda.synchronize()
    err_p = max(int((g - q).abs().max()) for g, q in zip(got, plain))
    check(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]),
          "radix_onesweep64 != its plain version")
    check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
          "radix_onesweep64 != counting_sort_pass")
    _, v_only = os1.radix_onesweep64(key, val, hp, 0, store_key=False)
    check(torch.equal(v_only, ref[1]), "radix_onesweep64 without the key "
          "store != counting_sort_pass")
    dig = (key ^ I64_MIN) & 255
    check(torch.equal(val[torch.sort(dig, stable=True).indices], got[1]),
          "stable sort yardstick != radix_onesweep64")
    status = torch.zeros(os1.status_words(n), dtype=torch.int64, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    k2, v2 = torch.empty_like(key), torch.empty_like(val)
    err = rk.new_err(dev)

    def zero():
        status.zero_()
        counter.zero_()
    b_ms, b_by = bound_ms(SORT_PASS_BYTES * n + 256 * 4, 4 * n)
    out["radix_onesweep64"] = dict(
        ms=cuda_ms(torch, lambda: os1.launch_pass(
            key, val, hp, status, counter, 0, k2, v2, err), flush=flush,
            prep=zero),
        plain_ms=cuda_ms(torch, lambda: os1.radix_onesweep64_plain(
            key, val, hp, 0), reps=3, flush=flush),
        library_ms=cuda_ms(torch, lambda: torch.sort(dig, stable=True),
                           flush=flush),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err_p)
    check(int(err.item()) == 0, "a timed onesweep launch reported an error")
    out["per_pass_ms"] = cuda_ms(torch, lambda: rk.counting_sort_pass(
        key, val, 0), flush=flush)
    return out


def sort_cases(torch, dev) -> dict:
    """Key sets of one SF=1 device batch (8,388,608 rows): one uniform
    64-bit key (8 passes), a 23-bit key such as l_orderkey (3 passes
    after the skip), and TopN's keys (dead flag with query A's share of
    dead rows, then per ORDER BY key a null flag and the key: ~price and
    l_orderkey, at lineitem's ranges)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n = KERNEL_ROWS

    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int64)
    dead = (torch.rand(n, generator=gen, device=dev)
            >= LIVE_SHARE_A).to(torch.int32)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    return {"uniform 64-bit": [ints(I64_MIN, I64_MAX)],
            "23-bit": [ints(0, 1 << 23)],
            "TopN keys": [dead, zeros, ~ints(90_000, 10_500_000), zeros,
                          ints(1, 6_000_000)]}


def library_argsort(torch, keys):
    """The library yardstick: ``torch.sort(stable=True)`` once a key,
    LSD, each key gathered by the permutation so far."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k[perm]
        order = torch.sort(kk, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def per_pass_argsort(torch, rk, S, keys):
    """The second yardstick, the per-pass ``stable_argsort``: the same LSD sort
    with one ``counting_sort_pass`` (``radix_hist64``, the offsets'
    torch ops, ``radix_scatter64``) a digit and one error read."""
    n, dev = keys[0].numel(), keys[0].device
    err = rk.new_err(dev)
    perm = None
    for key, passes in zip(reversed(keys), reversed(S.plan_passes(keys))):
        if passes == 0:
            continue
        k = (key if perm is None else key[perm]).to(torch.int64)
        v = (torch.arange(n, dtype=torch.int32, device=dev)
             if perm is None else perm)
        for p in range(passes):
            k, v = rk.counting_sort_pass(k.contiguous(), v, 8 * p, err)
        perm = v
    rk.read_err(err, "per_pass_argsort")
    if perm is None:
        return torch.arange(n, dtype=torch.int64, device=dev)
    return perm.to(torch.int64)


def sort_phase(torch, rk, os1, S, dev) -> dict:
    """The int64 per-pass kernels at shift 0 on the uniform key against
    their plain versions; the onesweep kernels on three keys against
    theirs and the per-pass kernels (the ``kernels`` line takes the
    uniform key's); then ``stable_argsort`` on each key set, exactly
    against its plain version, the library sort and the per-pass sort
    on the card, with kernel, plain, library, per-pass and bound times,
    and its launches: one ``radix_hist_all64`` a key with passes, one
    ``radix_onesweep64`` a pass, none of the per-pass kernels."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MiB
    val = torch.arange(KERNEL_ROWS, dtype=torch.int32, device=dev)
    keys64 = onesweep_keys(torch, dev)
    r = time_kernels(torch, rk, keys64["uniform 64-bit"], val, flush)
    for name in ("radix_hist64", "radix_scatter64"):
        k = r[name]
        print(f"kernel {name} [uniform 64-bit]: n={KERNEL_ROWS} "
              f"tile={rk.KERNEL_TILE} exact=True "
              f"kernel_ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
              f"library_ms={k['library_ms']:.4f} "
              f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) "
              f"of_bound={k['bound_ms'] / k['ms']:.3f} "
              f"kernel_ms_clean_l2={k['clean_ms']:.4f}")
    print(f"pass counting_sort_pass int64 [uniform 64-bit]: "
          f"n={KERNEL_ROWS} exact=True ms={r['pass_ms']:.4f} "
          f"plain_1bit_ms={r['pass_plain_ms']:.4f}")
    kern = {name: r[name] for name in ("radix_hist64", "radix_scatter64")}
    for dist, key in keys64.items():
        o = time_onesweep(torch, os1, rk, key, val, flush)
        for name in ("radix_hist_all64", "radix_onesweep64"):
            k = o[name]
            print(f"kernel {name} [{dist}]: n={KERNEL_ROWS} "
                  f"tile={os1.KERNEL_TILE} exact=True "
                  f"equals_per_pass=True kernel_ms={k['ms']:.4f} "
                  f"plain_ms={k['plain_ms']:.4f} "
                  f"library_ms={k['library_ms']:.4f} "
                  f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) "
                  f"of_bound={k['bound_ms'] / k['ms']:.3f}")
        print(f"pass counting_sort_pass int64 (per-pass kernels) [{dist}]: "
              f"n={KERNEL_ROWS} ms={o['per_pass_ms']:.4f}")
        if dist == "uniform 64-bit":
            kern.update({name: o[name] for name in ("radix_hist_all64",
                                                    "radix_onesweep64")})
    del keys64
    for name, keys in sort_cases(torch, dev).items():
        plan = S.plan_passes(keys)
        passes = sum(plan)
        sorted_keys = sum(1 for p in plan if p)
        gathers = max(sorted_keys - 1, 0)
        before, before_os = dict(rk.LAUNCHES), dict(os1.LAUNCHES)
        got = S.stable_argsort(keys)
        ran = {k: os1.LAUNCHES[k] - before_os[k] for k in os1.LAUNCHES}
        check(ran == {"radix_hist_all64": sorted_keys,
                      "radix_onesweep64": passes},
              f"stable_argsort [{name}]: launches {ran} for {sorted_keys} "
              f"keys and {passes} passes")
        check(rk.LAUNCHES == before,
              f"stable_argsort [{name}] launched a per-pass kernel")
        check(torch.equal(got, S.stable_argsort_plain(keys)),
              f"stable_argsort [{name}] != stable_argsort_plain")
        check(torch.equal(got, library_argsort(torch, keys)),
              f"stable_argsort [{name}] != the library sort")
        check(torch.equal(got, per_pass_argsort(torch, rk, S, keys)),
              f"stable_argsort [{name}] != the per-pass sort")
        ms = cuda_ms(torch, lambda: S.stable_argsort(keys), flush=flush)
        plain_ms = cuda_ms(torch, lambda: S.stable_argsort_plain(keys),
                           reps=3, flush=flush)
        lib_ms = cuda_ms(torch, lambda: library_argsort(torch, keys),
                         flush=flush)
        pp_ms = cuda_ms(torch, lambda: per_pass_argsort(torch, rk, S, keys),
                         flush=flush)
        nbytes = (SORT_PASS_BYTES * passes
                  + (SORT_HIST_BYTES - SORT_LAST_BYTES) * sorted_keys
                  + SORT_GATHER_BYTES * gathers) * KERNEL_ROWS
        b_ms, b_by = bound_ms(nbytes, KERNEL_ROWS * passes)
        pp_b_ms, _ = bound_ms((PER_PASS_BYTES * passes
                                + SORT_GATHER_BYTES * gathers) * KERNEL_ROWS,
                               KERNEL_ROWS * passes)
        print(f"sort stable_argsort [{name}]: n={KERNEL_ROWS} "
              f"keys={len(keys)} passes={passes} gathers={gathers} "
              f"exact=True ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} per_pass_ms={pp_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) of_bound={b_ms / ms:.3f} "
              f"per_pass_bound_ms={pp_b_ms:.4f} "
              f"launches=hist_all:{sorted_keys},onesweep:{passes}")
    return kern


# --------------------------------------------------------------------- #
# phase 4: group_reduce against its plain version
# --------------------------------------------------------------------- #

GR_GROUPS = (1, 12, 4096, 1_000_000, 1 << 23)
GR_LIVE = 0.7               # share of rows the mask keeps
GR_SINK = 0.25              # share of rows in the sink slot at G = 2^23
FSUM_RTOL = 1e-12           # float sums: of the slot's sum of |v|


def gr_cases():
    """(G, dtype name, how) of every group_reduce case."""
    out = []
    for G in GR_GROUPS:
        for dtype in ("int64", "float64"):
            out += [(G, dtype, how) for how in ("sum", "min", "max")]
        out += [(G, "int16", how) for how in ("min", "max")]
    return out


def gr_inputs(torch, dev, G: int, seed: int):
    """Mask and gids at the main path's row count: gids int32 uniform in
    [0, G), a quarter of the rows in the sink slot G at G = 2^23, none
    for G = 1 (SCALAR)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = MAIN_ROWS
    mask = torch.rand(n, generator=gen, device=dev) < GR_LIVE
    if G == 1:
        return mask, None
    gids = torch.randint(0, G, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    if G == 1 << 23:
        gids[torch.rand(n, generator=gen, device=dev) < GR_SINK] = G
    return mask, gids


def gr_values(torch, dev, dtype: str, seed: int):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = MAIN_ROWS
    if dtype == "float64":
        return torch.randn(n, generator=gen, device=dev,
                           dtype=torch.float64) * 1e6
    if dtype == "int16":
        return torch.randint(-32768, 32768, (n,), generator=gen, device=dev,
                             dtype=torch.int16)
    return torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen,
                         device=dev, dtype=torch.int64)


def gr_check(torch, gr, got, want, vals, mask, gids, G, how) -> float:
    """Raise unless the kernel's table equals the plain version's;
    returns the largest absolute difference."""
    if vals.dtype.is_floating_point and how == "sum":
        absum = gr.group_reduce_plain(vals.abs(), mask, gids, G, "sum")
        err = (got - want).abs()
        check(bool((err <= FSUM_RTOL * absum).all()),
              f"group_reduce G={G} float sum beyond {FSUM_RTOL} of sum|v|")
        return float(err.max())
    check(got.dtype == want.dtype and torch.equal(got, want),
          f"group_reduce G={G} {vals.dtype} {how} != plain")
    return 0.0


def group_reduce_phase(torch, gr, dev) -> float:
    """The one-lane call (``group_reduce``, one lane of the lanes kernel)
    in every case exact (or within FSUM_RTOL) against the plain version
    on the card, float sums bit-equal between two launches, with kernel,
    plain, library and bound times; returns the largest error."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MiB
    max_err = 0.0
    inputs = {}
    for G, dtype, how in gr_cases():
        if G not in inputs:
            inputs.clear()
            inputs[G] = gr_inputs(torch, dev, G, G % 1000 + 1)
        mask, gids = inputs[G]
        vals = gr_values(torch, dev, dtype, 7)
        got = gr.group_reduce(vals, mask, gids, G, how)
        want = gr.group_reduce_plain(vals, mask, gids, G, how)
        err = gr_check(torch, gr, got, want, vals, mask, gids, G, how)
        max_err = max(max_err, err)
        same = True
        if dtype == "float64" and how == "sum":
            same = torch.equal(got, gr.group_reduce(vals, mask, gids, G,
                                                    how))
            check(same, f"group_reduce G={G} float sum differs between "
                        "two launches")
        # the library yardstick: one scatter of the values, dead rows
        # sent to the sink slot beforehand
        gsink = torch.where(mask, torch.zeros((), dtype=torch.int64,
                                              device=dev)
                            if gids is None else gids.to(torch.int64), G)
        neu = gr.neutral(vals.dtype, how)

        def lib():
            out = torch.full((G + 1,), neu, dtype=vals.dtype, device=dev)
            if how == "sum":
                return out.index_add_(0, gsink, vals)
            return out.scatter_reduce_(0, gsink, vals, reduce="a" + how,
                                       include_self=True)
        lib_out = lib()[:G]
        if how != "sum" or dtype != "float64":
            check(torch.equal(lib_out, got), f"library yardstick G={G} "
                  f"{dtype} {how} != group_reduce")
        ms = cuda_ms(torch, lambda: gr.group_reduce(vals, mask, gids, G,
                                                    how), flush=flush)
        plain_ms = cuda_ms(torch, lambda: gr.group_reduce_plain(
            vals, mask, gids, G, how), flush=flush)
        lib_ms = cuda_ms(torch, lib, flush=flush)
        gid_bytes = 0 if gids is None else gids.element_size()
        nbytes = MAIN_ROWS * (vals.element_size() + 1 + gid_bytes) \
            + G * vals.element_size()
        b_ms, b_by = bound_ms(nbytes, MAIN_ROWS)
        cols = gr.lane_cols("fsum" if how == "sum" and dtype == "float64"
                            else how)
        print(f"kernel group_reduce [G={G} {dtype} {how}]: n={MAIN_ROWS} "
              f"table={gr.table_mode(G, cols)} exact={err == 0.0} "
              f"max_abs_err={err:.3g} two_launches_equal={same} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"of_bound={b_ms / ms:.3f}")
        del vals, got, want, gsink, lib_out
    return max_err


# the high-NDV paths' shape: one SF=1 batch; 6,000,000 live rows in
# 3,793,365 groups (SORT's table of 4,194,304) or 5,999,988 (SEGMENT's
# of 8,388,608)
GR_HIGH = ((1 << 22, 3_793_365), (1 << 23, 5_999_988))
GR_HIGH_LIVE = 6_000_000
# TPC-H Q1's dense gids: four of the twelve slots, with lineitem's shares
# of (A, F), (R, F), (N, O) and (N, F); the shipdate filter keeps 98.6%
Q1_SLOTS = ((0, 0.247), (3, 0.247), (7, 0.493), (6, 0.013))
Q1_LIVE = 0.986
Q6_LIVE = 0.019             # rows Q6's predicates keep


def gr_high_inputs(torch, dev, G: int, groups: int, order: str):
    """Mask and int64 gids of the segment reduce at the high-NDV shape:
    the live rows first, in segment order (every group of ``[0, groups)``
    present, sorted, as ``states_from_partition`` receives them after
    ``stable_argsort``), the dead rows after them in the sink slot G; or
    the same rows in a random order."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(G + len(order))
    n, live = KERNEL_ROWS, GR_HIGH_LIVE
    extra = torch.randint(0, groups, (live - groups,), generator=gen,
                          device=dev, dtype=torch.int64)
    gids = torch.full((n,), G, dtype=torch.int64, device=dev)
    gids[:live] = torch.sort(torch.cat([torch.arange(
        groups, device=dev, dtype=torch.int64), extra])).values
    mask = torch.arange(n, device=dev) < live
    if order == "random":
        perm = torch.randperm(n, generator=gen, device=dev)
        gids, mask = gids[perm], mask[perm]
    return mask, gids


def q1_lane_inputs(torch, dev, n: int, dist: str = "Q1"):
    """TPC-H Q1's reduction inputs at their placed dtypes: int32 dense
    gids (Q1's four slots, or uniform over the twelve), the filter's
    mask, int8 quantity, int32 price and the two int64 products
    (price x (100 - disc), x (100 + tax))."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    if dist == "uniform":
        gid = torch.randint(0, 12, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    else:
        u = torch.rand(n, generator=gen, device=dev)
        gid = torch.full((n,), Q1_SLOTS[-1][0], dtype=torch.int32,
                         device=dev)
        acc = 0.0
        for slot, share in Q1_SLOTS[:-1]:
            gid[(u >= acc) & (u < acc + share)] = slot
            acc += share
    mask = torch.rand(n, generator=gen, device=dev) < Q1_LIVE
    qty = torch.randint(1, 51, (n,), generator=gen, device=dev,
                        dtype=torch.int8)
    price = torch.randint(90_000, 10_500_000, (n,), generator=gen,
                          device=dev, dtype=torch.int32)
    disc = torch.randint(0, 11, (n,), generator=gen, device=dev)
    tax = torch.randint(0, 9, (n,), generator=gen, device=dev)
    dp = price.to(torch.int64) * (100 - disc)
    ch = dp * (100 + tax)
    return gid, mask, qty, price, dp, ch


def limb_lanes(gr, mask, srcs, narrow=()):
    """The lanes of a state table of COUNT(*) and one SUM a source, over
    one mask: ``__rows__`` and each SUM's count are one lane (the mask is
    the selection), then hi and lo a source, or one ``sum`` word for a
    source in ``narrow`` (a proven-narrow SUM, read at its stored
    width)."""
    lanes = [gr.Lane("count", None, mask)]
    for i, s in enumerate(srcs):
        if i in narrow:
            lanes.append(gr.Lane("sum", s, mask))
        else:
            lanes += [gr.Lane("sum_hi32", s, mask),
                      gr.Lane("sum_lo32", s, mask)]
    return lanes


def per_lane_states(torch, gr, mask, srcs, gids, G, narrow=()):
    """The same states as one-lane launches, as the callers made them
    before the lane sets: one launch a state field, each after its eager
    transform (``__rows__``, then a SUM's cnt from ``mask.to(int64)``,
    its widening, and its ``>> 32`` and ``& 0xFFFFFFFF`` passes or, for
    a narrow SUM, the widened word)."""
    out = [gr.group_reduce(mask.to(torch.int64), mask, gids, G, "sum")]
    for i, s in enumerate(srcs):
        out.append(gr.group_reduce(mask.to(torch.int64), mask, gids, G,
                                   "sum"))
        v = s.to(torch.int64)
        if i in narrow:
            out.append(gr.group_reduce(v, mask, gids, G, "sum"))
        else:
            out.append(gr.group_reduce(v >> 32, mask, gids, G, "sum"))
            out.append(gr.group_reduce(v & 0xFFFFFFFF, mask, gids, G,
                                       "sum"))
    return out


def lanes_of_states(old, srcs, narrow=()):
    """``per_lane_states``' tables in the order of ``limb_lanes``' lanes,
    and the indexes of the SUMs' count tables (each equal to the rows
    lane)."""
    tables, cnts, k = [old[0]], [], 1
    for i in range(len(srcs)):
        cnts.append(k)
        w = 1 if i in narrow else 2
        tables += old[k + 1:k + 1 + w]
        k += 1 + w
    return tables, cnts


def lane_sets(torch, dev):
    """(name, gids, G, mask, sources, path) of the lane sets of the main
    path and the high-NDV paths, at their shapes: Q1 (67,108,864 rows,
    G = 12, int32 gids, int8/int32/int64/int64 sources), Q6 (SCALAR, one
    int64 product), SORT (8,388,608 rows, 6,000,000 live, G = 2^22,
    int64 gids, the int32 price) and SEGMENT (G = 2^23, the int8
    quantity), the high-NDV gids in segment order and in a random
    order."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    gid, mask, qty, price, dp, ch = q1_lane_inputs(torch, dev, MAIN_ROWS)
    yield "Q1", gid, 12, mask, [qty, price, dp, ch], "main", ()
    # valueflow over the analyzed SF=10 lineitem proves Q1's two column
    # SUMs narrow (60M rows x 1024 headroom x their magnitudes < 2^62)
    # and keeps the two products in limbs (phase 18b prints the slots)
    yield "Q1 narrow", gid, 12, mask, [qty, price, dp, ch], "gates", (0, 1)
    del gid, mask, qty, dp, ch
    sel = torch.rand(MAIN_ROWS, generator=gen, device=dev) < Q6_LIVE
    rev = price.to(torch.int64) * torch.randint(
        0, 11, (MAIN_ROWS,), generator=gen, device=dev)
    del price
    yield "Q6", None, 1, sel, [rev], "main", ()
    del sel, rev
    for (G, groups), what, dt in zip(GR_HIGH, ("SORT", "SEGMENT"),
                                     (torch.int32, torch.int8)):
        lo, hi = (90_000, 10_500_000) if dt == torch.int32 else (1, 51)
        src = torch.randint(lo, hi, (KERNEL_ROWS,), generator=gen,
                            device=dev).to(dt)
        for order in ("sorted", "random"):
            mask, gids = gr_high_inputs(torch, dev, G, groups, order)
            yield f"{what} G=2^{G.bit_length() - 1} {order}", gids, G, mask, \
                [src], "slice4", ()
            del mask, gids


def group_reduce_lanes_phase(torch, gr, dev) -> dict:
    """Every lane set in one launch, equal to ``group_reduce_lanes_plain``
    on the card exactly, timed as kernel, plain, library (one
    ``index_add_`` of the stacked (n, L) int64 lane matrix into a
    (G + 1, L) table, the matrix built outside the timing) and bound (the
    distinct sources' bytes at their widths, the gids and the mask once,
    and the L x G x 8 B table), and against one-lane launches for the
    same states (``per_lane_states``).  Returns the JSON entries by
    name."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MiB
    out = {}
    for name, gids, G, mask, srcs, path, narrow in lane_sets(torch, dev):
        lanes = limb_lanes(gr, mask, srcs, narrow)
        n = mask.shape[0]
        before = gr.LAUNCHES["group_reduce"]
        got = gr.group_reduce_lanes(gids, G, lanes)
        check(gr.LAUNCHES["group_reduce"] == before + 1,
              f"lane set {name}: {gr.LAUNCHES['group_reduce'] - before} "
              "launches")
        want = gr.group_reduce_lanes_plain(gids, G, lanes)
        for ln, g, w in zip(lanes, got, want):
            check(torch.equal(g, w), f"lane set {name}: {ln.kind} lane != "
                                     "plain")
        old = per_lane_states(torch, gr, mask, srcs, gids, G, narrow)
        # the old states (rows, then cnt and hi, lo or the word a source)
        # hold the same tables: cnt is the rows lane
        tables, cnts = lanes_of_states(old, srcs, narrow)
        check(all(torch.equal(old[k], got[0]) for k in cnts)
              and all(torch.equal(t, g) for t, g in zip(tables, got)),
              f"lane set {name}: per-lane states != lane set")
        if narrow:
            # the narrow word equals its limb pair recombined, bit for bit
            limbs = gr.group_reduce_lanes(gids, G, limb_lanes(gr, mask,
                                                              srcs))
            pos = 1
            for i in range(len(srcs)):
                if i in narrow:
                    word = limbs[1 + 2 * i] * (1 << 32) + limbs[2 + 2 * i]
                    check(torch.equal(got[pos], word),
                          f"lane set {name}: narrow sum {i} != limbs")
                pos += 1 if i in narrow else 2
            del limbs
        # the library yardstick: the stacked lane matrix, dead rows in the
        # sink slot G
        gsink = torch.where(mask, torch.zeros((), dtype=torch.int64,
                                              device=dev)
                            if gids is None else gids.to(torch.int64), G)
        mat = torch.stack([gr.lane_values(ln)[0] for ln in lanes], 1)

        def lib():
            return torch.zeros((G + 1, len(lanes)), dtype=torch.int64,
                               device=dev).index_add_(0, gsink, mat)
        check(torch.equal(lib()[:G].t(), torch.stack(got)),
              f"lane set {name}: index_add_ != lanes")
        ms = cuda_ms(torch, lambda: gr.group_reduce_lanes(gids, G, lanes),
                     flush=flush)
        # the plain version is the yardstick, 0.3 s a call at Q1's shape:
        # fewer samples
        plain_ms = cuda_ms(torch, lambda: gr.group_reduce_lanes_plain(
            gids, G, lanes), reps=5, flush=flush)
        lib_ms = cuda_ms(torch, lib, flush=flush)
        per_lane_ms = cuda_ms(torch, lambda: per_lane_states(
            torch, gr, mask, srcs, gids, G, narrow), flush=flush)
        del mat, gsink
        nbytes = n + sum(s.element_size() for s in srcs) * n \
            + (0 if gids is None else gids.element_size() * n) \
            + len(lanes) * G * 8
        b_ms, b_by = bound_ms(nbytes, n * len(lanes))
        key = "group_reduce" if name == "Q1" else f"group_reduce[{name}]"
        out[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
                        path=path)
        print(f"kernel group_reduce lanes [{name}]: n={n} G={G} "
              f"lanes={len(lanes)} sources="
              f"{'/'.join(str(s.dtype).split('.')[-1] for s in srcs)} "
              f"table={gr.table_mode(G, len(lanes))} exact=True launches=1 "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"of_bound={b_ms / ms:.3f} per_lane_ms={per_lane_ms:.4f} "
              f"per_lane_launches={len(old)} "
              f"per_lane_over_lanes={per_lane_ms / ms:.2f}")
        del lanes, got, want, old, gids, mask, srcs
        gc.collect()
    return out


def expected_reduces(agg) -> int:
    """group_reduce launches of one device program run of ``agg`` on one
    logical device: one, for every lane of its state table
    (copr/exec.reduce_states over the lanes _agg_partial_states or
    states_from_partition plan), as long as they fit one launch, which
    every statement here does (``expected_lanes``)."""
    from tidb_tpu_torch.copr.cuda import group_reduce as gr
    check(expected_lanes(agg) <= gr.MAX_LANES,
          f"{expected_lanes(agg)} lanes need more than one launch")
    return 1


def expected_lanes(agg) -> int:
    """Distinct lanes of ``agg``'s state table when no aggregate's
    argument is nullable: ``__rows__`` (COUNT(*) and every COUNT reuse
    it), two for a (hi, lo) limb SUM, one for MIN, MAX and a float or
    proven-narrow SUM, each once an argument (an AVG's SUM of a column
    that a SUM also sums is the same lanes: ``unique_lanes``).  One-lane
    launches took one reduction a lane, and one more for the count of
    each SUM, MIN and MAX."""
    from tidb_tpu_torch.copr import dag as D
    lanes = set()
    for i, a in enumerate(agg.aggs):
        if a.func == D.AggFunc.COUNT:
            continue
        if a.func == D.AggFunc.SUM and not a.arg.dtype.is_float \
                and i not in agg.narrow_sums:
            lanes |= {(a.arg, "sum_hi32"), (a.arg, "sum_lo32")}
        else:
            lanes.add((a.arg, a.func.value))
    return 1 + len(lanes)


# --------------------------------------------------------------------- #
# phases 5-7: the slices
# --------------------------------------------------------------------- #

A_COLS = ["l_orderkey", "l_quantity"]
B_COLS = ["l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice"]


def build_query(which: str, num_buckets: int = 0):
    """(aggregation, key metas) of query A or B over the B_COLS / A_COLS
    snapshot layout; ``num_buckets=0`` lets the client start from its
    default bucket space and regrow."""
    from tidb_tpu_torch.copr import dag as D
    from tidb_tpu_torch.copr.aggregate import GroupKeyMeta, sum_out_dtype
    from tidb_tpu_torch.expr import builders as b
    from tidb_tpu_torch.expr.ir import ColumnRef
    from tidb_tpu_torch.types import dtypes as dt
    dec2, i64 = dt.decimal(15, 2), dt.bigint(False)
    if which == "A":
        scan = D.TableScan((0, 1), (i64, dec2))
        aggs = (D.AggDesc(D.AggFunc.SUM, ColumnRef(dec2, 1),
                          sum_out_dtype(dec2)),
                D.AggDesc(D.AggFunc.COUNT, None, i64))
        return (D.Aggregation(scan, (ColumnRef(i64, 0),), aggs,
                              D.GroupStrategy.SCATTER,
                              num_buckets=num_buckets),
                [GroupKeyMeta(i64, 0)])
    scan = D.TableScan((0, 1, 2, 3), (i64, i64, dec2, dec2))
    cond = b.compare("lt", ColumnRef(dec2, 2), b.lit(45))
    aggs = (D.AggDesc(D.AggFunc.MAX, ColumnRef(dec2, 3),
                      dec2.with_nullable(True)),)
    return (D.Aggregation(D.Selection(scan, (cond,)),
                          (ColumnRef(i64, 0), ColumnRef(i64, 1)), aggs,
                          D.GroupStrategy.SCATTER, num_buckets=num_buckets),
            [GroupKeyMeta(i64, 0), GroupKeyMeta(i64, 0)])


Q_COLS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
          "l_returnflag", "l_linestatus", "l_shipdate", "l_shipinstruct",
          "l_shipmode"]
MAIN_QUERIES = ("Q1", "Q6", "Q19")


def build_main_query(which: str, names, cols):
    """(aggregation, key metas) of TPC-H Q1, Q6 or Q19 over a snapshot of
    ``names``, built with the port's builders as
    __graft_entry__._q1_dag, bench._q6_dag and bench._q19_dag build
    them.  Q1's key metas are not nullable, as its key columns are not:
    the dense gid has no NULL slot to decode."""
    from tidb_tpu_torch.copr import dag as D
    from tidb_tpu_torch.copr.aggregate import GroupKeyMeta, sum_out_dtype
    from tidb_tpu_torch.expr import builders as b
    from tidb_tpu_torch.expr.ir import ColumnRef, Const
    from tidb_tpu_torch.types import dtypes as dt
    ix = {n: i for i, n in enumerate(names)}

    def r(n):
        return ColumnRef(cols[ix[n]].dtype, ix[n], n)
    scan = D.TableScan(tuple(range(len(names))),
                       tuple(c.dtype for c in cols))

    def summed(e):
        return D.AggDesc(D.AggFunc.SUM, e, sum_out_dtype(e.dtype))
    count = D.AggDesc(D.AggFunc.COUNT, None, dt.bigint(False))
    if which == "Q1":
        sel = D.Selection(scan, (b.compare(
            "le", r("l_shipdate"), b.lit("1998-09-02", dt.date())),))
        one = b.lit(1)
        disc_price = b.arith("mul", r("l_extendedprice"),
                             b.arith("sub", one, r("l_discount")))
        charge = b.arith("mul", disc_price, b.arith("add", one, r("l_tax")))
        fd = cols[ix["l_returnflag"]].dictionary
        sd = cols[ix["l_linestatus"]].dictionary
        agg = D.Aggregation(
            sel, (r("l_returnflag"), r("l_linestatus")),
            (summed(r("l_quantity")), summed(r("l_extendedprice")),
             summed(disc_price), summed(charge), count),
            D.GroupStrategy.DENSE, domain_sizes=(len(fd) + 1, len(sd) + 1))
        return agg, [GroupKeyMeta(dt.varchar(False), len(fd) + 1, fd),
                     GroupKeyMeta(dt.varchar(False), len(sd) + 1, sd)]
    if which == "Q6":
        sel = D.Selection(scan, (
            b.compare("ge", r("l_shipdate"), b.lit("1994-01-01", dt.date())),
            b.compare("lt", r("l_shipdate"), b.lit("1995-01-01", dt.date())),
            b.between(r("l_discount"), b.decimal_lit("0.05"),
                      b.decimal_lit("0.07")),
            b.compare("lt", r("l_quantity"), b.decimal_lit("24"))))
        rev = b.arith("mul", r("l_extendedprice"), r("l_discount"))
        return D.Aggregation(sel, (), (summed(rev), count),
                             D.GroupStrategy.SCALAR), []
    (air, regair, fob, mail, ship_, truck), dip = q19_codes(names, cols)
    mode_t = r("l_shipmode").dtype
    qty = r("l_quantity")

    def clause(qlo, qhi, modes):
        return b.logic("and", b.logic(
            "and", b.between(qty, b.decimal_lit(str(qlo)),
                             b.decimal_lit(str(qhi))),
            b.in_list(r("l_shipmode"), [Const(mode_t, m) for m in modes])),
            b.compare("eq", r("l_shipinstruct"),
                      Const(r("l_shipinstruct").dtype, dip)))
    pred = b.logic("or", b.logic("or", clause(1, 11, (air, regair)),
                                 clause(10, 20, (fob, mail))),
                   clause(20, 30, (ship_, truck)))
    rev = b.arith("mul", r("l_extendedprice"),
                  b.arith("sub", b.decimal_lit("1"), r("l_discount")))
    return D.Aggregation(D.Selection(scan, (pred,)), (),
                         (summed(rev), count), D.GroupStrategy.SCALAR), []


def q19_codes(names, cols):
    ix = {n: i for i, n in enumerate(names)}
    md = cols[ix["l_shipmode"]].dictionary
    sd = cols[ix["l_shipinstruct"]].dictionary
    return ([md.code_of(m) for m in ("AIR", "REG AIR", "FOB", "MAIL",
                                     "SHIP", "TRUCK")],
            sd.code_of("DELIVER IN PERSON"))


def exact_sum(x: np.ndarray) -> int:
    """The exact sum of an int64 array as a Python int: each row's high
    and low 32 bits sum apart, neither sum can wrap below 2^31 rows."""
    x = np.asarray(x, np.int64)
    return (int((x >> 32).sum()) << 32) + int((x & 0xFFFFFFFF).sum())


def main_oracle(which: str, names, cols) -> list:
    """numpy answer rows of Q1 (flag code, status code, sum_qty,
    sum_base_price, sum_disc_price, sum_charge, count_order) in dense
    group order, or of Q6 / Q19 (revenue, count): the predicates of
    bench.py's np_q1, np_q6 and np_q19."""
    c = {n: col.data for n, col in zip(names, cols)}
    qty, price = c["l_quantity"], c["l_extendedprice"]
    disc, tax, ship = c["l_discount"], c["l_tax"], c["l_shipdate"]
    if which == "Q1":
        keep = ship <= 10471                     # 1998-09-02
        dp = price * (100 - disc)
        ch = dp * (100 + tax)
        gid = c["l_returnflag"].astype(np.int64) * 3 + c["l_linestatus"]
        rows = []
        for g in np.unique(gid[keep]):
            m = keep & (gid == g)
            rows.append((int(g) // 3, int(g) % 3, exact_sum(qty[m]),
                         exact_sum(price[m]), exact_sum(dp[m]),
                         exact_sum(ch[m]), int(m.sum())))
        return rows
    if which == "Q6":
        m = ((ship >= 8766) & (ship < 9131) & (disc >= 5) & (disc <= 7)
             & (qty < 2400))
        return [(exact_sum(price[m] * disc[m]), int(m.sum()))]
    (air, regair, fob, mail, ship_, truck), dip = q19_codes(names, cols)
    mode, inst = c["l_shipmode"], c["l_shipinstruct"]
    c1 = (qty >= 100) & (qty <= 1100) & ((mode == air) | (mode == regair))
    c2 = (qty >= 1000) & (qty <= 2000) & ((mode == fob) | (mode == mail))
    c3 = (qty >= 2000) & (qty <= 3000) & ((mode == ship_) | (mode == truck))
    m = (c1 | c2 | c3) & (inst == dip)
    return [(exact_sum(price[m] * (100 - disc[m])), int(m.sum()))]


def main_answer(main_res: dict, name: str):
    """Phase 7's answer of statement ``name`` over the main lineitem,
    checked there against numpy (Q6's corpus form shares Q6's): the
    ``dag`` of ``sql_check``; None for another statement."""
    return main_res.get("Q6" if name == "Q6 corpus" else name)


def main_q6(main_res: dict) -> int:
    """TPC-H Q6's revenue over the main lineitem scaled by 10^4, phase
    7's answer (``q6_params_oracle`` at ``SERVER_Q6_PARAMS[0]``)."""
    return main_res["Q6"][0][0]


def result_rows(res) -> list:
    """[(keys..., values...)] of a CopResult as Python ints; a NULL
    fails the check (none of these queries yields one)."""
    cols = res.key_columns + res.columns
    for c in cols:
        check(bool(np.asarray(c.validity).all()), "unexpected NULL output")
    n = len(cols[0].data) if cols else 0
    return [tuple(int(c.data[i]) for c in cols) for i in range(n)]


def oracle(which: str, cols: dict) -> tuple[list, list]:
    """numpy answer: (key arrays, value arrays), groups in key order."""
    ok = cols["l_orderkey"].data
    qty = cols["l_quantity"].data
    if which == "A":
        u, inv = np.unique(ok, return_inverse=True)
        s = np.zeros(len(u), np.int64)
        np.add.at(s, inv, qty)
        return [u], [s, np.bincount(inv, minlength=len(u))]
    keep = qty < 4500
    keys = np.stack([ok[keep], cols["l_suppkey"].data[keep]], axis=1)
    u, inv = np.unique(keys, axis=0, return_inverse=True)
    mx = np.full(len(u), np.iinfo(np.int64).min)
    np.maximum.at(mx, inv.reshape(-1), cols["l_extendedprice"].data[keep])
    return [u[:, 0], u[:, 1]], [mx]


def result_arrays(res) -> tuple[list, list]:
    keys = [np.asarray(c.data).astype(np.int64) for c in res.key_columns]
    order = np.lexsort(keys[::-1])
    vals = [np.array([int(x) for x in c.data], dtype=np.int64)[order]
            if c.data.dtype == object else np.asarray(c.data)[order]
            for c in res.columns]
    for c in res.columns + res.key_columns:
        check(bool(np.asarray(c.validity).all()), "unexpected NULL output")
    return [k[order] for k in keys], vals


def leaves(tree: dict, prefix: str = ""):
    """(dotted name, tensor) of every leaf of a nested state dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def reference_phase(torch, dev) -> None:
    """A small lineitem through the GPU path and through the plain CPU
    path: states (per device for SCATTER, merged for Q1/Q6/Q19) and
    final results must be equal."""
    from tidb_tpu_torch.parallel.spmd import ShardedCopProgram
    from tidb_tpu_torch.store import CopClient, snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    names, cols = gen_lineitem(0.01, seed=3, columns=B_COLS + Q_COLS[1:])
    bycol = dict(zip(names, cols))
    runs = [("A", A_COLS), ("B", B_COLS)] + [(q, Q_COLS)
                                             for q in MAIN_QUERIES]
    for which, use in runs:
        snap = snapshot_from_columns(use, [bycol[c] for c in use])
        if which in MAIN_QUERIES:
            agg, meta = build_main_query(which, use,
                                         [bycol[c] for c in use])
        else:
            agg, meta = build_query(which, 1 << 16)
        st = {}
        for d in (dev, torch.device("cpu")):
            cols_d, counts = snap.device_cols((d,))
            st[d.type] = ShardedCopProgram(agg, (d,))(cols_d, counts)
        flat = {side: dict(leaves(tree)) for side, tree in st.items()}
        check(flat["cuda"].keys() == flat["cpu"].keys(), "state names")
        for k in flat["cpu"]:
            check(torch.equal(flat["cuda"][k].cpu(), flat["cpu"][k]),
                  f"query {which}: GPU state {k} != CPU plain state")
        gpu = CopClient("cuda").execute_agg(agg, snap, meta)
        cpu = CopClient("cpu", 8).execute_agg(agg, snap, meta)
        if which in MAIN_QUERIES:
            want = main_oracle(which, use, [bycol[c] for c in use])
            for got in (gpu, cpu):
                check(result_rows(got) == want,
                      f"query {which}: small result")
            groups = len(want)
        else:
            want = oracle(which, bycol)
            for got in (result_arrays(gpu), result_arrays(cpu)):
                for g, w in zip(got[0] + got[1], want[0] + want[1]):
                    check(np.array_equal(g, w),
                          f"query {which}: small result")
            groups = len(want[0][0])
        print(f"reference query {which}: rows={len(cols[0])} "
              f"groups={groups} gpu_states==cpu_states=True "
              f"gpu==cpu==numpy=True")


def reset(counters) -> None:
    for launches in counters:
        for name in launches:
            launches[name] = 0


RADIX32 = ("radix_hist", "radix_scatter")   # the SCATTER partition's


def slice_phase(torch, rk, gr, sf: float) -> dict:
    from tidb_tpu_torch.copr import dag as D
    from tidb_tpu_torch.store import CopClient, snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    t0 = time.perf_counter()
    names, cols = gen_lineitem(sf, seed=0, columns=B_COLS)
    bycol = dict(zip(names, cols))
    n_rows = len(cols[0])
    print(f"data: lineitem sf={sf} rows={n_rows} "
          f"gen_s={time.perf_counter() - t0:.2f}")
    reset((rk.LAUNCHES, gr.LAUNCHES))    # counts of this path only
    expected = reduces = 0
    for which in ("A", "B"):
        use = A_COLS if which == "A" else B_COLS
        snap = snapshot_from_columns(use, [bycol[c] for c in use])
        agg, meta = build_query(which)
        client = CopClient(device="cuda")
        before = dict(rk.LAUNCHES)
        before_gr = gr.LAUNCHES["group_reduce"]
        t0 = time.perf_counter()
        res = client.execute_agg(agg, snap, meta)
        wall = time.perf_counter() - t0
        t = client.timings
        passes = [D.radix_passes(b) for b in t["buckets"]]
        for name in RADIX32:
            got = rk.LAUNCHES[name] - before[name]
            check(got == sum(passes),
                  f"query {which}: {name} launched {got} times for "
                  f"{sum(passes)} radix passes")
        expected += sum(passes)
        got_gr = gr.LAUNCHES["group_reduce"] - before_gr
        want_gr = expected_reduces(agg) * len(passes)
        check(got_gr == want_gr, f"query {which}: group_reduce launched "
              f"{got_gr} times, its programs imply {want_gr}")
        reduces += want_gr
        want = oracle(which, bycol)
        got = result_arrays(res)
        check(len(got[0][0]) == len(want[0][0]),
              f"query {which}: {len(got[0][0])} groups, want "
              f"{len(want[0][0])}")
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            check(np.array_equal(g, w), f"query {which}: result != numpy")
        print(f"slice query {which}: rows={n_rows} groups={len(want[0][0])} "
              f"ms={wall * 1e3:.1f} rows_per_s={n_rows / wall:.0f} "
              f"buckets={t['buckets']} passes={passes} "
              f"hist_launches={sum(passes)} scatter_launches={sum(passes)} "
              f"group_reduce_launches={got_gr} "
              f"place_ms={t['place'] * 1e3:.1f} hash_ms={t['hash'] * 1e3:.1f} "
              f"device_ms={t['device'] * 1e3:.1f} "
              f"transfer_ms={t['transfer'] * 1e3:.1f} "
              f"merge_ms={t['merge'] * 1e3:.1f} exact=True")
    counts = {name: rk.LAUNCHES[name] for name in RADIX32}
    for name, c in counts.items():
        check(c == expected and c > 0, f"{name}: {c} main-path launches")
    check(rk.LAUNCHES["radix_hist64"] == 0, "SCATTER ran an int64 pass")
    check(gr.LAUNCHES["group_reduce"] == reduces,
          f"group_reduce: {gr.LAUNCHES['group_reduce']} SCATTER launches")
    return counts


def main_path_phase(torch, gr, sf: float) -> tuple[int, dict, tuple]:
    """TPC-H Q1, Q6 and Q19 at ``sf`` through CopClient(device="cuda"),
    each equal to the numpy oracle; returns the group_reduce launches of
    the three, each query's result rows and the generated ``(names,
    cols)`` (phase 9 runs Q1 and Q6 as SQL over them)."""
    from tidb_tpu_torch.store import CopClient, snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    t0 = time.perf_counter()
    names, cols = gen_lineitem(sf, seed=0, columns=Q_COLS)
    t1 = time.perf_counter()
    snap = snapshot_from_columns(names, cols)
    n_rows = len(cols[0])
    queries = {q: build_main_query(q, names, cols) for q in MAIN_QUERIES}
    print(f"data: lineitem sf={sf} rows={n_rows} columns={len(names)} "
          f"gen_s={t1 - t0:.2f}")
    reset((gr.LAUNCHES,))               # counts of this path only
    total = 0
    results = {}
    for which in MAIN_QUERIES:
        agg, meta = queries[which]
        client = CopClient(device="cuda")
        before = gr.LAUNCHES["group_reduce"]
        t0 = time.perf_counter()
        res = client.execute_agg(agg, snap, meta)
        wall = time.perf_counter() - t0
        got = gr.LAUNCHES["group_reduce"] - before
        want_n = expected_reduces(agg)
        check(got == want_n, f"{which}: group_reduce launched {got} times, "
              f"_agg_partial_states implies {want_n}")
        total += got
        t = client.timings
        rows = result_rows(res)
        want = main_oracle(which, names, cols)
        check(rows == want, f"{which}: result != numpy oracle")
        batch = int(snap.device_cols(client.devices)[0][0][0].numel())
        print(f"main query {which}: rows={n_rows} batch_rows={batch} "
              f"groups={len(rows)} ms={wall * 1e3:.1f} "
              f"rows_per_s={n_rows / wall:.0f} "
              f"group_reduce_launches={got} "
              f"place_ms={t['place'] * 1e3:.1f} "
              f"device_ms={t['device'] * 1e3:.1f} "
              f"transfer_ms={t['transfer'] * 1e3:.1f} "
              f"merge_ms={t['merge'] * 1e3:.1f} exact=True")
        print(f"main query {which} result: {rows}")
        results[which] = rows
    check(gr.LAUNCHES["group_reduce"] == total and total > 0,
          f"group_reduce: {gr.LAUNCHES['group_reduce']} main-path launches")
    return total, results, (names, cols)


# --------------------------------------------------------------------- #
# slice 4: SORT, SEGMENT and the row-returning path
# --------------------------------------------------------------------- #

S4_COLS = ["l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
           "l_discount"]
S4_QUERIES = ("SORT", "SEGMENT", "TopN", "Limit", "rows")
TOPN_LIMIT = 10
LIMIT = 5


def build_s4(which: str, cap: int = 0, float_key: bool = False):
    """(kind, root, key metas) of a slice-4 statement over the S4_COLS
    layout (a DOUBLE key ``l_dkey`` appended when ``float_key``), built
    with the port's builders; ``cap`` is the SORT/SEGMENT table's
    capacity (0: the client's default, then regrown).
        SORT:    select l_orderkey, sum(l_extendedprice) from lineitem
                 group by l_orderkey
        SEGMENT: select l_orderkey, l_partkey, count(*), sum(l_quantity)
                 from lineitem group by l_orderkey, l_partkey
        TopN:    select l_orderkey, l_extendedprice from lineitem
                 order by l_extendedprice desc, l_orderkey limit 10
        Limit:   select l_partkey from lineitem limit 5
        rows:    select l_orderkey, l_extendedprice * (1 - l_discount)
                 from lineitem where l_quantity < 5
    With ``float_key``, SORT groups by l_dkey and SEGMENT by (l_dkey,
    l_orderkey)."""
    from tidb_tpu_torch.copr import dag as D
    from tidb_tpu_torch.copr.aggregate import GroupKeyMeta, sum_out_dtype
    from tidb_tpu_torch.expr import builders as b
    from tidb_tpu_torch.expr.ir import ColumnRef
    from tidb_tpu_torch.types import dtypes as dt
    i64, dec2, f64 = dt.bigint(False), dt.decimal(15, 2), dt.double(False)
    types = (i64, i64, dec2, dec2, dec2) + ((f64,) if float_key else ())
    scan = D.TableScan(tuple(range(len(types))), types)
    ok, pk = ColumnRef(i64, 0), ColumnRef(i64, 1)
    qty, price, disc = (ColumnRef(dec2, i) for i in (2, 3, 4))
    if which == "SORT":
        keys = (ColumnRef(f64, 5),) if float_key else (ok,)
        return "agg", D.Aggregation(
            scan, keys, (D.AggDesc(D.AggFunc.SUM, price,
                                   sum_out_dtype(dec2)),),
            D.GroupStrategy.SORT, group_capacity=cap), \
            [GroupKeyMeta(k.dtype, 0) for k in keys]
    if which == "SEGMENT":
        keys = (ColumnRef(f64, 5), ok) if float_key else (ok, pk)
        return "agg", D.Aggregation(
            scan, keys, (D.AggDesc(D.AggFunc.COUNT, None, i64),
                         D.AggDesc(D.AggFunc.SUM, qty, sum_out_dtype(dec2))),
            D.GroupStrategy.SEGMENT, num_buckets=cap), \
            [GroupKeyMeta(k.dtype, 0) for k in keys]
    if which == "TopN":
        return "rows", D.TopN(D.Projection(scan, (ok, price)),
                              sort_keys=((ColumnRef(dec2, 1), True),
                                         (ColumnRef(i64, 0), False)),
                              limit=TOPN_LIMIT), None
    if which == "Limit":
        return "rows", D.Limit(D.Projection(scan, (pk,)), LIMIT), None
    sel = D.Selection(scan, (b.compare("lt", qty, b.lit(5)),))
    return "rows", D.Projection(sel, (ok, b.arith(
        "mul", price, b.arith("sub", b.lit(1), disc)))), None


def s4_snapshot(sf: float, seed: int, float_key: bool = False):
    """(snapshot, {name: Column}) of lineitem's S4_COLS at ``sf``, with
    a DOUBLE key l_dkey (l_discount / 100, every 7th row -0.0 and every
    13th NaN) appended when ``float_key``."""
    from tidb_tpu_torch.chunk.column import Column
    from tidb_tpu_torch.store import snapshot_from_columns
    from tidb_tpu_torch.testing.tpch import gen_lineitem
    from tidb_tpu_torch.types import dtypes as dt
    names, cols = gen_lineitem(sf, seed=seed, columns=S4_COLS)
    if float_key:
        d = cols[names.index("l_discount")].data / 100.0
        d[::7] = -0.0
        d[::13] = np.nan
        names = names + ["l_dkey"]
        cols = cols + [Column.from_numpy(dt.double(False), d)]
    return snapshot_from_columns(names, cols), dict(zip(names, cols))


def _cell(x):
    """One result cell as a comparable Python value: ints exact, floats
    with NaN as the string "nan" and -0.0 as 0.0."""
    if isinstance(x, (float, np.floating)):
        return "nan" if np.isnan(x) else float(x) + 0.0
    return int(x)


def agg_map(res) -> dict:
    """{key tuple: value tuple} of an aggregation's CopResult."""
    out = {}
    for i in range(len(res.columns[0].data)):
        key = tuple(_cell(c.data[i]) if c.validity[i] else None
                    for c in res.key_columns)
        out[key] = tuple(_cell(c.data[i]) if c.validity[i] else None
                         for c in res.columns)
    check(len(out) == len(res.columns[0].data), "duplicate result groups")
    return out


def rows_map(cols) -> list:
    """The rows of ``execute_rows``' columns, in order."""
    return [tuple(_cell(c.data[i]) if c.validity[i] else None for c in cols)
            for i in range(len(cols[0].data))]


def reference_cases(sf: float, seed: int = 3) -> list:
    """(name, kind, root, snapshot, key metas) of the slice-4 statements
    on a small lineitem, plus SORT and SEGMENT over a DOUBLE key with
    -0.0 and NaN."""
    snap, _ = s4_snapshot(sf, seed)
    fsnap, _ = s4_snapshot(sf, seed, float_key=True)
    out = []
    for which in S4_QUERIES:
        kind, root, meta = build_s4(which, cap=1 << 16)
        out.append((which, kind, root, snap, meta))
    for which in ("SORT", "SEGMENT"):
        kind, root, meta = build_s4(which, cap=1 << 16, float_key=True)
        out.append((f"{which} DOUBLE key", kind, root, fsnap, meta))
    return out


def reference_phase4(torch, dev) -> None:
    """Each reference case through the GPU path and the plain CPU path:
    the per-device states (or compacted rows and counts) and the
    client's results must be equal."""
    from tidb_tpu_torch.copr import dag as D
    from tidb_tpu_torch.parallel.spmd import ShardedCopProgram
    from tidb_tpu_torch.store import CopClient
    for name, kind, root, snap, meta in reference_cases(0.01):
        cap = 1 << 14
        st = {}
        for side, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            cols_d, counts = snap.device_cols((d,))
            out = ShardedCopProgram(root, (d,), row_capacity=cap)(cols_d,
                                                                  counts)
            if kind == "rows":
                out_cols, n = out
                out = {"count": n}
                for j, (v, m) in enumerate(out_cols):
                    out[f"c{j}"] = {"data": v, "valid": m}
            st[side] = dict(leaves(out))
        check(st["cuda"].keys() == st["cpu"].keys(), f"{name}: state names")
        for k, want in st["cpu"].items():
            got = st["cuda"][k].cpu()
            if want.is_floating_point():
                got, want = got.view(torch.int64), want.view(torch.int64)
            check(torch.equal(got, want),
                  f"{name}: GPU {k} != CPU plain {k}")
        if kind == "agg":
            gpu, cpu = (agg_map(CopClient(d).execute_agg(root, snap, meta))
                        for d in ("cuda", "cpu"))
        else:
            gpu, cpu = (rows_map(CopClient(d).execute_rows(
                root, snap, D.output_dtypes(root))) for d in ("cuda", "cpu"))
        check(gpu == cpu, f"{name}: GPU result != CPU result")
        print(f"reference {name}: rows={snap.num_rows} results={len(gpu)} "
              f"gpu_states==cpu_states=True gpu==cpu=True")


def s4_oracle(which: str, c: dict):
    """numpy answer of a slice-4 statement: (key arrays, value arrays) in
    key order for SORT and SEGMENT, the rows' columns for the rest (the
    top 10 for TopN, the table's first rows for Limit)."""
    ok, pk = c["l_orderkey"].data, c["l_partkey"].data
    qty, price = c["l_quantity"].data, c["l_extendedprice"].data
    if which == "SORT":
        u, inv = np.unique(ok, return_inverse=True)
        s = np.zeros(len(u), np.int64)
        np.add.at(s, inv, price)
        return [u], [s]
    if which == "SEGMENT":
        both = ok * (1 << 20) + pk
        u, inv, cnt = np.unique(both, return_inverse=True,
                                return_counts=True)
        s = np.zeros(len(u), np.int64)
        np.add.at(s, inv, qty)
        return [u >> 20, u & ((1 << 20) - 1)], [cnt, s]
    if which == "TopN":
        order = np.lexsort((ok, -price))[:TOPN_LIMIT]
        return [ok[order], price[order]]
    if which == "Limit":
        return [pk[:LIMIT]]
    keep = qty < 500
    return [ok[keep], price[keep] * (100 - c["l_discount"].data[keep])]


def _rows_arrays(cols) -> list:
    for c in cols:
        check(bool(np.asarray(c.validity).all()), "unexpected NULL output")
    return [np.array([int(x) for x in c.data], dtype=np.int64)
            if c.data.dtype == object else np.asarray(c.data) for c in cols]


def slice4_phase(torch, rk, os1, gr, S, sf: float) -> tuple[dict, dict]:
    """The five slice-4 statements on one 8-shard lineitem snapshot at
    ``sf`` through ``CopClient(device="cuda")``: SORT and SEGMENT by
    ``execute_agg``, TopN, Limit and the filtered projection by
    ``execute_rows``, each equal to the numpy oracle (TopN re-trimmed to
    its top 10, as the root does); ``radix_onesweep64``'s launches equal
    the passes ``stable_argsort`` ran, ``radix_hist_all64``'s the keys it
    sorted, none of the per-pass radix kernels ran, and group_reduce's
    launches equal the reductions the aggregations' programs imply.
    Returns the launch counts and each statement's result arrays (keys
    and values in key order, or the rows' columns)."""
    from tidb_tpu_torch.copr import dag as D
    from tidb_tpu_torch.store import CopClient
    t0 = time.perf_counter()
    snap, bycol = s4_snapshot(sf, 0)
    n_rows = snap.num_rows
    print(f"data: lineitem sf={sf} rows={n_rows} columns={len(S4_COLS)} "
          f"gen_s={time.perf_counter() - t0:.2f}")
    reset((rk.LAUNCHES, os1.LAUNCHES, gr.LAUNCHES, S.PASSES))  # this path's
    reduces = 0
    res = None
    results = {}
    for which in S4_QUERIES:
        kind, root, meta = build_s4(which)
        client = CopClient(device="cuda")
        # the previous statement's result (up to 6,000,000 groups of
        # Python ints) is freed and collected outside the timed window
        del res
        gc.collect()
        before = S.PASSES["stable_argsort"]
        before_gr = gr.LAUNCHES["group_reduce"]
        t0 = time.perf_counter()
        if kind == "agg":
            res = client.execute_agg(root, snap, meta)
        else:
            res = client.execute_rows(root, snap, D.output_dtypes(root))
        wall = time.perf_counter() - t0
        t = client.timings
        passes = S.PASSES["stable_argsort"] - before
        got_gr = gr.LAUNCHES["group_reduce"] - before_gr
        want = s4_oracle(which, bycol)
        if kind == "agg":
            want_gr = expected_reduces(root) * len(t["buckets"])
            check(got_gr == want_gr, f"{which}: group_reduce launched "
                  f"{got_gr} times, its programs imply {want_gr}")
            reduces += want_gr
            got = result_arrays(res)
            check(len(got[0][0]) == len(want[0][0]),
                  f"{which}: {len(got[0][0])} groups, want "
                  f"{len(want[0][0])}")
            for g, w in zip(got[0] + got[1], want[0] + want[1]):
                check(np.array_equal(g, w), f"{which}: result != numpy")
            size = f"groups={len(want[0][0])} capacity={t['buckets']}"
            split = f"merge_ms={t['merge'] * 1e3:.1f}"
        else:
            got = _rows_arrays(res)
            if which == "TopN":      # the root's re-trim of the union
                order = np.lexsort((got[0], -got[1]))[:TOPN_LIMIT]
                got = [g[order] for g in got]
            for g, w in zip(got, want):
                check(np.array_equal(g, w), f"{which}: rows != numpy")
            size = f"out_rows={len(res[0].data)} pages={t['pages']}"
            split = f"assemble_ms={t['assemble'] * 1e3:.1f}"
        results[which] = got
        print(f"slice4 query {which}: rows={n_rows} {size} "
              f"ms={wall * 1e3:.1f} rows_per_s={n_rows / wall:.0f} "
              f"sort_passes={passes} group_reduce_launches={got_gr} "
              f"place_ms={t['place'] * 1e3:.1f} "
              f"hash_ms={t.get('hash', 0.0) * 1e3:.1f} "
              f"device_ms={t['device'] * 1e3:.1f} "
              f"transfer_ms={t['transfer'] * 1e3:.1f} {split} exact=True")
    counts = dict(os1.LAUNCHES)
    check(counts["radix_onesweep64"] == S.PASSES["stable_argsort"]
          and counts["radix_onesweep64"] > 0,
          f"radix_onesweep64: {counts['radix_onesweep64']} launches for "
          f"{S.PASSES['stable_argsort']} stable_argsort passes")
    check(counts["radix_hist_all64"] == S.PASSES["stable_argsort_keys"]
          and counts["radix_hist_all64"] > 0,
          f"radix_hist_all64: {counts['radix_hist_all64']} launches for "
          f"{S.PASSES['stable_argsort_keys']} sorted keys")
    check(not any(rk.LAUNCHES.values()),
          f"slice 4 launched a per-pass radix kernel: {rk.LAUNCHES}")
    check(gr.LAUNCHES["group_reduce"] == reduces,
          f"group_reduce: {gr.LAUNCHES['group_reduce']} slice-4 launches")
    print(f"slice4 launches: radix_hist_all64={counts['radix_hist_all64']} "
          f"radix_onesweep64={counts['radix_onesweep64']} "
          f"stable_argsort_keys={S.PASSES['stable_argsort_keys']} "
          f"stable_argsort_passes={S.PASSES['stable_argsort']} "
          f"radix_hist64=0 radix_scatter64=0 group_reduce={reduces}")
    counts.update(radix_hist64=0, radix_scatter64=0,
                  group_reduce_slice4=reduces)
    return counts, results


# --------------------------------------------------------------------- #
# phase 9: SQL text through the port's session
# --------------------------------------------------------------------- #

SQL_COLS = ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
            "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
            "l_linestatus", "l_shipdate"]
SQL_MAIN = ("Q1", "Q6")              # at --main-sf, over phase 7's columns
# "SORT two keys filtered" (27-28 s of host decode) is left out, a cut
# for the script's time limit (PERF.md §4): phase 8's SEGMENT and the
# two-key SORT below run its plan shape
SQL_CORPUS = ("Q6 corpus", "Q1 corpus", "SORT", "SORT two keys",
              "TopN", "Limit", "rows", "HAVING")
# the DAG-level run of the same statement: phase 7's (Q1, Q6) or phase
# 8's (the rest) result of that name
SQL_DAG = {"Q1": "Q1", "Q6": "Q6", "SORT": "SORT",
           "SORT two keys": "SEGMENT", "TopN": "TopN", "Limit": "Limit",
           "rows": "rows"}
GR, OS = ("group_reduce",), ("radix_hist_all64", "radix_onesweep64")
# the hand kernels each statement launches; Limit and the filtered
# projection run no hand kernel (the device compaction is eager torch)
SQL_KERNELS = {"Q1": GR, "Q6": GR, "Q6 corpus": GR, "Q1 corpus": GR,
               "HAVING": GR, "SORT": GR + OS, "SORT two keys": GR + OS,
               "SORT two keys filtered": GR + OS, "TopN": OS, "Limit": (),
               "rows": ()}
# the plain versions of those kernels, none of which may run on the card
SQL_PLAIN = (("gr", "group_reduce_plain"),
             ("os1", "radix_hist_all64_plain"),
             ("os1", "radix_onesweep64_plain"))
SQL_SLOW_S = 1.0    # a warm call that takes longer is the only one
SQL_WARM = 5        # else the median of this many
# the corpus statements whose first call is already warm (their table
# placed by the session's first statement) and takes 2-38 s: they run
# once, a cut for the script's time limit (PERF.md §4)
SQL_ONCE = ("SORT", "SORT two keys", "rows")


def sql_columns(rs) -> list:
    """The result set's columns as lists of cells for the oracles: a
    DECIMAL as its scaled integer, a string as is, anything else as an
    int; a NULL fails (a column at a time: the SORT statements return
    millions of rows)."""
    from tidb_tpu_torch.types import dtypes as dt
    out = []
    for j, t in enumerate(rs.dtypes):
        col = [r[j] for r in rs.rows]
        check(None not in col, "unexpected NULL output")
        if t.kind == dt.TypeKind.DECIMAL:
            out.append([int(v.scaleb(t.scale)) for v in col])
        else:
            out.append([v if isinstance(v, str) else int(v) for v in col])
    return out


def avg_ok(avg, total: int, count: int, scale: int, t) -> bool:
    """An AVG within half a unit of its last decimal place of the exact
    quotient ``total / 10^scale / count``."""
    from fractions import Fraction
    exact = Fraction(total, 10 ** scale * count)
    return abs(Fraction(avg) - exact) <= Fraction(1, 2 * 10 ** t.scale)


def sql_key_order(cols: list, n_keys: int) -> list:
    """The columns of an aggregation's result in key order."""
    keys = [np.asarray(c, dtype=np.int64) for c in cols[:n_keys]]
    order = np.lexsort(keys[::-1])
    return [np.asarray(c, dtype=np.int64)[order] for c in cols]


Q1_ORACLE: dict = {}     # q1_groups by the identity of its columns


@host_work("oracle")
def q1_groups(c: dict, names) -> dict:
    """{(flag, status): (sum_qty, sum_price, sum_disc, sum_disc_price,
    sum_charge, count)} over the rows shipped by 1998-09-02, exact.
    Computed once a set of columns: the phases check Q1 over the same
    lineitem many times, and the columns live for the whole run."""
    arrays = tuple(c[n].data for n in Q1_ORACLE_COLS)
    key = tuple(map(id, arrays))
    if key not in Q1_ORACLE:     # the entry holds the arrays: ids stay
        Q1_ORACLE[key] = (arrays, _q1_groups(c))
    return Q1_ORACLE[key][1]


Q1_ORACLE_COLS = ("l_shipdate", "l_quantity", "l_extendedprice",
                  "l_discount", "l_tax", "l_returnflag", "l_linestatus")


def _q1_groups(c: dict) -> dict:
    ship = c["l_shipdate"].data
    keep = ship <= 10471                     # 1998-09-02
    qty, price = c["l_quantity"].data, c["l_extendedprice"].data
    disc, tax = c["l_discount"].data, c["l_tax"].data
    dp = price * (100 - disc)
    ch = dp * (100 + tax)
    fl, st = c["l_returnflag"], c["l_linestatus"]
    out = {}
    for f in np.unique(fl.data[keep]):
        for s in np.unique(st.data[keep]):
            m = keep & (fl.data == f) & (st.data == s)
            if m.any():
                out[(fl.dictionary.values[f], st.dictionary.values[s])] = (
                    exact_sum(qty[m]), exact_sum(price[m]),
                    exact_sum(disc[m]), exact_sum(dp[m]), exact_sum(ch[m]),
                    int(m.sum()))
    return out


@host_work("oracle")
def sql_check(name: str, rs, c: dict, names, dag) -> None:
    """``rs`` of statement ``name`` against its numpy oracle over the
    columns ``c``; where phase 7 or 8 ran it over the same rows, against
    that run's result ``dag`` instead, which equals the oracle's answer
    (checked there).  Q1 is held against both."""
    cols = sql_columns(rs)
    if name in ("Q1", "Q1 corpus"):
        groups = q1_groups(c, names)
        check(len(rs.rows) == len(groups) and
              [r[:2] for r in rs.rows] == sorted(groups),
              f"{name}: groups {[r[:2] for r in rs.rows]}")
        for i, row in enumerate(rs.rows):
            qty, price, disc, dp, ch, n = groups[row[:2]]
            vals = [col[i] for col in cols]
            t = rs.dtypes
            if name == "Q1":
                check(vals[2:6] + [vals[9]] == [qty, price, dp, ch, n],
                      f"Q1 {row[:2]}: sums != numpy")
                check(avg_ok(row[6], qty, n, 2, t[6])
                      and avg_ok(row[7], price, n, 2, t[7])
                      and avg_ok(row[8], disc, n, 2, t[8]),
                      f"Q1 {row[:2]}: AVG != numpy")
            else:
                check(vals[2:4] + [vals[5]] == [qty, price, n]
                      and avg_ok(row[4], disc, n, 2, t[4]),
                      f"Q1 corpus {row[:2]}: != numpy")
        if dag is not None:      # phase 7: codes, then Q1's sums, count
            want = [(f, s, q, p, d, h, k) for f, s, q, p, d, h, k in dag]
            got = [(c["l_returnflag"].dictionary.code_of(r[0]),
                    c["l_linestatus"].dictionary.code_of(r[1]),
                    cols[2][i], cols[3][i], cols[4][i], cols[5][i],
                    cols[9][i]) for i, r in enumerate(rs.rows)]
            check(got == want, "Q1: SQL != the DAG-level run")
        return
    if name in ("Q6", "Q6 corpus"):
        want = dag if dag is not None else \
            main_oracle("Q6", names, [c[n] for n in names])
        check(cols == [[want[0][0]]], f"{name}: {cols} != numpy {want}")
        return
    if name == "HAVING":
        u, n = np.unique(c["l_returnflag"].data, return_counts=True)
        d = c["l_returnflag"].dictionary
        want = sorted((d.values[k], int(m)) for k, m in zip(u, n) if m > 1)
        check(sorted(zip(cols[0], cols[1])) == want, "HAVING != numpy")
        return
    if name == "SORT two keys filtered":
        keys, vals = oracle("B", c)
        got = sql_key_order(cols, 2)
        check(all(np.array_equal(g, w) for g, w in zip(got, keys + vals)),
              f"{name} != numpy")
        return
    which = {"SORT": "SORT", "SORT two keys": "SEGMENT"}.get(name, name)
    want = dag if dag is not None else s4_oracle(which, c)
    if which in ("SORT", "SEGMENT"):
        want = want[0] + want[1]
        got = sql_key_order(cols, len(want) - (1 if which == "SORT" else 2))
    else:
        got = [np.asarray(col, dtype=np.int64) for col in cols]
    check(len(got) == len(want) and all(
        np.array_equal(g, w) for g, w in zip(got, want)), f"{name} != numpy")


class plain_guard:
    """Counts the calls of the kernels' plain versions while it is
    entered (module attributes swapped for counting wrappers)."""

    def __init__(self, modules: dict):
        self.modules, self.calls, self.saved = modules, 0, []

    def __enter__(self):
        for mod, name in SQL_PLAIN:
            m = self.modules[mod]
            fn = getattr(m, name)
            self.saved.append((m, name, fn))

            def counted(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)
            setattr(m, name, counted)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def sql_run(sess, name: str, sql: str, counters,
            warm_calls: int = SQL_WARM) -> tuple:
    """Statement ``name`` through ``sess.execute``: the first call, then
    ``warm_calls`` warm calls (one, if it takes longer than
    ``SQL_SLOW_S``); returns the last result, the first and median warm
    wall seconds (the first's when ``warm_calls`` is 0) and the last
    call's, the session's and the client's timings of the last call,
    and the launches of the hand kernels over all the calls."""
    before = {k: v for launches in counters for k, v in launches.items()}
    gc.collect()
    t0 = time.perf_counter()
    rs = sess.execute(sql)
    first = time.perf_counter() - t0
    warm = []
    while len(warm) < warm_calls and (not warm or warm[-1] <= SQL_SLOW_S):
        del rs
        gc.collect()
        t0 = time.perf_counter()
        rs = sess.execute(sql)
        warm.append(time.perf_counter() - t0)
    launched = {k: v - before[k] for launches in counters
                for k, v in launches.items()}
    warm = warm or [first]
    return (rs, first, statistics.median(warm), warm[-1],
            dict(sess.timings), dict(sess.domain.client.timings), launched)


def sql_phase(gr, os1, S, main_data, main_res, s4_sf: float,
              s4_res: dict) -> tuple:
    """TPC-H Q1 and Q6 as SQL text over phase 7's lineitem (``--main-sf``)
    and the corpus's lineitem-only statements over lineitem at
    ``--s4-sf`` (seed 0, as phase 8), each through the port's
    ``Session`` on ``cuda:0``: each equal to its numpy oracle and to the
    DAG-level run of phases 7 and 8, each launching its hand kernels,
    none of their plain versions running.  Prints each statement's
    first and warm wall times and the warm call's split; returns the
    phase's launch counts and the ``--s4-sf`` lineitem ``(names,
    cols)`` (phase 10 joins over it)."""
    from tidb_tpu_torch.testing import tpch
    rk_counts = (gr.LAUNCHES, os1.LAUNCHES)
    t0 = time.perf_counter()
    with host_work("gen"):
        names, cols = tpch.gen_lineitem(s4_sf, seed=0, columns=SQL_COLS)
    print(f"data: lineitem sf={s4_sf} rows={len(cols[0])} "
          f"columns={len(names)} gen_s={time.perf_counter() - t0:.2f}")
    runs = [("main", tpch.sql_session({"lineitem": main_data},
                                      device="cuda"),
             dict(zip(*main_data)), main_data[0], SQL_MAIN, main_res),
            ("corpus", tpch.sql_session({"lineitem": (names, cols)},
                                        device="cuda"),
             dict(zip(names, cols)), names, SQL_CORPUS, s4_res)]
    reset(rk_counts + (S.PASSES,))          # counts of this path only
    with plain_guard({"gr": gr, "os1": os1}) as guard:
        for scale, sess, c, tnames, stmts, dag_res in runs:
            n_rows = len(next(iter(c.values())))
            for name in stmts:
                rs, first, warm, last, st, ct, launched = sql_run(
                    sess, name, tpch.SQL_QUERIES[name], rk_counts,
                    0 if name in SQL_ONCE else SQL_WARM)
                for k in SQL_KERNELS[name]:
                    check(launched[k] > 0, f"SQL {name}: {k} not launched")
                check("device" in ct, f"SQL {name}: no device program ran")
                dag = dag_res.get(SQL_DAG.get(name))
                sql_check(name, rs, c, tnames, dag)
                client_s = sum(v for k, v in ct.items()
                               if isinstance(v, float))
                host_op = st["execute"] - client_s
                split = " ".join(f"{k}_ms={v * 1e3:.3f}"
                                 for k, v in ct.items()
                                 if isinstance(v, float))
                print(f"sql {name}: rows={n_rows} out_rows={len(rs.rows)} "
                      f"first_ms={first * 1e3:.3f} warm_ms={warm * 1e3:.3f} "
                      f"parse_ms={st['parse'] * 1e3:.3f} "
                      f"plan_ms={st['plan'] * 1e3:.3f} {split} "
                      f"host_op_ms={host_op * 1e3:.3f} "
                      f"decode_ms={st['decode'] * 1e3:.3f} "
                      f"overhead_ms={(last - client_s) * 1e3:.3f} "
                      f"rows_per_s={n_rows / warm:.0f} "
                      f"launches={ {k: launched[k] for k in GR + OS} } "
                      f"dag_equal={dag is not None} "
                      f"first_is_warm={name in SQL_ONCE} exact=True")
                del rs
    check(guard.calls == 0, f"SQL path ran {guard.calls} plain-version "
          "calls of its kernels on the card")
    counts = {k: v for launches in rk_counts for k, v in launches.items()}
    for k in GR + OS:
        check(counts[k] > 0, f"SQL path: {k} launched {counts[k]} times")
    print(f"sql launches: {counts} stable_argsort_passes="
          f"{S.PASSES['stable_argsort']} plain_calls={guard.calls}")
    return counts, (names, cols)


# --------------------------------------------------------------------- #
# phase 10: joins
# --------------------------------------------------------------------- #

JOIN_LI_EXTRA = ["l_orderkey", "l_partkey", "l_suppkey"]   # beside Q_COLS
JOIN_DEVICE = "cuda"
JOIN_ORDERS = 1_500_000      # the broadcast statements' orders: < 2^22
# at --main-sf through one Session on the card: the broadcast statements
# (orders of 1,500,000 rows), then TPC-H Q19 and the repartition join
# over orders of SF's order count ("shuffle big")
JOIN_MAIN = ("join agg", "join rows", "semi", "anti", "broadcast step",
             "Q19", "shuffle big")
# at --s4-sf: the m:n joins, the chain, the host sort over a join and the
# host hash join on one logical device, then both repartition statements
# on eight logical devices of the card (broadcast budget 0)
JOIN_S4 = ("m:n inner", "m:n left", "three tables", "join TopN",
           "left join ON filter")
JOIN_S4_SHUFFLE = ("shuffle", "shuffle group by")
# the hand kernels each statement launches: group_reduce for the
# aggregations on the card, the onesweep pair for the repartition join's
# build sort and the SORT aggregation
JOIN_KERNELS = {"join agg": GR, "join rows": (), "semi": (), "anti": GR,
                "broadcast step": GR, "Q19": GR + OS, "shuffle big": GR + OS,
                "m:n inner": GR, "m:n left": GR, "three tables": (),
                "join TopN": GR + OS, "left join ON filter": (),
                "shuffle": GR + OS, "shuffle group by": GR + OS}
# the operator the statement's plan holds
JOIN_PLANNED = {"Q19": "CopShuffleJoin[agg,inner] part x lineitem",
                "shuffle big": "CopShuffleJoin[agg,inner]",
                "shuffle": "CopShuffleJoin[agg,inner]",
                "shuffle group by": "CopShuffleJoin[agg,inner]",
                "left join ON filter": "HostHashJoin[left]",
                "m:n inner": "CopJoinTask[agg,inner]",
                "m:n left": "CopJoinTask[agg,left]"}
JOIN_TEXT = {"shuffle big": 0, "shuffle": 0, "shuffle group by": 1}


def join_sql(name: str) -> str:
    from tidb_tpu_torch.testing import tpch
    if name in JOIN_TEXT:
        return tpch.TPCH_SHUFFLE_QUERIES[JOIN_TEXT[name]]
    return tpch.JOIN_QUERIES[name]


def exact_bincount(keys: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """Per-key sums of int64 ``vals``, exact: float64 sums of integers
    stay exact below 2^53."""
    check(int(np.abs(vals).sum()) < 2 ** 53, "bincount oracle past 2^53")
    return np.bincount(keys, weights=vals, minlength=n).astype(np.int64)


def q19_mask(li: dict, part: dict) -> np.ndarray:
    """The lineitem rows TPC-H Q19 (the spec's validation values) keeps,
    the part attributes gathered by ``l_partkey``."""
    pk = li["l_partkey"].data
    n_part = len(part["p_partkey"].data)
    ok = (pk >= 1) & (pk <= n_part)
    row = np.clip(pk, 1, n_part) - 1
    brand, cont = part["p_brand"], part["p_container"]
    size = part["p_size"].data[row]
    qty = li["l_quantity"].data
    mode, instr = li["l_shipmode"], li["l_shipinstruct"]

    def codes(col, vals):
        return [c for c in (col.dictionary.code_of(v) for v in vals) if c >= 0]
    keep = ok & np.isin(mode.data, codes(mode, ("AIR", "AIR REG"))) & (
        instr.data == instr.dictionary.code_of("DELIVER IN PERSON"))
    any_branch = np.zeros(len(pk), bool)
    for b, conts, q, smax in (
            ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
            ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10,
             10),
            ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20,
             15)):
        any_branch |= ((brand.data[row] == brand.dictionary.code_of(b))
                       & np.isin(cont.data[row], codes(cont, conts))
                       & (qty >= q * 100) & (qty <= (q + 10) * 100)
                       & (size >= 1) & (size <= smax))
    return keep & any_branch


def join_check(name: str, rs, li: dict, part: dict, orders: dict) -> None:
    """``rs`` of join statement ``name`` against its numpy oracle: a
    unique-key join through a lookup array indexed by the key (part and
    orders keys are 1..n), an m:n join through per-key counts, a
    row-returning one by finding each row among the joined rows."""
    cols = sql_columns(rs)
    okey, pk = li["l_orderkey"].data, li["l_partkey"].data
    price, qty = li["l_extendedprice"].data, li["l_quantity"].data
    n_part = len(part["p_partkey"].data) if part else 0
    n_ord = len(orders["o_orderkey"].data)
    prow = np.clip(pk, 1, max(n_part, 1)) - 1
    p_ok = (pk >= 1) & (pk <= n_part)
    size = part["p_size"].data[prow] if part else None
    brand = part["p_brand"] if part else None
    o_ok = (okey >= 1) & (okey <= n_ord)
    orow = np.clip(okey, 1, n_ord) - 1
    if name == "join agg":
        m = p_ok & (qty < 1000)
        b = brand.data[prow[m]]
        sums = exact_bincount(b, price[m], len(brand.dictionary))
        seen = np.bincount(b, minlength=len(brand.dictionary)) > 0
        want = {brand.dictionary.values[c]: int(sums[c])
                for c in np.nonzero(seen)[0]}
        check(dict(zip(cols[0], cols[1])) == want, f"{name} != numpy")
        return
    if name in ("join rows", "semi"):
        limit = 20 if name == "join rows" else 10
        check(len(rs.rows) == limit, f"{name}: {len(rs.rows)} rows")
        for i, ok in enumerate(cols[0]):
            lo, hi = np.searchsorted(okey, [ok, ok + 1])   # sorted keys
            hit = p_ok[lo:hi] & (size[lo:hi] > (40 if limit == 20 else 45))
            if name == "join rows":
                hit &= brand.data[prow[lo:hi]] == brand.dictionary.code_of(
                    cols[1][i])
            check(hit.any(), f"{name}: row {rs.rows[i]} is not joined")
        return
    if name == "anti":
        cust = np.unique(orders["o_custkey"].data)
        want = int((~np.isin(li["l_suppkey"].data, cust)).sum())
        check(cols == [[want]], f"{name}: {cols} != numpy {want}")
        return
    if name == "broadcast step":
        m = p_ok & (size < 25)
        want = [[int(m.sum())], [exact_sum(price[m])]]
        check(cols == want, f"{name}: {cols} != numpy {want}")
        return
    if name == "Q19":
        m = q19_mask(li, part)
        check(m.any(), "Q19: no row qualifies at this scale")
        disc = li["l_discount"].data[m]
        want = exact_sum(price[m] * (100 - disc))
        check(cols == [[want]], f"Q19: {cols} != numpy {want}")
        return
    if name in ("shuffle big", "shuffle"):
        tp = orders["o_totalprice"].data
        want = [[int(o_ok.sum())], [exact_sum(qty[o_ok] + tp[orow[o_ok]])]]
        check(cols == want, f"{name}: {cols} != numpy {want}")
        return
    if name == "shuffle group by":
        ck = orders["o_custkey"].data[orow[o_ok]]
        sums = exact_bincount(ck, qty[o_ok], int(ck.max()) + 1)
        want = {int(k): int(sums[k]) for k in np.unique(ck)}
        check(dict(zip(cols[0], cols[1])) == want, f"{name} != numpy")
        return
    if name in ("m:n inner", "m:n left"):
        cnt = np.bincount(orders["o_custkey"].data)
        c = np.where(okey < len(cnt), cnt[np.clip(okey, 0, len(cnt) - 1)], 0)
        want = ([[int(c.sum())], [exact_sum(price * c)]]
                if name == "m:n inner"
                else [[int(np.maximum(c, 1).sum())], [int(c.sum())]])
        check(cols == want, f"{name}: {cols} != numpy {want}")
        return
    if name == "three tables":
        check(len(rs.rows) == 10, f"{name}: {len(rs.rows)} rows")
        tp = orders["o_totalprice"].data
        for tpv, b, q in zip(*cols):
            hit = o_ok & p_ok & (tp[orow] == tpv) & (qty == q) & (
                brand.data[prow] == brand.dictionary.code_of(b))
            check(hit.any(), f"{name}: row {(tpv, b, q)} is not joined")
        return
    if name == "join TopN":
        sums = exact_bincount(okey[o_ok], price[o_ok], n_ord + 1)
        top = np.sort(sums)[::-1][:5]
        check(sorted(cols[1], reverse=True) == [int(x) for x in top]
              and all(int(sums[k]) == r for k, r in zip(*cols)),
              f"{name} != numpy")
        return
    if name == "left join ON filter":
        want = [[len(okey)], [int((p_ok & (size < 3)).sum())]]
        check(cols == want, f"{name}: {cols} != numpy {want}")
        return
    raise RuntimeError(f"no oracle for {name}")


def swap_table(sess, name: str, data) -> None:
    """Replace table ``name`` of ``sess``'s catalog by ``(names, cols)``
    (the other tables keep their snapshots, so their placement too)."""
    from tidb_tpu_torch.session.catalog import TableInfo
    names, cols = data
    cat = sess.domain.catalog
    cat.drop_table("test", name)
    t = TableInfo(name, list(names), [c.dtype for c in cols])
    t.register_columns(list(cols))
    cat.create_table("test", t)


def probe_steps(torch, dev, li: dict, part: dict, li_s4: dict,
                orders_s4: dict) -> dict:
    """Device ms of the broadcast join's probe steps at the aggregated
    join's shape (--main-sf lineitem against part), each against its
    memory bound (inputs read once, outputs written once, over
    ``HBM_BYTES_PER_S``): ``searchsorted`` of the probe keys into the
    sorted build keys, the gathers of the unique join (match test,
    permutation, one int32 build column), and the m:n join's
    ``expand_slots`` at its --s4-sf shape (lineitem on orders.o_custkey)."""
    from tidb_tpu_torch.copr import join as J
    kv = torch.from_numpy(li["l_partkey"].data).to(dev, torch.int64)
    keys = np.asarray(part["p_partkey"].data, np.int64)
    order = np.argsort(keys, kind="stable")
    sk = torch.from_numpy(keys[order]).to(dev)
    perm = torch.from_numpy(order.astype(np.int64)).to(dev)
    bcol = torch.from_numpy(part["p_brand"].data).to(dev)
    n, b = kv.numel(), sk.numel()
    out = {}
    idx = torch.searchsorted(sk, kv)
    out["searchsorted"] = (cuda_ms(torch, lambda: torch.searchsorted(
        sk, kv)), bound_ms(8 * n + 8 * b + 8 * n, 0)[0])

    def gathers():
        idxc = idx.clamp(0, b - 1)
        matched = sk[idxc] == kv
        brow = perm[idxc]
        return matched, bcol[brow]
    out["gathers"] = (cuda_ms(torch, gathers),
                      bound_ms(8 * n + 8 * n + 12 * b + n + 4 * n, 0)[0])
    ck = np.sort(np.asarray(orders_s4["o_custkey"].data, np.int64))
    sk2 = torch.from_numpy(ck).to(dev)
    kv2 = torch.from_numpy(li_s4["l_orderkey"].data).to(dev, torch.int64)
    ok2 = torch.ones(kv2.numel(), dtype=torch.bool, device=dev)
    _lo, _hi, cnt = J.match_ranges(sk2, sk2.numel(), kv2, ok2)
    n2 = cnt.numel()
    # the statement's first capacity: probe rows x the mean duplication
    # (executor/physical.py CopJoinTaskExec._execute_single)
    dup = len(ck) / len(np.unique(ck))
    cap = 1 << max(int(n2 * dup) - 1, 1023).bit_length()
    out["expand_slots"] = (
        cuda_ms(torch, lambda: J.expand_slots(ok2, cnt, "inner", cap)),
        bound_ms(n2 + 8 * n2 + cap * (8 + 8 + 1 + 1), 0)[0])
    out["shapes"] = {"probe_rows": n, "build_rows": b, "mn_probe_rows": n2,
                     "mn_out_capacity": cap}
    return out


def join_phase(torch, gr, os1, S, main_data, main_sf: float, s4_data,
               s4_sf: float) -> dict:
    """The join statements (``JOIN_MAIN`` at ``--main-sf``, ``JOIN_S4``
    and ``JOIN_S4_SHUFFLE`` at ``--s4-sf``) through the port's
    ``Session`` on ``cuda:0``: each equal to its numpy oracle, planned
    as stated, launching its hand kernels with no plain version run and
    no join fallback taken; prints first and warm ms and the client's
    split, the join capacities and the probe steps' device ms.  Returns
    the phase's launch counts."""
    from tidb_tpu_torch.executor import plan as pplan
    from tidb_tpu_torch.testing import tpch
    counters = (gr.LAUNCHES, os1.LAUNCHES)
    t0 = time.perf_counter()
    extra = tpch.gen_lineitem(main_sf, seed=0, columns=JOIN_LI_EXTRA)
    li_main = (list(main_data[0]) + extra[0], list(main_data[1]) + extra[1])
    part_main = tpch.gen_part(main_sf, seed=7)
    orders_b = tpch.gen_orders_mini(JOIN_ORDERS)
    orders_big = tpch.gen_orders_mini(int(1_500_000 * main_sf))
    part_s4 = tpch.gen_part(s4_sf, seed=7)
    orders_s4 = tpch.gen_orders_mini(int(1_500_000 * s4_sf))
    print(f"data: lineitem sf={main_sf} rows={len(li_main[1][0])} "
          f"columns={len(li_main[0])}; part rows={len(part_main[1][0])}; "
          f"orders rows={len(orders_b[1][0])} and "
          f"{len(orders_big[1][0])}; at sf={s4_sf}: lineitem "
          f"rows={len(s4_data[1][0])} part rows={len(part_s4[1][0])} "
          f"orders rows={len(orders_s4[1][0])} "
          f"gen_s={time.perf_counter() - t0:.2f}")

    def cols(data):
        return dict(zip(*data))
    main = tpch.sql_session({"lineitem": li_main, "part": part_main,
                             "orders": orders_b}, device=JOIN_DEVICE)
    s4 = tpch.sql_session({"lineitem": s4_data, "part": part_s4,
                           "orders": orders_s4}, device=JOIN_DEVICE)
    s4x8 = tpch.sql_session({"lineitem": s4_data, "orders": orders_s4},
                            device=JOIN_DEVICE, n_devices=8)
    runs = [(main, n, cols(li_main), cols(part_main), cols(orders_b))
            for n in JOIN_MAIN]
    runs += [(s4, n, cols(s4_data), cols(part_s4), cols(orders_s4))
             for n in JOIN_S4]
    runs += [(s4x8, n, cols(s4_data), {}, cols(orders_s4))
             for n in JOIN_S4_SHUFFLE]
    reset(counters + (S.PASSES,))            # counts of this path only
    probe = None
    with plain_guard({"gr": gr, "os1": os1}) as guard:
        for sess, name, li, part, orders in runs:
            if name == "shuffle big":
                swap_table(sess, "orders", orders_big)
                orders = cols(orders_big)
            forced = name in JOIN_S4_SHUFFLE
            saved = pplan.BROADCAST_BUILD_MAX_ROWS
            if forced:
                pplan.BROADCAST_BUILD_MAX_ROWS = 0
            try:
                sql = join_sql(name)
                plan = [r[0] for r in sess.execute("explain " + sql).rows]
                want_op = JOIN_PLANNED.get(name, "CopJoinTask")
                check(any(want_op in ln for ln in plan),
                      f"join {name}: planned {plan}")
                fb0 = sess.domain.client.join_fallbacks
                rs, first, warm, last, st, ct, launched = sql_run(
                    sess, name, sql, counters)
            finally:
                pplan.BROADCAST_BUILD_MAX_ROWS = saved
            check(sess.domain.client.join_fallbacks == fb0,
                  f"join {name}: a host fallback of the join ran")
            for k in JOIN_KERNELS[name]:
                check(launched[k] > 0, f"join {name}: {k} not launched")
            join_check(name, rs, li, part, orders)
            n_rows = len(li["l_orderkey"].data)
            client_s = sum(v for v in ct.values() if isinstance(v, float))
            split = " ".join(f"{k}_ms={v * 1e3:.3f}" for k, v in ct.items()
                             if isinstance(v, float))
            caps = " ".join(f"{k}={ct[k]}" for k in ("joins", "shuffles",
                                                     "buckets", "pages")
                            if k in ct)
            print(f"join {name}: plan={'/'.join(ln.strip() for ln in plan)} "
                  f"rows={n_rows} out_rows={len(rs.rows)} "
                  f"first_ms={first * 1e3:.3f} warm_ms={warm * 1e3:.3f} "
                  f"parse_ms={st['parse'] * 1e3:.3f} "
                  f"plan_ms={st['plan'] * 1e3:.3f} {split} {caps} "
                  f"decode_ms={st['decode'] * 1e3:.3f} "
                  f"overhead_ms={(last - client_s) * 1e3:.3f} "
                  f"rows_per_s={n_rows / warm:.0f} "
                  f"launches={ {k: launched[k] for k in GR + OS} } "
                  f"fallbacks=0 exact=True")
            del rs
            if name == "join agg":
                probe = probe_steps(torch, torch.device(JOIN_DEVICE), li,
                                    part, cols(s4_data), cols(orders_s4))
    check(guard.calls == 0, f"join path ran {guard.calls} plain-version "
          "calls of its kernels on the card")
    counts = {k: v for launches in counters for k, v in launches.items()}
    for k in GR + OS:
        check(counts[k] > 0, f"join path: {k} launched {counts[k]} times")
    shapes = probe.pop("shapes")
    print("join probe steps: " + " ".join(
        f"{k}_ms={ms:.4f} {k}_bound_ms={bd:.4f}"
        for k, (ms, bd) in probe.items()) + f" shapes={shapes}")
    print(f"join launches: {counts} stable_argsort_passes="
          f"{S.PASSES['stable_argsort']} plain_calls={guard.calls}")
    return counts


# --------------------------------------------------------------------- #
# phase 11: the store (DDL, LOAD DATA, DML, transactions, online index)
# --------------------------------------------------------------------- #

STORE_SF = 0.05       # lineitem 300,000 rows: the host row codec's cut,
#                       halved to keep the script inside its time limit
STORE_ROUNDS = 5      # write/read rounds of the HBM check
STORE_WARM = 3        # warm calls of a statement after its first
STORE_UPDATE_BELOW = 6_000     # UPDATE lineitem ... where l_orderkey < it
# l_orderkey runs up to 6,000,000 * SF: DELETE ... l_orderkey between the
# two keys of the middle of that range; index point reads in all of it
STORE_KEYS = int(6_000_000 * STORE_SF)
STORE_DELETE = (STORE_KEYS // 2, STORE_KEYS // 2 + 6_000)
STORE_INSERTS = 100   # rows the committed transaction inserts
STORE_POINTS = (97, 4_242, STORE_KEYS // 2 - 1, STORE_KEYS - 9_999)
STORE_FRTOL = 1e-9    # float SUM/AVG: of the sum of |terms|
STORE_JOIN = """select o_orderpriority, count(*), sum(l_quantity)
from lineitem join orders on l_orderkey = o_orderkey
where o_orderdate < date '1995-03-15'
group by o_orderpriority order by o_orderpriority"""
STORE_TOPN = """select l_orderkey, l_linenumber, l_extendedprice
from lineitem order by l_extendedprice desc, l_orderkey, l_linenumber
limit 10"""
STORE_POINT = ("select l_linenumber, l_quantity, l_discount from lineitem"
               " where l_orderkey = {} order by l_linenumber")
STORE_ORDERS = ("select o_orderstatus, count(*), sum(o_totalprice)"
                " from orders group by o_orderstatus order by o_orderstatus")
STORE_DEVICE = "cuda"


def _days(iso: str) -> int:
    import datetime
    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


@host_work("oracle")
def store_oracle_data(li_cols, li_names, o_cols, o_names) -> tuple:
    """The generated tables as the loaded types read them: DOUBLE
    columns as float64 (the files' two-decimal text), strings as str."""
    def plain(names, cols):
        out = {}
        for n, c in zip(names, cols):
            k = c.dtype.kind.name
            if k == "DECIMAL":
                out[n] = c.data.astype(np.int64) / 100.0
            elif k == "STRING":
                out[n] = np.asarray(c.dictionary.values, dtype=object)[c.data]
            else:
                out[n] = c.data.astype(np.float64 if k == "FLOAT64"
                                       else np.int64)
        return out
    return plain(li_names, li_cols), plain(o_names, o_cols)


def fsum_ok(got: float, terms: np.ndarray) -> bool:
    return abs(got - float(terms.sum())) <= \
        STORE_FRTOL * max(float(np.abs(terms).sum()), 1.0)


@host_work("oracle")
def store_check(name: str, rows: list, li: dict, od: dict) -> None:
    """``rows`` of statement ``name`` against a numpy oracle over the
    written rows ``li`` / ``od``: counts and keys exactly, float sums
    and averages within ``STORE_FRTOL`` of the sum of their |terms|."""
    if name == "Q1":
        m = li["l_shipdate"] <= _days("1998-09-02")
        keys = sorted(set(zip(li["l_returnflag"][m], li["l_linestatus"][m])))
        check(len(rows) == len(keys), f"store Q1: {len(rows)} groups")
        for r, (rf, ls) in zip(rows, keys):
            g = m & (li["l_returnflag"] == rf) & (li["l_linestatus"] == ls)
            q, p = li["l_quantity"][g], li["l_extendedprice"][g]
            d, t = li["l_discount"][g], li["l_tax"][g]
            n = int(g.sum())
            check(r[0] == rf and r[1] == ls and r[9] == n,
                  f"store Q1 keys/count {r[:2]} {r[9]} != {rf} {ls} {n}")
            for v, terms in ((r[2], q), (r[3], p), (r[4], p * (1 - d)),
                             (r[5], p * (1 - d) * (1 + t)),
                             (r[6] * n, q), (r[7] * n, p), (r[8] * n, d)):
                check(fsum_ok(v, terms), f"store Q1 {rf}{ls}: {v}")
    elif name == "Q6":
        m = ((li["l_shipdate"] >= _days("1994-01-01"))
             & (li["l_shipdate"] < _days("1995-01-01"))
             & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
             & (li["l_quantity"] < 24))
        terms = li["l_extendedprice"][m] * li["l_discount"][m]
        check(len(rows) == 1 and fsum_ok(rows[0][0], terms),
              f"store Q6: {rows} against {terms.sum()}")
    elif name == "join":
        order = np.argsort(od["o_orderkey"], kind="stable")
        ok = od["o_orderkey"][order]
        pos = np.clip(np.searchsorted(ok, li["l_orderkey"]), 0, len(ok) - 1)
        hit = ok[pos] == li["l_orderkey"]
        oi = order[pos]
        m = hit & (od["o_orderdate"][oi] < _days("1995-03-15"))
        prio = od["o_orderpriority"][oi]
        keys = sorted(set(prio[m]))
        check([r[0] for r in rows] == keys, f"store join keys {rows}")
        for r, k in zip(rows, keys):
            g = m & (prio == k)
            check(r[1] == int(g.sum()) and
                  fsum_ok(r[2], li["l_quantity"][g]),
                  f"store join {k}: {r}")
    elif name == "TopN":
        idx = np.lexsort((li["l_linenumber"], li["l_orderkey"],
                          -li["l_extendedprice"]))[:10]
        want = [(int(li["l_orderkey"][i]), int(li["l_linenumber"][i]),
                 float(li["l_extendedprice"][i])) for i in idx]
        check(rows == want, f"store TopN {rows} != {want}")
    elif name == "orders":
        keys = sorted(set(od["o_orderstatus"]))
        check([r[0] for r in rows] == keys, f"store orders keys {rows}")
        for r, k in zip(rows, keys):
            g = od["o_orderstatus"] == k
            check(r[1] == int(g.sum()) and
                  fsum_ok(r[2], od["o_totalprice"][g]),
                  f"store orders {k}: {r}")
    elif name.startswith("point"):
        key = int(name.split()[1])
        m = li["l_orderkey"] == key
        idx = np.nonzero(m)[0][np.argsort(li["l_linenumber"][m],
                                          kind="stable")]
        want = [(int(li["l_linenumber"][i]), float(li["l_quantity"][i]),
                 float(li["l_discount"][i])) for i in idx]
        check(rows == want, f"store {name}: {rows} != {want}")
    else:
        raise RuntimeError(f"no oracle for {name}")


def store_run(sess, name: str, sql: str, li: dict, od: dict, counters,
              tag: str) -> dict:
    """``sql`` once cold and ``STORE_WARM`` times warm, each result held
    against its oracle; prints the first and warm ms with the client's
    split of the first call (``place`` is the re-placement after a
    write) and of the last; returns the launches."""
    before = {k: v for launches in counters for k, v in launches.items()}
    t0 = time.perf_counter()
    rs = sess.execute(sql)
    first = time.perf_counter() - t0
    first_ct = dict(sess.domain.client.timings)
    store_check(name, rs.rows, li, od)
    warm = []
    for _ in range(STORE_WARM):
        t0 = time.perf_counter()
        rs = sess.execute(sql)
        warm.append(time.perf_counter() - t0)
        store_check(name, rs.rows, li, od)
    launched = {k: v - before[k] for launches in counters
                for k, v in launches.items()}

    def split(ct):
        return " ".join(f"{k}_ms={v * 1e3:.3f}" for k, v in ct.items()
                        if isinstance(v, float))
    print(f"store {tag} {name}: out_rows={len(rs.rows)} "
          f"first_ms={first * 1e3:.3f} "
          f"warm_ms={statistics.median(warm) * 1e3:.3f} "
          f"first[{split(first_ct)}] "
          f"warm[{split(sess.domain.client.timings)}] "
          f"launches={ {k: launched[k] for k in GR + OS} } exact=True")
    return launched


def placement_bytes(tbl) -> int:
    """Bytes of a table's placement on the card (its snapshot's)."""
    n = 0
    for cols, counts in tbl.snapshot()._device_cache.values():
        n += counts.numel() * counts.element_size()
        for d, v in cols:
            n += d.numel() * d.element_size()
            if v is not None:
                n += v.numel() * v.element_size()
    return n


def store_phase(torch, gr, os1, S, sf: float = STORE_SF) -> dict:
    """Phase 11 through one port ``Domain(device="cuda", data_dir=...)``:
    CREATE TABLE lineitem and orders (tests/test_tpch_diff.py's types),
    LOAD DATA from the generator's '|' files, Q1, Q6 (the spec's text),
    a join of the two, a TopN; one transaction of UPDATE, DELETE and
    INSERT, then COMMIT; the statements again against the numpy oracle
    of the written rows; CREATE INDEX on ``l_orderkey`` and point reads
    through ``IndexLookUp``; a rolled-back transaction; write/read rounds
    with ``memory_allocated`` flat; the durable reopen.  Returns the
    phase's launch counts."""
    import tempfile
    from tidb_tpu_torch.session import Domain, Session
    from tidb_tpu_torch.testing import tpch
    counters = (gr.LAUNCHES, os1.LAUNCHES)
    sqls = {"Q1": tpch.TPCH_Q1, "Q6": tpch.TPCH_Q6, "join": STORE_JOIN,
            "TopN": STORE_TOPN}
    with tempfile.TemporaryDirectory(prefix="tidb_store_") as tmp:
        t0 = time.perf_counter()
        with host_work("gen"):
            li_names, li_cols = tpch.gen_lineitem(sf, seed=0)
            li_cols = li_cols + [tpch.lineitem_comments(len(li_cols[0]))]
            li_names = li_names + ["l_comment"]
            o_names, o_cols = tpch.gen_orders(sf, seed=0)
        files = {"lineitem": f"{tmp}/lineitem.tbl",
                 "orders": f"{tmp}/orders.tbl"}
        with host_work("write"):
            n_rows = {"lineitem": tpch.write_tbl(files["lineitem"], li_cols),
                      "orders": tpch.write_tbl(files["orders"], o_cols)}
        li, od = store_oracle_data(li_cols, li_names, o_cols, o_names)
        del li_cols, o_cols
        print(f"store data: sf={sf} lineitem rows={n_rows['lineitem']} "
              f"orders rows={n_rows['orders']} "
              f"gen_write_s={time.perf_counter() - t0:.2f}")
        data_dir = f"{tmp}/data"
        dom = Domain(STORE_DEVICE, data_dir=data_dir)
        sess = Session(dom)
        reset(counters + (S.PASSES,))       # counts of this path only
        mem = []

        def round_mem(tag):
            torch.cuda.synchronize()
            gc.collect()
            mem.append(torch.cuda.memory_allocated())
            print(f"store memory {tag}: allocated={mem[-1]}")

        with plain_guard({"gr": gr, "os1": os1}) as guard:
            for t in ("lineitem", "orders"):
                sess.execute(f"create table {t} {tpch.TPCH_DDL[t]}")
                t0 = time.perf_counter()
                rs = sess.execute(f"load data infile '{files[t]}' into "
                                  f"table {t} fields terminated by '|'")
                s_ = time.perf_counter() - t0
                check(rs.affected == n_rows[t], f"store load {t}: "
                      f"{rs.affected} rows of {n_rows[t]}")
                print(f"store load {t}: rows={rs.affected} s={s_:.3f} "
                      f"rows_per_s={rs.affected / s_:.0f}")
            for name, sql in sqls.items():
                store_run(sess, name, sql, li, od, counters, "loaded")
            round_mem("after load/read")

            # one transaction of UPDATE, DELETE and INSERT
            rng = np.random.default_rng(11)
            dates = ("1996-03-01", "1996-03-02", "1996-03-03")
            ins = [(int(k), 1, 1, int(ln), float(q), float(p), 0.05, 0.01,
                    "N", "O") + dates + ("NONE", "AIR", "added")
                   for k, ln, q, p in zip(
                       rng.integers(1, int(6_000_000 * sf), STORE_INSERTS),
                       rng.integers(8, 12, STORE_INSERTS),
                       rng.integers(1, 51, STORE_INSERTS),
                       rng.integers(100_000, 10_000_000, STORE_INSERTS)
                       / 100.0)]
            vals = ", ".join(
                "(" + ", ".join(repr(v) if not isinstance(v, str)
                                else f"'{v}'" for v in r) + ")"
                for r in ins)
            ins = [r[:10] + tuple(_days(d) for d in dates) + r[13:]
                   for r in ins]
            writes = [
                ("UPDATE", "update lineitem set l_discount = 0.1, "
                           "l_tax = l_tax + 0.01 where l_orderkey < "
                           f"{STORE_UPDATE_BELOW}"),
                ("DELETE", "delete from lineitem where l_orderkey between "
                           f"{STORE_DELETE[0]} and {STORE_DELETE[1]}"),
                ("INSERT", f"insert into lineitem values {vals}"),
                ("COMMIT", "commit")]
            sess.execute("begin")
            done = {}
            for what, sql in writes:
                t0 = time.perf_counter()
                rs = sess.execute(sql)
                done[what] = (rs.affected, time.perf_counter() - t0)
            up = li["l_orderkey"] < STORE_UPDATE_BELOW
            dl = ((li["l_orderkey"] >= STORE_DELETE[0])
                  & (li["l_orderkey"] <= STORE_DELETE[1]))
            check(done["UPDATE"][0] == int(up.sum()) and
                  done["DELETE"][0] == int(dl.sum()) and
                  done["INSERT"][0] == STORE_INSERTS,
                  f"store txn affected {done}")
            li["l_discount"] = np.where(up, 0.1, li["l_discount"])
            li["l_tax"] = np.where(up, li["l_tax"] + 0.01, li["l_tax"])
            keep = ~dl
            li = {k: np.concatenate([v[keep], np.asarray(
                [r[i] for r in ins], dtype=v.dtype)])
                for i, (k, v) in enumerate(li.items())}
            print("store txn: " + " ".join(
                f"{w}_rows={a} {w}_ms={s_ * 1e3:.3f}"
                for w, (a, s_) in done.items()))
            for name, sql in sqls.items():
                store_run(sess, name, sql, li, od, counters, "written")
            round_mem("after txn/read")

            # online CREATE INDEX, then point reads through IndexLookUp
            t0 = time.perf_counter()
            sess.execute("create index iok on lineitem (l_orderkey)")
            ix_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            sess.execute("admin check table lineitem")
            ck_s = time.perf_counter() - t0
            plan = [r[0] for r in sess.execute(
                "explain " + STORE_POINT.format(STORE_POINTS[0])).rows]
            check(any("IndexLookUp" in ln for ln in plan),
                  f"store point read planned {plan}")
            ms = []
            for key in STORE_POINTS:
                t0 = time.perf_counter()
                rs = sess.execute(STORE_POINT.format(key))
                ms.append((time.perf_counter() - t0) * 1e3)
                store_check(f"point {key}", rs.rows, li, od)
            print(f"store index: create_ms={ix_s * 1e3:.3f} "
                  f"admin_check_ms={ck_s * 1e3:.3f} "
                  f"plan={'/'.join(ln.strip() for ln in plan)} "
                  f"point_read_ms={' '.join(f'{m:.3f}' for m in ms)} "
                  "equal_to_scan=True")

            # a rolled-back transaction leaves no trace
            store_run(sess, "orders", STORE_ORDERS, li, od, counters,
                      "before rollback")
            sess.execute("begin")
            t0 = time.perf_counter()
            for sql in ("delete from orders where o_orderkey < 1000",
                        "update orders set o_totalprice = 0 "
                        "where o_orderkey < 5000",
                        "insert into orders values (9, 1, 'O', 1.0, "
                        "'1995-01-01', '5-LOW', 'Clerk#000000001', 0, 'x')",
                        "rollback"):
                sess.execute(sql)
            rb_s = time.perf_counter() - t0
            store_run(sess, "orders", STORE_ORDERS, li, od, counters,
                      "after rollback")
            # 9 is no key of the spec's sparse scheme (the first 8 of 32)
            check(sess.must_query("select count(*) from orders where "
                                  "o_orderkey = 9") == [(0,)],
                  "store rollback: the rolled-back insert is visible")
            print(f"store rollback: ms={rb_s * 1e3:.3f} no_trace=True")

            # write/read rounds: the placement of each epoch is freed
            tbl = dom.catalog.get_table("test", "orders")
            place = []
            for r in range(STORE_ROUNDS):
                key = int(od["o_orderkey"][r * 997])
                sess.execute("update orders set o_totalprice = "
                             f"o_totalprice + 1 where o_orderkey = {key}")
                od["o_totalprice"] = np.where(od["o_orderkey"] == key,
                                              od["o_totalprice"] + 1,
                                              od["o_totalprice"])
                store_run(sess, "orders", STORE_ORDERS, li, od, counters,
                          f"round {r + 1}")
                place.append(placement_bytes(tbl))
                round_mem(f"round {r + 1}")
            grow = mem[-1] - mem[-STORE_ROUNDS]
            check(grow <= max(place), f"store HBM grew {grow} bytes over "
                  f"{STORE_ROUNDS} rounds (one placement: {max(place)})")
            print(f"store hbm: rounds={STORE_ROUNDS} first={mem[-5]} "
                  f"last={mem[-1]} grow={grow} placement={max(place)} "
                  "flat=True")

            # the durable reopen
            probes = {"li": "select count(*), sum(l_quantity), "
                            "sum(l_extendedprice) from lineitem",
                      "o": "select count(*), sum(o_totalprice) from orders"}
            before = {k: sess.must_query(q) for k, q in probes.items()}
            dom.close()
            del sess, dom, tbl
            gc.collect()
            t0 = time.perf_counter()
            dom = Domain(STORE_DEVICE, data_dir=data_dir)
            sess = Session(dom)
            reopen_s = time.perf_counter() - t0
            after = {k: sess.must_query(q) for k, q in probes.items()}
            for k in probes:
                b, a = before[k][0], after[k][0]
                check(a[0] == b[0] and all(
                    abs(x - y) <= STORE_FRTOL * abs(y) for x, y in
                    zip(a[1:], b[1:])), f"store reopen {k}: {a} != {b}")
            check(after["li"][0][0] == len(li["l_orderkey"]) and
                  fsum_ok(after["li"][0][1], li["l_quantity"]),
                  f"store reopen: {after['li']} against the oracle")
            store_run(sess, "Q1", tpch.TPCH_Q1, li, od, counters,
                      "reopened")
            dom.close()
            print(f"store reopen: open_s={reopen_s:.3f} "
                  f"committed={after} equal=True")
        check(guard.calls == 0, f"store path ran {guard.calls} "
              "plain-version calls of its kernels on the card")
    counts = {k: v for launches in counters for k, v in launches.items()}
    for k in GR + OS:
        check(counts[k] > 0, f"store path: {k} launched {counts[k]} times")
    print(f"store launches: {counts} stable_argsort_passes="
          f"{S.PASSES['stable_argsort']} plain_calls={guard.calls}")
    return counts


# --------------------------------------------------------------------- #
# phase 12: the rest of the SELECT surface
# --------------------------------------------------------------------- #

SELECT_DEVICE = "cuda"
TPCH_SF = 0.01       # phase 12c's scale: Q20's host apply grows as its square
SELECT_FRTOL = 1e-9  # doubles: of the sum of |terms| (a SUM) or |value|
SELECT_WARM = 1      # warm calls of a TPC-H statement after its first
# the statements whose broadcast joins take the JAX package's host plan
# at TPCH_SF: Q7's plan probes customer against the orders chain keyed
# by o_custkey, a key with duplicates (tests/test_torch_tpch.py holds
# the port's count a statement equal to the JAX package's branch)
TPCH_FALLBACKS = {"Q7"}
# Q20's host apply takes 21-26 s a call at SF=0.01: it runs once, a cut
# for the script's time limit (PERF.md §4)
TPCH_ONCE = {"Q20"}
MICROS_PER_DAY = 86_400_000_000

# 12a: (name, statement, the lanes its cop task must evaluate); lineitem
# at --main-sf, phase 7's columns
LANE_SQL = [
    ("decimal /", """select l_returnflag, sum(l_extendedprice / l_quantity),
        count(*) from lineitem where l_discount / l_tax > 1
        group by l_returnflag order by l_returnflag""", {"div"}),
    ("double /", """select l_linestatus,
        sum(cast(l_extendedprice as double) / l_quantity), count(*)
        from lineitem where cast(l_discount as double) / l_tax > 1
        group by l_linestatus order by l_linestatus""", {"div", "cast"}),
    ("DIV and %", """select l_linestatus,
        sum(cast(l_quantity as signed) div 7),
        sum(cast(l_extendedprice as signed) % 1000), count(*)
        from lineitem where cast(l_quantity as signed) % 5 = 0
        group by l_linestatus order by l_linestatus""",
     {"cast", "intdiv", "mod"}),
    ("CAST", """select count(*), sum(cast(l_discount as double)),
        sum(cast(l_tax as decimal(15,4))),
        min(cast(l_shipdate as datetime)),
        max(cast(l_extendedprice as decimal(15,0)))
        from lineitem where cast(l_extendedprice as unsigned) > 50000""",
     {"cast"}),
    ("DATE against DATETIME", """select count(*), sum(l_quantity)
        from lineitem
        where l_shipdate < cast('1995-03-15 12:00:00' as datetime)
          and l_shipdate >= cast('1994-01-01 00:00:01' as datetime)""",
     {"lt", "ge"}),
    ("BIGINT UNSIGNED", """select count(*),
        sum(cast(l_quantity as unsigned) * 3) from lineitem
        where cast(l_quantity as unsigned) - 25 > 9223372036854775807""",
     {"cast", "sub", "mul", "gt"}),
    ("XOR", """select count(*) from lineitem
        where (l_discount > 0.05) xor (l_tax < 0.04)""", {"xor"}),
    ("ROUND and TRUNCATE", """select l_returnflag,
        sum(round(l_extendedprice * (1 - l_discount), 1)),
        sum(truncate(l_extendedprice / 3, 2)),
        max(round(cast(l_extendedprice as double) / 7, 2))
        from lineitem group by l_returnflag order by l_returnflag""",
     {"round", "truncate", "div"}),
    ("math", """select count(*), sum(sqrt(l_quantity)),
        sum(ln(l_extendedprice)), sum(pow(l_discount, 2)),
        max(greatest(l_discount, l_tax)), sum(sign(l_tax - 0.04))
        from lineitem""", {"sqrt", "ln", "pow", "greatest", "sign"}),
    ("YEAR and QUARTER", """select year(l_shipdate), quarter(l_shipdate),
        count(*), sum(l_quantity) from lineitem
        group by year(l_shipdate), quarter(l_shipdate) order by 1, 2""",
     {"year", "quarter"}),
    ("DAYOFWEEK and DATEDIFF", """select dayofweek(l_shipdate), count(*),
        sum(datediff('1998-12-01', l_shipdate)) from lineitem
        group by dayofweek(l_shipdate) order by 1""",
     {"dayofweek", "datediff"}),
    ("DATE_ADD MONTH and LAST_DAY", """select count(*),
        min(date_add(l_shipdate, interval 3 month)),
        max(last_day(l_shipdate)) from lineitem
        where last_day(l_shipdate) = l_shipdate""",
     {"dateadd_months", "last_day"}),
]

# 12b: (name, statement, rollup levels)
ROLLUP_SQL = [
    ("Q1 rollup", """select l_returnflag, l_linestatus, sum(l_quantity),
        sum(l_extendedprice), sum(l_extendedprice * (1 - l_discount)),
        count(*) from lineitem where l_shipdate <= '1998-09-02'
        group by l_returnflag, l_linestatus with rollup""", 3),
    ("GROUPING", """select l_returnflag, grouping(l_returnflag), count(*),
        sum(l_quantity) from lineitem group by l_returnflag with rollup""",
     2),
]


def _rdiv(a, b):
    """Integer a / b rounded half away from zero (MySQL decimal ``/``)."""
    q = (np.abs(a) + np.abs(b) // 2) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def _civil(days):
    """(year, month, day of month) of days since 1970-01-01."""
    d = np.asarray(days).astype("datetime64[D]")
    m = d.astype("datetime64[M]")
    y = m.astype("datetime64[Y]")
    return (y.astype(np.int64) + 1970,
            (m - y.astype("datetime64[M]")).astype(np.int64) + 1,
            (d - m.astype("datetime64[D]")).astype(np.int64) + 1)


def _month_add(days, n: int):
    """DATE_ADD(d, INTERVAL n MONTH): the day clamped to the month."""
    d = np.asarray(days).astype("datetime64[D]")
    m = d.astype("datetime64[M]")
    dom = (d - m.astype("datetime64[D]")).astype(np.int64)
    m2 = m + n
    last = ((m2 + 1).astype("datetime64[D]")
            - m2.astype("datetime64[D]")).astype(np.int64)
    out = m2.astype("datetime64[D]") + np.minimum(dom, last - 1)
    return out.astype(np.int64)


def _last_day(days):
    m = np.asarray(days).astype("datetime64[D]").astype("datetime64[M]")
    return ((m + 1).astype("datetime64[D]") - 1).astype(np.int64)


def _by(keys, cols: list) -> dict:
    """{key tuple: [column values...]} of the rows of each key, keys in
    ``keys`` (arrays of small-range ints, one a key column): one mixed
    radix code a row, a bincount for the codes present, then a mask a
    group (no sort of the rows)."""
    keys = [np.asarray(a, np.int64) for a in keys]
    lows = [int(a.min()) for a in keys]
    spans = [int(a.max()) - lo + 1 for a, lo in zip(keys, lows)]
    code = np.zeros(len(keys[0]), np.int64)
    for a, lo, sp in zip(keys, lows, spans):
        code = code * sp + (a - lo)
    out = {}
    for k in np.flatnonzero(np.bincount(code)).tolist():
        m = code == k
        key, rest = [], k
        for lo, sp in zip(reversed(lows), reversed(spans)):
            key.append(rest % sp + lo)
            rest //= sp
        out[tuple(reversed(key))] = [np.asarray(c)[m] for c in cols]
    return out


def _fsum(x) -> tuple:
    """A double SUM to hold within ``SELECT_FRTOL`` of its terms' sum of
    magnitudes (each engine adds in its own order)."""
    x = np.asarray(x, np.float64)
    return ("f", float(x.sum()), float(np.abs(x).sum()))


@host_work("oracle")
def lane_oracle(name: str, c: dict) -> list:
    """The rows statement ``name`` of ``LANE_SQL`` returns, from numpy
    over the generator's columns (DECIMALs as scaled ints, dates as
    days; ("f", sum, sum of |terms|) a double to hold within
    ``SELECT_FRTOL``)."""
    q, p = c["l_quantity"].data, c["l_extendedprice"].data
    d, t = c["l_discount"].data, c["l_tax"].data
    ship = c["l_shipdate"].data
    rf, ls = c["l_returnflag"], c["l_linestatus"]
    text = lambda col, k: col.dictionary.values[k]         # noqa: E731
    if name == "decimal /":
        m = (t != 0) & (_rdiv(d * 10 ** 6, np.where(t == 0, 1, t)) > 10 ** 6)
        g = _by([rf.data[m]], [_rdiv(p[m] * 10 ** 6, q[m])])
        return [(text(rf, k), exact_sum(v), len(v)) for (k,), (v,) in
                sorted(g.items())]
    if name == "double /":
        m = (t != 0) & ((d / 100.0) / np.where(t == 0, 1, t / 100.0) > 1)
        g = _by([ls.data[m]], [(p[m] / 100.0) / (q[m] / 100.0)])
        return [(text(ls, k), _fsum(v), len(v)) for (k,), (v,) in
                sorted(g.items())]
    if name == "DIV and %":
        qi, pi = _rdiv(q, 100), _rdiv(p, 100)
        m = qi % 5 == 0
        g = _by([ls.data[m]], [qi[m] // 7, pi[m] % 1000])
        return [(text(ls, k), exact_sum(a), exact_sum(b), len(a))
                for (k,), (a, b) in sorted(g.items())]
    if name == "CAST":
        m = _rdiv(p, 100) > 50000
        from tidb_tpu_torch.types.temporal import datetime_to_string
        return [(int(m.sum()), _fsum(d[m] / 100.0), exact_sum(t[m] * 100),
                 datetime_to_string(int(ship[m].min()) * MICROS_PER_DAY),
                 int(_rdiv(p[m], 100).max()))]
    if name == "DATE against DATETIME":
        from tidb_tpu_torch.types.temporal import parse_datetime
        us = ship.astype(np.int64) * MICROS_PER_DAY
        m = (us < parse_datetime("1995-03-15 12:00:00")) \
            & (us >= parse_datetime("1994-01-01 00:00:01"))
        return [(int(m.sum()), exact_sum(q[m]))]
    if name == "BIGINT UNSIGNED":
        qi = _rdiv(q, 100)
        m = qi < 25                 # qi - 25 wraps past 2^63 - 1
        return [(int(m.sum()), exact_sum(qi[m] * 3))]
    if name == "XOR":
        return [(int(((d > 5) ^ (t < 4)).sum()),)]
    if name == "ROUND and TRUNCATE":
        r1 = _rdiv(p * (100 - d), 1000)
        tq = _rdiv(p * 10 ** 4, 3)
        t2 = np.sign(tq) * (np.abs(tq) // 10 ** 4)
        x = (p / 100.0) / 7.0 * 100.0
        r2 = np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)) / 100.0
        g = _by([rf.data], [r1, t2, r2])
        return [(text(rf, k), exact_sum(a), exact_sum(b),
                 ("f", float(e.max()), float(np.abs(e).max())))
                for (k,), (a, b, e) in sorted(g.items())]
    if name == "math":
        return [(len(q), _fsum(np.sqrt(q / 100.0)), _fsum(np.log(p / 100.0)),
                 _fsum(np.power(d / 100.0, 2.0)), int(np.maximum(d, t).max()),
                 exact_sum(np.sign(t - 4)))]
    if name == "YEAR and QUARTER":
        y, mo, _ = _civil(ship)
        g = _by([y, (mo + 2) // 3], [q])
        return [(yy, qq, len(v), exact_sum(v)) for (yy, qq), (v,) in
                sorted(g.items())]
    if name == "DAYOFWEEK and DATEDIFF":
        from tidb_tpu_torch.types.temporal import parse_date
        g = _by([(ship + 4) % 7 + 1], [parse_date("1998-12-01") - ship])
        return [(k, len(v), exact_sum(v)) for (k,), (v,) in sorted(g.items())]
    if name == "DATE_ADD MONTH and LAST_DAY":
        m = _last_day(ship) == ship
        return [(int(m.sum()), int(_month_add(ship[m], 3).min()),
                 int(_last_day(ship[m]).max()))]
    raise KeyError(name)


@host_work("oracle")
def rollup_oracle(name: str, c: dict) -> list:
    """The rows of ``ROLLUP_SQL``'s ``name``: the union of its levels'
    GROUP BYs, the rolled keys NULL, sorted with NULLs last."""
    q, p, d = (c["l_quantity"].data, c["l_extendedprice"].data,
               c["l_discount"].data)
    rf, ls = c["l_returnflag"], c["l_linestatus"]
    # the finest level's exact sums once; a coarser level adds its
    # groups' (integer sums are exact in any order)
    out = []
    if name == "Q1 rollup":
        m = c["l_shipdate"].data <= 10471                   # 1998-09-02
        fine = {k: (exact_sum(a), exact_sum(b), exact_sum(e), len(a))
                for k, (a, b, e) in _by(
                    [rf.data[m], ls.data[m]],
                    [q[m], p[m], p[m] * (100 - d[m])]).items()}
        for level in (2, 1, 0):
            sums: dict = {}
            for k, v in fine.items():
                acc = sums.setdefault(k[:level], [0, 0, 0, 0])
                for i, x in enumerate(v):
                    acc[i] += x
            for k, v in sums.items():
                names = [rf.dictionary.values[k[0]] if level else None,
                         ls.dictionary.values[k[1]] if level == 2 else None]
                out.append(tuple(names) + tuple(v))
    else:
        fine = {k[0]: (len(a), exact_sum(a))
                for k, (a,) in _by([rf.data], [q]).items()}
        out = [(rf.dictionary.values[k], 0) + v for k, v in fine.items()]
        out.append((None, 1, sum(v[0] for v in fine.values()),
                    sum(v[1] for v in fine.values())))
    return sorted(out, key=_null_last)


def _null_last(row):
    return tuple((x is None, "" if x is None else str(x)) for x in row)


def select_cells(rs) -> list:
    """The result rows with each DECIMAL as its scaled int and each DATE
    as its days since the epoch."""
    import datetime as _d
    from tidb_tpu_torch.types import dtypes as dt
    out = []
    for r in rs.rows:
        row = []
        for v, t in zip(r, rs.dtypes):
            if v is not None and t.kind == dt.TypeKind.DECIMAL:
                v = int(v.scaleb(t.scale))
            elif isinstance(v, _d.date):
                v = (v - _d.date(1970, 1, 1)).days
            row.append(v)
        out.append(tuple(row))
    return out


def select_rows_equal(got: list, want: list) -> bool:
    """Cell by cell: ints, strings and NULLs equal; a double, given as
    ("f", value, magnitude), within ``SELECT_FRTOL`` of its magnitude:
    the card's libm (SQRT, LN, POW) differs from numpy's in the last
    bits, and a float SUM adds in another order (the division lanes
    equal the CPU's bit for bit, tests/test_torch_cuda.py)."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for x, y in zip(g, w):
            if isinstance(y, tuple):
                if x is None or abs(x - y[1]) > SELECT_FRTOL * max(y[2],
                                                                   1.0):
                    return False
            elif x != y:
                return False
    return True


class statement_timings:
    """The client's timings summed over every cop call of a statement:
    each public call's timings fold in before the next call resets
    them."""

    CALLS = ("execute_agg", "execute_rows", "execute_shuffle_agg",
             "execute_shuffle_rows", "execute_window")

    def __init__(self, client):
        self.client, self.acc = client, {}
        for name in self.CALLS:
            fn = getattr(client, name)

            def wrapped(*a, _fn=fn, **k):
                self.fold()
                return _fn(*a, **k)
            setattr(client, name, wrapped)

    def fold(self) -> None:
        for k, v in self.client.timings.items():
            if isinstance(v, float):
                self.acc[k] = self.acc.get(k, 0.0) + v
            elif k == "windows":      # the window programs' capacities
                self.acc[k] = self.acc.get(k, []) + list(v)
        self.client.timings = {}

    def run(self, sess, sql: str) -> tuple:
        """``sess.execute(sql)``: its result, wall seconds and summed
        client timings."""
        self.client.timings, self.acc = {}, {}
        gc.collect()
        t0 = time.perf_counter()
        rs = sess.execute(sql)
        wall = time.perf_counter() - t0
        self.fold()
        return rs, wall, dict(self.acc)


def select_line(tag: str, name: str, first: float, warm: float,
                acc: dict, extra: str = "") -> None:
    # a broadcast join's ``build`` holds its build side's own joins, so
    # it is not summed over a statement's nested joins
    split = " ".join(f"{k}_ms={v * 1e3:.3f}" for k, v in acc.items()
                     if k != "build" and isinstance(v, float))
    print(f"{tag} {name}: first_ms={first * 1e3:.3f} "
          f"warm_ms={warm * 1e3:.3f} {split} {extra}".rstrip())


@host_work("sqlite")
def tpch_sqlite(data: dict):
    """An in-memory sqlite3 database of ``gen_tpch``'s tables (dates as
    ISO text, as tests/test_tpch_diff.py loads them), with indexes on the
    join keys so that its correlated subqueries finish."""
    import sqlite3
    from tidb_tpu_torch.testing import tpch
    lite = sqlite3.connect(":memory:")
    lite.create_function("year", 1, lambda d: None if d is None
                         else int(str(d)[:4]))
    for tbl, (names, cols) in data.items():
        lite.execute(f"create table {tbl} {tpch.TPCH_TABLE_DDL[tbl]}")
        py = [c.to_python() for c in cols]
        py = [[x.isoformat() for x in col] if col and hasattr(
            col[0], "isoformat") else col for col in py]
        lite.executemany(f"insert into {tbl} values "
                         f"({','.join('?' * len(names))})", zip(*py))
    for ix in ("lineitem(l_orderkey)", "lineitem(l_partkey, l_suppkey)",
               "lineitem(l_suppkey)", "orders(o_orderkey)",
               "orders(o_custkey)", "partsupp(ps_partkey, ps_suppkey)",
               "customer(c_custkey)", "supplier(s_suppkey)",
               "part(p_partkey)", "nation(n_nationkey)"):
        tbl = ix.split("(")[0]
        if tbl not in data:
            continue
        cols = ix[len(tbl) + 1:-1].replace(", ", "_")
        lite.execute(f"create index ix_{tbl}_{cols} on {ix}")
    lite.commit()
    return lite


def tpch_rows_equal(a: list, b: list) -> bool:
    """tests/test_sqlite_diff.py's ``rows_equal``: a Decimal as a float,
    floats within a relative (and absolute) 1e-9, the rest as text."""
    import decimal
    import math

    def norm(v):
        if isinstance(v, decimal.Decimal):
            return float(v)
        if isinstance(v, float):
            return round(v, 6)
        if hasattr(v, "isoformat"):
            return v.isoformat()
        return v
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(map(norm, ra), map(norm, rb)):
            if x is None or y is None:
                if x is not y:
                    return False
            elif isinstance(x, float) or isinstance(y, float):
                if not math.isclose(float(x), float(y), rel_tol=1e-9,
                                    abs_tol=1e-9):
                    return False
            elif str(x) != str(y):
                return False
    return True


def select_phase(torch, gr, os1, S, main_data, main_sf: float,
                 tpch_sf: float = TPCH_SF) -> tuple:
    """Phase 12 through the port's ``Session`` on ``SELECT_DEVICE``: the
    device lanes over lineitem at ``--main-sf`` (12a), rollup over it
    (12b), and the 22 TPC-H statements and Q15's view over
    ``gen_tpch(tpch_sf)`` against sqlite (12c).  Returns the phase's
    launch counts and 12a's session (its lineitem placed on the card)."""
    from tidb_tpu_torch.testing import tpch
    counters = (gr.LAUNCHES, os1.LAUNCHES)
    on_card = SELECT_DEVICE == "cuda"
    c = dict(zip(*main_data))
    n_rows = len(next(iter(c.values())))
    sess = tpch.sql_session({"lineitem": main_data}, device=SELECT_DEVICE)
    timer = statement_timings(sess.domain.client)
    reset(counters + (S.PASSES,))           # counts of this path only
    with plain_guard({"gr": gr, "os1": os1}) as guard:
        # -- 12a: the lanes ------------------------------------------- #
        for name, sql, lanes in LANE_SQL:
            pushed = tpch.pushed_ops(sess, sql)
            check(lanes <= pushed, f"12a {name}: lanes {lanes - pushed} "
                  f"not in a cop task (pushed {sorted(pushed)})")
            plan = [r[0] for r in sess.execute("explain " + sql).rows]
            check(any("CopTask" in ln for ln in plan),
                  f"12a {name}: no cop task in {plan}")
            rs, first, acc = timer.run(sess, sql)
            got, want = select_cells(rs), lane_oracle(name, c)
            check(select_rows_equal(got, want),
                  f"12a {name}: {got[:4]} != numpy {want[:4]}")
            _rs, warm, acc = timer.run(sess, sql)
            select_line("12a", name, first, warm, acc,
                        f"rows={n_rows} out_rows={len(got)} "
                        f"lanes={','.join(sorted(lanes))} "
                        f"plan={plan[0].strip()}|{plan[-1].strip()} "
                        "exact=True")
        # -- 12b: rollup ------------------------------------------------ #
        for name, sql, levels in ROLLUP_SQL:
            check("CopTask[agg]" in "\n".join(
                r[0] for r in sess.execute("explain " + sql).rows),
                f"12b {name}: the rollup is not a cop task")
            sess.execute(sql)                       # placed, warm
            before = gr.LAUNCHES.get("group_reduce", 0)
            if on_card:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            rs, first, acc = timer.run(sess, sql)
            peak = (torch.cuda.max_memory_allocated() - base) if on_card \
                else 0
            launched = gr.LAUNCHES.get("group_reduce", 0) - before
            if GR:
                check(launched == levels, f"12b {name}: {launched} "
                      f"group_reduce launches for {levels} levels")
            got = sorted(select_cells(rs), key=_null_last)
            want = rollup_oracle(name, c)
            check(got == want, f"12b {name}: {got} != numpy {want}")
            _rs, warm, acc = timer.run(sess, sql)
            cols = ["l_returnflag", "l_linestatus", "l_quantity",
                    "l_extendedprice", "l_discount", "l_shipdate"]
            row_bytes = sum(c[k].narrowed().dtype.itemsize + 1
                            for k in cols) + 8
            select_line("12b", name, first, warm, acc,
                        f"rows={n_rows} levels={levels} "
                        f"group_reduce_launches={launched} "
                        f"peak_bytes={peak} "
                        f"materialized_bytes={levels * n_rows * row_bytes} "
                        f"out_rows={len(got)} exact=True")
        check(sess.domain.client.join_fallbacks == 0,
              "12a-12b: a join took its host plan")
        main_sess = sess          # phase 13 reuses its placement
        del sess, timer
        gc.collect()
        # -- 12c: TPC-H ------------------------------------------------- #
        t0 = time.perf_counter()
        with host_work("gen"):
            data = tpch.gen_tpch(tpch_sf, seed=0)
        lite = tpch_sqlite(data)
        sess = tpch.sql_session(data, device=SELECT_DEVICE)
        timer = statement_timings(sess.domain.client)
        print(f"12c data: sf={tpch_sf} " + " ".join(
            f"{t}={len(cols[0])}" for t, (_n, cols) in data.items())
            + f" gen_load_s={time.perf_counter() - t0:.2f}")
        del data
        stmts = [(f"Q{k}", v) for k, v in sorted(tpch.TPCH_22.items())]
        stmts.insert(14, ("Q15", tpch.TPCH_Q15))
        for name, sql in stmts:
            if name == "Q15":
                for e in (sess, lite):
                    e.execute(tpch.TPCH_Q15_VIEW)
            plan = [r[0].strip() for r in sess.execute("explain " + sql).rows]
            fb0 = sess.domain.client.join_fallbacks
            rs, first, acc = timer.run(sess, sql)
            warm = first
            for _ in range(0 if name in TPCH_ONCE else SELECT_WARM):
                _rs, warm, acc = timer.run(sess, sql)
            with host_work("sqlite"):
                want = lite.execute(sql).fetchall()
            check(tpch_rows_equal(rs.rows, want),
                  f"12c {name}: {rs.rows[:4]} != sqlite {want[:4]}")
            dev_s = acc.get("device", 0.0)
            fb = sess.domain.client.join_fallbacks - fb0
            check(fb == 0 or (name in TPCH_FALLBACKS and tpch_sf == TPCH_SF),
                  f"12c {name}: {fb} broadcast joins took their host plan")
            select_line("12c", name, first, warm, acc,
                        f"out_rows={len(rs.rows)} top={'|'.join(plan[:2])} "
                        f"join_fallbacks={fb} "
                        f"wall_set_by={'device' if dev_s > warm / 2 else 'host'}"
                        f" calls={1 if name in TPCH_ONCE else 1 + SELECT_WARM}"
                        " equal_sqlite=True")
    check(guard.calls == 0, f"select path ran {guard.calls} plain-version "
          "calls of its kernels on the card")
    counts = {k: v for launches in counters for k, v in launches.items()}
    for k in GR + OS:
        check(counts[k] > 0, f"select path: {k} launched {counts[k]} times")
    print(f"select launches: {counts} stable_argsort_passes="
          f"{S.PASSES['stable_argsort']} plain_calls={guard.calls}")
    return counts, main_sess


# -- phase 13: windows and statistics ----------------------------------- #

WINDOW_DEVICE = "cuda"
WINDOW_ORDERS = 1_500_000      # gen_orders_mini: o_custkey ~368,000 values
WINDOW_ORDERS_DEVICES = 8      # 13b on eight logical devices
WINDOW_DAY = "1995-06-17"
WINDOW_SQL = [
    # (name, statement, its session: "lineitem" (12a's) or "orders")
    ("top 3 a day", "select * from (select l_shipdate, l_extendedprice, "
     "row_number() over (partition by l_shipdate order by l_extendedprice "
     "desc) rn from lineitem) t where rn <= 3", "lineitem"),
    ("rank a mode", "select l_shipmode, l_extendedprice, rank() over "
     "(partition by l_shipmode order by l_extendedprice desc), dense_rank() "
     "over (partition by l_shipmode order by l_extendedprice desc) from "
     f"lineitem where l_shipdate = date '{WINDOW_DAY}'", "lineitem"),
    ("aggregates a mode", "select l_shipmode, l_quantity, sum(l_quantity) "
     "over (partition by l_shipmode), avg(l_extendedprice) over (partition "
     f"by l_shipmode) from lineitem where l_shipdate = date '{WINDOW_DAY}'",
     "lineitem"),
    ("orders rank 1", "select * from (select o_orderkey, o_custkey, "
     "o_totalprice, rank() over (partition by o_custkey order by "
     "o_totalprice desc) rk from orders) t where rk = 1", "orders"),
]
# the statements whose window items hold an aggregate: one group_reduce
# launch a device a program run
WINDOW_AGG = ("aggregates a mode",)
HIGH_NDV_ONCE_S = 5.0    # 13c: a group-by slower than this runs once (its
                         # host merge is its wall, warm or not)
HIGH_NDV_SQL = [
    ("orders by custkey", "select count(*), sum(s) from (select o_custkey, "
     "sum(o_totalprice) s from orders group by o_custkey) t", "orders",
     "o_custkey", "o_totalprice"),
    ("lineitem by orderkey", "select count(*), sum(s) from (select "
     "l_orderkey, sum(l_quantity) s from lineitem group by l_orderkey) t",
     "s4", "l_orderkey", "l_quantity"),
]
STATS_BUCKETS, STATS_TOP = 64, 16      # StatsHandle.analyze_table's


def _splitmix(x: np.ndarray, seed: int) -> np.ndarray:
    """splitmix64's finalizer in numpy uint64 (the oracle's own copy)."""
    with np.errstate(over="ignore"):
        h = (x.astype(np.int64).view(np.uint64) + np.uint64(seed)) \
            * np.uint64(0x9E3779B97F4A7C15)
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


def stats_sample(n: int, stats) -> tuple:
    """The rows ``StatsHandle.analyze_table`` samples from an ``n``-row
    table, and its scale: a systematic sample of ``SAMPLE_TARGET`` rows,
    each offset within its step drawn by ``default_rng(n)``; every row,
    at scale 1, up to ``SAMPLE_THRESHOLD``."""
    if n <= stats.SAMPLE_THRESHOLD:
        return None, 1.0
    m = max(int(n * (stats.SAMPLE_TARGET / n)), 1)
    step = max(n // m, 1)
    rng = np.random.default_rng(n)
    return (np.arange(m) * step + rng.integers(0, step, m)).clip(0, n - 1), \
        n / m


@host_work("oracle")
def stats_oracle(x: np.ndarray, valid: np.ndarray,
                 scale: float = 1.0) -> dict:
    """A column's statistics by the ANALYZE kernel's semantics, in numpy:
    count, null count, NDV, the equal-depth bounds, cumulative counts and
    repeats (trailing empty buckets dropped), TopN by count then value
    (kept where at least the uniform count), the CM counters and the KMV
    minima (filled to 64 with all-ones bits).  A sampled column (``scale`` > 1) is scaled as the handle
    scales it: the counts by ``scale``, the NDV by the Duj1 estimate
    from the sample's singletons."""
    n = len(x)
    v = np.sort(x[valid].astype(np.int64))
    nv = len(v)
    xs = np.concatenate([v, np.sort(x[~valid].astype(np.int64))])
    vals, cnts = np.unique(v, return_counts=True)
    ndv = len(vals)
    size = max(-(-nv // STATS_BUCKETS), 1)
    ub = np.minimum((np.arange(STATS_BUCKETS) + 1) * size, nv) - 1
    bounds = xs[np.clip(ub, 0, n - 1)]
    cum = ub + 1
    clean = np.where(np.arange(n) < nv, xs, 2 ** 62)
    rep = np.maximum(cum - np.searchsorted(clean, bounds, side="left"), 0)
    top = np.lexsort((vals, -cnts))[:STATS_TOP]
    top_vals, top_cnts = vals[top], cnts[top]
    cm = np.zeros((4, 2048), np.int64)
    for d in range(4):
        cm[d] = np.bincount((_splitmix(v, 0xABCD + d * 7919)
                             & np.uint64(2047)).astype(np.int64),
                            minlength=2048)
    # the 64 least hashes of the distinct values, the sketch's
    # all-ones fill after them where there are fewer (as many as rows)
    kmv = np.full(min(64, n), np.iinfo(np.uint64).max, np.uint64)
    least = np.sort(_splitmix(vals, 0x5bd1e995))[:64]
    kmv[:len(least)] = least
    count, nulls = nv, n - nv
    if scale > 1.0:
        if nv:
            f1 = int((cnts == 1).sum())
            denom = 1.0 - (1.0 - 1.0 / scale) * f1 / nv
            ndv = int(round(min(max(ndv / max(denom, 1e-3), ndv),
                                nv * scale)))

        def up(a):
            return np.round(a * scale).astype(np.int64)
        cum, rep, top_cnts, cm = up(cum), up(rep), up(top_cnts), up(cm)
        count, nulls = round(nv * scale), round((n - nv) * scale)
    keep = np.concatenate([[True], np.diff(cum) > 0])
    uniform = max(count / max(ndv, 1), 1.0)
    return {"count": count, "null_count": nulls, "ndv": ndv,
            "bounds": bounds[keep], "cum_counts": cum[keep],
            "repeats": rep[keep], "min_val": int(xs[0]) if nv else None,
            "topn": {int(a): int(b) for a, b in zip(top_vals, top_cnts)
                     if b >= uniform},
            "cm": cm, "kmv": kmv}


def stats_equal(cs, want: dict) -> bool:
    h = cs.hist
    return (cs.count == want["count"] and cs.ndv == want["ndv"]
            and cs.null_count == want["null_count"]
            and h.min_val == want["min_val"]
            and all(np.array_equal(getattr(h, k), want[k])
                    for k in ("bounds", "cum_counts", "repeats"))
            and cs.topn.values == want["topn"]
            and np.array_equal(cs.cms.table, want["cm"])
            and np.array_equal(cs.fms.kmv, want["kmv"]))


@host_work("oracle")
def window_oracle(name: str, c: dict) -> list:
    """The rows of window statement ``name`` in numpy, as
    ``select_cells`` gives them (decimals as scaled ints, dates as days,
    a double as ("f", value, magnitude))."""
    from tidb_tpu_torch.testing import tpch
    if name == "top 3 a day":
        # rows by (day, price descending) in one sort of a packed key
        # (prices under 2^31, days under 2^31): which of two equal
        # (day, price) rows gets which row number leaves the sorted
        # (day, price, row number) triples the same
        day = c["l_shipdate"].data.astype(np.int64)
        price = c["l_extendedprice"].data.astype(np.int64)
        top = (1 << 31) - 1
        check(int(price.min()) >= 0 and int(price.max()) <= top
              and int(day.min()) >= 0 and int(day.max()) <= top,
              "top 3 a day: a key past the packed range")
        packed = np.sort((day << 31) | (top - price))
        ds, ps = packed >> 31, top - (packed & top)
        first = np.r_[0, np.flatnonzero(ds[1:] != ds[:-1]) + 1]
        rn = np.arange(len(ds)) - np.repeat(first, np.diff(np.r_[first,
                                                                 len(ds)]))
        k = rn < 3
        return sorted(zip(ds[k].tolist(), ps[k].tolist(),
                          (rn[k] + 1).tolist()))
    if name == "orders rank 1":
        ok, ck, tp = (c["o_orderkey"].data, c["o_custkey"].data,
                      c["o_totalprice"].data)
        o = np.lexsort((-tp, ck))
        cs_, ts = ck[o], tp[o]
        first = np.r_[0, np.flatnonzero(cs_[1:] != cs_[:-1]) + 1]
        top = np.repeat(ts[first], np.diff(np.r_[first, len(cs_)]))
        k = ts == top
        return sorted(zip(ok[o][k].tolist(), cs_[k].tolist(), ts[k].tolist(),
                          [1] * int(k.sum())))
    day = _days(WINDOW_DAY)
    sel = np.flatnonzero(c["l_shipdate"].data == day)
    mode = c["l_shipmode"].data[sel]
    price = c["l_extendedprice"].data[sel].astype(np.int64)
    qty = c["l_quantity"].data[sel].astype(np.int64)
    rows = []
    for m in np.unique(mode):
        k = mode == m
        name_m = tpch.SHIPMODES[int(m)]
        if name == "rank a mode":
            p = price[k]
            desc = np.sort(p)[::-1]
            uniq = np.unique(p)[::-1]
            rank = np.searchsorted(-desc, -p, side="left") + 1
            dense = np.searchsorted(-uniq, -p, side="left") + 1
            rows += list(zip([name_m] * len(p), p.tolist(), rank.tolist(),
                             dense.tolist()))
        else:
            sq = exact_sum(qty[k])
            total, cnt = exact_sum(price[k]), int(k.sum())
            avg = total / cnt / 100
            rows += [(name_m, int(q), sq, ("f", avg, abs(avg)))
                     for q in qty[k].tolist()]
    return sorted(rows, key=lambda r: (r[0], r[1], r[2]))


def _window_sort(rows: list) -> list:
    return sorted(rows, key=lambda r: tuple(
        x[1] if isinstance(x, tuple) else x for x in r[:3]))


def window_stats_phase(torch, gr, os1, S, main_sess, main_data, s4_data
                       ) -> dict:
    """Phase 13 through the port's ``Session`` on ``WINDOW_DEVICE``: window
    functions over 12a's lineitem on one logical device (13a) and over
    ``gen_orders_mini(WINDOW_ORDERS)`` on eight (13b); ANALYZE of orders
    (a full build on the card) and of lineitem (sampled by the handle's
    rule), the SHOW STATS statements, and two high-NDV GROUP BYs whose
    strategy the cost model chooses from the statistics (13c).  Every
    result equals its numpy oracle; returns the phase's launches."""
    from tidb_tpu_torch.analysis import calibrate as pcal
    from tidb_tpu_torch.executor import plan as pplan
    from tidb_tpu_torch.testing import tpch
    counters = (gr.LAUNCHES, os1.LAUNCHES)
    on_card = WINDOW_DEVICE == "cuda"
    c = dict(zip(*main_data))
    with host_work("gen"):
        orders = tpch.gen_orders_mini(WINDOW_ORDERS)
    co = dict(zip(*orders))
    sessions = {
        "lineitem": main_sess,
        "orders": tpch.sql_session({"orders": orders}, device=WINDOW_DEVICE,
                                   n_devices=WINDOW_ORDERS_DEVICES),
        "s4": tpch.sql_session({"lineitem": s4_data},
                               device=WINDOW_DEVICE)}
    timers = {k: statement_timings(v.domain.client)
              for k, v in sessions.items()}
    fb0 = {k: v.domain.client.join_fallbacks for k, v in sessions.items()}
    reset(counters + (S.PASSES,))           # counts of this path only
    arb0 = pplan.ARBITRATE_FALLBACKS
    with plain_guard({"gr": gr, "os1": os1}) as guard:
        # -- 13a, 13b: windows ---------------------------------------- #
        for name, sql, where in WINDOW_SQL:
            sess, timer = sessions[where], timers[where]
            plan = "\n".join(r[0] for r in sess.execute("explain " + sql).rows)
            check("CopWindow" in plan and "HostWindow" not in plan,
                  f"13 {name}: not a device window: {plan}")
            before = gr.LAUNCHES.get("group_reduce", 0)
            if on_card:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            rs, first, acc = timer.run(sess, sql)
            peak = (torch.cuda.max_memory_allocated() - base) if on_card \
                else 0
            rounds = acc.get("windows", [])
            runs = len(rounds) * len(sess.domain.client.devices)
            launched = gr.LAUNCHES.get("group_reduce", 0) - before
            want = window_oracle(name, co if where == "orders" else c)
            got = select_cells(rs)
            if name == "aggregates a mode":
                got, want = _window_sort(got), _window_sort(want)
            else:
                got = sorted(got)
            check(select_rows_equal(got, want),
                  f"13 {name}: {got[:3]} != numpy {want[:3]}")
            if GR:
                expect = runs if name in WINDOW_AGG else 0
                check(launched == expect, f"13 {name}: {launched} "
                      f"group_reduce launches for {runs} program runs")
            _rs, warm, acc = timer.run(sess, sql)
            tag = "13b" if where == "orders" else "13a"
            select_line(tag, name, first, warm, acc,
                        f"out_rows={len(rs.rows)} "
                        f"buckets={rounds} "
                        f"devices={len(sess.domain.client.devices)} "
                        f"group_reduce_launches={launched} "
                        f"peak_bytes={peak} exact=True")
        # -- 13c: ANALYZE, SHOW, the strategy choice -------------------- #
        for where, table in (("orders", "orders"), ("lineitem", "lineitem"),
                             ("s4", "lineitem")):
            sess = sessions[where]
            before = gr.LAUNCHES.get("group_reduce", 0)
            t0 = time.perf_counter()
            sess.execute(f"analyze table {table}")
            if on_card:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            tbl = sess.domain.catalog.get_table("test", table)
            ts = sess.domain.stats.get(tbl)
            n = tbl.num_rows
            check(ts is not None and len(ts.cols) == len(tbl.col_names),
                  f"13c analyze {where}: no statistics")
            launched = gr.LAUNCHES.get("group_reduce", 0) - before
            if GR:
                check(launched == 2 * len(ts.cols), f"13c analyze {where}: "
                      f"{launched} group_reduce launches for "
                      f"{len(ts.cols)} columns")
            idx, scale = stats_sample(n, sess.domain.stats)
            for cname, col in zip(tbl.col_names, tbl.snapshot().columns):
                if idx is not None:
                    col = col.take(idx)
                want = stats_oracle(col.data, col.validity, scale)
                check(stats_equal(ts.col(cname), want),
                      f"13c analyze {where}: {cname} != numpy oracle")
            ndv = {k: cs.ndv for k, cs in ts.cols.items()}
            print(f"13c analyze {where}: rows={n} ms={secs * 1e3:.3f} "
                  f"sampled={n > sess.domain.stats.SAMPLE_THRESHOLD} "
                  f"group_reduce_launches={launched} ndv={ndv} "
                  f"scale={scale} exact=True")
        for kind in ("stats_meta", "stats_histograms", "stats_topn"):
            rows = []
            for sess in sessions.values():
                rows += sess.execute(f"show {kind}").rows
            check(rows, f"13c show {kind}: no rows")
            print(f"13c show {kind}: rows={len(rows)} first={rows[0]}")
        meta = sessions["orders"].execute("show stats_meta").rows
        check(("test", "orders", 0, WINDOW_ORDERS) in meta,
              f"13c show stats_meta: {meta}")
        # the scheduler's drain has fed the correction store with the
        # measured times of phases 1-13's warm launches; the strategy
        # choice below reads it (a candidate never launched prices as
        # the static model)
        corrections = pcal.correction_store().stats()["entries"]
        check(corrections > 0, "13c: no launch fed the correction store")
        for name, sql, where, key, val in HIGH_NDV_SQL:
            sess, timer = sessions[where], timers[where]
            data = co if where == "orders" else dict(zip(*s4_data))
            plan = [r[0] for r in sess.execute("explain " + sql).rows]
            strat = next(ln.split("Aggregation[", 1)[1].split("]", 1)[0]
                         for ln in plan if "Aggregation[" in ln)
            rs, first, acc = timer.run(sess, sql)
            k = data[key].data
            want = (len(np.unique(k)), exact_sum(data[val].data))
            got = select_cells(rs)
            check(got == [want], f"13c {name}: {got} != numpy {want}")
            warm = first
            if first < HIGH_NDV_ONCE_S:
                _rs, warm, acc = timer.run(sess, sql)
            ndv_est = sess.domain.stats.get(sess.domain.catalog.get_table(
                "test", "orders" if where == "orders" else "lineitem")
            ).col(key).ndv
            select_line("13c", name, first, warm, acc,
                        f"strategy={strat} groups={want[0]} "
                        f"ndv_estimate={ndv_est} "
                        f"corrections={corrections} exact=True")
    check(pplan.ARBITRATE_FALLBACKS == arb0,
          "13: the strategy choice fell back to its first candidate")
    for k, sess in sessions.items():
        check(sess.domain.client.join_fallbacks == fb0[k],
              f"13: a join of the {k} session took its host plan")
    check(guard.calls == 0, f"windows and statistics ran {guard.calls} "
          "plain-version calls of their kernels on the card")
    counts = {k: v for launches in counters for k, v in launches.items()}
    if OS:
        check(counts["radix_onesweep64"] == S.PASSES["stable_argsort"]
              and counts["radix_hist_all64"]
              == S.PASSES["stable_argsort_keys"],
              f"13: onesweep launches {counts} != the passes planned "
              f"{dict(S.PASSES)}")
    for k in GR + OS:
        check(counts[k] > 0, f"13: {k} launched {counts[k]} times")
    print(f"windows and statistics launches: {counts} stable_argsort_passes="
          f"{S.PASSES['stable_argsort']} plain_calls={guard.calls} "
          f"arbitrate_fallbacks={pplan.ARBITRATE_FALLBACKS - arb0}")
    return counts


# -- phase 14: the server on the card ------------------------------------ #

SERVER_DEVICE = "cuda"      # the `serve` subprocess's --device (step 7)
SERVER_Q6 = """select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= ? and l_shipdate < ?
  and l_discount between ? - 0.01 and ? + 0.01
  and l_quantity < ?"""
# (shipdate from, shipdate before, discount, discount, quantity): A, B, C,
# then A and B again, which the plan cache answers (its key is the bound
# text, tidb_tpu/planner/plan_cache.py:56-57)
SERVER_Q6_PARAMS = [("1994-01-01", "1995-01-01", 0.06, 0.06, 24),
                    ("1995-01-01", "1996-01-01", 0.05, 0.05, 25),
                    ("1993-01-01", "1994-01-01", 0.07, 0.07, 24)]
SERVER_Q6_ORDER = (0, 1, 2, 0, 1)
# a filtered projection of lineitem: 1/50 quantities x 1/11 discounts of
# the SF=10 rows, ~109,000 rows (each costs ~160 us in text and ~90 us
# through the cursor on the chip machine's loopback: a packet a row)
SERVER_ROWS = ("select l_quantity, l_extendedprice, l_shipdate from lineitem"
               " where l_quantity = 1 and l_discount = 0.05")
SERVER_ROWS_RANGE = (100_000, 500_000)
SERVER_FETCH = 20_000       # rows a COM_STMT_FETCH
# the KILL victim: a host hash join (the hint keeps it off the card's
# broadcast join) of orders' 1,500,000 rows and lineitem's 1/25 (~2.4 M
# rows at SF=10; 1/50 ran 0.95-1.06 s, too near the floor below), whose
# probe side streams through the host operator's cancellation point, a
# chunk of 65,536 rows at a time
SERVER_VICTIM = ("select /*+ HASH_JOIN(o) */ count(*), sum(o.o_totalprice)"
                 " from lineitem l join orders o"
                 " on l.l_extendedprice = o.o_totalprice"
                 " where l.l_quantity < 3")
SERVER_VICTIM_MIN_S = 1.0   # the victim's wall when nothing kills it
SERVER_KILL_S = 2.0         # the victim's error within this of the KILL
SERVER_CONNS, SERVER_REPS = 4, 20
SERVER_IMPORT_ROWS = 10_000
SERVER_STOP_S = 10.0        # SIGINT to the serve subprocess's exit


def q6_params_oracle(c: dict, params) -> int:
    """SERVER_Q6's revenue at ``params``, scaled by 10^4, exactly."""
    lo, hi, d, _d, q = params
    ship, disc = c["l_shipdate"].data, c["l_discount"].data
    qty, price = c["l_quantity"].data, c["l_extendedprice"].data
    dc = round(d * 100)
    m = ((ship >= _days(lo)) & (ship < _days(hi)) & (disc >= dc - 1)
         & (disc <= dc + 1) & (qty < q * 100))
    return exact_sum(price[m] * disc[m])


def _scaled(s: str, scale: int) -> int:
    import decimal
    return int(decimal.Decimal(s).scaleb(scale))


def _wire_ms(fn, reps: int) -> tuple:
    """(last result, first ms, median warm ms) of ``fn`` called
    ``1 + reps`` times."""
    t0 = time.perf_counter()
    out = fn()
    first = (time.perf_counter() - t0) * 1e3
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        warm.append((time.perf_counter() - t0) * 1e3)
    return out, first, statistics.median(warm)


def server_phase(torch, gr, os1, S, main_sess, main_data, main_res) -> None:
    """Phase 14: the port's MySQL server over phase 13's ``main_sess``
    Domain (the SF=10 lineitem placed on the card; orders of
    ``gen_orders_mini(WINDOW_ORDERS)`` registered beside it), reached only
    through the wire: ``server/client.Client`` and, for the caching_sha2
    login over TLS that reads the cursor, ``testing/mysql_client``.
    Steps 1-5 count their hand-kernel launches, step 6 that they grew;
    no plain version runs; step 7 drives ``python -m tidb_tpu_torch
    serve`` as a process."""
    import threading

    from tidb_tpu_torch.server.client import Client, MySQLError
    from tidb_tpu_torch.server.mysql_server import MySQLServer
    from tidb_tpu_torch.session.catalog import TableInfo
    from tidb_tpu_torch.testing import tpch
    from tidb_tpu_torch.testing.mysql_client import MiniMySQLClient
    counters = (gr.LAUNCHES, os1.LAUNCHES)
    dom = main_sess.domain
    for name in statement_timings.CALLS:    # phases 12-13's wrappers
        dom.client.__dict__.pop(name, None)
    orders = tpch.gen_orders_mini(WINDOW_ORDERS)
    t = TableInfo("orders", list(orders[0]), [c.dtype for c in orders[1]])
    t.register_columns(list(orders[1]))
    dom.catalog.create_table("test", t)
    c = dict(zip(*main_data))
    srv = MySQLServer(dom, host="127.0.0.1", port=0)
    port = srv.start()
    conns: list = []

    def connect(**kw):
        conns.append(Client("127.0.0.1", port, **kw))
        return conns[-1]

    def launched(before: dict) -> dict:
        return {k: v - before[k] for launches in counters
                for k, v in launches.items()}

    def snapshot() -> dict:
        return {k: v for launches in counters for k, v in launches.items()}

    reset(counters + (S.PASSES,))
    try:
        with plain_guard({"gr": gr, "os1": os1}) as guard:
            root = connect()
            # -- 1: Q1 and Q6 over COM_QUERY ---------------------------- #
            for name in SQL_MAIN:
                sql = tpch.SQL_QUERIES[name]
                rs, _f, inproc = _wire_ms(lambda: main_sess.execute(sql), 5)
                sql_check(name, rs, c, main_data[0], main_res.get(name))
                text = [tuple(None if v is None else
                              (repr(v) if isinstance(v, float) else str(v))
                              for v in r) for r in rs.rows]
                before = snapshot()
                rows, first, warm = _wire_ms(lambda: root.query(sql), 5)
                ran = launched(before)
                check(rows == text, f"14 {name}: wire rows != phase 9's")
                for k in SQL_KERNELS[name]:
                    check(ran[k] >= 6, f"14 {name}: {k} launched {ran[k]}")
                main_sess.execute("set tidb_enable_plan_cache = 0")
                main_sess.execute(sql)
                miss_ms = main_sess.timings["plan"] * 1e3
                main_sess.execute("set tidb_enable_plan_cache = 1")
                main_sess.execute(sql)
                hit_ms = main_sess.timings["plan"] * 1e3
                print(f"server {name}: rows={len(rows)} first_ms={first:.3f} "
                      f"warm_ms={warm:.3f} in_process_warm_ms={inproc:.3f} "
                      f"wire_overhead_ms={warm - inproc:.3f} "
                      f"plan_miss_ms={miss_ms:.3f} plan_hit_ms={hit_ms:.3f} "
                      f"launches={ {k: ran[k] for k in GR + OS} } "
                      "equal_phase9=True")
            # -- 2: Q6 prepared, five executions over three sets ---------- #
            stmt = root.prepare(SERVER_Q6)
            check(stmt.n_params == 5, f"14 Q6 prepared: {stmt.n_params} ?")
            cache = dom.plan_cache
            h0, before = cache.hits, snapshot()
            times = []
            wants = {i: main_q6(main_res) if i == 0 else
                     q6_params_oracle(c, SERVER_Q6_PARAMS[i])
                     for i in set(SERVER_Q6_ORDER)}
            for i in SERVER_Q6_ORDER:
                t0 = time.perf_counter()
                got = stmt.execute(*SERVER_Q6_PARAMS[i])
                times.append((time.perf_counter() - t0) * 1e3)
                want = wants[i]
                check(len(got) == 1 and _scaled(got[0][0], 4) == want,
                      f"14 Q6 prepared {SERVER_Q6_PARAMS[i]}: {got} != "
                      f"numpy {want}")
            ran = launched(before)
            check(cache.hits - h0 == 2, f"14 Q6 prepared: "
                  f"{cache.hits - h0} plan-cache hits, expected 2")
            check(ran["group_reduce"] == len(SERVER_Q6_ORDER) or not GR,
                  f"14 Q6 prepared: group_reduce launched {ran}")
            stmt.close()
            print(f"server Q6 prepared: executions={len(times)} "
                  f"ms={[round(x, 3) for x in times]} plan_cache_hits="
                  f"{cache.hits - h0} launches={ {k: ran[k] for k in GR} } "
                  "exact=True")
            # -- 3: a large result, in text and through a cursor ---------- #
            keep = ((c["l_quantity"].data == 100)
                    & (c["l_discount"].data == 5))
            want = sorted(zip(c["l_quantity"].data[keep].tolist(),
                              c["l_extendedprice"].data[keep].tolist(),
                              c["l_shipdate"].data[keep].tolist()))
            epoch = np.datetime64("1970-01-01")

            def as_oracle(rows, date_of):
                return sorted((_scaled(q, 2), _scaled(p, 2), date_of(d))
                              for q, p, d in rows)
            t0 = time.perf_counter()
            rows = root.query(SERVER_ROWS)
            text_s = time.perf_counter() - t0
            check(as_oracle(rows, lambda d: _days(d)) == want,
                  f"14 rows: {len(rows)} text rows != numpy {len(want)}")
            lo, hi = SERVER_ROWS_RANGE
            check(lo <= len(want) <= hi,
                  f"14 rows: {len(want)} rows out of {lo}-{hi}")
            del rows
            tls = MiniMySQLClient("127.0.0.1", port, use_tls=True,
                                  auth_plugin="caching_sha2_password")
            check(tls.tls, "14: the caching_sha2 login is not over TLS")
            sid, _n = tls.prepare(SERVER_ROWS)
            t0 = time.perf_counter()
            tls.execute_cursor(sid)
            fetched, fetches = [], 0
            while True:
                page, done = tls.fetch(sid, SERVER_FETCH)
                fetched.extend(page)
                fetches += 1
                if done:
                    break
            cursor_s = time.perf_counter() - t0
            tls.close()
            # the independent client reads a binary DATE by its length
            # only: the rows' quantities and prices are compared, the
            # dates' count
            check(sorted((_scaled(q, 2), _scaled(p, 2))
                         for q, p, _d in fetched)
                  == [w[:2] for w in want] and len(fetched) == len(want),
                  f"14 rows: cursor {len(fetched)} rows != numpy")
            print(f"server rows: rows={len(want)} text_s={text_s:.3f} "
                  f"text_rows_per_s={len(want) / text_s:.0f} "
                  f"cursor_s={cursor_s:.3f} cursor_rows_per_s="
                  f"{len(want) / cursor_s:.0f} fetches={fetches} "
                  "login=caching_sha2+tls exact=True")
            del fetched
            # -- 4: users and grants --------------------------------------- #
            root.execute("create user u14 identified by 'pw14'")
            root.execute("grant select on test.orders to u14")
            user = connect(user="u14", password="pw14")
            before = snapshot()
            got = user.query("select count(*), sum(o_totalprice)"
                             " from orders")
            ran = launched(before)
            tot = exact_sum(orders[1][2].data)
            check(got == [(str(WINDOW_ORDERS), f"{tot // 100}.{tot % 100:02d}")],
                  f"14 grants: orders {got}")
            check(ran["group_reduce"] > 0 or not GR,
                  f"14 grants: group_reduce launched {ran}")
            try:
                user.query("select count(*) from lineitem")
                check(False, "14 grants: SELECT on lineitem was allowed")
            except MySQLError as e:
                check(e.errno == 1105 and str(e) == (
                    "(1105) SELECT command denied to user 'u14' for table "
                    "'test.lineitem'"), f"14 grants: {e}")
            grants = user.query("show grants")
            check(grants == [("GRANT USAGE ON *.* TO 'u14'@'%'",),
                             ("GRANT SELECT ON test.orders TO 'u14'@'%'",)],
                  f"14 grants: {grants}")
            print(f"server grants: denied_errno=1105 show_grants={len(grants)}"
                  f" allowed_rows=1 launches={ {k: ran[k] for k in GR} }")
            # -- 5: KILL QUERY from a second connection -------------------- #
            victim = connect()
            vid = int(victim.query("select connection_id()")[0][0])
            before = snapshot()
            t0 = time.perf_counter()
            full = victim.query(SERVER_VICTIM)
            full_s = time.perf_counter() - t0
            ran = launched(before)
            check(full_s >= SERVER_VICTIM_MIN_S,
                  f"14 kill: the victim took {full_s:.3f} s")
            res: list = []

            def run_victim():
                t1 = time.perf_counter()
                try:
                    res.append(victim.query(SERVER_VICTIM))
                except MySQLError as e:
                    res.append(e)
                res.append(time.perf_counter() - t1)
            th = threading.Thread(target=run_victim)
            th.start()
            deadline = time.perf_counter() + 30
            while True:
                listed = {int(r[0]) for r in root.query("show processlist")}
                if vid in listed and dom.coordinator.get(vid) is not None:
                    break
                check(time.perf_counter() < deadline and th.is_alive(),
                      "14 kill: the victim never showed as running")
                time.sleep(0.01)
            t_kill = time.perf_counter()
            root.execute(f"kill query {vid}")
            th.join(30)
            check(not th.is_alive(), "14 kill: the victim did not return")
            err, took = res
            after_kill = time.perf_counter() - t_kill
            check(isinstance(err, MySQLError) and err.errno == 1105
                  and str(err) == "(1105) Query execution was interrupted",
                  f"14 kill: the victim got {err!r}")
            check(after_kill <= SERVER_KILL_S,
                  f"14 kill: error {after_kill:.3f} s after the KILL")
            check(victim.query("select 1") == [("1",)],
                  "14 kill: the victim's connection does not answer")
            print(f"server kill: victim=host hash join full_s={full_s:.3f} "
                  f"full_rows={full} killed_after_s={took:.3f} "
                  f"error_after_kill_s={after_kill:.3f} errno=1105 "
                  f"launches={ {k: ran[k] for k in GR + OS} }")
        check(guard.calls == 0, f"14: {guard.calls} plain-version calls of "
              "the kernels on the card")
        # -- 6: four connections, Q6 twenty times each ----------------- #
        q6 = tpch.SQL_QUERIES["Q6"]
        rev = main_q6(main_res)
        want6 = [(f"{rev // 10 ** 4}.{rev % 10 ** 4:04d}",)]
        one = connect()
        before = snapshot()
        t0 = time.perf_counter()
        for _ in range(SERVER_CONNS * SERVER_REPS):
            check(one.query(q6) == want6, "14 Q6 serial: != numpy")
        serial_s = time.perf_counter() - t0
        many = [connect() for _ in range(SERVER_CONNS)]
        outs: dict = {}

        def run(i):
            try:
                outs[i] = [many[i].query(q6) for _ in range(SERVER_REPS)]
            except Exception as e:       # reported by the check below
                outs[i] = e
        ths = [threading.Thread(target=run, args=(i,))
               for i in range(SERVER_CONNS)]
        t0 = time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join(120)
        par_s = time.perf_counter() - t0
        check(not any(th.is_alive() for th in ths), "14 Q6 x4: hung")
        check(all(outs[i] == [want6] * SERVER_REPS
                  for i in range(SERVER_CONNS)), f"14 Q6 x4: {outs}")
        ran = launched(before)
        check(all(ran[k] > 0 for k in GR), f"14 Q6 x4: launches {ran}")
        n = SERVER_CONNS * SERVER_REPS
        print(f"server Q6 x{SERVER_CONNS}: statements={n} "
              f"conns{SERVER_CONNS}_s={par_s:.3f} conns{SERVER_CONNS}_"
              f"stmts_per_s={n / par_s:.1f} conns1_s={serial_s:.3f} "
              f"conns1_stmts_per_s={n / serial_s:.1f} exact=True "
              f"launches_grew={ {k: ran[k] for k in GR} }")
    finally:
        for cl in conns:
            try:
                cl.close()
            except OSError:
                pass
        srv.close()
    # -- 7: `python -m tidb_tpu_torch serve` as a process --------------- #
    serve_subprocess(c)


def serve_subprocess(c: dict) -> None:
    """Step 7 of phase 14: ``serve`` on ``SERVER_DEVICE`` in a child
    process: its listening line, ``import`` of a CSV into a new table,
    an aggregate over it, ``dump``, ``/status`` and ``/metrics``, then
    SIGINT and exit code 0 within ``SERVER_STOP_S``."""
    import csv
    import os
    import re
    import signal
    import tempfile
    import urllib.request

    from tidb_tpu_torch.server.client import Client
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "tidb_tpu_torch"]
    qty = c["l_quantity"].data[:SERVER_IMPORT_ROWS]
    price = c["l_extendedprice"].data[:SERVER_IMPORT_ROWS]
    with tempfile.TemporaryDirectory(prefix="phase14_") as tmp:
        src = os.path.join(tmp, "items.csv")
        with open(src, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "qty", "price"])
            for i, (q, p) in enumerate(zip(qty.tolist(), price.tolist())):
                w.writerow([i, f"{q // 100}.{q % 100:02d}",
                            f"{p // 100}.{p % 100:02d}"])
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            cmd + ["serve", "--device", SERVER_DEVICE, "--port", "0",
                   "--status-port", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        try:
            line = proc.stdout.readline()
            m = re.search(r"listening on [\d.]+:(\d+) \(status :(\d+)\)",
                          line)
            check(m is not None, f"14 serve: {line!r}")
            start_s = time.perf_counter() - t0
            port, sport = int(m.group(1)), int(m.group(2))
            cl = Client("127.0.0.1", port)
            cl.execute("create table items (id bigint primary key,"
                       " qty decimal(8,2), price decimal(12,2))")
            t0 = time.perf_counter()
            out = subprocess.run(
                cmd + ["import", "--port", str(port), "--table", "items",
                       "--file", src, "--batch", "1000"],
                capture_output=True, text=True, env=env, timeout=300)
            import_s = time.perf_counter() - t0
            check(out.returncode == 0 and
                  f"imported {SERVER_IMPORT_ROWS} rows" in out.stdout,
                  f"14 import: {out.stdout} {out.stderr}")
            t0 = time.perf_counter()
            got = cl.query("select count(*), sum(qty), sum(price)"
                           " from items where qty < 30")
            agg_ms = (time.perf_counter() - t0) * 1e3
            m30 = qty < 3000
            want = [(str(int(m30.sum())),
                     f"{exact_sum(qty[m30]) // 100}."
                     f"{exact_sum(qty[m30]) % 100:02d}",
                     f"{exact_sum(price[m30]) // 100}."
                     f"{exact_sum(price[m30]) % 100:02d}")]
            check(got == want, f"14 serve aggregate: {got} != numpy {want}")
            plan = "\n".join(r[0] for r in cl.query(
                "explain select count(*), sum(qty) from items"
                " where qty < 30"))
            check(f"-> {SERVER_DEVICE}" in plan,
                  f"14 serve: the aggregate is not on {SERVER_DEVICE}: "
                  f"{plan}")
            cl.close()
            t0 = time.perf_counter()
            out = subprocess.run(
                cmd + ["dump", "--port", str(port), "--out",
                       os.path.join(tmp, "dump"), "--format", "csv"],
                capture_output=True, text=True, env=env, timeout=300)
            dump_s = time.perf_counter() - t0
            check(out.returncode == 0 and
                  f"dumped {SERVER_IMPORT_ROWS} rows" in out.stdout,
                  f"14 dump: {out.stdout} {out.stderr}")
            with open(os.path.join(tmp, "dump",
                                   "test.items.000000000.csv")) as f:
                back = list(csv.reader(f))[1:]
            check(len(back) == SERVER_IMPORT_ROWS
                  and sorted(int(r[0]) for r in back)
                  == list(range(SERVER_IMPORT_ROWS)),
                  "14 dump: rows != the imported ones")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{sport}/status", timeout=30) as r:
                status = json.load(r)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{sport}/metrics", timeout=30) as r:
                metrics = r.read().decode()
            check("version" in status
                  and "tidb_tpu_query_total" in metrics,
                  f"14 status: {status}")
            proc.send_signal(signal.SIGINT)
            t0 = time.perf_counter()
            proc.communicate(timeout=SERVER_STOP_S)
            stop_s = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"14 serve: exit code {proc.returncode} after SIGINT")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    print(f"server serve: device={SERVER_DEVICE} start_s={start_s:.3f} "
          f"import_s={import_s:.3f} import_rows_per_s="
          f"{SERVER_IMPORT_ROWS / import_s:.0f} aggregate_ms={agg_ms:.3f} "
          f"dump_s={dump_s:.3f} stop_s={stop_s:.3f} exit=0 exact=True")


# --------------------------------------------------------------------- #
# phase 15: streaming, the fault ladders, retries, the result cache and
# the remote stores
# --------------------------------------------------------------------- #

RESILIENCE_DEVICE = "cuda"
STREAM_PARTS = 4          # the streamed runs' cap: this share of the bytes
OOM_HEADROOM = 0.6        # step b's allowance: this share of the resident
#                           run's peak allocation over what is allocated
RC_ROWS = 5_000           # step d's table
REMOTE_SF = 0.1           # step e's lineitem, shipped to each store
# every client's entries into the OOM and the quarantine ladder
# (``_oom_degraded_agg``, ``_degraded_agg``), counted from the start
LADDER = {"oom": 0, "degraded": 0}
# the group_reduce launch count at the last entry into each ladder
LADDER_AT: dict = {}


def watch_ladders(gr) -> None:
    """Count each entry of any client into the OOM and the quarantine
    ladder in ``LADDER`` (the clients of phases 1-14 die with them), and
    note ``gr``'s ``group_reduce`` launches at the entry in
    ``LADDER_AT``."""
    from tidb_tpu_torch.store.client import CopClient
    for name, key in (("_oom_degraded_agg", "oom"),
                      ("_degraded_agg", "degraded")):
        fn = getattr(CopClient, name)

        def counted(self, *a, _fn=fn, _key=key, **k):
            LADDER[_key] += 1
            LADDER_AT[_key] = gr.LAUNCHES["group_reduce"]
            return _fn(self, *a, **k)
        setattr(CopClient, name, counted)


def no_ladder(step: str) -> None:
    check(LADDER == {"oom": 0, "degraded": 0},
          f"{step}: a ladder served a statement: {LADDER}")


BATCH_TIMES = ("stack_ms", "h2d_ms", "device_ms", "wait_ms")


def batch_lines(tag: str, rec: list) -> dict:
    """Print each streamed batch's times (the CUDA events' are nan off
    the card); returns their sums."""
    nan = float("nan")
    for k, r in enumerate(rec):
        print(f"{tag} batch {k}: rows={r['rows']} " + " ".join(
            f"{name}={r.get(name, nan):.3f}" for name in BATCH_TIMES))
    return {name: sum(r.get(name, nan) for r in rec)
            for name in BATCH_TIMES}


def stream_step(gr, sess, main_data, main_res, s4_data, s4_res) -> None:
    """15a: TPC-H Q1 and Q6 through SQL over 13a's Domain, and the SORT
    group-by over the ``--s4-sf`` lineitem through ``CopClient``, each
    resident and then streamed under a cap of a quarter of the snapshot's
    ``device_bytes()``: equal to the resident run and the numpy oracle,
    one ``group_reduce`` launch a batch program run."""
    from tidb_tpu_torch.store import CopClient, snapshot_from_columns
    from tidb_tpu_torch.testing import tpch
    client = sess.domain.client
    c, names = dict(zip(*main_data)), main_data[0]
    snap = sess.domain.catalog.get_table("test", "lineitem").snapshot()
    cap = snap.device_bytes() // STREAM_PARTS
    planned = len(snap.row_batches(cap) or ())
    check(planned >= 4, f"15a: {planned} batches under the cap")
    for name in SQL_MAIN:
        sql = tpch.SQL_QUERIES[name]
        sess.execute("set global tidb_tpu_device_mem_cap = 0")
        resident = sess.execute(sql)
        sess.execute(f"set global tidb_tpu_device_mem_cap = {cap}")
        before = gr.LAUNCHES["group_reduce"]
        t0 = time.perf_counter()
        rs = sess.execute(sql)
        wall = time.perf_counter() - t0
        launched = gr.LAUNCHES["group_reduce"] - before
        t = dict(client.timings)
        sess.execute("set global tidb_tpu_device_mem_cap = 0")
        check(rs.rows == resident.rows, f"15a {name}: streamed != resident")
        sql_check(name, rs, c, names, main_answer(main_res, name))
        rec = t["batches"]
        check(len(rec) == planned and launched == planned,
              f"15a {name}: {len(rec)} batches, {launched} group_reduce "
              f"launches, {planned} batches planned")
        tot = batch_lines(f"15a {name}", rec)
        print(f"15a {name}: rows={snap.num_rows} cap_bytes={cap} "
              f"device_bytes={snap.device_bytes()} batches={len(rec)} "
              f"wall_ms={wall * 1e3:.1f} stream_ms={t['stream'] * 1e3:.1f} "
              f"stack_ms={tot['stack_ms']:.1f} h2d_ms={tot['h2d_ms']:.1f} "
              f"device_ms={tot['device_ms']:.1f} "
              f"wait_ms={tot['wait_ms']:.1f} h2d_overlaps_compute=False "
              f"group_reduce_launches={launched} equal_resident=True "
              "exact=True")
    bycol = dict(zip(*s4_data))
    snap4 = snapshot_from_columns(S4_COLS, [bycol[n] for n in S4_COLS])
    _kind, agg, meta = build_s4("SORT")
    resident = result_arrays(CopClient(device=RESILIENCE_DEVICE).execute_agg(
        agg, snap4, meta))
    client = CopClient(device=RESILIENCE_DEVICE)
    client.device_mem_cap = snap4.device_bytes() // STREAM_PARTS
    planned = len(snap4.row_batches(client.device_mem_cap) or ())
    before = gr.LAUNCHES["group_reduce"]
    t0 = time.perf_counter()
    res = client.execute_agg(agg, snap4, meta)
    wall = time.perf_counter() - t0
    launched = gr.LAUNCHES["group_reduce"] - before
    t = client.timings
    got = result_arrays(res)
    want_k, want_v = s4_res["SORT"]
    check(all(np.array_equal(g, w) for g, w in zip(
        got[0] + got[1], resident[0] + resident[1])),
        "15a SORT: streamed != resident")
    check(all(np.array_equal(g, w) for g, w in zip(
        got[0] + got[1], want_k + want_v)), "15a SORT: != numpy")
    runs = len(t["buckets"])
    check(planned >= 4 and len(t["batches"]) == planned
          and launched == runs * expected_reduces(agg),
          f"15a SORT: {len(t['batches'])} of {planned} batches, "
          f"{launched} launches for {runs} program runs")
    tot = batch_lines("15a SORT", t["batches"])
    print(f"15a SORT: rows={snap4.num_rows} groups={len(got[0][0])} "
          f"batches={planned} wall_ms={wall * 1e3:.1f} "
          f"stream_ms={t['stream'] * 1e3:.1f} merge_ms={t['merge'] * 1e3:.1f} "
          f"buckets={t['buckets']} stack_ms={tot['stack_ms']:.1f} "
          f"h2d_ms={tot['h2d_ms']:.1f} device_ms={tot['device_ms']:.1f} "
          f"group_reduce_launches={launched} equal_resident=True exact=True")


def retry_step(gr, s4_data) -> None:
    """15c: Q6 over the ``--s4-sf`` lineitem with a placement of 8 shards
    on 4 stores (4 logical devices), a STORE_UNAVAILABLE naming store 2
    and a REGION_MISS naming shard 0 injected: the retries heal the
    placement (store 2 excluded, shard 0 split) and the answer equals
    numpy."""
    from tidb_tpu_torch.store import CopClient, snapshot_from_columns
    from tidb_tpu_torch.store.backoff import REGION_MISS, STORE_UNAVAILABLE
    from tidb_tpu_torch.store.placement import Placement
    names, cols = s4_data
    agg, meta = build_main_query("Q6", names, cols)
    snap = snapshot_from_columns(names, cols, placement=Placement.even(
        len(cols[0]), 8))
    snap.placement.rebalance(4)
    client = CopClient(device=RESILIENCE_DEVICE, n_devices=4)
    client.inject_failures(STORE_UNAVAILABLE, n=1, store=2)
    client.inject_failures(REGION_MISS, n=1, shard=0)
    before = gr.LAUNCHES["group_reduce"]
    t0 = time.perf_counter()
    res = client.execute_agg(agg, snap, meta)
    wall = time.perf_counter() - t0
    check(result_rows(res) == main_oracle("Q6", names, cols),
          "15c Q6: != numpy after the heals")
    p = snap.placement
    check(client.last_retries == 2 and client.last_heals == 2
          and p.excluded == {2} and len(p.shards) == 9,
          f"15c: retries={client.last_retries} heals={client.last_heals} "
          f"excluded={p.excluded} shards={len(p.shards)}")
    print(f"15c Q6: rows={len(cols[0])} wall_ms={wall * 1e3:.1f} "
          f"last_retries={client.last_retries} "
          f"last_heals={client.last_heals} placement_epoch={p.epoch} "
          f"shards={len(p.shards)} excluded={sorted(p.excluded)} "
          f"group_reduce_launches={gr.LAUNCHES['group_reduce'] - before} "
          "exact=True")


def cache_step(gr, main_sess) -> None:
    """15d: the result cache: Q1 over 13a's Domain (a miss, then a hit),
    and a table of ``RC_ROWS`` rows in a Domain of its own: a miss, a
    hit, and after an INSERT a miss that sees the new row."""
    from tidb_tpu_torch.session import Domain, Session
    from tidb_tpu_torch.testing import tpch
    main_sess.execute("set global tidb_tpu_result_cache_entries = 64")
    client = main_sess.domain.client
    walls = []
    for _ in range(2):
        before = gr.LAUNCHES["group_reduce"]
        t0 = time.perf_counter()
        rs = main_sess.execute(tpch.SQL_QUERIES["Q1"])
        walls.append(time.perf_counter() - t0)
        walls.append(gr.LAUNCHES["group_reduce"] - before)
    check(walls[1] > 0 and walls[3] == 0 and client.result_cache_hits == 1,
          f"15d Q1: launches {walls[1]}, {walls[3]}; hits "
          f"{client.result_cache_hits}")
    print(f"15d Q1: miss_ms={walls[0] * 1e3:.3f} hit_ms={walls[2] * 1e3:.3f}"
          f" miss_launches={walls[1]} hit_launches={walls[3]} "
          f"rows={len(rs.rows)}")
    main_sess.execute("set global tidb_tpu_result_cache_entries = 0")
    client._result_cache.clear()
    sess = Session(Domain(device=RESILIENCE_DEVICE))
    sess.execute("set global tidb_tpu_result_cache_entries = 64")
    sess.execute("create table rc (g bigint, v bigint)")
    sess.execute("insert into rc values " + ",".join(
        f"({i % 7}, {i})" for i in range(RC_ROWS)))
    q = "select g, count(*), sum(v) from rc group by g order by g"
    client = sess.domain.client
    out = []
    for step in ("miss", "hit", "insert", "miss after the write"):
        if step == "insert":
            sess.execute(f"insert into rc values (0, {RC_ROWS})")
            continue
        before = gr.LAUNCHES["group_reduce"]
        t0 = time.perf_counter()
        rows = sess.execute(q).rows
        out.append((step, (time.perf_counter() - t0) * 1e3,
                    gr.LAUNCHES["group_reduce"] - before, rows))
    want = [(g, len(range(g, RC_ROWS, 7)), sum(range(g, RC_ROWS, 7)))
            for g in range(7)]
    after = [(0, want[0][1] + 1, want[0][2] + RC_ROWS)] + want[1:]
    check([r[3] for r in out] == [want, want, after]
          and [r[2] > 0 for r in out] == [True, False, True]
          and client.result_cache_hits == 1,
          f"15d: {[(r[0], r[2], r[3][:1]) for r in out]} hits="
          f"{client.result_cache_hits}")
    print("15d table: " + " ".join(
        f"{step.replace(' ', '_')}_ms={ms:.3f}" for step, ms, _n, _r in out)
        + f" hits={client.result_cache_hits} "
        f"misses={client.result_cache_misses} exact=True")


def remote_step(gr) -> None:
    """15e: two store processes (``RemoteCluster``: numpy host engines,
    no GPU) behind a ``RemoteCopClient`` over lineitem at ``REMOTE_SF``:
    Q1 equal to the card's, again after store 0 exits mid-query (the
    placement heals onto store 1), and with both stores dead through the
    local client on the card; ``nvidia-smi`` lists no store process."""
    from tidb_tpu_torch.store.remote import RemoteCluster, RemoteCopClient
    from tidb_tpu_torch.testing import tpch
    data = tpch.gen_lineitem(REMOTE_SF, seed=0, columns=Q_COLS)
    sess = tpch.sql_session({"lineitem": data},
                             device=RESILIENCE_DEVICE)
    q1 = tpch.SQL_QUERIES["Q1"]
    card = sess.execute(q1).rows
    sql_check("Q1", sess.execute(q1), dict(zip(*data)), data[0], None)
    t0 = time.perf_counter()
    cluster = RemoteCluster(n_stores=2)
    boot = time.perf_counter() - t0
    try:
        remote = RemoteCopClient(cluster, device=RESILIENCE_DEVICE)
        sess.domain.client = remote
        walls = []
        for _ in range(2):     # the first call ships the table
            t0 = time.perf_counter()
            rows = sess.execute(q1).rows
            walls.append(time.perf_counter() - t0)
            check(rows == card, "15e Q1: remote != the card")
        check(remote.remote_dispatches == 2 and remote.local_fallbacks == 0,
              f"15e: {remote.remote_dispatches} remote dispatches, "
              f"{remote.local_fallbacks} local fallbacks")
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.split()
        pids = [p.pid for p in cluster.procs]
        check(not set(map(str, pids)) & set(apps),
              f"15e: a store process holds the GPU: {apps} {pids}")
        cluster.stores[0].request(("fail_after", 1))
        t0 = time.perf_counter()
        rows = sess.execute(q1).rows
        heal = time.perf_counter() - t0
        check(rows == card and cluster.live_ids() == [1],
              f"15e: after store 0 died live={cluster.live_ids()}")
        cluster.close()
        before = gr.LAUNCHES["group_reduce"]
        t0 = time.perf_counter()
        rows = sess.execute(q1).rows
        local = time.perf_counter() - t0
        launched = gr.LAUNCHES["group_reduce"] - before
        check(rows == card and remote.local_fallbacks == 1 and launched > 0,
              f"15e: all dead: fallbacks={remote.local_fallbacks} "
              f"launches={launched}")
    finally:
        cluster.close()
    print(f"15e Q1: rows={len(data[1][0])} stores=2 boot_s={boot:.2f} "
          f"first_ms={walls[0] * 1e3:.1f} warm_ms={walls[1] * 1e3:.1f} "
          f"healed_ms={heal * 1e3:.1f} local_fallback_ms={local * 1e3:.1f} "
          f"local_launches={launched} compute_apps={len(apps)} "
          f"store_pids_on_gpu=0 equal_card=True")


def oom_step(torch, gr, main_data) -> None:
    """15b (run last): TPC-H Q1 over a fresh snapshot of the ``--main-sf``
    lineitem under ``torch.cuda.set_per_process_memory_fraction``, set so
    that the process may hold ``OOM_HEADROOM`` of the resident run's peak
    allocation over what it holds now: the resident launch raises a real
    CUDA OOM, and the ladder's half-size streamed batches answer on the
    card (the client's host fallback is off), one ``group_reduce``
    launch a batch planned, equal to numpy, ``oom_recovered == 1``.  The
    fraction is restored in a ``finally``."""
    from tidb_tpu_torch.store import CopClient, snapshot_from_columns
    names, cols = main_data
    agg, meta = build_main_query("Q1", names, cols)
    want = main_oracle("Q1", names, cols)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    probe = CopClient(device=RESILIENCE_DEVICE).execute_agg(
        agg, snapshot_from_columns(names, cols), meta)
    need = torch.cuda.max_memory_allocated() - base
    check(result_rows(probe) == want, "15b: the resident probe != numpy")
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    held = torch.cuda.memory_reserved()
    allowed = held + int(OOM_HEADROOM * need)
    client = CopClient(device=RESILIENCE_DEVICE)
    check(not client.host_fallback, "15b: the client's host fallback is on")
    snap = snapshot_from_columns(names, cols)
    planned = len(snap.row_batches(max(snap.device_bytes() // 2, 1)) or ())
    before = gr.LAUNCHES["group_reduce"]
    torch.cuda.set_per_process_memory_fraction(min(allowed / total, 1.0))
    try:
        t0 = time.perf_counter()
        res = client.execute_agg(agg, snap, meta)
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    t = client.timings
    check(result_rows(res) == want, "15b: the OOM ladder's answer != numpy")
    check(client.oom_recovered == 1 and LADDER["oom"] == 1,
          f"15b: oom_recovered={client.oom_recovered} ladder={LADDER}")
    laddered = gr.LAUNCHES["group_reduce"] - LADDER_AT["oom"]
    check(t["oom_rung"] == "stream" and planned >= 2
          and len(t["batches"]) == planned and laddered == planned,
          f"15b: rung {t['oom_rung']}, {len(t.get('batches', ()))} batches "
          f"and {laddered} group_reduce launches in the ladder, {planned} "
          "half-size batches planned")
    tot = batch_lines("15b Q1", t["batches"])
    print(f"15b Q1: rows={len(cols[0])} resident_peak_bytes={need} "
          f"held_bytes={held} allowed_bytes={allowed} "
          f"rung={t['oom_rung']} wall_ms={wall * 1e3:.1f} "
          f"batches={len(t['batches'])} stack_ms={tot['stack_ms']:.1f} "
          f"h2d_ms={tot['h2d_ms']:.1f} device_ms={tot['device_ms']:.1f} "
          f"ladder_launches={laddered} "
          f"group_reduce_launches={gr.LAUNCHES['group_reduce'] - before} "
          f"oom_recovered={client.oom_recovered} "
          f"degraded={client.degraded} exact=True")


def resilience_phase(torch, gr, main_sess, main_data, main_res, s4_data,
                     s4_res) -> None:
    """Phase 15: the streamed path (a), a real CUDA OOM through its
    ladder (b, last), retries that heal the placement (c), the result
    cache (d) and the remote stores (e); no ladder serves a statement
    outside (b), and the native host library is built (f)."""
    from tidb_tpu_torch.copr import nativeops
    check(nativeops.available(), f"15f: the native host library is "
          f"missing: {nativeops.build_error()}")
    no_ladder("15f: phases 1-14")
    dom = main_sess.domain
    for name in statement_timings.CALLS:    # phases 12-13's wrappers
        dom.client.__dict__.pop(name, None)
    steps = (("a", lambda: stream_step(gr, main_sess, main_data, main_res,
                                       s4_data, s4_res)),
             ("c", lambda: retry_step(gr, s4_data)),
             ("d", lambda: cache_step(gr, main_sess)),
             ("e", lambda: remote_step(gr)))
    for tag, step in steps:
        t0 = time.perf_counter()
        step()
        no_ladder(f"15{tag}")
        print(f"15{tag}: s={time.perf_counter() - t0:.1f} "
              f"ladder={LADDER}")
    t0 = time.perf_counter()
    oom_step(torch, gr, main_data)
    print(f"15b: s={time.perf_counter() - t0:.1f} ladder={LADDER}")


# --------------------------------------------------------------------- #
# phase 16: admission and programs (the device scheduler)
# --------------------------------------------------------------------- #

ADMISSION_SF = 1.0         # 16b's two lineitem tables
ADMISSION_THREADS = 8      # 16a's concurrent Q6 sessions
ADMISSION_DEPTH = 2        # 16d's queue depth
ADMISSION_REPS = 5         # cuda_ms samples of 16b/16c's programs
ADMISSION_TIMEOUT_S = 120.0


def _wait_until(pred, what: str) -> None:
    deadline = time.monotonic() + ADMISSION_TIMEOUT_S
    while not pred():
        check(time.monotonic() < deadline, f"16: timed out waiting for {what}")
        time.sleep(0.002)


def states_equal(a: dict, b: dict, rtol: float = FSUM_RTOL) -> float:
    """Two state trees of tensors equal: float fields within ``rtol``
    (relative), every other field bit for bit; the largest absolute
    difference of a float field (0 if none)."""
    err = 0.0
    la, lb = dict(leaves(a)), dict(leaves(b))
    check(sorted(la) == sorted(lb), f"states {sorted(la)} != {sorted(lb)}")
    for k, x in la.items():
        y = lb[k]
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"state {k}: {x.shape} {x.dtype} != {y.shape} {y.dtype}")
        if x.dtype.is_floating_point:
            xs, ys = x.double().cpu().numpy(), y.double().cpu().numpy()
            check(np.allclose(xs, ys, rtol=rtol, atol=0.0, equal_nan=True),
                  f"state {k}: {xs} != {ys}")
            if xs.size:
                err = max(err, float(np.nanmax(np.abs(xs - ys))))
        else:
            check(bool((x == y).all()), f"state {k} differs")
    return err


class task_spy:
    """Records the structured tasks submitted to the scheduler while it
    is entered (``DeviceScheduler.submit`` wrapped)."""

    def __enter__(self):
        from tidb_tpu_torch.sched import scheduler as sm
        self.cls, self.real, self.tasks = sm.DeviceScheduler, \
            sm.DeviceScheduler.submit, []

        def submit(sched, task, _real=self.real):
            if task.key is not None:
                self.tasks.append(task)
            return _real(sched, task)
        self.cls.submit = submit
        return self

    def __exit__(self, *exc):
        self.cls.submit = self.real


def run_queued(sched, fns: list) -> tuple:
    """Run ``fns`` in threads once their tasks are queued under
    ``pause()``: (their results in order, the seconds from the release
    to the last join)."""
    import threading
    out: dict = {}

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:           # reported by the check below
            out[i] = e
    sched.pause()
    try:
        ths = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
        for th in ths:
            th.start()
        _wait_until(lambda: sched.depth >= len(fns),
                    f"{len(fns)} queued tasks")
        t0 = time.perf_counter()
    finally:
        sched.resume()
    for th in ths:
        th.join(ADMISSION_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in ths), "16: a waiter hung")
    res = [out[i] for i in range(len(fns))]
    check(not any(isinstance(r, Exception) for r in res), f"16: {res}")
    return res, wall


def admission_phase(torch, gr, main_sess, main_data, main_res,
                    s4_data) -> int:
    """Phase 16 (see the module docstring): returns the group_reduce
    launches of the statements it drives (the programs it times and
    compares are not counted)."""
    from tidb_tpu_torch.compilecache import compile_cache
    from tidb_tpu_torch.copr import dag as D
    from tidb_tpu_torch.copr import exec as cexec
    from tidb_tpu_torch.parallel import spmd
    from tidb_tpu_torch.sched import DEFAULT_QUEUE_DEPTH, ServerBusyError
    from tidb_tpu_torch.server.client import Client, MySQLError
    from tidb_tpu_torch.server.mysql_server import MySQLServer
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.session.catalog import TableInfo
    from tidb_tpu_torch.testing import tpch
    dom = main_sess.domain
    client = dom.client
    q1, q6 = tpch.SQL_QUERIES["Q1"], tpch.SQL_QUERIES["Q6"]
    names = main_data[0]
    driven = 0

    def launches() -> int:
        return gr.LAUNCHES["group_reduce"]

    def solo(sql: str, name: str, data) -> tuple:
        """One Session's run of ``sql`` over ``data`` (its table's
        ``(names, cols)``), checked against numpy: (rows, seconds, its
        structured tasks)."""
        nonlocal driven
        n0 = launches()
        with task_spy() as spy:
            t0 = time.perf_counter()
            rs = Session(dom).execute(sql)
            wall = time.perf_counter() - t0
        driven += launches() - n0
        sql_check(name, rs, dict(zip(*data)), data[0],
                  main_answer(main_res, name) if data is main_data else None)
        return rs.rows, wall, spy.tasks

    want6, _w, tasks6 = solo(q6, "Q6", main_data)
    want1, _w, tasks1 = solo(q1, "Q1", main_data)
    sched = client._sched_obj
    check(sched is not None and len(tasks6) == 1 and len(tasks1) == 1,
          f"16: Q6 {len(tasks6)} and Q1 {len(tasks1)} scheduled tasks")
    check(sched.fusion_enable and sched.max_depth == DEFAULT_QUEUE_DEPTH,
          "16: the scheduler is not at its defaults")

    # -- a: coalescing ------------------------------------------------- #
    walls = [solo(q6, "Q6", main_data)[1]
             for _ in range(ADMISSION_THREADS)]
    st0, miss0, n0 = sched.stats(), compile_cache().misses, launches()
    outs, wall8 = run_queued(sched, [lambda: Session(dom).execute(q6).rows]
                             * ADMISSION_THREADS)
    st1 = sched.stats()
    driven += launches() - n0
    check(outs == [want6] * ADMISSION_THREADS, "16a: != the solo Q6")
    coal = st1["coalesced_launches"] - st0["coalesced_launches"]
    new_miss = compile_cache().misses - miss0
    check(coal >= 1 and new_miss == 0,
          f"16a: coalesced_launches +{coal}, cache misses +{new_miss}")
    print(f"16a coalescing: threads={ADMISSION_THREADS} "
          f"launches={st1['launches'] - st0['launches']} "
          f"coalesced_launches={coal} coalesced_tasks="
          f"{st1['coalesced_tasks'] - st0['coalesced_tasks']} "
          f"cache_misses={new_miss} "
          f"group_reduce_launches={launches() - n0} "
          f"wall8_ms={wall8 * 1e3:.1f} "
          f"solo_ms={[round(w * 1e3, 1) for w in walls]} "
          f"solo_sum_ms={sum(walls) * 1e3:.1f} exact=True")

    # -- b: batching over two tables of one shape ---------------------- #
    t0 = time.perf_counter()
    tables = {"adm_a": s4_data if abs(ADMISSION_SF - 1.0) < 1e-9
              and len(s4_data[1][0]) == int(6_000_000 * ADMISSION_SF)
              else tpch.gen_lineitem(ADMISSION_SF, seed=0,
                                     columns=SQL_COLS),
              "adm_b": tpch.gen_lineitem(ADMISSION_SF, seed=1,
                                         columns=SQL_COLS)}
    gen_s = time.perf_counter() - t0
    for tname, (tn, tc) in tables.items():
        ti = TableInfo(tname, list(tn), [col.dtype for col in tc])
        ti.register_columns(list(tc))
        dom.catalog.create_table("test", ti)
    qa, qb = (q6.replace("lineitem", t) for t in tables)
    solo_a, _wa, ta = solo(qa, "Q6", tables["adm_a"])
    solo_b, _wb, tb = solo(qb, "Q6", tables["adm_b"])
    check(ta[0].key == tb[0].key, "16b: the two tables' tasks differ in key")
    calls: list = []
    real_lanes = cexec.group_reduce_lanes

    def counting(gids, G, lanes):
        calls.append(G)
        return real_lanes(gids, G, lanes)
    b0, n0 = sched.batched_launches, launches()
    cexec.group_reduce_lanes = counting
    try:
        outs, _wall = run_queued(sched, [
            lambda: Session(dom).execute(qa).rows,
            lambda: Session(dom).execute(qb).rows])
    finally:
        cexec.group_reduce_lanes = real_lanes
    driven += launches() - n0
    n_dev = len(client.devices)
    check(outs == [solo_a, solo_b], "16b: != the solo runs")
    check(sched.batched_launches == b0 + 1 and len(calls) == n_dev,
          f"16b: batched_launches +{sched.batched_launches - b0}, "
          f"{len(calls)} group_reduce_lanes calls for {n_dev} devices")
    dag = ta[0].dag
    (cols_a, cnt_a), (cols_b, cnt_b) = ((t[0].cols, t[0].counts)
                                        for t in (ta, tb))
    bprog = spmd.get_batched_program(dag, client.devices, 2)
    sprog = spmd.get_sharded_program(dag, client.devices)
    got = bprog([cols_a, cols_b], [cnt_a, cnt_b])
    for st, (cols, cnt) in zip(got, ((cols_a, cnt_a), (cols_b, cnt_b))):
        states_equal(st, sprog(cols, cnt))
    cexec.group_reduce_lanes = gr.group_reduce_lanes_plain
    try:
        plain = bprog([cols_a, cols_b], [cnt_a, cnt_b])
    finally:
        cexec.group_reduce_lanes = real_lanes
    err_b = max(states_equal(g, p) for g, p in zip(got, plain))
    ms_b = cuda_ms(torch, lambda: bprog([cols_a, cols_b], [cnt_a, cnt_b]),
                   reps=ADMISSION_REPS)
    ms_a1 = cuda_ms(torch, lambda: sprog(cols_a, cnt_a),
                    reps=ADMISSION_REPS)
    ms_b1 = cuda_ms(torch, lambda: sprog(cols_b, cnt_b),
                    reps=ADMISSION_REPS)
    print(f"16b batching: tables=2 rows={len(tables['adm_a'][1][0])} "
          f"gen_s={gen_s:.1f} batched_launches={sched.batched_launches - b0}"
          f" group_reduce_lanes_calls={len(calls)} groups={calls} "
          f"devices={n_dev} batched_ms={ms_b:.3f} solo_ms={ms_a1:.3f},"
          f"{ms_b1:.3f} solo_sum_ms={ms_a1 + ms_b1:.3f} "
          f"plain_max_abs_err={err_b} states_equal_solo=True exact=True")

    # -- c: fusion over one scan --------------------------------------- #
    # over the analyzed lineitem (13c) Q1 and Q6 prove different SUM
    # slots narrow, and a narrow chain fuses only with chains proving the
    # same slots (contracts.fusion_signature, the JAX package's rule): Q1
    # and Q6 launch apart; Q6 fuses with the corpus's Q6, a chain of its
    # class over the same scan
    from tidb_tpu_torch.analysis.contracts import fusion_signature
    t1, t6 = tasks1[0], tasks6[0]
    fs1, fs6 = fusion_signature(t1.dag), fusion_signature(t6.dag)
    f0, n0 = sched.fused_launches, launches()
    outs, _wall = run_queued(sched, [
        lambda: Session(dom).execute(q1).rows,
        lambda: Session(dom).execute(q6).rows])
    driven += launches() - n0
    check(outs == [want1, want6], "16c: != the solo Q1, Q6")
    check(sched.fused_launches == f0 + (fs1 == fs6),
          f"16c: Q1, Q6 fused_launches +{sched.fused_launches - f0} "
          f"(signatures {fs1}, {fs6})")
    q6c = tpch.SQL_QUERIES["Q6 corpus"]
    wantc, _w, tasksc = solo(q6c, "Q6 corpus", main_data)
    tc = tasksc[0]
    check(len(tasksc) == 1 and tc.dag != t6.dag
          and fusion_signature(tc.dag) == fs6 is not None,
          f"16c: Q6 corpus {fusion_signature(tc.dag)} against Q6 {fs6}")
    f1, n0 = sched.fused_launches, launches()
    outs, _wall = run_queued(sched, [
        lambda: Session(dom).execute(q6).rows,
        lambda: Session(dom).execute(q6c).rows])
    driven += launches() - n0
    check(outs == [want6, wantc], "16c: != the solo Q6, Q6 corpus")
    check(sched.fused_launches == f1 + 1,
          f"16c: fused_launches +{sched.fused_launches - f1}")
    check(t6.input_token == tc.input_token, "16c: the Q6 scans differ")
    fprog = spmd.get_fused_program(D.FusedDag((t6.dag, tc.dag)),
                                   client.devices)
    p6 = spmd.get_sharded_program(t6.dag, client.devices)
    pc = spmd.get_sharded_program(tc.dag, client.devices)
    fused = fprog(t6.cols, t6.counts)
    states_equal(fused[0], p6(t6.cols, t6.counts))
    states_equal(fused[1], pc(tc.cols, tc.counts))
    ms_f = cuda_ms(torch, lambda: fprog(t6.cols, t6.counts),
                   reps=ADMISSION_REPS)
    ms_6 = cuda_ms(torch, lambda: p6(t6.cols, t6.counts),
                   reps=ADMISSION_REPS)
    ms_c = cuda_ms(torch, lambda: pc(tc.cols, tc.counts),
                   reps=ADMISSION_REPS)
    print(f"16c fusion: Q1 {fs1} and Q6 {fs6} fused_launches="
          f"{int(fs1 == fs6)}; members=Q6,Q6 corpus "
          f"rows={len(main_data[1][0])} fused_launches="
          f"{sched.fused_launches - f1} fused_ms={ms_f:.3f} "
          f"q6_ms={ms_6:.3f} q6_corpus_ms={ms_c:.3f} "
          f"solo_sum_ms={ms_6 + ms_c:.3f} states_equal_solo=True "
          "exact=True")

    # -- d, e: admission and the server -------------------------------- #
    rev = main_q6(main_res)
    wire6 = [(f"{rev // 10 ** 4}.{rev % 10 ** 4:04d}",)]
    srv = MySQLServer(dom, host="127.0.0.1", port=0)
    port = srv.start()
    conns: list = []

    def connect():
        conns.append(Client("127.0.0.1", port, db="test"))
        return conns[-1]
    admin = Session(dom)
    try:
        admin.execute("set global tidb_tpu_sched_queue_depth = "
                      f"{ADMISSION_DEPTH}")
        admin.execute(q6)
        check(sched.max_depth == ADMISSION_DEPTH, "16d: depth not applied")
        wire = [connect() for _ in range(3)]
        import threading
        outs: dict = {}

        def run(i):
            try:
                outs[i] = wire[i].query(q6)
            except Exception as e:       # reported by the check below
                outs[i] = e
        busy0, n0 = sched.busy_rejects, launches()
        sched.pause()
        try:
            ths = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
            for th in ths:
                th.start()
            _wait_until(lambda: sched.depth >= ADMISSION_DEPTH,
                        "two queued statements")
            errno_wire = errno_local = None
            try:
                wire[2].query(q6)
            except MySQLError as e:
                errno_wire = e.errno
            try:
                Session(dom).execute(q6)
            except ServerBusyError as e:
                errno_local = e.errno
        finally:
            sched.resume()
        for th in ths:
            th.join(ADMISSION_TIMEOUT_S)
        driven += launches() - n0
        check(errno_wire == 9003 and errno_local == 9003,
              f"16d: the third statement got {errno_wire} over the wire "
              f"and {errno_local} in process")
        check(outs == {0: wire6, 1: wire6}, f"16d: queued {outs}")
        print(f"16d admission: depth={ADMISSION_DEPTH} queued=2 "
              f"third_errno_wire={errno_wire} "
              f"third_errno_local={errno_local} "
              f"busy_rejects={sched.busy_rejects - busy0} exact=True")
        admin.execute("set global tidb_tpu_sched_queue_depth = "
                      f"{DEFAULT_QUEUE_DEPTH}")
        admin.execute(q6)
        check(sched.max_depth == DEFAULT_QUEUE_DEPTH, "16d: not restored")
        # -- e: phase 14's 4 x 20 Q6 --------------------------------- #
        one = connect()
        n0 = launches()
        t0 = time.perf_counter()
        for _ in range(SERVER_CONNS * SERVER_REPS):
            check(one.query(q6) == wire6, "16e Q6 serial: != numpy")
        serial_s = time.perf_counter() - t0
        many = [connect() for _ in range(SERVER_CONNS)]
        st0 = sched.stats()
        outs = {}

        def rep(i):
            try:
                outs[i] = [many[i].query(q6) for _ in range(SERVER_REPS)]
            except Exception as e:       # reported by the check below
                outs[i] = e
        ths = [threading.Thread(target=rep, args=(i,))
               for i in range(SERVER_CONNS)]
        t0 = time.perf_counter()
        for th in ths:
            th.start()
        for th in ths:
            th.join(ADMISSION_TIMEOUT_S)
        par_s = time.perf_counter() - t0
        st1 = sched.stats()
        driven += launches() - n0
        check(not any(th.is_alive() for th in ths), "16e: hung")
        check(all(outs[i] == [wire6] * SERVER_REPS
                  for i in range(SERVER_CONNS)), f"16e: {outs}")
        n = SERVER_CONNS * SERVER_REPS
        print(f"16e server Q6 x{SERVER_CONNS}: statements={n} "
              f"conns{SERVER_CONNS}_stmts_per_s={n / par_s:.1f} "
              f"conns1_stmts_per_s={n / serial_s:.1f} "
              f"launches={st1['launches'] - st0['launches']} "
              f"coalesced_launches="
              f"{st1['coalesced_launches'] - st0['coalesced_launches']} "
              f"coalesced_tasks="
              f"{st1['coalesced_tasks'] - st0['coalesced_tasks']} "
              f"window_waits={st1['window_waits'] - st0['window_waits']} "
              f"exact=True")
    finally:
        sched.resume()
        for cl in conns:
            try:
                cl.close()
            except OSError:
                pass
        srv.close()
    st = sched.stats()
    print(f"16 sched: launches={st['launches']} tasks_done="
          f"{st['tasks_done']} coalesced_launches="
          f"{st['coalesced_launches']} batched_launches="
          f"{st['batched_launches']} fused_launches={st['fused_launches']} "
          f"window_waits={st['window_waits']} window_hits="
          f"{st['window_hits']} busy_rejects={st['busy_rejects']} "
          f"retried_launches={st['retried_launches']} "
          f"bisected_launches={st['bisected_launches']} oom_faults="
          f"{st['oom_faults']} budget_rejects={st['budget_rejects']} "
          f"hbm_budget={st['hbm_budget']} wait_p50_ms={st['wait_p50_ms']} "
          f"wait_p99_ms={st['wait_p99_ms']} compile_cache="
          f"{json.dumps(compile_cache().stats())}")
    check(driven > 0, "16: no group_reduce launch")
    return driven


# --------------------------------------------------------------------- #
# phase 17: the statement's observability
# --------------------------------------------------------------------- #

OBS_TRACE_REPS = 40        # 17f's warm Q6 calls a setting, interleaved
OBS_PROFILE_MS = 1500      # 17e's capture window
OBS_Q6_IN_CAPTURE = 5      # Q6 calls inside it
OBS_ROOF_ROWS = 12         # 17d's rows by roofline gap
OBS_REQUIRED = ("session.ExecuteStmt", "cop.dispatch", "sched.queue",
                "sched.launch", "cop.transfer", "cop.host_merge")


def print_tree(tag: str, tree) -> None:
    """One span tree as TRACE renders it: a line a span, indented by
    depth, with its start and duration in µs from the statement's
    start."""
    print(f"{tag} trace_id={tree.trace_id} latency_ms={tree.latency_ms:.3f}"
          f" flags={sorted(tree.flags)} spans={len(tree.spans)}")
    for label, start_us, dur_us in tree.rows():
        print(f"{tag}   {label} start_us={start_us} dur_us={dur_us}")


def newest_trace(dom, sql: str):
    """The flight recorder's newest trace of ``sql``."""
    for ent in dom.flight_recorder.index():
        if ent["sql"] == sql.strip()[:200]:
            return dom.flight_recorder.get(ent["trace_id"])
    return None


def launch_spans(tree) -> list:
    return [sp for sp in tree.spans if sp.name == "sched.launch"]


def observability_phase(torch, gr, os1, main_sess, main_data, main_res,
                        s4_data) -> int:
    """Phase 17 (see the module docstring): returns the group_reduce
    launches of the main-path statements it drives (Q1 and Q6; 17b's
    SORT is phase 8's slice-4 shape and is not counted)."""
    from tidb_tpu_torch.analysis.compilekey import stable_digest
    from tidb_tpu_torch.obs.hbm import profiler_gate
    from tidb_tpu_torch.obs.roofline import roofline_status, roofline_store
    from tidb_tpu_torch.server.status import StatusServer
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store import snapshot_from_columns
    from tidb_tpu_torch.testing import tpch
    from tidb_tpu_torch.utils.tracing import Tracer
    dom = main_sess.domain
    on_card = dom.client.devices[0].type == "cuda"
    sess = Session(dom)
    q1, q6 = tpch.SQL_QUERIES["Q1"], tpch.SQL_QUERIES["Q6"]
    c = dict(zip(*main_data))
    sess.execute("set global tidb_tpu_trace_sample = 1")
    driven = 0
    step_t: dict = {}

    def launches() -> int:
        return gr.LAUNCHES["group_reduce"]

    def run(sql: str, name: str):
        nonlocal driven
        n0 = launches()
        with task_spy() as spy:
            rs = sess.execute(sql)
        driven += launches() - n0
        if name:
            sql_check(name, rs, c, main_data[0],
                      main_answer(main_res, name))
        return rs, spy.tasks

    step_t["a"] = time.perf_counter()
    # -- a: Q1's span tree --------------------------------------------- #
    rs1, tasks1 = run(q1, "Q1")
    tree = newest_trace(dom, q1)
    check(tree is not None, "17a: Q1's trace is not in the recorder")
    names = {sp.name for sp in tree.spans}
    check(set(OBS_REQUIRED) <= names, f"17a: Q1's spans {sorted(names)}")
    lsp = launch_spans(tree)
    check(lsp and all("device_ms" in sp.attrs for sp in lsp),
          f"17a: sched.launch without device_ms {[sp.attrs for sp in lsp]}")
    if on_card:
        check(all(sp.thread.startswith("sched-drain") for sp in lsp),
              "17a: a launch span not recorded by the drain")
    print_tree("17a Q1", tree)
    q1_device_ms = sum(sp.attrs["device_ms"] for sp in lsp)
    q1_measured_ms = sum(sp.attrs["measured_ms"] for sp in lsp)

    step_t["b"] = time.perf_counter()
    # -- b: the SORT GROUP BY of phase 8's shape ----------------------- #
    names4, cols4 = s4_data
    snap = snapshot_from_columns(
        S4_COLS, [cols4[names4.index(n)] for n in S4_COLS])
    _kind, agg, key_meta = build_s4("SORT")
    reset([gr.LAUNCHES, os1.LAUNCHES])
    tracer = Tracer()
    tracer.tree.sql = "SORT (phase 8's DAG)"
    t0 = time.perf_counter()
    with task_spy() as spy, tracer.region("session.ExecuteStmt"):
        res = dom.client.execute_agg(agg, snap, key_meta)
    sort_ms = (time.perf_counter() - t0) * 1e3
    tasks_sort = spy.tasks
    ok =cols4[names4.index("l_orderkey")].data
    price = cols4[names4.index("l_extendedprice")].data
    got = res.columns[0].data
    got_sum = exact_sum(got) if got.dtype == np.int64 \
        else sum(int(v) for v in got)
    check(len(res.key_columns[0].data) == len(np.unique(ok))
          and got_sum == exact_sum(price),
          "17b: SORT's groups or sum != numpy")
    check(gr.LAUNCHES["group_reduce"] >= 1
          and os1.LAUNCHES["radix_onesweep64"] >= 1
          and os1.LAUNCHES["radix_hist_all64"] >= 1,
          f"17b: SORT launches {gr.LAUNCHES} {os1.LAUNCHES}")
    snames = {sp.name for sp in tracer.tree.spans}
    check({"cop.dispatch", "sched.launch", "cop.transfer",
           "cop.host_merge"} <= snames, f"17b: SORT's spans {snames}")
    check(all("device_ms" in sp.attrs
              for sp in launch_spans(tracer.tree)),
          "17b: a SORT launch without device_ms")
    print(f"17b SORT: groups={len(res.key_columns[0].data)} "
          f"wall_ms={sort_ms:.1f} group_reduce_launches="
          f"{gr.LAUNCHES['group_reduce']} radix_hist_all64_launches="
          f"{os1.LAUNCHES['radix_hist_all64']} radix_onesweep64_launches="
          f"{os1.LAUNCHES['radix_onesweep64']} exact=True")
    tracer.tree.latency_ms = sort_ms
    print_tree("17b SORT", tracer.tree)
    del res, snap

    step_t["c"] = time.perf_counter()
    # -- c: EXPLAIN ANALYZE of Q1 --------------------------------------- #
    n0 = launches()
    ea = sess.execute("explain analyze " + q1)
    driven += launches() - n0
    groups = len(rs1.rows)           # 17a checked them against numpy
    check(ea.names == ["operator", "actRows", "time", "loops"]
          and ea.rows[0][1] == groups
          and any(r[0].lstrip().startswith("CopTask") and r[1] == groups
                  for r in ea.rows),
          f"17c: EXPLAIN ANALYZE {ea.rows}")
    ea_tree = newest_trace(dom, "explain analyze " + q1)
    ea_dev = sum(sp.attrs.get("device_ms", 0.0)
                 for sp in launch_spans(ea_tree)) if ea_tree else 0.0
    for op, act, tm, loops in ea.rows:
        print(f"17c EXPLAIN ANALYZE: {op} actRows={act} time={tm} "
              f"loops={loops}")
    cop = next(r for r in ea.rows if r[0].lstrip().startswith("CopTask"))
    print(f"17c Q1: groups={groups} "
          f"cop_task_ms={cop[2]} launch_device_ms={ea_dev:.3f} "
          f"(17a: device_ms={q1_device_ms:.3f} "
          f"measured_ms={q1_measured_ms:.3f})")

    step_t["d"] = time.perf_counter()
    # -- d: the roofline ------------------------------------------------ #
    _rs6, tasks6 = run(q6, "Q6")
    st = roofline_status(OBS_ROOF_ROWS)
    peak_bw, peak_fl = st["peak_bytes_per_s"], st["peak_flops_per_s"]
    print(f"17d roofline: entries={st['entries']} observed={st['observed']}"
          f" peak_bytes_per_s={peak_bw} peak_flops_per_s={peak_fl} "
          f"peak_source={st['peak_source']} bounds={st['bounds']}")
    if on_card:
        kind = torch.cuda.get_device_name(0)
        want = ("declared:nvidia-datasheet" if "H100 80GB HBM3" in kind
                else "microbench:cuda")
        check(st["peak_source"].startswith(want),
              f"17d: peak source {st['peak_source']} on {kind}")

    def roof_line(tag: str, att: dict) -> None:
        unclamped = att["achieved_gbps"] * 1e9 / peak_bw * 100.0
        print(f"17d {tag}: ewma_ms={att['ewma_ms']} achieved_gbps="
              f"{att['achieved_gbps']} bytes_pct={att['bytes_pct']} "
              f"bytes_pct_unclamped={unclamped:.3f} flops_pct="
              f"{att['flops_pct']} bound={att['bound']} samples="
              f"{att['samples']}")
    rows = 0
    for tag, tasks in (("Q1", tasks1), ("Q6", tasks6),
                       ("SORT", tasks_sort)):
        for d in dict.fromkeys(stable_digest(t.dag) for t in tasks):
            att = roofline_store().get(d)
            if att is not None:
                roof_line(f"{tag} {d[:16]}", att)
                rows += 1
            else:
                print(f"17d {tag} {d[:16]}: no warm launch measured")
    for d, att in st["by_gap"].items():
        roof_line(f"gap {d}", att)
    # every digest, closest to the peak first: an unclamped share past
    # 100% means the copied LaunchCost counts too few bytes for the
    # port's program (or the time is not the card's)
    every = roofline_store().top(st["entries"])["by_gap"]
    near = sorted(every.items(), key=lambda kv: kv[1]["gap_pct"])[:3]
    for d, att in near:
        roof_line(f"near {d}", att)
    over = [d for d, att in every.items()
            if att["achieved_gbps"] * 1e9 / peak_bw * 100.0 > 100.0]
    print(f"17d over_peak_unclamped={len(over)} {over}")
    check(st["entries"] >= 3 and len(st["by_gap"]) >= 3,
          f"17d: {st['entries']} roofline digests ({rows} of 17's)")

    step_t["e"] = time.perf_counter()
    # -- e: a /profile capture around Q6 -------------------------------- #
    srv = StatusServer(dom)
    port = srv.start()
    gate = profiler_gate()
    try:
        sess.execute("set global tidb_tpu_profile = 1")
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/profile?ms={OBS_PROFILE_MS}",
                timeout=60) as r:
            started = json.loads(r.read())
        check(started.get("started") is True, f"17e: /profile {started}")
        if on_card:
            check("CUDA" in started["activities"],
                  f"17e: activities {started['activities']}")
        t0 = time.perf_counter()
        n0 = launches()
        for _ in range(OBS_Q6_IN_CAPTURE):
            sess.execute(q6)
        in_capture = launches() - n0
        driven += in_capture
        q6_s = time.perf_counter() - t0
        check(q6_s * 1e3 < OBS_PROFILE_MS,
              f"17e: the Q6 calls outlasted the capture ({q6_s:.2f} s)")
        deadline = time.monotonic() + 120
        while gate.stats()["active"]:
            check(time.monotonic() < deadline, "17e: the capture never ended")
            time.sleep(0.05)
        gst = gate.stats()
        check(gst["trace"] and not gst["last_error"], f"17e: {gst}")
        with open(gst["trace"]) as f:
            events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        grk = [e for e in kern if "group_reduce" in e.get("name", "")]
        if on_card:
            check(len(grk) >= 1, "17e: no group_reduce kernel event in "
                                 f"the capture ({len(kern)} kernels)")
        print(f"17e profile: ms={OBS_PROFILE_MS} q6_calls="
              f"{OBS_Q6_IN_CAPTURE} group_reduce_launches={in_capture} "
              f"events={len(events)} kernel_events={len(kern)} "
              f"group_reduce_kernel_events={len(grk)} "
              f"kernel_us={sum(e.get('dur', 0) for e in kern):.1f} "
              f"activities={started['activities']}")
    finally:
        sess.execute("set global tidb_tpu_profile = 0")
        srv.close()

    step_t["f"] = time.perf_counter()
    # -- f: tracing's cost on a warm Q6 --------------------------------- #
    walls: dict = {1: [], 0: []}
    n0 = launches()
    gc.collect()          # once: a collection a call would be the time
    for _ in range(OBS_TRACE_REPS):
        for on in (1, 0):
            sess.execute(f"set tidb_tpu_trace = {on}")
            t0 = time.perf_counter()
            sess.execute(q6)
            walls[on].append((time.perf_counter() - t0) * 1e3)
    sess.execute("set tidb_tpu_trace = 1")
    driven += launches() - n0
    on_ms, off_ms = (statistics.median(walls[k]) for k in (1, 0))
    print(f"17f trace cost: q6_warm_ms_on={on_ms:.3f} q6_warm_ms_off="
          f"{off_ms:.3f} diff_ms={on_ms - off_ms:.3f} diff_pct="
          f"{(on_ms - off_ms) / off_ms * 100:.2f} reps={OBS_TRACE_REPS}")

    step_t["g"] = time.perf_counter()
    # -- g: the slow log at a zero threshold ---------------------------- #
    sess.execute("set tidb_tpu_slow_threshold_ms = 0")
    try:
        n0 = launches()
        sess.execute(q6)
        driven += launches() - n0
        slow = sess.execute("show slow_queries")
    finally:
        sess.execute("set tidb_tpu_slow_threshold_ms = 300")
        sess.execute("set global tidb_tpu_trace_sample = 16")
    mine = [r for r in slow.rows if r[0] == q6]
    check(mine and mine[-1][7]
          and dom.flight_recorder.get(mine[-1][7]) is not None,
          f"17g: slow log {slow.rows[-3:]}")
    for r in slow.rows[-3:]:
        print("17g SHOW SLOW_QUERIES: " + " | ".join(
            f"{k}={' '.join(str(v).split())[:60]}"
            for k, v in zip(slow.names, r)))
    check(driven > 0, "17: no group_reduce launch")
    ends = list(step_t.values())[1:] + [time.perf_counter()]
    print("17 steps: " + " ".join(
        f"{k}_s={e - t:.2f}" for (k, t), e in zip(step_t.items(), ends)))
    return driven


# --------------------------------------------------------------------- #
# phase 18: the plan-time gates and buffer lifetime
# --------------------------------------------------------------------- #

# ROADMAP.md Queue 3 item 1: statements whose device lane would wrap
# over an analyzed table, with the rule the JAX session refuses them by
# (written here: the script imports nothing of the JAX package), and
# what the port's lanes return with the gate off (the wrapped digits the
# JAX device lanes return too)
GATES_SETUP = [
    "create table g18t (d decimal(18,2), a bigint)",
    f"insert into g18t values (999999999999.99, {2 ** 62}), (1.50, 3)",
    "analyze table g18t",
    "create table g18u (a bigint)",
    f"insert into g18u values ({2 ** 61}), (5)",
    "analyze table g18u",
]
GATES_WRAPS = {
    "select d / 2.5 from g18t": "NUM-DIV-PRESCALE",
    "select sum(d / 2.5) from g18t": "NUM-DIV-PRESCALE",
    "select a + a from g18t": "NUM-OVERFLOW-DEVICE",
    "select sum(a + a) from g18t": "NUM-OVERFLOW-DEVICE",
    "select a * 16 from g18u where a > 100": "NUM-OVERFLOW-DEVICE",
}
GATES_WRAPPED = {
    "select d / 2.5 from g18t": ["-337869762948.386065", "0.600000"],
    "select sum(d / 2.5) from g18t": ["-337869762947.786065"],
    "select a + a from g18t": [str(-2 ** 63), "6"],
    "select sum(a + a) from g18t": [str(-2 ** 63 + 6)],
    "select a * 16 from g18u where a > 100": ["0"],
}
GATES_DRIFT_ROWS = 64            # 18d's table: 1..64, then one far row
GATES_DRIFT_FAR = 100_000


def gates_phase(torch, gr, main_sess, main_data, main_res) -> int:
    """Phase 18 (see the module docstring): returns the group_reduce
    launches of 18b's narrow Q1 and Q6 statements."""
    from tidb_tpu_torch.analysis import valueflow
    from tidb_tpu_torch.analysis.contracts import PlanContractError
    from tidb_tpu_torch.copr import dag as D
    from tidb_tpu_torch.copr import exec as cexec
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.testing import tpch
    dom = main_sess.domain
    on_card = dom.client.devices[0].type == "cuda"
    sched = dom.client._scheduler()
    sess = Session(dom)
    sess.execute("set global tidb_tpu_result_cache_entries = 0")
    sess.execute("set global tidb_tpu_trace_sample = 1")
    c, names = dict(zip(*main_data)), main_data[0]

    # -- a: the wrapping statements, refused by the gate ---------------- #
    t0 = time.perf_counter()
    for sql in GATES_SETUP:
        sess.execute(sql)
    sess.execute("set tidb_enable_plan_cache = 0")   # each plan afresh
    sess.vars["tidb_tpu_verify_plan"] = 0   # off first: nothing refused
    for sql, want in GATES_WRAPPED.items():
        n0 = gr.LAUNCHES["group_reduce"]
        rows = sess.execute(sql).rows
        got = sorted(str(r[0]) for r in rows)
        check(got == sorted(want), f"18a gate off {sql!r}: {got}")
        print(f"18a gate off: {sql!r} rows={got} "
              f"group_reduce_launches={gr.LAUNCHES['group_reduce'] - n0}")
    sess.vars.pop("tidb_tpu_verify_plan")
    for sql, rule in GATES_WRAPS.items():
        n0 = gr.LAUNCHES["group_reduce"]
        try:
            sess.execute(sql)
            got = "ran"
        except PlanContractError as e:
            got = e.rule
        check(got == rule and gr.LAUNCHES["group_reduce"] == n0,
              f"18a {sql!r}: {got}, want {rule} before any launch")
        print(f"18a gate on: {sql!r} PlanContractError rule={got} "
              "launches=0")
    sess.execute("set tidb_enable_plan_cache = 1")
    print(f"18a: s={time.perf_counter() - t0:.1f}")

    # -- b: Q1 and Q6 at the main scale over the analyzed lineitem ------ #
    t0 = time.perf_counter()
    seen: list = []
    real_lanes = cexec.group_reduce_lanes

    def lanes_spy(gids, num_groups, lanes):
        seen.append(len(gr.unique_lanes(lanes)))
        return real_lanes(gids, num_groups, lanes)
    driven = 0
    cexec.group_reduce_lanes = lanes_spy
    try:
        for name in ("Q1", "Q6"):
            sql = tpch.SQL_QUERIES[name]
            # the plan phases 14-17 ran: the plan cache's, if it holds one
            n0 = gr.LAUNCHES["group_reduce"]
            with task_spy() as spy:
                sess.execute(sql)
            driven += gr.LAUNCHES["group_reduce"] - n0
            print(f"18b {name} as planned for phases 14-17: narrow_sums="
                  f"{[list(t.dag.narrow_sums) for t in spy.tasks]}")
            sess.execute("set tidb_enable_plan_cache = 0")
            n0 = gr.LAUNCHES["group_reduce"]
            with task_spy() as spy:
                sess.execute(sql)           # a plan cache miss: the gates
            miss_ms = sess.timings["plan"] * 1e3
            aggs = [t.dag for t in spy.tasks
                    if isinstance(t.dag, D.Aggregation)]
            # Q1's column SUMs narrow at SF=10; Q6's product may not
            check(len(aggs) == 1 and (name != "Q1" or aggs[0].narrow_sums),
                  f"18b {name}: narrow slots "
                  f"{[a.narrow_sums for a in aggs]}")
            agg = aggs[0]
            sess.execute("set tidb_enable_plan_cache = 1")
            dom.plan_cache._lru.clear()     # a narrow plan, cached
            seen.clear()
            sess.execute(sql)
            check(seen and all(n == expected_lanes(agg) for n in seen),
                  f"18b {name}: launch lanes {seen}, want "
                  f"{expected_lanes(agg)}")
            lanes = seen[0]
            t1 = time.perf_counter()
            rs = sess.execute(sql)          # warm, a plan cache hit
            wall_ms = (time.perf_counter() - t1) * 1e3
            hit_ms = sess.timings["plan"] * 1e3
            sql_check(name, rs, c, names, main_answer(main_res, name))
            tree = newest_trace(dom, sql)
            dev_ms = sum(sp.attrs.get("device_ms", 0.0)
                         for sp in launch_spans(tree)) if tree else 0.0
            launched = gr.LAUNCHES["group_reduce"] - n0
            driven += launched
            limbs = sum(1 for i, a in enumerate(agg.aggs)
                        if a.func == D.AggFunc.SUM
                        and not a.arg.dtype.is_float
                        and i not in agg.narrow_sums)
            print(f"18b {name}: narrow_sums={list(agg.narrow_sums)} "
                  f"limb_sums={limbs} launch_lanes={lanes} "
                  f"expected_lanes={expected_lanes(agg)} "
                  f"rows={len(rs.rows)} warm_wall_ms={wall_ms:.3f} "
                  f"plan_ms_miss={miss_ms:.3f} plan_ms_hit={hit_ms:.3f} "
                  f"launch_device_ms={dev_ms:.3f} "
                  f"group_reduce_launches={launched} exact=True")
    finally:
        cexec.group_reduce_lanes = real_lanes
    print(f"18b: s={time.perf_counter() - t0:.1f}")

    # -- d: watermark drift ------------------------------------------------ #
    t0 = time.perf_counter()
    sql = "select sum(a) from g18m"
    sess.execute("create table g18m (a bigint)")
    sess.execute("insert into g18m values " + ",".join(
        f"({i})" for i in range(1, GATES_DRIFT_ROWS + 1)))
    sess.execute("analyze table g18m")
    sess.execute(f"insert into g18m values ({GATES_DRIFT_FAR})")
    want = GATES_DRIFT_ROWS * (GATES_DRIFT_ROWS + 1) // 2 + GATES_DRIFT_FAR
    rows0 = sess.execute(sql).rows     # planned on the old statistics
    d0 = sched.stats()["value_drifts"]
    sess.execute("analyze table g18m")  # the far row's watermark
    rows1 = sess.execute(sql).rows     # the cached plan's old proof
    d1 = sched.stats()["value_drifts"]
    sess.execute("set tidb_enable_plan_cache = 0")
    rows2 = sess.execute(sql).rows     # a fresh proof after the ANALYZE
    d2 = sched.stats()["value_drifts"]
    sess.execute("set tidb_enable_plan_cache = 1")
    check(all(r == [(want,)] for r in (rows0, rows1, rows2)),
          f"18d: {rows0} {rows1} {rows2}, want {want}")
    check(d1 == d0 + 1 and d2 == d1,
          f"18d: value_drifts {d0} -> {d1} -> {d2}")
    print(f"18d drift: value_drifts {d0} -> {d1} (cached plan after the "
          f"ANALYZE) -> {d2} (re-planned) result={want} exact=True "
          f"registry_drifts={valueflow.drift_count()} "
          f"s={time.perf_counter() - t0:.1f}")

    # -- e: EXPLAIN's footers ------------------------------------------ #
    for name in ("Q1", "Q6"):
        lines = [r[0] for r in sess.execute(
            "explain " + tpch.SQL_QUERIES[name]).rows]
        foot = lines[lines.index("contract: ok"):] \
            if "contract: ok" in lines else []
        check(foot and any(ln.startswith("est. device bytes: ")
                           for ln in foot)
              and (name != "Q1" or any(ln.startswith("agg strategy: dense")
                                       for ln in foot)),
              f"18e {name}: footers {foot}")
        for ln in foot:
            print(f"18e EXPLAIN {name}: {ln}")

    # -- f: the streamed Q1 with its DonationPlan ---------------------- #
    t0 = time.perf_counter()
    client = dom.client
    snap = dom.catalog.get_table("test", "lineitem").snapshot()
    cap = snap.device_bytes() // STREAM_PARTS
    planned = len(snap.row_batches(cap) or ())
    sql = tpch.SQL_QUERIES["Q1"]
    real_launch = type(client)._launch

    def undonated(self, dag, cols, counts, aux, row_capacity=0,
                  donate=False):
        return real_launch(self, dag, cols, counts, aux, row_capacity,
                           donate=False)
    out = {}
    sess.execute(f"set global tidb_tpu_device_mem_cap = {cap}")
    try:
        for label in ("donated", "undonated", "donated again"):
            if label == "undonated":
                client._launch = undonated.__get__(client)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            s0 = sched.stats()
            t1 = time.perf_counter()
            rs = sess.execute(sql)
            wall_ms = (time.perf_counter() - t1) * 1e3
            if on_card:
                torch.cuda.synchronize()
            _wait_until(lambda s0=s0: sched.stats()["tasks_done"]
                        >= s0["tasks_done"] + planned,
                        "18f: the drain's bookkeeping")
            s1 = sched.stats()
            client.__dict__.pop("_launch", None)
            if not out:
                sql_check("Q1", rs, c, names, None)
                first = rs.rows
            check(rs.rows == first, f"18f [{label}]: rows != the first run")
            peak = torch.cuda.max_memory_allocated() - base if on_card \
                else 0
            out[label] = dict(
                launches=s1["donated_launches"] - s0["donated_launches"],
                tasks=s1["donated_tasks"] - s0["donated_tasks"],
                priced=s1["donated_bytes"] - s0["donated_bytes"],
                peak=peak, wall_ms=wall_ms)
            print(f"18f streamed Q1 [{label}]: batches={planned} "
                  f"cap_bytes={cap} donated_launches="
                  f"{out[label]['launches']} donated_tasks="
                  f"{out[label]['tasks']} donated_bytes_priced="
                  f"{out[label]['priced']} peak_above_start_bytes={peak} "
                  f"wall_ms={wall_ms:.1f} exact=True")
    finally:
        client.__dict__.pop("_launch", None)
        sess.execute("set global tidb_tpu_device_mem_cap = 0")
    check(out["donated"]["launches"] == planned
          and out["donated again"]["launches"] == planned
          and out["undonated"]["launches"] == 0,
          f"18f: donated launches {out}")
    print(f"18f: peak_donated_bytes={out['donated']['peak']} "
          f"peak_undonated_bytes={out['undonated']['peak']} "
          f"peak_donated_again_bytes={out['donated again']['peak']} "
          f"s={time.perf_counter() - t0:.1f}")
    return driven


# --------------------------------------------------------------------- #
# phase 19: the coordination plane and the background workers
# --------------------------------------------------------------------- #

PD_B_SF = 0.1             # 19a's second Domain: its own SF=0.1 lineitem
PD_Q6_REPS = 20           # 19a's warm Q6 calls with pd off, then on
PD_GROUP = "pd19"         # 19a's limited resource group, in both Domains
PD_RU_BUDGET = 1_000_000  # its declared RU_PER_SEC, split by the plane
PD_VICTIM = "select sum(l_tax) from lineitem where l_quantity < 2"
PD_POISON_TRIES = 8       # poisoned runs of the victim, at most
PD_CLAIM_REPS = 200       # claim + release round trips timed
SERVE_PD_SF = 0.1         # 19b: each server process's lineitem, by LOAD DATA
SERVE_PD_SF_CUT = 0.01    # 19b's scale when the script is late (below)
SERVE_PD_LATE_S = 950.0   # the script's seconds at phase 19 past which 19b
                          # is cut: at SF=0.1 it takes ~105 s on the H100's
                          # host (two LOAD DATA of 600,000 rows ~57 s, two
                          # first Q6 ~21 s), and the script has 1200 s
SERVE_PD_LOAD_S = 300.0   # 19b: the wire client's timeout over LOAD DATA and a first Q6
PD_WIRE_S = 2.0           # 19b: seconds of warm Q6 over the wire a leg (pd on/off/on)
SERVE_PD_COLS = ("l_quantity", "l_extendedprice", "l_discount",
                 "l_shipdate")
TTL_ROWS = 20_000         # 19c's TTL table
TTL_DAYS = 2              # its TTL: created + INTERVAL 2 DAY
TTL_THREADS = 4           # 19c's Q6 senders during the auto-analyze
TIMER_FIRST_S = 60.0      # 19c: the timers' first round, at most


def late_sf(tag: str, full: float, cut: float, late_s: float) -> float:
    """``full``, or ``cut`` (printed) when the script reaches sub-phase
    ``tag`` past ``late_s`` seconds."""
    late = time.perf_counter() - T_START
    if late <= late_s:
        return full
    print(f"{tag} cut to sf={cut}: the script at {late:.1f} s, past "
          f"{late_s:.1f} s")
    return cut


def _pd_status(port: int) -> dict:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/pd",
                                timeout=30) as r:
        return json.load(r)


def pd_two_domains(gr, main_sess, main_data, main_res) -> int:
    """Phase 19a: ``main_sess``'s Domain (A) and a second Domain (B)
    over the SF=0.1 lineitem on the same card, joined on the in-process
    pd backend.  Returns the group_reduce launches of its Q1 and Q6
    statements on both Domains, counted around those calls alone (not
    B's ANALYZE, nor the breaker's victim)."""
    import os
    import shutil
    import tempfile

    from tidb_tpu_torch import faults, pd
    from tidb_tpu_torch.analysis.calibrate import CorrectionStore
    from tidb_tpu_torch.analysis.compilekey import stable_digest
    from tidb_tpu_torch.compilecache import compile_cache
    from tidb_tpu_torch.compilecache.cache import CompileCache
    from tidb_tpu_torch.compilecache.manifest import WarmManifest
    from tidb_tpu_torch.server.status import StatusServer
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.testing import tpch
    t0 = time.perf_counter()
    steps, t_step = {}, [t0]

    def step(name):
        """The seconds since the last step, under ``name``."""
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    dom_a = main_sess.domain
    sa = Session(dom_a)
    b_data = tpch.gen_lineitem(PD_B_SF, seed=19, columns=Q_COLS)
    sb = tpch.sql_session({"lineitem": b_data},
                          device=dom_a.client.devices[0].type)
    dom_b = sb.domain
    ca, cb = dict(zip(*main_data)), dict(zip(*b_data))
    q1, q6 = tpch.SQL_QUERIES["Q1"], tpch.SQL_QUERIES["Q6"]
    launched = [0]       # group_reduce launches of the Q1 and Q6 calls

    def run(s, sql):
        """One Q1 or Q6 statement, its launches counted."""
        n0 = gr.LAUNCHES["group_reduce"]
        rs = s.execute(sql)
        launched[0] += gr.LAUNCHES["group_reduce"] - n0
        return rs

    for s in (sa, sb):
        s.execute("set global tidb_tpu_result_cache_entries = 0")
    # analyzed as A's is: the two Domains plan one statement to one DAG
    # (the proven-narrow SUMs included), so one digest names it in both
    sb.execute("analyze table lineitem")
    sql_check("Q6", run(sb, q6), cb, b_data[0], None)  # B's placement
    print(f"19a B: lineitem sf={PD_B_SF} rows={len(b_data[1][0])} placed "
          f"and analyzed s={time.perf_counter() - t0:.1f}")
    step("b")

    want_a = main_q6(main_res)

    def q6_median():
        walls, got = [], []
        n0 = launched[0]
        for _ in range(PD_Q6_REPS):
            t1 = time.perf_counter()
            rs = run(sa, q6)
            walls.append((time.perf_counter() - t1) * 1e3)
            got.append(_scaled(str(rs.rows[0][0]), 4))
        check(set(got) == {want_a}, f"19a Q6 {set(got)} != numpy {want_a}")
        return statistics.median(walls), launched[0] - n0

    run(sa, q6)
    off_ms, off_n = q6_median()
    step("off")
    for d in (dom_a, dom_b):
        d.resource_groups.create(PD_GROUP, PD_RU_BUDGET, if_not_exists=True)
    for s in (sa, sb):
        s.execute("set global tidb_tpu_pd = 1")
    run(sa, q6)           # A attaches first: the process-wide hooks (the
    run(sb, q6)           # breaker's tombstone, the claim) speak for A
    on_ms, on_n = q6_median()
    check(on_n == off_n > 0, f"19a Q6 launches pd on {on_n} != off {off_n}")
    step("on")
    coord_a, coord_b = dom_a.pd, dom_b.pd
    check(coord_a is not None and coord_b is not None
          and coord_a.store.backend is coord_b.store.backend,
          "19a: the Domains are not on one in-process backend")
    for c in (coord_a, coord_b, coord_a):
        c.tick(force=True)
    srv = StatusServer(dom_a)
    port = srv.start()
    try:
        body = _pd_status(port)
    finally:
        srv.close()
    leases = body["status"]["store"]["leases"]
    shares = {c.member.member_id: c.quota.shares.get(PD_GROUP, 0.0)
              for c in (coord_a, coord_b)}
    check(len(body["status"]["members"]) == 2 and len(leases) == 2
          and set(leases) == set(shares),
          f"19a /pd: members {body['status']['members']} leases {leases}")
    check(abs(sum(shares.values()) - PD_RU_BUDGET) <= 1e-6 * PD_RU_BUDGET,
          f"19a quota shares {shares} do not sum to {PD_RU_BUDGET}")
    print(f"19a /pd: members={len(body['status']['members'])} "
          f"leases={sorted(leases)} shares={shares} "
          f"budget={PD_RU_BUDGET}")
    step("pd")

    # a correction A learned from its warm Q1 launches reaches B, whose
    # coordinator merges into a store of its own (as a second process's)
    with task_spy() as spy:
        for _ in range(3):
            sql_check("Q1", run(sa, q1), ca, main_data[0], None)
    q1_digest = stable_digest(spy.tasks[0].dag)
    calib_b = CorrectionStore()
    coord_b._calib = calib_b
    coord_a.tick(force=True)
    coord_b.tick(force=True)
    shared = coord_a.store.get("calib")[0] or {}
    pub, got = shared.get(q1_digest), calib_b.get(q1_digest)
    check(pub is not None and pub.get("samples", 0) > 0 and got is not None
          and abs(got.time_factor - pub["time_factor"]) <= 1e-9,
          f"19a: Q1's correction {pub} did not reach B ({got})")
    print(f"19a calibration: Q1 digest={q1_digest[:16]} "
          f"samples={pub['samples']} time_factor A={pub['time_factor']} "
          f"B={got.time_factor} b_merged={coord_b.calib_merged}")
    step("calib")

    # a breaker tripped in A leaves a tombstone that purges B's entry.
    # B's coordinator keeps a program cache of its own (as a second
    # process's), over the directory B's victim was recorded in; A's
    # statements record into another, which A's breaker purges itself
    t1 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase19_cc_")
    dir_a, dir_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    cache = compile_cache()
    old_dir = cache.cache_dir

    def cache_dir(path):
        for s in (sa, sb):
            s.execute(f"set global tidb_tpu_compile_cache_dir = '{path}'")

    try:
        cache_dir(dir_b)
        with task_spy() as spy:
            sb.execute(PD_VICTIM)                  # B's program, recorded
        victim = stable_digest(spy.tasks[0].dag)
        cache_b = CompileCache()
        cache_b.configure(cache_dir=dir_b)
        man = cache_b.manifest
        check(man is not None and man.has_program(victim),
              "19a: the victim's program is not in B's manifest")
        coord_b._cache = cache_b
        cache_dir(dir_a)
        faults.install(faults.FaultPlan.parse("launch:poison"))
        tries = answered = 0
        try:
            while tries < PD_POISON_TRIES and \
                    not coord_a.store.read_prefix("quarantine/"):
                tries += 1
                try:
                    sa.execute(PD_VICTIM)
                    answered += 1
                except Exception:   # noqa: BLE001 - poisoned, as it must
                    pass
        finally:
            faults.clear()
        check(answered == 0, f"19a: {answered} poisoned launches answered")
        tombs = coord_a.store.read_prefix("quarantine/")
        check(list(tombs) == ["quarantine/" + victim],
              f"19a: tombstones {list(tombs)}, want the victim {victim}")
        kept = man.has_program(victim)
        check(kept, "19a: B's entry went before B read the tombstone")
        coord_b.tick(force=True)
        check(coord_b.registry.quarantine_purged == 1
              and not man.has_program(victim)
              and not WarmManifest(dir_b).has_program(victim),
              "19a: B did not purge the victim's manifest entry")
        print(f"19a breaker: victim={victim[:16]} poisoned_runs={tries} "
              f"tombstone_by={tombs['quarantine/' + victim][0]['by']} "
              f"b_entry_after_trip={kept} "
              f"b_purged={coord_b.registry.quarantine_purged} "
              f"b_entry_after_tick={man.has_program(victim)} "
              f"s={time.perf_counter() - t1:.1f}")
    finally:
        coord_b._cache = None
        cache_dir("")
        cache.configure(cache_dir=old_dir)
        shutil.rmtree(tmp, ignore_errors=True)
    step("breaker")

    # what a build claim costs a statement that misses (a warm one
    # resolves from the pool and claims nothing)
    hx = "19" * 16
    ns = []
    for _ in range(PD_CLAIM_REPS):
        t1 = time.perf_counter_ns()
        pd.try_compile_claim(hx)
        pd.release_compile_claim(hx)
        ns.append(time.perf_counter_ns() - t1)
    claim_us = statistics.median(ns) / 1e3
    step("claim")
    for name, s, c, names in (("A", sa, ca, main_data[0]),
                              ("B", sb, cb, b_data[0])):
        sql_check("Q1", run(s, q1), c, names, None)
        got = _scaled(str(run(s, q6).rows[0][0]), 4)
        check(got == (want_a if name == "A" else
                      q6_params_oracle(c, SERVER_Q6_PARAMS[0])),
              f"19a {name} Q6: {got}")
        print(f"19a {name}: Q1, Q6 exact")
    for s in (sa, sb):
        s.execute("set global tidb_tpu_pd = 0")
    for d in (dom_a, dom_b):
        pd.configure_domain(d, False)
    step("exact")
    print("19a steps: " + " ".join(f"{k}_s={v:.2f}" for k, v in steps.items()))
    print(f"19a Q6 warm median of {PD_Q6_REPS}: pd_off_ms={off_ms:.3f} "
          f"pd_on_ms={on_ms:.3f} launches_off={off_n} launches_on={on_n} "
          f"claim_release_us={claim_us:.1f} q1_q6_group_reduce_launches="
          f"{launched[0]} s={time.perf_counter() - t0:.1f}")
    return launched[0]


def pd_two_servers(dev_type: str, sf: float) -> None:
    """Phase 19b: two ``python -m tidb_tpu_torch serve`` processes on the
    card with one ``tidb_tpu_pd_dir``, each over its own SF lineitem by
    LOAD DATA; Q6 over the wire, the warm Q6 with pd on, off and on
    again over the file backend, ``/pd``, one killed, the lease loss."""
    import os
    import re
    import signal
    import tempfile
    import threading

    from tidb_tpu_torch.pd import PD_SYNC_S
    from tidb_tpu_torch.pd.store import PD_LEASE_TTL_S
    from tidb_tpu_torch.server.client import Client
    from tidb_tpu_torch.testing import tpch
    t0 = time.perf_counter()
    names, cols = tpch.gen_lineitem(sf, seed=192,
                                    columns=list(SERVE_PD_COLS))
    c = dict(zip(names, cols))
    want = q6_params_oracle(c, SERVER_Q6_PARAMS[0])
    q6 = tpch.SQL_QUERIES["Q6"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory(prefix="phase19b_") as tmp:
        src = os.path.join(tmp, "lineitem.csv")
        qty, price, disc = (c[n].data.tolist() for n in SERVE_PD_COLS[:3])
        ship = (np.datetime64("1970-01-01") + c["l_shipdate"].data.astype(
            "timedelta64[D]")).astype(str).tolist()
        with open(src, "w") as f:
            for q, p, d, s in zip(qty, price, disc, ship):
                f.write(f"{q // 100}.{q % 100:02d},{p // 100}.{p % 100:02d},"
                        f"{d // 100}.{d % 100:02d},{s}\n")
        cfg = os.path.join(tmp, "pd.toml")
        with open(cfg, "w") as f:
            f.write(f'[variables]\ntidb_tpu_pd = 1\n'
                    f'tidb_tpu_pd_dir = "{os.path.join(tmp, "pd")}"\n')
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tidb_tpu_torch", "serve", "--device",
             dev_type, "--port", "0", "--status-port", "0", "--config",
             cfg], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env) for _ in range(2)]
        try:
            ports = []
            for p in procs:
                line = p.stdout.readline()
                m = re.search(r"listening on [\d.]+:(\d+) \(status :(\d+)\)",
                              line)
                check(m is not None, f"19b serve: {line!r}")
                ports.append((int(m.group(1)), int(m.group(2))))
            start_s = time.perf_counter() - t0
            clients = [Client("127.0.0.1", port) for port, _s in ports]
            for cl in clients:
                cl.sock.settimeout(SERVE_PD_LOAD_S)

            def both(fn):
                """``fn(0)`` and ``fn(1)`` at once, one thread a server;
                the seconds of each."""
                secs, errs = [0.0, 0.0], []

                def one(i):
                    t1 = time.perf_counter()
                    try:
                        fn(i)
                    except Exception as e:   # noqa: BLE001 - failed below
                        errs.append(f"server {i}: {e!r}")
                    secs[i] = time.perf_counter() - t1
                ths = [threading.Thread(target=one, args=(i,))
                       for i in (0, 1)]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join()
                check(not errs, f"19b: {errs}")
                return secs

            def load(i):
                clients[i].execute(
                    "create table lineitem (l_quantity decimal(15,2), "
                    "l_extendedprice decimal(15,2), l_discount "
                    "decimal(15,2), l_shipdate date)")
                clients[i].execute(f"load data infile '{src}' into table "
                                   "lineitem fields terminated by ','")

            def first_q6(i):
                got = clients[i].query(q6)[0][0]
                check(_scaled(got, 4) == want,
                      f"19b Q6 over the wire {got} != numpy {want}")
            load_s = both(load)
            firsts = [x * 1e3 for x in both(first_q6)]
            # what the file backend costs a warm statement: server 0's
            # Q6 with pd on, off, on; a statement due a tick (every
            # PD_SYNC_S) pays the quota sync, the calibration merge, the
            # manifest gossip and the tombstone read on its own thread
            legs = {}
            for leg, on in (("on", 1), ("off", 0), ("on_again", 1)):
                clients[0].execute(f"set global tidb_tpu_pd = {on}")
                clients[0].query(q6)     # attaches or detaches, untimed
                sync0 = _pd_status(ports[0][1])["this_domain"].get(
                    "sync_total", 0)
                walls, t_leg = [], time.perf_counter()
                while time.perf_counter() - t_leg < PD_WIRE_S:
                    t1 = time.perf_counter()
                    got = clients[0].query(q6)[0][0]
                    walls.append((time.perf_counter() - t1) * 1e3)
                    check(_scaled(got, 4) == want, f"19b Q6 pd {leg}: {got}")
                legs[leg] = (walls, _pd_status(ports[0][1])["this_domain"].get(
                    "sync_total", 0) - sync0)
            check(legs["off"][1] == 0 and legs["on"][1] > 0
                  and legs["on_again"][1] > 0,
                  f"19b ticks a leg: {[(k, v[1]) for k, v in legs.items()]}")
            # a warm Q6 on each renews its lease (a first Q6 columnarizes
            # the rows and may outlast the other's lease), then /pd
            for cl in clients:
                check(_scaled(cl.query(q6)[0][0], 4) == want,
                      "19b warm Q6 over the wire")
            bodies = [_pd_status(sport) for _p, sport in ports]
            ids = [b["this_domain"]["member"]["member_id"] for b in bodies]
            for b in bodies:
                live = {m for m, lease in b["status"]["store"]["leases"].items()
                        if lease["ttl_left_s"] > 0}
                check(live == set(ids), f"19b /pd leases {live} != {ids}")
            procs[1].kill()
            procs[1].wait()
            t_kill = time.perf_counter()
            lost_s, answered = None, 0
            while time.perf_counter() - t_kill < PD_LEASE_TTL_S + 5.0:
                got = clients[0].query(q6)[0][0]
                check(_scaled(got, 4) == want,
                      f"19b survivor Q6 {got} != numpy {want}")
                answered += 1
                lease = _pd_status(ports[0][1])["status"]["store"][
                    "leases"].get(ids[1])
                if lease is None or lease["ttl_left_s"] <= 0:
                    lost_s = time.perf_counter() - t_kill
                    break
                time.sleep(0.05)
            check(lost_s is not None and lost_s <= PD_LEASE_TTL_S + PD_SYNC_S,
                  f"19b: the killed server's lease lost after {lost_s} s")
            got = clients[0].query(q6)[0][0]
            check(_scaled(got, 4) == want, "19b survivor after the loss")
            for cl in clients:
                cl.close()
            procs[0].send_signal(signal.SIGINT)
            procs[0].communicate(timeout=SERVER_STOP_S)
            check(procs[0].returncode == 0,
                  f"19b serve exit code {procs[0].returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for leg, (walls, syncs) in legs.items():
        print(f"19b warm Q6 over the wire pd_{leg}: reps={len(walls)} "
              f"median_ms={statistics.median(walls):.3f} "
              f"mean_ms={statistics.fmean(walls):.3f} "
              f"max_ms={max(walls):.3f} ticks={syncs}")
    print(f"19b two servers: sf={sf} rows={len(qty)} start_s={start_s:.2f} "
          f"load_s={load_s[0]:.2f},{load_s[1]:.2f} q6_first_ms="
          f"{firsts[0]:.1f},{firsts[1]:.1f} members={len(ids)} "
          f"lease_lost_s={lost_s:.3f} (ttl {PD_LEASE_TTL_S}) "
          f"survivor_q6_exact={answered + 1} s={time.perf_counter() - t0:.1f}")


def background_workers(gr, os1, main_sess, main_data, main_res) -> None:
    """Phase 19c: the background workers on ``main_sess``'s Domain: the
    TTL sweep, the auto-analyze timer under four Q6 senders, a DXF
    analyze task over two tables, and ADMIN RECOMMEND INDEX."""
    import threading

    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.testing import tpch
    t0 = time.perf_counter()
    dom = main_sess.domain
    sess = Session(dom)
    c = dict(zip(*main_data))
    q6 = tpch.SQL_QUERIES["Q6"]
    counters = (gr.LAUNCHES, os1.LAUNCHES)
    reset(counters)
    timers = dom.start_background()
    deadline = time.perf_counter() + TIMER_FIRST_S
    while time.perf_counter() < deadline and \
            not all(t.fire_count for t in timers.timers()):
        time.sleep(0.05)
    check(all(t.fire_count and not t.last_error for t in timers.timers()),
          "19c: the first round of timers: " + ", ".join(
              f"{t.name}:{t.fire_count}:{t.last_error}"
              for t in timers.timers()))
    first_s = time.perf_counter() - t0

    # TTL: a 20,000-row table, its DATETIME column spread over 4 days
    rng = np.random.default_rng(193)
    now = time.time()
    age = rng.integers(0, 2 * TTL_DAYS * 86400, TTL_ROWS)
    age[np.abs(age - TTL_DAYS * 86400) < 60] += 120   # none at the cutoff
    price = rng.integers(1, 10_000, TTL_ROWS)
    sess.execute("create table ttl19 (id bigint, price bigint, "
                 f"created datetime) TTL = created + INTERVAL {TTL_DAYS} DAY")
    stamps = [time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(int(now - a)))
              for a in age]
    sess.execute("insert into ttl19 values " + ",".join(
        f"({i}, {p}, '{s}')" for i, (p, s) in enumerate(zip(price.tolist(),
                                                           stamps))))
    keep = age < TTL_DAYS * 86400
    before = sess.execute("select count(*) from ttl19").rows[0][0]
    t1 = time.perf_counter()
    timers.trigger("ttl")
    ttl_ms = (time.perf_counter() - t1) * 1e3
    got = sess.execute("select count(*), sum(price) from ttl19").rows
    check(before == TTL_ROWS
          and got == [(int(keep.sum()), exact_sum(price[keep]))],
          f"19c TTL: {got}, want numpy {int(keep.sum())} rows")
    print(f"19c ttl: rows={TTL_ROWS} deleted={TTL_ROWS - int(keep.sum())} "
          f"kept={int(keep.sum())} sweep_ms={ttl_ms:.1f} "
          f"aggregate_exact=True")

    # auto-analyze under four Q6 senders: lineitem's statistics dropped,
    # the timer's sweep rebuilds them while Q6 runs
    tbl = dom.catalog.get_table("test", "lineitem")
    old = dom.stats.get(tbl)
    check(old is not None, "19c: lineitem has no statistics from 13c")
    dom.stats._cache.pop(dom.stats._key(tbl))
    want_q6 = main_q6(main_res)
    errors, sent, done = [], [0], threading.Event()

    def sender():
        s = Session(dom)
        # only the timer analyzes: the senders' own inline auto-analyze
        # and stats load stay off in their sessions
        s.execute("set tidb_enable_auto_analyze = 0")
        while not done.is_set():
            try:
                got = s.execute(q6).rows[0][0]
                if _scaled(str(got), 4) != want_q6:
                    errors.append(got)
                sent[0] += 1
            except Exception as e:   # noqa: BLE001 - failed below
                errors.append(repr(e))
    ths = [threading.Thread(target=sender) for _ in range(TTL_THREADS)]
    for th in ths:
        th.start()
    t1 = time.perf_counter()
    try:
        # the timer's sweep follows the Domain's sysvar (off by default)
        sess.execute("set global tidb_enable_auto_analyze = 1")
        timers.trigger("auto-analyze")
    finally:
        analyze_ms = (time.perf_counter() - t1) * 1e3
        sess.execute("set global tidb_enable_auto_analyze = 0")
        done.set()
        for th in ths:
            th.join()
    auto = [t for t in timers.timers() if t.name == "auto-analyze"][0]
    check(not errors and not auto.last_error,
          f"19c auto-analyze under load: {errors[:3]} {auto.last_error}")
    new = dom.stats.get(tbl)
    check(new is not None and stats_same(new, old),
          "19c: auto-analyze's lineitem statistics differ from 13c's")
    print(f"19c auto-analyze: under {TTL_THREADS} Q6 senders, "
          f"analyze_ms={analyze_ms:.1f} q6_calls={sent[0]} exact=True "
          f"stats_equal_13c=True")

    # a DXF analyze task over two tables, then information_schema
    m = dom.dxf
    t1 = time.perf_counter()
    task = m.run(m.submit("analyze", {"db": "test",
                                      "tables": ["lineitem", "ttl19"]}))
    dxf_ms = (time.perf_counter() - t1) * 1e3
    rows = sess.execute("select task_id, type, state, subtasks_done, "
                        "subtasks_total from information_schema.dist_tasks"
                        ).rows
    check(task.state == "succeed"
          and (task.task_id, "analyze", "succeed", 2, 2) in rows
          and stats_same(dom.stats.get(tbl), old),
          f"19c DXF analyze: {task.state} {task.error} {rows}")
    print(f"19c dxf: task={task.task_id} state={task.state} subtasks=2 "
          f"ms={dxf_ms:.1f} dist_tasks={rows}")

    # ADMIN RECOMMEND INDEX after a point-lookup workload
    for i in range(5):
        rs = sess.execute(f"select price from ttl19 where id = {int(i)}")
        check(rs.rows == ([(int(price[i]),)] if keep[i] else []),
              f"19c point lookup id={i}: {rs.rows}")
    rec = sess.execute("admin recommend index").rows
    check(any(r[0] == "ttl19" and r[1] == "id" and r[2] >= 5 for r in rec),
          f"19c ADMIN RECOMMEND INDEX: {rec}")
    print(f"19c recommend index: {[r[:3] for r in rec]}")
    dom.close()
    check(not timers._thread.is_alive(), "19c: the timer thread lives on")
    launches = {"radix_hist_all64": os1.LAUNCHES["radix_hist_all64"],
                "radix_onesweep64": os1.LAUNCHES["radix_onesweep64"],
                "group_reduce": gr.LAUNCHES["group_reduce"]}
    check(all(launches.values()), f"19c: a kernel never launched "
          f"{launches}")
    print(f"19c launches: {' '.join(f'{k}={v}' for k, v in launches.items())}"
          f" first_timer_round_s={first_s:.1f}"
          f" s={time.perf_counter() - t0:.1f}")


def stats_same(got, want) -> bool:
    """Two TableStats of one table hold the same column statistics."""
    if (got.count, sorted(got.cols)) != (want.count, sorted(want.cols)):
        return False
    for name, w in want.cols.items():
        g = got.cols[name]
        if (g.ndv, g.null_count, g.count) != (w.ndv, w.null_count, w.count):
            return False
        if not (np.array_equal(g.hist.bounds, w.hist.bounds)
                and np.array_equal(g.hist.cum_counts, w.hist.cum_counts)
                and list(g.topn.values.items()) == list(w.topn.values.items())
                and np.array_equal(g.cms.table, w.cms.table)):
            return False
    return True


def pd_phase(gr, os1, main_sess, main_data, main_res) -> int:
    """Phase 19 (see the module docstring): returns the group_reduce
    launches of 19a's Q1 and Q6."""
    launched = pd_two_domains(gr, main_sess, main_data, main_res)
    sf = late_sf("19b", SERVE_PD_SF, SERVE_PD_SF_CUT, SERVE_PD_LATE_S)
    pd_two_servers(main_sess.domain.client.devices[0].type, sf)
    background_workers(gr, os1, main_sess, main_data, main_res)
    return launched


# -- phase 20: the ecosystem tools and the cascades planner ------------- #

TOOLS_DEVICE = "cuda"
TOOLS_SF = 0.1            # 20a's eight TPC-H tables: lineitem 600,000 rows
TOOLS_SF_CUT = 0.01       # their scale when the script is late (below)
TOOLS_FULL_S = 210.0      # phase 20 at TOOLS_SF alone on the H100's host:
#                           195.8 and 210.3 s in two runs (PERF.md section 4)
TOOLS_FAST_AT = 835.0     # a fast host's seconds at phase 20: phases 1-18
#                           took 703.3 s, phase 19 at full scale 131.5 s
TOOLS_END_S = 1100.0      # phase 20 ends by then (the script's limit 1200 s)
# A host's pace is its seconds at phase 20 over TOOLS_FAST_AT (at least 1).
# At TOOLS_SF, TOOLS_FULL_S times that pace, phase 20 would end past
# TOOLS_END_S when the script reaches it past this many seconds:
TOOLS_LATE_S = TOOLS_END_S / (1 + TOOLS_FULL_S / TOOLS_FAST_AT)
TOOLS_THREADS = 4         # import_csv's and dump_database's pools
TOOLS_EXTRA_SHARE = 60    # 20a's further chunk: 1/this of lineitem's rows
TOOLS_GS_BYTES = 40 << 20   # 20a's global-sort memory budget at SF=1, by SF
TOOLS_CASCADES = (3, 5, 10, 12)   # 20d's TPC-H statements
TOOLS_CASCADES_TABLES = ("lineitem", "orders", "customer", "supplier",
                         "nation", "region")   # the tables they read
TOOLS_WARM = 2            # 20d's warm rounds of both legs, order alternating
TOOLS_ORDERS_AGG = ("select o_orderstatus, count(*), sum(o_orderkey), "
                    "sum(o_custkey), sum(o_totalprice), min(o_orderdate), "
                    "max(o_orderdate), sum(o_shippriority) from orders "
                    "group by o_orderstatus order by o_orderstatus")


def write_csv(path: str, names: list, cols: list) -> int:
    """``cols`` as a CSV file with a header line, the text LOAD DATA
    reads (``tpch._as_text``: ``\\N`` for NULL, ISO dates, doubles by
    ``repr``); returns the rows."""
    import csv
    from tidb_tpu_torch.testing import tpch
    texts = [tpch._as_text(c) for c in cols]
    with open(path, "w", newline="") as f:
        f.write(",".join(names) + "\n")
        w = csv.writer(f)
        for lo in range(0, len(texts[0]), 65536):
            w.writerows(zip(*[t[lo:lo + 65536] for t in texts]))
    return len(texts[0])


def dir_bytes(path: str) -> int:
    import os
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def tools_launches(tag: str, counters, need) -> dict:
    """The launches of the sub-phase since the counters' reset, printed;
    each kernel of ``need`` must have launched."""
    launched = {k: launches[k] for launches in counters for k in GR + OS
                if k in launches}
    check(all(launched[k] > 0 for k in need),
          f"{tag}: a kernel of its path never launched {launched}")
    print(f"{tag} launches: "
          + " ".join(f"{k}={v}" for k, v in launched.items()))
    return launched


def tools_phase(gr, os1) -> int:
    """Phase 20 (see the module docstring): returns the group_reduce
    launches of 20a-20d."""
    import tempfile

    from tidb_tpu_torch.chunk.column import Column
    from tidb_tpu_torch.planner.cascades import search as search_mod
    from tidb_tpu_torch.session import Domain, Session
    from tidb_tpu_torch.testing import tpch
    from tidb_tpu_torch.tools import br, dump, external_sort, lightning

    sf = late_sf("20", TOOLS_SF, TOOLS_SF_CUT, TOOLS_LATE_S)
    counters = (gr.LAUNCHES, os1.LAUNCHES)
    group_reduce = 0
    with tempfile.TemporaryDirectory(prefix="tidb_tools_") as tmp:
        # -- 20a: the direct and the global-sort imports --------------- #
        t0 = time.perf_counter()
        data = tpch.gen_tpch(sf, seed=0)
        rows = {t: write_csv(f"{tmp}/{t}.csv", names, cols)
                for t, (names, cols) in data.items()}
        li_names, li_cols = data["lineitem"]
        n_extra = rows["lineitem"] // TOOLS_EXTRA_SHARE
        write_csv(f"{tmp}/extra.csv", li_names,
                  [c.slice(0, n_extra) for c in li_cols])
        print(f"20a data: sf={sf} " + " ".join(
            f"{t}={n}" for t, n in rows.items())
            + f" extra={n_extra} gen_write_s={time.perf_counter() - t0:.2f}")
        dom = Domain(TOOLS_DEVICE)
        sess = Session(dom)
        reset(counters)
        sess.execute("create database tpch")
        sess.execute("use tpch")
        for t in data:
            sess.execute(f"create table {t} {tpch.TPCH_TABLE_DDL[t]}")
            t0 = time.perf_counter()
            n = lightning.import_csv(dom, "tpch", t, f"{tmp}/{t}.csv",
                                     threads=TOOLS_THREADS)
            s_ = time.perf_counter() - t0
            check(n == rows[t], f"20a import {t}: {n} rows of {rows[t]}")
            print(f"20a import_csv {t}: rows={n} s={s_:.3f} "
                  f"rows_per_s={n / s_:.0f} threads={TOOLS_THREADS}")
        sess.execute("create database tools_gs")
        sess.execute(f"create table tools_gs.orders "
                     f"{tpch.TPCH_TABLE_DDL['orders']}")
        runs = [0]
        close = external_sort.RunWriter.close

        def counted_close(self):
            runs[0] += 1
            close(self)
        budget = int(TOOLS_GS_BYTES * sf)
        external_sort.RunWriter.close = counted_close
        try:
            t0 = time.perf_counter()
            n = lightning.global_sort_import(
                dom, "tools_gs", "orders", f"{tmp}/orders.csv",
                f"{tmp}/runs", mem_budget_bytes=budget)
            s_ = time.perf_counter() - t0
        finally:
            external_sort.RunWriter.close = close
        check(n == rows["orders"] and runs[0] >= 2,
              f"20a global_sort_import: {n} rows, {runs[0]} runs")
        print(f"20a global_sort_import orders: rows={n} s={s_:.3f} "
              f"rows_per_s={n / s_:.0f} runs={runs[0]} "
              f"mem_budget_bytes={budget}")
        o_names, o_cols = data["orders"]
        li, od = store_oracle_data(li_cols, li_names, o_cols, o_names)
        answers = {}
        for name in ("Q1", "Q6"):
            t0 = time.perf_counter()
            rs = sess.execute(tpch.SQL_QUERIES[name])
            first = time.perf_counter() - t0
            store_check(name, rs.rows, li, od)
            t0 = time.perf_counter()
            answers[name] = sess.execute(tpch.SQL_QUERIES[name]).rows
            check(answers[name] == rs.rows, f"20a {name}: warm != first")
            print(f"20a {name}: first_ms={first * 1e3:.3f} warm_ms="
                  f"{(time.perf_counter() - t0) * 1e3:.3f} exact=True")
        gs = Session(dom, db="tools_gs").execute(TOOLS_ORDERS_AGG).rows
        check(tpch_rows_equal(gs, sess.execute(TOOLS_ORDERS_AGG).rows),
              f"20a: the global-sort orders differ from import_csv's {gs}")
        # a further chunk into the non-empty lineitem, the result cache on
        client = dom.client
        sess.execute("set global tidb_tpu_result_cache_entries = 64")
        sess.execute(tpch.TPCH_Q6)
        hits = client.result_cache_hits
        check(sess.execute(tpch.TPCH_Q6).rows == answers["Q6"]
              and client.result_cache_hits == hits + 1,
              "20a: the result cache did not answer the warm Q6")
        t0 = time.perf_counter()
        n = lightning.import_csv(dom, "tpch", "lineitem", f"{tmp}/extra.csv",
                                 threads=TOOLS_THREADS)
        s_ = time.perf_counter() - t0
        li_cols = [Column.concat([c, c.slice(0, n_extra)]) for c in li_cols]
        data["lineitem"] = (li_names, li_cols)
        li, _od = store_oracle_data(li_cols, li_names, o_cols, o_names)
        hits = client.result_cache_hits
        old = answers["Q6"]
        t0 = time.perf_counter()
        q6 = sess.execute(tpch.TPCH_Q6).rows
        q6_ms = (time.perf_counter() - t0) * 1e3
        store_check("Q6", q6, li, od)
        check(n == n_extra and q6 != answers["Q6"]
              and client.result_cache_hits == hits,
              f"20a: Q6 after the import {q6}, before {answers['Q6']}")
        answers["Q6"] = q6
        answers["Q1"] = sess.execute(tpch.TPCH_Q1).rows
        store_check("Q1", answers["Q1"], li, od)
        print(f"20a import into non-empty lineitem: rows={n} s={s_:.3f} "
              f"q6_before={old[0][0]} q6_after={q6[0][0]} "
              f"q6_after_first_ms={q6_ms:.3f} result_cache_hit=False "
              "exact=True")
        group_reduce += tools_launches("20a", counters, GR)["group_reduce"]

        # -- 20b: BR backup, restore and PITR, the result cache on ------ #
        reset(counters)
        bk = f"{tmp}/backup"
        t0 = time.perf_counter()
        counts = br.backup(dom, "tpch", bk)
        s_b = time.perf_counter() - t0
        mb = dir_bytes(bk) / 1e6
        t0 = time.perf_counter()
        restored = br.restore(dom, bk, db="tpch_r")
        s_r = time.perf_counter() - t0
        check(restored == counts, f"20b restore: {restored} != {counts}")
        print(f"20b backup: pairs={sum(counts.values())} mb={mb:.1f} "
              f"s={s_b:.3f} mb_per_s={mb / s_b:.1f}")
        print(f"20b restore: pairs={sum(restored.values())} s={s_r:.3f} "
              f"mb_per_s={mb / s_r:.1f}")
        rsess = Session(dom, db="tpch_r")
        first = {}
        for name in ("Q1", "Q6"):
            t0 = time.perf_counter()
            got = rsess.execute(tpch.SQL_QUERIES[name]).rows
            first[name] = (time.perf_counter() - t0) * 1e3
            check(got == answers[name],
                  f"20b {name} on the restored tables: {got[:2]}")
        print(f"20b Q1 Q6 on the restored tables: first_ms Q1="
              f"{first['Q1']:.3f} Q6={first['Q6']:.3f} equal_20a=True")
        gsess = Session(dom, db="tools_gs")
        pitr = f"{tmp}/pitr"
        t0 = time.perf_counter()
        br.log_backup_start(dom, "tools_gs", pitr)
        base_ts = json.load(open(f"{pitr}/{br.STREAM_FILE}"))["last_ts"]
        base = gsess.execute(TOOLS_ORDERS_AGG).rows
        gsess.execute("update orders set o_totalprice = o_totalprice + 1, "
                      "o_shippriority = 1 where o_orderkey % 7 = 0")
        gsess.execute("delete from orders where o_orderkey % 11 = 0")
        gsess.execute("insert into orders values "
                      "(-1, 1, 'X', 10.5, '1999-01-01', '1-URGENT', 'c', 0, "
                      "'pitr'), (-2, 2, 'X', 20.25, '1999-01-02', '5-LOW', "
                      "'c', 0, null)")
        n_changed = br.log_backup_tick(dom, pitr)
        tick_ts = json.load(open(f"{pitr}/{br.STREAM_FILE}"))["last_ts"]
        s_l = time.perf_counter() - t0
        now = gsess.execute(TOOLS_ORDERS_AGG).rows
        t0 = time.perf_counter()
        br.restore_pitr(dom, pitr, restore_ts=tick_ts, db="pitr_tick")
        br.restore_pitr(dom, pitr, restore_ts=base_ts, db="pitr_base")
        s_p = time.perf_counter() - t0
        at_tick = Session(dom, db="pitr_tick").execute(TOOLS_ORDERS_AGG).rows
        at_base = Session(dom, db="pitr_base").execute(TOOLS_ORDERS_AGG).rows
        check(n_changed > 0 and now != base and tpch_rows_equal(at_tick, now)
              and tpch_rows_equal(at_base, base),
              f"20b PITR: tick {at_tick} vs {now}; base {at_base} vs {base}")
        n_now = sum(r[1] for r in now)
        print(f"20b pitr: orders={n_now} changed_keys={n_changed} "
              f"log_s={s_l:.3f} restore_pitr_s={s_p:.3f} (two restores) "
              "tick_equal_source=True base_equal_backup=True")
        # 20d's legs plan one statement two ways: each launches its own
        sess.execute("set global tidb_tpu_result_cache_entries = 0")
        group_reduce += tools_launches("20b", counters, GR)["group_reduce"]

        # -- 20c: Dumpling, and its CSV back through import_csv -------- #
        reset(counters)
        for fmt in ("sql", "csv"):
            out = f"{tmp}/dump_{fmt}"
            t0 = time.perf_counter()
            got = dump.dump_database(dom, "tools_gs", out, fmt=fmt,
                                     threads=TOOLS_THREADS)
            s_ = time.perf_counter() - t0
            check(got == {"orders": n_now},
                  f"20c dump {fmt}: {got}")
            print(f"20c dump {fmt}: rows={got['orders']} "
                  f"mb={dir_bytes(out) / 1e6:.1f} s={s_:.3f} "
                  f"rows_per_s={got['orders'] / s_:.0f}")
        n_stmts = open(f"{tmp}/dump_sql/tools_gs.orders.000000000.sql"
                       ).read().count("INSERT INTO `orders` VALUES")
        check(n_stmts == -(-n_now // 200),
              f"20c: {n_stmts} INSERT statements in the SQL dump")
        sess.execute("create database dumpcheck")
        sess.execute(f"create table dumpcheck.orders "
                     f"{tpch.TPCH_TABLE_DDL['orders']}")
        t0 = time.perf_counter()
        n = lightning.import_csv(
            dom, "dumpcheck", "orders",
            f"{tmp}/dump_csv/tools_gs.orders.000000000.csv",
            threads=TOOLS_THREADS)
        s_ = time.perf_counter() - t0
        back = Session(dom, db="dumpcheck").execute(TOOLS_ORDERS_AGG).rows
        check(tpch_rows_equal(back, now),
              f"20c: the re-imported dump {back} != the source {now}")
        print(f"20c csv dump re-imported: rows={n} s={s_:.3f} "
              "count_and_sums_equal=True")
        group_reduce += tools_launches("20c", counters, GR)["group_reduce"]

        # -- 20d: tidb_enable_cascades_planner against the heuristic ---- #
        # both planners cost from the statistics of the tables read
        t0 = time.perf_counter()
        for t in TOOLS_CASCADES_TABLES:
            sess.execute(f"analyze table {t}")
        print(f"20d analyze: tables={len(TOOLS_CASCADES_TABLES)} "
              f"s={time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        lite = tpch_sqlite({t: data[t] for t in TOOLS_CASCADES_TABLES})
        print(f"20d sqlite: load_s={time.perf_counter() - t0:.2f}")
        del data
        reset(counters)
        # the session's cascades leg must plan through search, not fall
        # back to the greedy reorder: its returns are counted
        search = search_mod.search
        searched = [0]

        def counted_search(plan, stats):
            out = search(plan, stats)
            searched[0] += 1
            return out
        search_mod.search = counted_search
        try:
            cascades_legs(sess, dom, lite, search, searched)
        finally:
            search_mod.search = search
        group_reduce += tools_launches("20d", counters, GR + OS)[
            "group_reduce"]
        dom.close()
    return group_reduce


def cascades_legs(sess, dom, lite, search, searched) -> None:
    """Phase 20d: each of ``TOOLS_CASCADES`` with the cascades planner
    off, then on (its plan a cache miss, planned through ``search``),
    equal to each other and to sqlite; then ``TOOLS_WARM`` warm rounds
    of both legs, the order alternating, for their walls; ``search``
    called directly on the statement's optimized plan."""
    from tidb_tpu_torch.planner.build import build_query
    from tidb_tpu_torch.planner.logical import explain_logical, walk_plan
    from tidb_tpu_torch.planner.optimize import optimize_plan
    from tidb_tpu_torch.sql.parser import parse_one
    from tidb_tpu_torch.testing import tpch
    for k in TOOLS_CASCADES:
        sql = tpch.TPCH_22[k]
        want = lite.execute(sql).fetchall()
        plan = optimize_plan(build_query(parse_one(sql), dom.catalog,
                                         "tpch").plan)
        t0 = time.perf_counter()
        chosen = search(plan, dom.stats)
        search_ms = (time.perf_counter() - t0) * 1e3
        methods = [getattr(n, "hint_method", "") or "hash"
                   for n in walk_plan(chosen)
                   if type(n).__name__ == "LogicalJoin"]
        plan_ms = {}
        for flag in (0, 1):
            sess.execute(f"set tidb_enable_cascades_planner = {flag}")
            before = searched[0]
            rows = sess.execute(sql).rows
            plan_ms[flag] = sess.timings["plan"] * 1e3
            check(searched[0] - before == flag,
                  f"20d Q{k}: {searched[0] - before} searches with "
                  f"the cascades planner {'on' if flag else 'off'}")
            check(tpch_rows_equal(rows, want),
                  f"20d Q{k} cascades={flag}: {rows[:3]}, sqlite "
                  f"{want[:3]}")
        walls = {0: [], 1: []}
        for r in range(TOOLS_WARM):
            for flag in ((1, 0) if r % 2 == 0 else (0, 1)):
                sess.execute(f"set tidb_enable_cascades_planner = {flag}")
                t0 = time.perf_counter()
                rows = sess.execute(sql).rows
                walls[flag].append(time.perf_counter() - t0)
                check(tpch_rows_equal(rows, want),
                      f"20d Q{k} warm, cascades={flag}: {rows[:3]}")
        explains = {}
        for flag in (0, 1):
            sess.execute(f"set tidb_enable_cascades_planner = {flag}")
            explains[flag] = [r[0] for r in sess.execute(
                "explain " + sql).rows]
        sess.execute("set tidb_enable_cascades_planner = 0")
        same = explains[0] == explains[1]
        top = explain_logical(chosen).splitlines()[0].strip()
        print(f"20d Q{k}: rows={len(want)} search_ms={search_ms:.3f} "
              f"joins={','.join(methods)} plan_ms heuristic="
              f"{plan_ms[0]:.3f} cascades={plan_ms[1]:.3f} warm_s "
              f"heuristic={' '.join(f'{w:.4f}' for w in walls[0])} "
              f"cascades={' '.join(f'{w:.4f}' for w in walls[1])} "
              f"same_plan={same} top={top} equal_sqlite=True")
        if not same:
            for flag in (0, 1):
                print(f"20d Q{k} plan, cascades={flag}: "
                      + " / ".join(ln.strip() for ln in explains[flag]))


# -- phase 21: resource control and the chaos stress harness ----------- #

RC_CALLS = 10             # 21a: warm Q6 calls in the limited group, and in default
RC_RATE_Q6 = 4            # 21a: the limited group's RU_PER_SEC, in Q6 prices
RC_BLOCK_S = 1.0          # 21a: the refill the limited calls must wait, at least
STRESS_ROWS = 60_000      # 21b: build_stress_domain's rows (the JAX rung's)
STRESS_SMOKE = 64         # 21b: the smoke's sessions, at STRESS_SMOKE_RATE
STRESS_SMOKE_RATE = 400.0
STRESS_SESSIONS = 1000    # 21b: the full rung's sessions, at STRESS_RATE
STRESS_RATE = 200.0       # arrivals/s, over the harness's four groups
STRESS_WAVES = (32, 16)   # 21c: the ledger's two waves of sessions
STRESS_FULL_S = 45.0      # phase 21 with the full rung on the H100's host:
#                           28.8 s alone with 21a at SF=1 (its rung 15.0 s;
#                           PERF.md section 6), 21a at SF=10 adds seconds
STRESS_FAST_AT = 1000.0   # a fast host's seconds at phase 21: 954-993 s
STRESS_END_S = 1150.0     # phase 21 ends by then (the script's limit 1200 s)
# Past this arrival, phase 21 at this host's pace (its seconds so far over
# STRESS_FAST_AT) would end after STRESS_END_S with the full rung: 21b then
# runs the smoke only, and says so
STRESS_LATE_S = STRESS_END_S / (1 + STRESS_FULL_S / STRESS_FAST_AT)


def group_debited(dom, name: str) -> float:
    return dom.resource_groups.get(name).bucket.debited


def resource_control(gr, main_sess, main_data, main_res) -> int:
    """Phase 21a: the resource-group statements and the statement's RU
    charge over 13a's Domain.  Returns the group_reduce launches of its
    Q1 and Q6 calls."""
    from tidb_tpu_torch.planner.build import PlanError
    from tidb_tpu_torch.rc.controller import DEFAULT_OVERDRAFT_RU
    from tidb_tpu_torch.rc.runaway import RunawayError
    from tidb_tpu_torch.server.status import StatusServer
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.testing import tpch
    t0 = time.perf_counter()
    dom = main_sess.domain
    s = Session(dom)
    c = dict(zip(*main_data))
    q1, q6 = tpch.SQL_QUERIES["Q1"], tpch.SQL_QUERIES["Q6"]
    want6 = main_q6(main_res)
    # every launch of 21a is one of its Q1 and Q6 calls'
    n0 = gr.LAUNCHES["group_reduce"]

    def run(sess, name):
        """Q1 or Q6 through ``sess``, checked against numpy."""
        rs = sess.execute(q1 if name == "Q1" else q6)
        if name == "Q1":
            sql_check("Q1", rs, c, main_data[0], None)
        else:
            got = _scaled(str(rs.rows[0][0]), 4)
            check(got == want6, f"21a Q6 {got} != numpy {want6}")
        return rs

    def in_group(group):
        sess = Session(dom)
        sess.execute(f"set resource group {group}")
        return sess

    def groups_row(name):
        return s.must_query(
            "select name, ru_per_sec, burstable, exec_elapsed_sec, "
            "runaway_action, priority from information_schema."
            f"resource_groups where name = '{name}'")

    # the statements against the memtable
    s.execute("create resource group rc21 RU_PER_SEC = 1000")
    s.execute("create resource group if not exists rc21 RU_PER_SEC = 5")
    check(groups_row("rc21") == [("rc21", 1000, "NO", None, "KILL",
                                  "MEDIUM")], f"21a create: "
          f"{groups_row('rc21')}")
    s.execute("alter resource group rc21 RU_PER_SEC = 2000 BURSTABLE "
              "PRIORITY = HIGH QUERY_LIMIT = (EXEC_ELAPSED = '60s' "
              "ACTION = COOLDOWN)")
    check(groups_row("rc21") == [("rc21", 2000, "YES", 60.0, "COOLDOWN",
                                  "HIGH")],
          f"21a alter: {groups_row('rc21')}")
    s.execute("drop resource group rc21")
    check(groups_row("rc21") == [], "21a drop: the group is still listed")
    for sql in ("drop resource group default", "drop resource group rc21",
                "set resource group rc21",
                "alter resource group rc21 RU_PER_SEC = 1"):
        try:
            s.execute(sql)
            raised = None
        except PlanError as e:
            raised = str(e)
        check(raised is not None, f"21a {sql!r} did not raise PlanError")
    print("21a statements: CREATE, IF NOT EXISTS, ALTER, DROP against "
          "information_schema.resource_groups; four PlanErrors")

    # a limited group blocks for its refill, default does not
    s.execute("create resource group probe21 RU_PER_SEC = 1000000000")
    d0 = group_debited(dom, "probe21")
    run(in_group("probe21"), "Q6")
    price = group_debited(dom, "probe21") - d0
    check(price > 0, f"21a: Q6 was priced {price} RU")
    rate = int(np.ceil(RC_RATE_Q6 * price))
    sched = dom.client._sched_obj
    s.execute(f"create resource group lim21 RU_PER_SEC = {rate}")
    s.execute("set global tidb_tpu_rc_overdraft_ru = 0")
    try:
        sl, sd = in_group("lim21"), in_group("default")
        throttled0 = sched.stats()["rc_throttled"]
        d0 = group_debited(dom, "lim21")
        t1 = time.perf_counter()
        for _ in range(RC_CALLS):
            run(sl, "Q6")
        lim_s = time.perf_counter() - t1
        paid = group_debited(dom, "lim21") - d0
        throttled = sched.stats()["rc_throttled"] - throttled0
        t1 = time.perf_counter()
        for _ in range(RC_CALLS):
            run(sd, "Q6")
        free_s = time.perf_counter() - t1
    finally:
        s.execute(f"set global tidb_tpu_rc_overdraft_ru = "
                  f"{DEFAULT_OVERDRAFT_RU:g}")
        run(s, "Q6")                 # a launch re-plumbs the knob
    # the bucket starts full (one second of refill): what it paid past
    # that, it paid at ``rate``
    refill_s = (paid - rate) / rate
    check(refill_s >= RC_BLOCK_S and lim_s >= 0.9 * refill_s,
          f"21a: {RC_CALLS} Q6 in lim21 took {lim_s:.3f} s, the refill "
          f"{refill_s:.3f} s")
    check(free_s < 0.5 * lim_s,
          f"21a: default took {free_s:.3f} s against lim21's {lim_s:.3f}")
    check(sched.rc_overdraft_ru == DEFAULT_OVERDRAFT_RU,
          f"21a: overdraft left at {sched.rc_overdraft_ru}")
    print(f"21a throttle: q6_ru={price:.3f} lim21_ru_per_sec={rate} "
          f"calls={RC_CALLS} paid_ru={paid:.3f} refill_s={refill_s:.3f} "
          f"lim21_s={lim_s:.3f} default_s={free_s:.3f} "
          f"throttled_skips={throttled}")

    # two priorities queued together: each group given its device time
    s.execute("create resource group hi21 RU_PER_SEC = 0 PRIORITY = HIGH")
    s.execute("create resource group lo21 RU_PER_SEC = 0 PRIORITY = LOW")
    sh, so = in_group("hi21"), in_group("lo21")
    before = {g: dict(sched.stats()["groups"].get(g) or {})
              for g in ("hi21", "lo21")}
    run_queued(sched, [lambda: run(sh, "Q6"), lambda: run(so, "Q1")])
    st = sched.stats()
    got = {g: {k: st["groups"][g][k] - before[g].get(k, 0)
               for k in ("tasks", "rus", "device_ms")}
           for g in ("hi21", "lo21")}
    check(all(v["device_ms"] > 0 and v["rus"] > 0 for v in got.values()),
          f"21a: queued groups {got}")
    check(st["digest_device_ms"], "21a: digest_device_ms is empty")
    print("21a queued: " + " ".join(
        f"{g}_tasks={v['tasks']} {g}_ru={v['rus']:.3f} "
        f"{g}_device_ms={v['device_ms']:.3f}" for g, v in got.items())
        + f" digests={len(st['digest_device_ms'])}")

    # the runaway watch: KILL on a read, SWITCH_GROUP repricing
    s.execute("create resource group kill21 RU_PER_SEC = 0 QUERY_LIMIT = "
              "(EXEC_ELAPSED = '1ms' ACTION = KILL)")
    sk = in_group("kill21")
    try:
        run(sk, "Q1")
        raised = None
    except RunawayError as e:
        raised = e
    check(raised is not None and raised.errno == 8253,
          f"21a: Q1 in kill21 raised {raised!r}")
    check(sk.must_query("select 1") == [(1,)], "21a: session after KILL")
    s.execute(f"create resource group batch21 RU_PER_SEC = {rate}")
    s.execute(f"create resource group hot21 RU_PER_SEC = {rate} "
              "QUERY_LIMIT = (EXEC_ELAPSED = '1ms' "
              "ACTION = SWITCH_GROUP(batch21))")
    sw = in_group("hot21")
    hot, batch = dom.resource_groups.get("hot21"), \
        dom.resource_groups.get("batch21")
    b0, h0 = batch.bucket.debited, hot.bucket.credited
    run(sw, "Q6")
    moved, refunded = batch.bucket.debited - b0, hot.bucket.credited - h0
    rec = dom.resource_groups.runaway_ring.records()[-1]
    check(moved > 0 and abs(moved - refunded) <= 1e-9 * moved
          and (rec["group"], rec["action"], rec["target"])
          == ("hot21", "switch_group", "batch21"),
          f"21a SWITCH_GROUP: moved {moved} refunded {refunded} {rec}")
    print(f"21a runaway: kill21 Q1 raised errno={raised.errno} "
          f"({raised}); hot21 Q6 repriced to batch21 ru={moved:.3f}")

    srv = StatusServer(dom)
    port = srv.start()
    try:
        import urllib.request
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/resource",
                                    timeout=30) as r:
            body = json.load(r)
    finally:
        srv.close()
    groups = body["groups"]
    check({"hi21", "lo21", "lim21", "kill21", "hot21", "batch21"}
          <= set(groups) and groups["hi21"]["device_ms"] > 0
          and groups["lim21"]["ru_per_sec"] == rate
          and groups["kill21"]["runaway_count"] >= 1
          and body["runaway"]["total"] >= 2 and body["rc_enable"],
          f"21a /resource: {json.dumps(body)[:2000]}")
    print(f"21a /resource: groups={len(groups)} "
          f"rc_debited_ru={body['rc_debited_ru']} "
          f"rc_throttled={body['rc_throttled']} "
          f"runaway_total={body['runaway']['total']} "
          f"digests={len(body['digest_device_ms'])}")
    for g in ("probe21", "lim21", "hi21", "lo21", "kill21", "hot21",
              "batch21"):
        s.execute(f"drop resource group {g}")
    launched = gr.LAUNCHES["group_reduce"] - n0
    check(launched > 0, "21a: group_reduce never launched")
    print(f"21a group_reduce launches={launched} "
          f"s={time.perf_counter() - t0:.1f}")
    return launched


def stress_run(dom, sessions: int, rate: float) -> dict:
    """``run_stress_harness`` as the JAX package's tests run it: transient
    retries that do not sleep, the breaker reset after."""
    from tidb_tpu_torch.testing.stress import run_stress_harness
    sched = dom.client._scheduler()
    saved = sched._retry_sleep
    sched._retry_sleep = lambda sec: None
    try:
        return run_stress_harness(dom, n_sessions=sessions, rate_per_s=rate)
    finally:
        sched._retry_sleep = saved
        sched.breaker.reset()


def stress_bars(tag: str, out: dict, smoke: bool) -> None:
    """The JAX package's bars (tests/test_stress.py): the smoke's or the
    full rung's."""
    from tidb_tpu_torch.testing.stress import STRESS_QUERIES
    check(out["wrong_results"] == 0, f"{tag}: wrong results {out}")
    if not smoke:
        check(out["completion_rate"] >= 0.98 and out["ru_fairness"]
              is not None and out["ru_fairness"] < 1.5, f"{tag}: {out}")
        return
    shapes = out["per_shape"]
    check(out["completion_rate"] == 1.0 and out["failed"] == 0
          and set(shapes) == {t for t, _q in STRESS_QUERIES}
          and all(v["ok"] == v["submitted"] for v in shapes.values())
          and out["sched_wait_p99_ms"] >= out["sched_wait_p50_ms"] >= 0
          and 0.0 <= out["fusion_rate"] <= 1.0
          and out["ru_fairness"] == 1.0 and out["calibration_entries"] > 0
          and out["launches"] <= out["tasks"] and out["value_drifts"] == 0,
          f"{tag}: {out}")


def stress_phase(torch, rk, gr, os1, main_sess, main_data,
                 main_res) -> dict:
    """Phase 21 (see the module docstring): returns the launches of
    group_reduce, radix_hist_all64 and radix_onesweep64 of 21a's Q1 and
    Q6 and of 21b's sessions, and of radix_hist and radix_scatter (the
    SCATTER partition the cost model may choose for the high-NDV
    group-by) of 21b's sessions."""
    from tidb_tpu_torch.testing.stress import build_stress_domain
    launched = {"group_reduce": resource_control(gr, main_sess, main_data,
                                                 main_res)}
    late = time.perf_counter() - T_START
    full = late <= STRESS_LATE_S
    if not full:
        print(f"21b cut to the {STRESS_SMOKE}-session smoke: the script at "
              f"{late:.1f} s, past {STRESS_LATE_S:.1f} s")
    counters = (gr.LAUNCHES, os1.LAUNCHES, rk.LAUNCHES)
    kernels = GR + OS + RADIX32
    t0 = time.perf_counter()
    reset(counters)
    dom, _s = build_stress_domain(STRESS_ROWS, device="cuda")
    check(dom.client.devices[0].type == "cuda", "21b: not on the card")
    print(f"21b domain: rows={STRESS_ROWS} s={time.perf_counter() - t0:.1f} "
          "build launches: " + " ".join(
              f"{k}={launches[k]}" for launches in counters
              for k in kernels if k in launches))
    reset(counters)
    ladder0, fb0 = dict(LADDER), dom.client.join_fallbacks
    runs = [("smoke", STRESS_SMOKE, STRESS_SMOKE_RATE)]
    if full:
        runs.append(("rung", STRESS_SESSIONS, STRESS_RATE))
    with plain_guard({"gr": gr, "os1": os1}) as plain:
        for tag, sessions, rate in runs:
            out = stress_run(dom, sessions, rate)
            print(f"21b {tag}: " + json.dumps(out))
            stress_bars(f"21b {tag}", out, smoke=tag == "smoke")
    check(plain.calls == 0, f"21b: {plain.calls} plain kernel calls")
    check(LADDER == ladder0 and dom.client.join_fallbacks == fb0,
          f"21b: a fallback served a statement: {LADDER} "
          f"join_fallbacks={dom.client.join_fallbacks - fb0}")
    stress = {k: launches[k] for launches in counters for k in kernels
              if k in launches}
    check(all(stress[k] > 0 for k in GR + OS),
          f"21b: a kernel of the stress path never launched {stress}")
    print("21b launches: " + " ".join(f"{k}={v}" for k, v in stress.items())
          + f" s={time.perf_counter() - t0:.1f}")
    for k, v in stress.items():
        launched[k] = launched.get(k, 0) + v

    # 21c: the HBM ledger conserves over two waves on (b)'s Domain
    t0 = time.perf_counter()
    sched = dom.client._scheduler()
    check(sched.hbm_enable, "21c: the ledger is off")
    # the drain measures a launch's peak where it raises the card's peak
    # counter, which the SF=10 statements before this phase set high
    torch.cuda.reset_peak_memory_stats()
    led = None
    for i, sessions in enumerate(STRESS_WAVES):
        out = stress_run(dom, sessions, STRESS_SMOKE_RATE)
        check(out["wrong_results"] == 0, f"21c wave {i}: {out}")
        led = sched._ledger_obj
        check(led is not None, "21c: the ledger never engaged")
        deadline = time.monotonic() + 10.0
        while led.inflight_bytes and time.monotonic() < deadline:
            time.sleep(0.02)
        check(led.inflight_bytes == 0 and led.negative_events == 0,
              f"21c wave {i}: inflight {led.inflight_bytes} negative "
              f"{led.negative_events}")
        if i == 0:
            baseline = led.persistent_bytes
            check(baseline > 0, "21c: no resident bytes")
    check(led.persistent_bytes == baseline
          and led.watermark_bytes >= led.max_measured_bytes
          and led.watermark_bytes >= led.persistent_bytes
          and led.measured_launches > 0,
          f"21c: resident {led.persistent_bytes} (was {baseline}) "
          f"watermark {led.watermark_bytes} max measured "
          f"{led.max_measured_bytes} measured {led.measured_launches}")
    print(f"21c ledger: waves={STRESS_WAVES} resident_bytes={baseline} "
          f"watermark_bytes={led.watermark_bytes} max_measured_bytes="
          f"{led.max_measured_bytes} measured_launches="
          f"{led.measured_launches} s={time.perf_counter() - t0:.1f}")
    return launched


def build_phase(*modules) -> None:
    """The kernel libraries of ``modules`` from the checkout's sources,
    one nvcc each, started together."""
    from tidb_tpu_torch.copr.cuda import build as kb
    t0 = time.perf_counter()
    sos = kb.build_all([m.LIBRARY.src for m in modules])
    for m in modules:
        m.LIBRARY.get()
    regs = [ln.strip() for log in kb.BUILD_LOG for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build: {' '.join(so.name for so in sos)} "
          f"seconds={time.perf_counter() - t0:.2f} kernels={len(regs)}")
    for ln in regs:
        print(f"ptxas: {ln}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of the SCATTER slice phase")
    ap.add_argument("--main-sf", type=float, default=10.0,
                    help="TPC-H scale factor of the DENSE/SCALAR main "
                         "path (Q1, Q6, Q19)")
    ap.add_argument("--s4-sf", type=float, default=1.0,
                    help="TPC-H scale factor of the slice-4 statements "
                         "(SORT, SEGMENT, TopN, Limit, filtered rows)")
    ap.add_argument("--tpch-sf", type=float, default=TPCH_SF,
                    help="TPC-H scale factor of phase 12's 22 statements "
                         "(all eight tables, against sqlite)")
    ap.add_argument("--perm-of", metavar="DIR",
                    help="only time scatter_permutation of the "
                         "tidb_tpu_torch package found in DIR (e.g. an "
                         "unpacked parent commit) and stop")
    args = ap.parse_args()
    if args.perm_of:
        sys.path.insert(0, args.perm_of)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    from tidb_tpu_torch.copr import radix
    from tidb_tpu_torch.copr.cuda import radix_kernel as rk

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"python={sys.version.split()[0]}")
    print(smi)
    if args.perm_of:
        print(f"scatter_permutation of {radix.__file__}")
        flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
        time_scatter_permutation(torch, radix, dev, flush)
        return 0
    from tidb_tpu_torch.copr.cuda import group_reduce as gr
    from tidb_tpu_torch.copr.cuda import onesweep as os1
    from tidb_tpu_torch.ops import sort as S
    from tidb_tpu_torch.store import client as client_mod
    # phases 1-14 time the card on every call, warm ones too: no result
    # cache (phase 15 turns it on by its sysvar); every ladder entry counts
    client_mod.RESULT_CACHE_ENTRIES = 0
    watch_ladders(gr)

    t_lap = [time.perf_counter()]

    def lap(label: str) -> None:
        """The seconds of the phase that just ended, on a line, with the
        script's own host work among them."""
        now = time.perf_counter()
        print(f"phase {label}: s={now - t_lap[0]:.1f} host_s="
              f"{sum(HOST_S.values()):.1f} " + " ".join(
                  f"{k}_s={v:.1f}" for k, v in sorted(HOST_S.items())))
        HOST_S.clear()
        t_lap[0] = now

    build_phase(rk, gr, os1)
    lap("2 build")
    kern = kernel_phase(torch, rk, radix, dev)
    kern.update(sort_phase(torch, rk, os1, S, dev))
    lap("3-3b kernels")
    one_lane_err = group_reduce_phase(torch, gr, dev)
    lane_sets_out = group_reduce_lanes_phase(torch, gr, dev)
    lane_sets_out["group_reduce"]["max_abs_err"] = one_lane_err
    kern.update(lane_sets_out)
    lap("4 group_reduce")
    reference_phase(torch, dev)
    reference_phase4(torch, dev)
    lap("5 reference")
    counts = slice_phase(torch, rk, gr, args.sf)
    lap("6 SCATTER")
    counts["group_reduce"], main_res, main_data = main_path_phase(
        torch, gr, args.main_sf)
    lap("7 main path")
    s4_counts, s4_res = slice4_phase(torch, rk, os1, gr, S, args.s4_sf)
    counts.update(s4_counts)
    lap("8 slice 4")
    _sql_counts, s4_data = sql_phase(gr, os1, S, main_data, main_res,
                                     args.s4_sf, s4_res)
    lap("9 sql")
    join_phase(torch, gr, os1, S, main_data, args.main_sf, s4_data,
               args.s4_sf)
    lap("10 joins")
    store_phase(torch, gr, os1, S)
    lap("11 store")
    _select_counts, main_sess = select_phase(
        torch, gr, os1, S, main_data, args.main_sf, args.tpch_sf)
    lap("12 select surface")
    window_stats_phase(torch, gr, os1, S, main_sess, main_data, s4_data)
    # 13c's ANALYZE does not invalidate cached plans (in either package):
    # from here on every statement plans over the statistics, its SUMs
    # proven narrow where valueflow proves them
    main_sess.domain.plan_cache._lru.clear()
    lap("13 windows and statistics")
    server_phase(torch, gr, os1, S, main_sess, main_data, main_res)
    lap("14 server")
    resilience_phase(torch, gr, main_sess, main_data, main_res, s4_data,
                     s4_res)
    lap("15 resilience")
    counts["group_reduce"] += admission_phase(torch, gr, main_sess,
                                              main_data, main_res, s4_data)
    lap("16 admission")
    counts["group_reduce"] += observability_phase(torch, gr, os1, main_sess,
                                                  main_data, main_res,
                                                  s4_data)
    lap("17 observability")
    counts["group_reduce_gates"] = 0
    counts["group_reduce_gates"] += gates_phase(torch, gr, main_sess,
                                                main_data, main_res)
    lap("18 gates")
    counts["group_reduce"] += pd_phase(gr, os1, main_sess, main_data,
                                       main_res)
    lap("19 coordination and background")
    counts["group_reduce"] += tools_phase(gr, os1)
    lap("20 tools and cascades")
    for name, n in stress_phase(torch, rk, gr, os1, main_sess, main_data,
                                main_res).items():
        counts[name] += n
    del main_sess
    lap("21 resource control and stress")

    cu = "tidb_tpu_torch/copr/cuda/"
    sources = {"radix_hist": cu + "radix_kernel.cu",
               "radix_scatter": cu + "radix_kernel.cu",
               "radix_hist64": cu + "radix_kernel.cu",
               "radix_scatter64": cu + "radix_kernel.cu",
               "group_reduce": cu + "group_reduce.cu",
               "radix_hist_all64": cu + "onesweep.cu",
               "radix_onesweep64": cu + "onesweep.cu"}
    sort_sites = ("lax.sort at tidb_tpu/copr/exec.py:340, :579 and "
                  "tidb_tpu/copr/segment.py:178")
    replaces = {"radix_hist": "tidb_tpu/copr/pallas/radix_kernel.py:92",
                "radix_scatter": "tidb_tpu/copr/pallas/radix_kernel.py:105",
                "radix_hist64": "tidb_tpu/copr/pallas/radix_kernel.py:92 "
                                f"(the per-pass reference of the {sort_sites}"
                                "; on no query path)",
                "radix_scatter64": "tidb_tpu/copr/pallas/radix_kernel.py:105 "
                                   "(the per-pass reference of the "
                                   f"{sort_sites}; on no query path)",
                "group_reduce":
                    "tidb_tpu/copr/exec.py:87 _reduce (XLA-fused), as "
                    "_one_agg_state :125 and _agg_partial_states :244 call "
                    "it once a state lane",
                "radix_hist_all64": f"{sort_sites} (the histograms of a "
                                    "key's passes)",
                "radix_onesweep64": f"{sort_sites} (a pass)"}
    # a lane set's launches are those of its path's run (main: Q1, Q6 and
    # Q19; slice4: SORT and SEGMENT; gates: phase 18b's narrow Q1 and Q6)
    paths = {"main": "group_reduce", "slice4": "group_reduce_slice4",
             "gates": "group_reduce_gates"}
    for name, r in kern.items():
        if name.startswith("group_reduce"):
            counts[name] = counts[paths[r["path"]]]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": sources[name.split("[")[0]],
         "replaces": replaces[name.split("[")[0]], "launches": counts[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in kern.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

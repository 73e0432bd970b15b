#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (opentenbase_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 42] [--rows 60000000]
                          [--ssb-rows 60000000] [--q3-sf 10]
                          [--hits-rows 60000000]
                          [--sf100-rows 603979776] [--chunk-sf 30]
                          [--repeats 5] [--data-dir DIR]

Phases, one line each; any failure raises and exits non-zero:

1. card: the nvidia-smi name and power limit, and torch's device name;
2. build: every kernel compiled from csrc/ (one nvcc each, in parallel),
   with the registers, spills and shared memory ptxas reports, and the
   GTM's server from gtm/native/ (g++, beside them);
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, exactly equal. scan_agg: int32/int64/bool columns, G=1 and G=6,
   compact and full MVCC planes with invisible rows (and a run hidden in
   the middle of a tile), shards whose nrows is no tile multiple, shards
   shorter than a tile and an empty one, a spec with no predicate, and
   the widest spec compile_spec accepts (16 columns, 16 groups, 8
   values, stack depth 16), full planes at the GTM's hybrid magnitude
   (stamps about 2^60.7, one apart around the snapshot, some xmax at
   RESERVED_TS), and Q6 over ``--rows`` rows with full MVCC
   planes hiding 0.1 % of them in runs and scattered. radix_probe: the
   reference test's data, int32 and int64 keys, keys near +-2^62, dead
   and NULL probe rows, an empty build, duplicate build keys, n not a
   multiple of a thread's rows, probes starting at an offset view, every
   pass of a multi-pass plan, and DATE probed by ``--ssb-rows`` rows of
   which 0.1 % are deleted;
4. main path, TPC-H: Cluster(num_datanodes=2) on cuda, CREATE TABLE
   lineitem, a bulk append of ``--rows`` rows (60 M = TPC-H SF10, as
   bench.py measures it) made from ``--seed``, then Q6 and Q1 through
   Session.query through the scan-aggregate kernel;
5. main path, SSB: a second cluster holding SSB lineorder (``--ssb-rows``,
   60 M = SF10, round robin over 2 datanodes) and DATE, PART, SUPPLIER
   and CUSTOMER at the same scale factor (replicated; TEXT attributes as
   dictionary codes), loaded once, then query flight 1 (Q1.1-Q1.3)
   through Session.query: a star join through the fused DAG's scalar
   mode and the radix-probe kernel; then flights 2-4 (Q2.1-Q4.3): star
   joins of three or four dimensions, filtered and grouped on TEXT,
   through the DAG's grouped mode (DATE by the radix probe, the other
   dimensions by the dense fold). Every answer must equal a numpy
   computation over the same arrays exactly, and every kernel of each
   path must have launched in that path's run (counts set to 0 just
   before each query and read just after);
5c. main path, device top-k: TPC-H Q3 through the fused DAG's ranking
   modes, once with bench.py's dense order keys (orders and customer
   added to phase 4's cluster: gagg over two folds) and once as the spec
   writes it over dbgen-shaped data at ``--q3-sf`` (sparse order keys,
   TEXT segments, its own cluster: gsort), then ClickBench's top-10
   UserIDs over ``--hits-rows`` rows (full-range ids: the grouped mode,
   every group shipped, as the reference). Each exact against numpy in
   the mode the CPU tests fixed, with K1's and K2's launches counted;
5d. main path, fragment program and coordinator expressions: TPC-H Q1
   as the spec writes it (three avgs, sum_charge) over phase 5c's
   lineitem (its columns Q1 reads), and ClickBench Q0, Q1, Q2, Q6 and
   Q7 over phase 5c's hits (AdvEngineID, ResolutionWidth and EventDate
   added). Each exact against numpy on the route and rung the CPU tests
   fixed (FRAGMENT_ROUTES: the kernel where the certifier takes the
   fragment, else the fragment program's scalar or hash rung), K1
   launched once on its route and never on the program's;
6. timing, per path: median end-to-end ms per query, the layers each
   timed on its own, the device busy and idle share of single queries
   from a torch.profiler trace, kernel ms from CUDA events at the main
   path's own inputs (held against the plain version there too), the
   plain version's ms, the bytes-over-bandwidth bound and the GB/s
   moved;
7. main path, bench.py's TPC-H SF100 leg: lineitem ``--sf100-rows``
   (603 979 776 = 2^26 * 9, SF 100.6), orders a quarter, customer a
   fortieth, made from ``--seed`` on the host (cut to what the host can
   check, as bench.py cuts it, and printed as ``reduced:``), registered
   on the card as device-resident external tables in one datanode.
   OTB_SCAN_HBM_BUDGET is 11 GB and OTB_DIMFOLD_MAX 260 M rows, as
   bench.py sets them, so that Q6's four resident columns (9.7 GB) stay
   on K1's route and the 151 M-row orders side folds. Q6 through K1 in
   one launch; Q3 through the windowed gagg (16 windows under the 6 GB
   window budget) with the orders side hoisted and both joins folded,
   all ten rows exact against numpy (computed over row slices in
   threads); K1 held against its plain version at Q6's inputs; Q3's
   warm, layered and traced runs 2 each (a cut for the time limit);
8. main path, the write path: (a) TPC-H's refresh functions in phase
   5c's SF10 cluster after every earlier query of it (Q6 first, over
   compact planes): RF1 inserts 15 000 orders and their lineitems
   through INSERT ... VALUES of at most 5 000 rows in one transaction,
   RF2 deletes 15 000 orders and their lineitems through DELETE ...
   IN (5 000 keys) in one transaction, and Q6, Q1 and Q3 run after
   each, exact against numpy, with the device cache's refresh counters
   of each first run and K1 held against its plain version at Q6's
   full-plane inputs; (b) bench.py's HTAP loop at its own parameters
   (100 000 rows, then for 4 s a 500-row INSERT, 8 UPDATEs and the
   top-5 query, every answer exact against numpy); (c) in phase 5's SSB
   cluster after flights 1-4 and their timings, a DELETE of the rows of
   lineorder's first 0.1 % of order keys, then flight 1 again, exact,
   with K2 held against its plain version at the new inputs.

The second-to-last lines are the kernel table as JSON and the nvidia-smi
line; the last line is the run's verdict as JSON. The script imports
neither jax nor the reference package.

9. main path, the rest of both fused executors: (a) in phase 5c's SF10
   cluster, after its Q3 and Q1 and before phase 8's writes, TPC-H Q4
   (rev. 3, section 2.4.4: a grouped count over a semi join) and its NOT
   EXISTS complement (a scalar count over an anti join), over the
   columns make_q3_spec draws for them from streams of their own
   (o_orderpriority, l_commitdate); (b) join rows: one customer's order
   lines (TPC-C's Order-Status read) and one month of order lines (rows
   mode, the row capacity regrown), the month's 100 largest lines
   (rows_topk); (c) a query grouped by the orders key and o_weight, a
   FLOAT8 column added to orders for it (gseg); (e) CREATE INDEX on
   lineitem (l_orderkey), then Q1's select list over the first 1 % of
   order keys through the fragment program's zone window, timed beside
   the same query before the index (before the refreshes: RF1 appends
   keys from the whole range at every shard's tail). Each exact against
   numpy in the mode the CPU tests fixed, K2 launched wherever the
   radix table answers a join and held against its plain version at
   two of these queries' inputs. (d) After phase 7: TPC-H Q1 as the spec
   writes it and Q6 over make_q3_spec's lineitem at ``--chunk-sf``
   (default 30: 180 M rows, 2 datanodes) under the default 8 GB
   OTB_SCAN_HBM_BUDGET: each scan streams shard-row windows through the
   fragment program (Q1 in 3 windows, Q6 in 2), one resident at a time,
   K1 never launched, each exact against numpy; one warm run and one
   traced run each, with no untimed trace before it and no layered run
   (cuts that keep the whole script inside its time limit); the
   lineitem made by make_q3_spec, its columns drawn in threads.
10. main path, the host executor and the distributed loop (no kernel:
   K1 and K2 must launch 0 times on each of these queries): (a) after
   phase 5c's ClickBench, its top-10 UserIDs over the published
   99 997 497 rows (17 630 976 distinct UserIDs, the UserID column
   alone) in a cluster of its own, declined by the fused DAG and the
   fragment program as in the reference; (b) in phase 5c's SF10
   cluster after phase 9, TPC-H Q18 and Q13 (c_name, o_totalprice and
   o_comment added to make_q3_spec from streams of their own), a bare
   scan of one day's lines and each customer's three largest orders by
   rank(), then Q6, Q1 and Q3 as the spec writes them with
   ``set enable_fused_execution = off``; (c) inside RF1's transaction
   (phase 8a), after its INSERTs, Q6 and a count of orders. Each exact
   against numpy, with its route and declines, join modes, per
   fragment and node ms and rows, motions, coordinator ms, bytes
   uploaded, the warm median of ``--repeats`` runs (ClickBench: 2; 1
   where the first run took over 1 s, a cut for the time limit), a
   traced run's device busy time and idle share, and peak memory.
11. the durable server: (a) after phase 9d, lineitem at ``--rows`` in a
   Cluster(num_datanodes=2, data_dir=D) on the card (D under
   ``--data-dir``, default .benchtmp/chip_smoke/, removed at the end),
   the load logged as one WAL commit frame; served by a ClusterServer
   in this process, over the JSON wire: one transaction of TPC-H RF1's
   lineitem shape (60 000 rows in 16 INSERTs), one deleting the lines
   of 1 000 order keys, Q6 and Q1 (exact, K1 launched once each),
   VACUUM (which takes the checkpoint), a 500-row transaction in the
   WAL tail; then close(), Cluster.recover(D, 2) with its seconds,
   records replayed, checkpoint and WAL bytes and the WAL's fsyncs
   against its durable commits, and Q6 and Q1 again over a new server
   (exact, K1 launched). (b) In phase 5's SSB cluster after phase 8c, a
   PgWireServer: SSB Q1.1 through a minimal v3 client here, its text
   rows equal to numpy's value as PostgreSQL's text format writes it,
   K2 launched. (c) ``python -m opentenbase_tpu_torch.cli.otb_server``
   as its own process on the card with a data directory; otb_bench's
   initialize at scale 100 (100 000 accounts) and a run of 8 clients
   (its TPS printed); a second run SIGKILLed 2 s in; the server
   restarted with --recover: sum(abalance) = sum(delta) over history,
   and history holds every acknowledged transaction and at most 8
   more. Every durable-path number carries the data directory's
   filesystem type.
12. the process topology, after phase 11, over phase 5c's SF10 arrays
   (customer 1.5 M, orders 15 M, lineitem 60 M): a durable coordinator
   on the card whose GTM is the native server in a process of its own
   (every snapshot and commit timestamp crosses its wire), with the
   tables distributed by their keys (lineitem and
   orders by shard(orderkey), customer by shard(c_custkey)), loaded in
   commit frames of at most 4 M rows, a WalSender, two datanode
   processes (``python -m opentenbase_tpu_torch.dn.server``, started
   with Popen, on the same card) and a hot StandbyCluster in this
   process on the card, each catching up on the stream (seconds and lag
   bytes printed). (a) Fused route off: Q6, Q1 as the spec writes it,
   Q3, Q13 and Q18, every fragment in the datanode processes, the
   redistribution of Q3 or Q18 on the peer exchange, each exact against
   numpy; per query its first and warm times (``warm_repeats``' cut),
   each fragment's datanode ms and the
   bytes on the wire. (b) Fused route on: Q6 and Q1 (phase
   4's form) through K1 on the coordinator, one launch each. (c) RF1's
   rows appended in one transaction, committed by implicit 2PC with the
   write set shipped (prepare and commit ms), then count(*) and Q6 read back
   through the datanodes; their 2PC journals empty. (d) A small commit
   under synchronous_commit = on, one under remote_write. (e) The
   standby's Q6 and Q1 through K1 (one launch each), and a replica read
   of Q6 on datanode 0's host route. Every process's RSS and device
   memory printed; every child reaped at the end.
14. the GTM, on phase 12's live topology after its (e) and before phase
   13: the GTM's pid and RSS, the median of 1 000 get_gts round trips,
   its node registry (cn0, gtm0, dn0, dn1). (a) RF1's shape again
   (make_rf1 with another seed) appended and the lines of 8 loaded
   orders deleted in one transaction, PREPARE TRANSACTION: both
   datanodes' votes and the GTM's registry list the gid; Q6 through K1
   and count(*) through the datanodes still equal the answers before
   it (the deleted lines visible at RESERVED_TS); COMMIT PREPARED: Q6
   and Q1 through K1, count(*) and Q6 through the datanodes and the
   standby's Q6 through K1 equal numpy's with the batch and without
   the deleted lines; the journals and the registry empty; the PREPARE
   and COMMIT PREPARED ms and the 'T' frame's bytes. (b) 64 rows
   prepared and rolled back: visible nowhere. (c) CREATE SEQUENCE, a
   4 096-row INSERT of nextval() in one GTM reservation, sum(id) and
   count(*) through K1 exact; the standby refuses nextval and holds
   the primary's next value. (d) 64 rows left prepared; the GTM
   SIGKILLed, respawned from its state directory and the coordinator
   re-pointed: its first timestamp above every commit stamp on the
   card's planes, the gid still listed, Q6 through K1 exact, a 64-row
   write commits. (e) (d)'s transaction rides into phase 13's crash:
   13 (c) sends its COMMIT PREPARED to the promoted process (where the
   replayed 'T' record parked it) and reads its rows back on the
   re-pointed standby. The promoted node runs its own in-process GTM
   (as the reference's does), so the topology's native GTM keeps
   listing the gid; the re-registration is checked in 13 (g).
   (f) tests/test_gtm_ha.py's failover on the card: a small cluster's
   in-process GTM feeds a standby over TCP, dies; the standby promoted
   behind a GTSFrontend, the cluster re-pointed through NativeGTS:
   commits stamp above the old watermark, a K1 read is exact.
13. self-healing HA, on phase 12's live topology before its teardown:
   (a) once both datanodes and the standby replayed the WAL's end, the
   coordinator crashes as HATopology.crash_primary makes it (walsender
   stopped, datanode pools closed), then commits 64 rows under
   synchronous_commit = local: a frame that never streams; (b) the
   failover by ha.failover_endpoints, the RPC half HATopology.failover
   drives: both datanodes pinged, the
   one with the higher applied offset promoted to generation 1 (a SQL
   front end and a walsender inside its process, on its device), the
   other fenced (a ping carrying generation 1) and re-pointed at the
   promoted walsender, the in-process standby's stream restarted there
   after probe_timeline; promote ms, promote_lsn, torn bytes and each
   replica's catch-up printed; (c) over the JSON wire to the promoted
   process, Q6 and Q1 (phase 4's form, fused route on) exact against
   numpy after RF1, and a 64-row commit under remote_write, read back
   exactly on the re-pointed standby and, as a replica read, on the
   surviving datanode, with none of (a)'s rows anywhere; (d) the
   ex-primary revived (a ClusterServer, its datanode channels
   re-attached): a read (fused route off) and a write refused with
   SQLSTATE 72000, then every statement (demoted); (e) the ex-primary
   closed and rewound by rejoin_standby onto the promoted timeline, on
   the card: the bytes truncated (its WAL end less promote_lsn: exactly
   (a)'s frame), the replay and catch-up seconds; (f) Q6 and Q1 through
   K1 on the re-pointed standby and on the rewound ex-primary, one
   launch each, exact; (g) a small HATopology on the card with
   tests/test_ha.py's configuration: HAMonitor declares the crashed
   primary dead within detect_ms + detect_ms / beats + 600 ms, the
   promoted node takes RoutingClient's writes, and every acknowledged
   row is present; each candidate's GTM lost dn1's registration and
   held a stale address for cn0 before the crash, and the promoted
   node's GTM lists the topology as it was built.
15. the rest of the expression library and the query sugar, in phase
   5c's SF10 cluster after phase 10b and before phase 8's writes, over
   columns and tables make_phase15 adds as dbgen makes them (TPC-H rev.
   3, 4.2.3; each random column from a stream of its own): nation,
   region, supplier (100 000: s_name, s_address, s_nationkey, s_phone),
   part (2 000 000: p_name of five P_NAME words, p_type), partsupp
   (8 000 000: the spec's four suppliers a part, ps_supplycost),
   lineitem's l_partkey and l_suppkey, customer's c_nationkey, c_phone
   and c_acctbal (phase 12 loads none of them). TPC-H Q7, Q8 and Q9 as
   the spec writes them (extract(year ...) on the card), Q15 in its
   CREATE VIEW revenue0 / query / DROP VIEW form and as a WITH, Q22's
   grouping core (substring(c_phone from 1 for 2): a text table over
   1.5 M phone numbers built on the host), Q6 through a view over
   lineitem (K1), CREATE TABLE AS of Q15's revenue rows, and an INSERT
   ... SELECT of one month of lineitem (772 218 rows through the delta
   plane) into an empty table of Q6's columns, then Q6 over it (K1).
   Each exact against an independent numpy computation, with its route,
   mode or rung, K1's and K2's launches, the text tables' build ms, the
   warm median of the runs ``warm_repeats`` allows and the layers of
   one run.
16. the DML and transaction statements, in phase 5c's SF10 cluster right
   after phase 8 (a)'s RF2, every answer exact against numpy over RF2's
   arrays: (a) CREATE TABLE cust_acct with a PRIMARY KEY, NOT NULL,
   a DEFAULT and DISTRIBUTE BY HASH, filled by INSERT ... SELECT from
   customer (1.5 M rows); RF1's volume (SF x 1 500 rows, half existing
   keys) upserted by INSERT ... ON CONFLICT DO UPDATE ... RETURNING in
   5 000-row statements, then one DO NOTHING; a NULL for the NOT NULL
   column and a duplicate key refused with the reference's messages,
   their transaction intact; (b) an UPDATE under SAVEPOINT, read inside
   the transaction, ROLLBACK TO SAVEPOINT, COMMIT, read again; (c) RF2
   as users write it: SF x 1 500 order keys in a replicated rf2_keys,
   DELETE ... USING of orders (RETURNING the keys) and of lineitem in
   one transaction, then Q6 on K1 (held against its plain version at
   these inputs) and Q3 once; (d) UPDATE orders ... FROM cust_acct, an
   UPDATE with a scalar subquery, an INSERT whose VALUES hold
   expressions; (e) ALTER TABLE lineitem ADD COLUMN (60 M rows), Q6 on
   K1 with the device cache's refresh counters, DROP COLUMN, ALTER
   TABLE cust_acct DISTRIBUTE BY MODULO, TRUNCATE of rf2_keys and other
   keys inserted, its count and sum read on the host route and, grouped,
   on the fused DAG (the stale-plane trap); (f) FOR UPDATE in a second
   session failing an UPDATE under lock_timeout 200 ms and a FOR UPDATE
   NOWAIT, both with the reference's messages and SQLSTATE, and LOCK
   TABLE holding off another session's INSERT until COMMIT; (g) one
   compaction pass, then Q6 on K1. Each statement's rows and ms
   (``write:``), each read's route, launches, first and warm ms and
   refresh counters (``main path:``, ``refresh:``);
17. the session statements and introspection, each statement run once
   and every answer exact against numpy: (a) SHOW ALL; Q6 under
   ``enable_pallas_scan`` off (the fragment program, no K1 launch) and
   on (one); SSB Q1.1 in the SSB cluster after phase 8 (c) under
   ``join_mode`` sortmerge (no K2 launch) and radix (one); phase 8 (b)'s
   HTAP batches again, as many as the loop ran up to 40, with
   ``enable_delta_scan`` off, rows/s beside the loop's and the folds
   (``deltas_absorbed``) of each; (b) Q6 PREPAREd with $1..$5 and
   EXECUTEd with the spec's parameters and another set (one K1 launch
   each), and a prepared one-row INSERT EXECUTEd 1 000 times; (c)
   EXPLAIN ANALYZE of Q6 (K1) and of SSB Q1.1 (the DAG, K2, a radix
   join), each with its Total rows equal to the answer's and its device
   ms (CUDA events) within its end to end ms, of Q3 with fused
   execution off (the host route's operator tree, the root's rows equal
   to the answer's) and, in phase 12, of Q1 (spec) through the datanode
   processes; (d) an RF1-shaped batch written by numpy as dbgen .tbl
   files and COPYed into orders and lineitem, then Q6 on K1 with a
   delta-tail refresh and K1 held against its plain version at those
   inputs; COPY customer TO a file (SF x 150 000 rows) read back by
   numpy, and COPY FROM that file into a new table read grouped; (e)
   pg_stat_device_cache and pg_stat_fused against the executor's own
   counters, pg_stat_user_tables against numpy's live rows, pgxc_node,
   pgxc_shard_map, pg_stat_wal in phase 11 (a), pg_prepared_xacts in
   phase 14 while its gid is prepared, pg_locks in phase 16 (f) while
   the INSERT waits, and pg_unlock_check_deadlock / pg_unlock_execute
   breaking a two-session deadlock under a 600 s deadlock_timeout;
18. the rest of the query surface in the same SF10 cluster after phase
   17, every answer exact against numpy: (a) orders_p PARTITION BY RANGE
   (o_orderdate) BEGIN ('1992-01-01') STEP (1 year) PARTITIONS (7),
   DISTRIBUTE BY SHARD (o_orderkey), loaded by INSERT ... SELECT from
   orders (SF x 1.5 M rows, routed by the partition split), each
   child's rows in pg_partitions; one year's count by priority through
   the parent pruned by bare literals (EXPLAIN keeps p2 and p3) and the
   parent's count, on the host route; the same grouped count on
   orders_p$p2 by name on K1 (one launch, held against its plain
   version at those inputs); an UPDATE and a DELETE fanned out over one
   year's children (about 230 000 rows each), the partition-key UPDATE
   refused with
   the reference's message, ADD PARTITIONS (1) and an INSERT landing in
   orders_p$p7; DROP, the name created again and its child read on K1
   (no stale plane); (b) a generated org chart emp(id, mgr, salary) of
   1 M employees (fan-out 3-5, depth about 12) and WITH RECURSIVE: the
   reports under a manager (UNION ALL) with their count and summed
   salary, and reachability (UNION) over its edges plus back edges that
   close cycles, each against numpy's BFS with the iterations counted;
   (c) PL/pgSQL: q6_rev(lo, hi, qty) whose body's SELECT ... INTO is Q6
   (one K1 launch a call, two parameter sets, K1 held against its plain
   version at the first), and a call looping over 1 000 RF1-shaped
   INSERTs: every row visible after it, none after the same call
   RAISEs; (d) supplier (SF x 10 000 rows, dbgen's seven columns)
   written as CSV without trailing delimiters and read as a foreign
   table by TPC-H Q11 (its value sum(ps_supplycost): partsupp holds no
   ps_availqty), INSERT and COPY FROM refused, the file rewritten and
   read anew.
19. workload management, the datanodes' parallel workers, materialized
   views and logical replication, every answer exact against numpy:
   (a) in phase 5c's SF10 cluster after phase 18, a resource group of
   concurrency 2 and queue depth 2 bound to a role: two sessions of the
   role hold both slots with pg_sleep, four more send Q6 at once: two
   queue and then run Q6 on K1 (one launch each), two are shed with
   53000, and pg_stat_wlm's admitted, queued and shed counts equal what
   the threads saw (the queue wait printed); a memory_limit between
   Q6's and Q3's (spec) printed estimates sheds Q3 with 53200 and admits
   Q6 (K1); a queued Q6 under statement_timeout = 500 fails with 57014.
   (b) In phase 12 after its (a): Q6 and Q1 (spec) through the datanode
   processes with dn_parallel_workers at its default 4 and at 1: each
   datanode's parallel_fragments rises by one a fragment a run at 4 and
   not at 1; first and warm ms of each, every process's memory. (c) In
   phase 11 (a)'s durable cluster after its recovery, over its JSON
   wire: Q1 (phase 4's, its aggregates named, no ORDER BY) as a
   materialized view, populated on K1 (its rows and its aux partial
   state: two launches, each held against the plain version at those
   inputs) beside a second one with incremental = off; Q1 answered
   through the rewrite (EXPLAIN shows it; K1 launches 0) and with
   enable_matview_rewrite off (one launch); RF1's lineitem shape with
   another seed COPYed from a .tbl file and the lines of 100 of its
   order keys deleted: the
   matview is stale and the rewrite skipped; REFRESH incremental
   (pg_stat_matview's mode) beside the full one, both exact, their ms.
   (d) Before (c)'s writes, a publication of lineitem and a second
   durable Cluster(num_datanodes=2) on the card subscribed to phase 11's
   JSON server with copy_data = false; once it applied (c)'s frames
   (the apply lag and rows/s printed), its count(*) and Q6 on K1 equal
   numpy's over (c)'s batch less its deleted lines; DROP SUBSCRIPTION,
   the cluster closed.
20. fault injection, every answer exact against numpy and no fault
   caught to let a part pass: (a) in phase 5c's SF10 cluster after phase
   19 (a), ``set fault_injection = on`` and
   pg_fault_inject('fused/delta_tail_upload', 'error', 'once'), TPC-H
   RF1's lineitem volume (SF x 6 000 rows) COPYed in; Q6 raises the
   injected error with no K1 launch, no tail written and no host-route
   answer; Q6 again exact on K1 (one launch) with a delta tail of the
   batch; then with the fused route off, storage/delta_scan armed error
   once: Q6 fails, the rerun is exact; pg_stat_faults' rows. (b) In
   phase 12 after 19 (b): each datanode pool holds five channels open,
   pg_fault_inject('dn/exec_fragment', 'crash_node', 'node=1, once')
   reaches both processes; Q6 and Q1 (spec) through the datanodes exact
   through one retry and one failover to the coordinator's stores each;
   pg_stat_faults shows datanode 1's firing; pg_fault_clear() revives it
   and Q6 runs in both processes again. (c) Phase 13 (b) above. (d)
   After phase 13 (g), tests/test_ha.py's chaos schedule (seed 4242, 4
   s, two datanodes, detect 900 ms over 3 beats) on an HATopology on the
   card: its verdict ``ok``, one promotion, the revived ex-primary's
   probe refused (72000); acknowledged, lost and indeterminate writes
   and the detection ms printed.

The numpy answers over 60 M rows and more (Q6, Q1 as the spec writes
it, SF100's Q6 and Q3) are sums over row slices taken in threads, and
the hits generator's Zipf inversion runs on the card: the same answers
and the same data in less of the time limit; so are flights 2-4's
answers, one thread a query. Cuts for the time limit (``warm_repeats``):
a query whose first run took over 250 ms gets two warm runs, over 1 s
one warm run and one traced run, over 3 s no warm run (its first run's
time stands for it) where it is timed alone (phases 10, 12, 14-16), over
5 s no traced run either (TPC-H Q18 on the host route, the chunked
scan's queries); the fused DAG's month of lines keeps one warm, layered
and traced run; phase 10's numpy answers run in threads beside phase
9's queries.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# HBM bandwidth of the SXM H100 (NVIDIA data sheet), bytes/s. The scan
# is bound by bytes: its few dozen integer operations a row are far
# below the card's ratio of operations to bytes.
HBM_RATE = {"NVIDIA H100 80GB HBM3": 3.35e12}

Q6 = (
    "select sum(l_extendedprice * l_discount) from lineitem "
    "where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' "
    "and l_discount between 0.05 and 0.07 and l_quantity < 24"
)
Q1 = (
    "select l_returnflag, l_linestatus, sum(l_quantity), "
    "sum(l_extendedprice), sum(l_extendedprice * l_discount), "
    "count(*) from lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)
LINEITEM_DDL = (
    "create table lineitem (l_orderkey bigint, l_quantity numeric(10,2), "
    "l_extendedprice numeric(12,2), l_discount numeric(4,2), "
    "l_shipdate date, l_returnflag int, l_linestatus int) "
    "distribute by roundrobin"
)


def start_threads(jobs: dict, workers: int = 4):
    """{name: fn} started side by side in threads (numpy drops the GIL in
    its bulk loops); returns a function that waits for them and gives
    {name: fn()}, each result what the call gives alone. Only for calls
    that share no mutable state with each other or with the caller."""
    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(max(1, min(workers, len(jobs))))
    futs = {k: ex.submit(fn) for k, fn in jobs.items()}
    ex.shutdown(wait=False)
    return lambda: {k: f.result() for k, f in futs.items()}


def in_threads(jobs: dict, workers: int = 4) -> dict:
    """``start_threads``' results, waited for."""
    return start_threads(jobs, workers)()


TRACE_MAX_FIRST_MS = 5000  # no traced run past this first run (a cut)


def untraced(name: str, first_ms: float) -> dict:
    """The trace a query whose first run took over TRACE_MAX_FIRST_MS does
    not get (a cut for the time limit), printed as not measured."""
    print(f"trace: {name} not measured (a cut for the time limit: its "
          f"first run took {first_ms:.3f} ms)", flush=True)
    return {"wall_ms": None, "busy_ms": None, "idle_share": None,
            "events": {}, "top": []}


def warm_repeats(first_ms: float, repeats: int) -> int:
    """The warm runs a query gets after its first run: ``repeats`` where
    the first run took at most 250 ms, two where it took at most 1 s,
    one where it took at most 3 s, and none beyond, its first run's
    time standing for it (cuts for the script's time limit; every
    answer is still checked)."""
    if first_ms <= 250:
        return repeats
    if first_ms <= 1000:
        return min(2, repeats)
    return 1 if first_ms <= 3000 else 0


def over_slices(fn, n: int, parts: int = 8) -> list:
    """``fn(slice)`` over ``parts`` consecutive row slices of [0, n), side
    by side in threads: the per-slice results in row order (numpy's
    answers over 60-600 M rows are sums of the slices' sums)."""
    cuts = [n * i // parts for i in range(parts + 1)]
    got = in_threads({i: functools.partial(fn, slice(cuts[i], cuts[i + 1]))
                      for i in range(parts)}, workers=parts)
    return [got[i] for i in range(parts)]


def make_lineitem(n: int, seed: int = 42):
    """The lineitem generator of bench.py (make_lineitem), copied."""
    rng = np.random.default_rng(seed)
    n_orders = max(n // 4, 1)
    return {
        "l_orderkey": rng.integers(1, n_orders + 1, n).astype(np.int64),
        "l_quantity": (rng.uniform(1, 51, n) * 100).astype(np.int64),
        "l_extendedprice": (rng.uniform(900, 105000, n)).astype(np.int64),
        "l_discount": rng.integers(0, 11, n).astype(np.int64),
        "l_shipdate": (8036 + rng.integers(0, 2556, n)).astype(np.int32),
        "l_returnflag": rng.integers(0, 3, n).astype(np.int32),
        "l_linestatus": rng.integers(0, 2, n).astype(np.int32),
    }


def make_q3_dims(n: int, seed: int = 43):
    """The orders and customer generator of bench.py (make_q3_dims),
    copied: n/4 orders with dense keys 1..n/4 and n/40 customers, the
    segment an int code (0 plays BUILDING)."""
    rng = np.random.default_rng(seed)
    n_orders = max(n // 4, 1)
    n_cust = max(n // 40, 1)
    orders = {
        "o_orderkey": np.arange(1, n_orders + 1, dtype=np.int64),
        "o_custkey": rng.integers(1, n_cust + 1, n_orders).astype(np.int64),
        "o_orderdate": (8036 + rng.integers(0, 2405, n_orders)).astype(
            np.int32),
        "o_shippriority": rng.integers(0, 3, n_orders).astype(np.int32),
    }
    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_mktsegment": rng.integers(0, 5, n_cust).astype(np.int32),
    }
    return orders, customer


# bench.py's orders and customer beside phase 4's lineitem, and its Q3
Q3_DENSE_DDL = (
    "create table orders (o_orderkey bigint, o_custkey bigint, "
    "o_orderdate date, o_shippriority int) distribute by roundrobin",
    "create table customer (c_custkey bigint, c_mktsegment int) "
    "distribute by roundrobin",
)
Q3_DENSE = (
    "select l_orderkey, sum(l_extendedprice * (1 - l_discount)), "
    "o_orderdate, o_shippriority "
    "from customer, orders, lineitem "
    "where c_mktsegment = 0 and c_custkey = o_custkey "
    "and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15' "
    "and l_shipdate > date '1995-03-15' "
    "group by l_orderkey, o_orderdate, o_shippriority "
    "order by 2 desc, o_orderdate limit 10"
)
# TPC-H rev. 3 Q3 (section 2.4.3) with its validation substitutions,
# over the columns it reads, every table round robin (bench.py's layout)
Q3_SPEC_DDL = (
    "create table customer (c_custkey bigint, c_mktsegment text, "
    "c_name text) distribute by roundrobin",
    "create table orders (o_orderkey bigint, o_custkey bigint, "
    "o_orderdate date, o_shippriority int, o_orderpriority text, "
    "o_weight double precision, o_totalprice numeric(12,2), "
    "o_comment text) distribute by roundrobin",
    "create table lineitem (l_orderkey bigint, "
    "l_extendedprice numeric(12,2), l_discount numeric(4,2), "
    "l_shipdate date, l_quantity numeric(10,2), l_tax numeric(4,2), "
    "l_receiptdate date, l_returnflag text, l_linestatus text, "
    "l_commitdate date) distribute by roundrobin",
)
Q3_SPEC = (
    "select l_orderkey, sum(l_extendedprice*(1-l_discount)) as revenue, "
    "o_orderdate, o_shippriority "
    "from customer, orders, lineitem "
    "where c_mktsegment = 'BUILDING' "
    "and c_custkey = o_custkey and l_orderkey = o_orderkey "
    "and o_orderdate < date '1995-03-15' "
    "and l_shipdate > date '1995-03-15' "
    "group by l_orderkey, o_orderdate, o_shippriority "
    "order by revenue desc, o_orderdate limit 10"
)
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")


class Text:
    """A TEXT column as indices into a small vocabulary (``vocab[idx]``
    are the strings): ``encode_text`` codes it without sorting a
    string per row."""

    def __init__(self, vocab, idx):
        self.vocab = np.asarray(vocab)
        self.idx = np.asarray(idx)

    def __len__(self) -> int:
        return len(self.idx)


def make_q3_spec(sf: float, seed: int = 42,
                 lineitem_only: bool = False) -> dict:
    """The lineitem columns TPC-H Q3 and Q1 read, and those of customer
    and orders Q3 reads, as dbgen makes them (spec rev. 3, section
    4.2.3), at scale factor ``sf``: customer 150 000 x SF rows, keys
    1..N, the segment uniform over the five; orders 1 500 000 x SF rows
    with SPARSE keys (the first 8 of every 32), a customer uniform over
    the keys not divisible by 3, a date uniform over 1992-01-01 ..
    1998-08-02 and priority 0; 1-7 lines an order, quantity 1-50, the
    extended price the quantity times the part's retail price (90000 +
    (partkey / 10) mod 20001 + 100 (partkey mod 1000), in cents, over
    200 000 x SF parts), discount 0.00-0.10, a ship date 1-121 days
    after the order, tax 0.00-0.08, a receipt date 1-30 days after the
    ship date, the return flag 'R' or 'A' at random where the receipt
    date is on or before 1995-06-17 (dbgen's CURRENTDATE) and 'N'
    after it, the line status 'O' where the ship date is after
    1995-06-17 and 'F' otherwise. Each random column is drawn from a
    stream of its own (``SeedSequence(seed).spawn``), so the draws run
    side by side in threads. TPC-H Q4's columns come from streams of
    their own too: the order priority uniform over PRIORITIES, the
    commit date 30-90 days after the order date; and ``o_weight``, a
    FLOAT8 score of three decimals in [0, 1000) that no TPC-H table
    has, the build-side key of the gseg query (phase 9c). Phase 10's
    columns (``phase10_columns``) come last: c_name, o_totalprice and
    o_comment. ``lineitem_only`` returns {"lineitem": ...} with the
    columns Q1 and Q6 read (phase 9d's SF30 table)."""
    n_c = max(int(150_000 * sf), 3)
    n_o = max(int(1_500_000 * sf), 1)
    n_p = max(int(200_000 * sf), 1)
    rng = [np.random.default_rng(s)
           for s in np.random.SeedSequence(seed).spawn(11)]
    odate = rng[0].integers(_day("1992-01-01"), _day("1998-08-02") + 1,
                            n_o).astype(np.int32)
    lines = rng[1].integers(1, 8, n_o)
    i = np.arange(n_o, dtype=np.int64)
    okey = i // 8 * 32 + i % 8 + 1
    oi = np.repeat(i, lines)
    n_l = len(oi)
    d = in_threads({
        "pk": lambda: rng[2].integers(1, n_p + 1, n_l),
        "qty": lambda: rng[3].integers(1, 51, n_l),
        "l_discount": lambda: rng[4].integers(0, 11, n_l).astype(np.int64),
        "ship_after": lambda: rng[5].integers(1, 122, n_l).astype(np.int32),
        "l_tax": lambda: rng[6].integers(0, 9, n_l).astype(np.int64),
        "receipt_after": lambda: rng[7].integers(1, 31, n_l).astype(
            np.int32),
        "coin": lambda: rng[8].random(n_l) < 0.5,
        "l_orderkey": lambda: okey[oi],
        "ship_base": lambda: odate[oi],
    }, workers=8)
    current = _day("1995-06-17")

    def price():
        pk = d["pk"]
        return (d["qty"] * (90_000 + (pk // 10) % 20_001
                            + 100 * (pk % 1000))).astype(np.int64)

    def dates():
        ship = d["ship_base"] + d["ship_after"]
        receipt = ship + d["receipt_after"]
        # 'A' or 'R' where received by CURRENTDATE, else 'N' (RF_VOCAB)
        flag = np.where(receipt <= current, np.where(d["coin"], 0, 2), 1)
        return (ship, receipt, Text(RF_VOCAB, flag.astype(np.int8)),
                Text(LS_VOCAB, (ship > current).astype(np.int8)))

    got = in_threads({"price": price, "dates": dates,
                      "qty": lambda: (d["qty"] * 100).astype(np.int64)})
    ship, receipt, flag, status = got["dates"]
    ep, disc, tax = got["price"], d["l_discount"], d["l_tax"]
    lineitem = {
        "l_orderkey": d["l_orderkey"],
        "l_extendedprice": ep,
        "l_discount": disc,
        "l_shipdate": ship,
        "l_quantity": got["qty"],
        "l_tax": tax,
        "l_receiptdate": receipt,
        "l_returnflag": flag,
        "l_linestatus": status,
    }
    if lineitem_only:
        return {"lineitem": lineitem}
    free = n_c - n_c // 3  # customer keys not divisible by 3
    j = rng[9].integers(0, free, n_o)
    segment = rng[10].integers(0, 5, n_c)
    q4 = q4_columns(odate, oi, seed)
    p10 = phase10_columns(n_c, oi, ep, disc, tax, seed)
    lineitem["l_commitdate"] = q4["l_commitdate"]
    return {
        "customer": {
            "c_custkey": np.arange(1, n_c + 1, dtype=np.int64),
            "c_mktsegment": np.array(SEGMENTS)[segment],
            "c_name": p10["c_name"],
        },
        "orders": {
            "o_orderkey": okey,
            "o_custkey": (j + j // 2 + 1).astype(np.int64),
            "o_orderdate": odate,
            "o_shippriority": np.zeros(n_o, dtype=np.int32),
            "o_orderpriority": q4["o_orderpriority"],
            "o_weight": q4["o_weight"],
            "o_totalprice": p10["o_totalprice"],
            "o_comment": p10["o_comment"],
        },
        "lineitem": lineitem,
    }


PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")


def q4_columns(odate, oi, seed: int) -> dict:
    """The columns make_q3_spec and make_rf1 add for phase 9, each from
    a stream of its own: o_orderpriority (TEXT, uniform over
    PRIORITIES), o_weight (FLOAT8, k / 1000 for k uniform in [0, 10^6))
    and l_commitdate (the order date plus 30-90 days; ``oi`` is each
    line's order)."""
    n_o = len(odate)
    prio = np.random.default_rng(seed + 301).integers(0, 5, n_o)
    weight = np.random.default_rng(seed + 302).integers(0, 10**6, n_o)
    commit = np.random.default_rng(seed + 303).integers(30, 91, len(oi))
    return {
        "o_orderpriority": Text(PRIORITIES, prio.astype(np.int8)),
        "o_weight": weight / 1000.0,
        "l_commitdate": (odate[oi] + commit).astype(np.int32),
    }


# TPC-H rev. 3, section 4.2.2.13: the word lists of the text grammar
# (dbgen's dists.dss), without the terminators ';' and '--', which SQL
# literals would have to carry
_NOUNS = ("foxes", "ideas", "theodolites", "pinto beans", "instructions",
          "dependencies", "excuses", "platelets", "asymptotes", "courts",
          "dolphins", "multipliers", "sauternes", "warthogs", "frets",
          "dinos", "attainments", "somas", "Tiresias", "patterns",
          "forges", "braids", "hockey players", "frays", "warhorses",
          "dugouts", "notornis", "epitaphs", "pearls", "tithes", "waters",
          "orbits", "gifts", "sheaves", "depths", "sentiments", "decoys",
          "realms", "pains", "grouches", "escapades", "packages",
          "requests", "accounts", "deposits")
_VERBS = ("sleep", "wake", "are", "cajole", "haggle", "nag", "use", "boost",
          "affix", "detect", "integrate", "maintain", "nod", "was", "lose",
          "sublate", "solve", "thrash", "promise", "engage", "hinder",
          "print", "x-ray", "breach", "eat", "grow", "impress", "mold",
          "poach", "serve", "run", "dazzle", "snooze", "doze", "unwind",
          "kindle", "play", "hang", "believe", "doubt")
_ADJECTIVES = ("special", "pending", "unusual", "express", "furious", "sly",
               "careful", "blithe", "quick", "fluffy", "slow", "quiet",
               "ruthless", "thin", "close", "dogged", "daring", "brave",
               "stealthy", "permanent", "enticing", "idle", "busy",
               "regular", "final", "ironic", "even", "bold", "silent")
_ADVERBS = ("sometimes", "always", "never", "furiously", "slyly",
            "carefully", "blithely", "quickly", "fluffily", "slowly",
            "quietly", "ruthlessly", "thinly", "closely", "doggedly",
            "daringly", "bravely", "stealthily", "permanently",
            "enticingly", "idly", "busily", "regularly", "finally",
            "ironically", "evenly", "boldly", "silently")
_PREPOSITIONS = ("about", "above", "according to", "across", "after",
                 "against", "along", "alongside of", "among", "around",
                 "at", "atop", "before", "behind", "beneath", "beside",
                 "besides", "between", "beyond", "by", "despite", "during",
                 "except", "for", "from", "in place of", "inside",
                 "instead of", "into", "near", "of", "on", "outside",
                 "over", "past", "since", "through", "throughout", "to",
                 "toward", "under", "until", "up", "upon", "without",
                 "with", "within")
_AUXILIARIES = ("do", "may", "might", "shall", "will", "would", "can",
                "could", "should", "ought to", "must", "will have to",
                "shall have to", "could have to", "should have to",
                "must have to", "need to", "try to")
_TERMINATORS = (".", "?", "!", ":")
# dbgen's weights (dists.dss) where they are not uniform: these nouns
# and adjectives carry most of the text
_WEIGHTS = {"packages": 40, "requests": 40, "accounts": 40, "deposits": 40,
            "foxes": 20, "ideas": 20, "theodolites": 20, "pinto beans": 20,
            "instructions": 20, "dependencies": 10, "excuses": 10,
            "platelets": 10, "asymptotes": 10, "courts": 5, "dolphins": 5,
            "special": 20, "pending": 20, "unusual": 20, "express": 20,
            "regular": 50, "final": 40, "ironic": 40, "even": 30,
            "bold": 20, "silent": 10}
COMMENT_POOL = 65_536  # o_comment's distinct strings (reduced: see PERF.md)


@functools.lru_cache(maxsize=4)
def comment_pool(seed: int, size: int = COMMENT_POOL) -> np.ndarray:
    """``size`` comments as dbgen makes o_comment (section 4.2.2.10): a
    text of grammar sentences (noun phrase, verb phrase, an optional
    prepositional phrase, a terminator), and each comment a substring of
    it, 19-78 characters long from a uniform offset, trimmed."""
    rng = np.random.default_rng(seed)
    cdfs = {}

    def pick(words):
        if words not in cdfs:
            w = np.array([_WEIGHTS.get(x, 1) for x in words], np.float64)
            cdfs[words] = np.cumsum(w) / w.sum()
        return words[int(np.searchsorted(cdfs[words], rng.random(),
                                         side="right"))]

    def noun_phrase():
        k = int(rng.integers(0, 4))
        if k == 0:
            return pick(_NOUNS)
        if k == 1:
            return f"{pick(_ADJECTIVES)} {pick(_NOUNS)}"
        if k == 2:
            return f"{pick(_ADJECTIVES)}, {pick(_ADJECTIVES)} {pick(_NOUNS)}"
        return f"{pick(_ADVERBS)} {pick(_ADJECTIVES)} {pick(_NOUNS)}"

    def verb_phrase():
        k = int(rng.integers(0, 4))
        if k == 0:
            return pick(_VERBS)
        if k == 1:
            return f"{pick(_AUXILIARIES)} {pick(_VERBS)}"
        if k == 2:
            return f"{pick(_VERBS)} {pick(_ADVERBS)}"
        return f"{pick(_AUXILIARIES)} {pick(_VERBS)} {pick(_ADVERBS)}"

    parts, length = [], 0
    while length < size * 40:
        s = f"{noun_phrase()} {verb_phrase()}"
        if rng.random() < 0.5:
            s += f" {pick(_PREPOSITIONS)} the {noun_phrase()}"
        s += pick(_TERMINATORS) + " "
        parts.append(s)
        length += len(s)
    text = "".join(parts)
    lens = rng.integers(19, 79, size)
    starts = rng.integers(0, len(text) - 80, size)
    return np.array([text[a:a + n].strip() for a, n in zip(starts.tolist(),
                                                           lens.tolist())])


def like_mask(values, pattern: str) -> np.ndarray:
    """Which strings match a LIKE pattern of literals and '%' (numpy's
    check of the port's LIKE)."""
    import re

    rx = re.compile("^" + ".*".join(map(re.escape, pattern.split("%")))
                    + "$", re.S)
    return np.array([bool(rx.match(v)) for v in values], dtype=bool)


def order_totals(oi, ep, disc, tax, n_o: int) -> np.ndarray:
    """o_totalprice in cents as dbgen sums it (mk_order): each line's
    extended price less its discount, truncated to cents, plus its tax,
    truncated again, summed over the order's lines."""
    line = (ep * (100 - disc) // 100) * (100 + tax) // 100
    return np.rint(np.bincount(oi, weights=line, minlength=n_o)).astype(
        np.int64)


def phase10_columns(n_c: int, oi, ep, disc, tax, seed: int) -> dict:
    """The columns phase 10 reads that earlier phases did not load, each
    from a stream of its own so every earlier column keeps its values:
    c_name 'Customer#%09d' of the key, o_totalprice from the order's
    lines (``order_totals``), o_comment one of ``comment_pool``'s
    strings, uniform."""
    n_o = int(oi.max()) + 1 if len(oi) else 0
    names = np.array([f"Customer#{k:09d}" for k in range(1, n_c + 1)])
    pick = np.random.default_rng(seed + 401).integers(0, COMMENT_POOL, n_o)
    return {
        "c_name": Text(names, np.arange(n_c, dtype=np.int64)),
        "o_totalprice": order_totals(oi, ep, disc, tax, n_o),
        "o_comment": Text(comment_pool(seed + 402), pick.astype(np.int32)),
    }


RF_VOCAB = ("A", "N", "R")
LS_VOCAB = ("F", "O")
# TPC-H rev. 3 Q1 (section 2.4.1) with its validation DELTA = 90: the
# spec's `interval '90' day (3)`, in the interval syntax both parsers
# take
Q1_SPEC = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice) as sum_base_price, "
    "sum(l_extendedprice*(1-l_discount)) as sum_disc_price, "
    "sum(l_extendedprice*(1-l_discount)*(1+l_tax)) as sum_charge, "
    "avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price, "
    "avg(l_discount) as avg_disc, count(*) as count_order "
    "from lineitem "
    "where l_shipdate <= date '1998-12-01' - interval '90 days' "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)


# TPC-H rev. 3 Q4 (section 2.4.4) with its validation DATE: the spec's
# `date '1993-07-01' + interval '3' month` written as the date it names
# (neither parser takes a month interval)
Q4 = (
    "select o_orderpriority, count(*) as order_count from orders "
    "where o_orderdate >= date '1993-07-01' "
    "and o_orderdate < date '1993-10-01' "
    "and exists (select * from lineitem where l_orderkey = o_orderkey "
    "and l_commitdate < l_receiptdate) "
    "group by o_orderpriority order by o_orderpriority"
)
# its complement: the quarter's orders with no late line (an anti join)
Q4_ANTI = (
    "select count(*) from orders "
    "where o_orderdate >= date '1993-07-01' "
    "and o_orderdate < date '1993-10-01' "
    "and not exists (select * from lineitem where l_orderkey = o_orderkey "
    "and l_commitdate < l_receiptdate)"
)


def expected_q4(orders, lineitem) -> tuple:
    """(Q4's rows, Q4_ANTI's rows) in numpy over the same arrays."""
    late = lineitem["l_commitdate"] < lineitem["l_receiptdate"]
    has = np.isin(orders["o_orderkey"], lineitem["l_orderkey"][late])
    od = orders["o_orderdate"]
    q = (od >= _day("1993-07-01")) & (od < _day("1993-10-01"))
    prio = orders["o_orderpriority"].idx
    rows = [(PRIORITIES[i], int((q & has & (prio == i)).sum()))
            for i in range(len(PRIORITIES))]
    return [r for r in rows if r[1]], [(int((q & ~has).sum()),)]


def _avg32(total: int, scale: int, n: int) -> float:
    """The reference's avg: CAST(sum AS FLOAT8) / CAST(count AS FLOAT8),
    computed FLOAT8 being float32 on its device (a decimal sum divided
    by its scale factor in float64 first)."""
    return float(np.float32(np.float64(total) / scale) / np.float32(n))


def expected_q1_spec(li, m=None) -> list:
    """TPC-H Q1 in numpy over the same arrays: exact scaled-integer sums
    per (return flag, line status) in string order, the averages as the
    reference computes them (``_avg32``). ``m``: the rows that pass, in
    place of Q1's ship-date predicate. The sums are taken over row
    slices in threads and added as Python integers."""
    rf, ls = li["l_returnflag"].idx, li["l_linestatus"].idx
    groups = [(fi, si)
              for fi in sorted(range(len(RF_VOCAB)), key=RF_VOCAB.__getitem__)
              for si in sorted(range(len(LS_VOCAB)),
                               key=LS_VOCAB.__getitem__)]

    def part(sl):
        ms = (li["l_shipdate"][sl] <= _day("1998-09-02") if m is None
              else m[sl])
        out = []
        for fi, si in groups:
            g = ms & (rf[sl] == fi) & (ls[sl] == si)
            q, p = li["l_quantity"][sl][g], li["l_extendedprice"][sl][g]
            d, tx = li["l_discount"][sl][g], li["l_tax"][sl][g]
            disc_price = p * (100 - d)
            out.append((int(g.sum()), int(q.sum()), int(p.sum()),
                        int(d.sum()), int(disc_price.sum()),
                        int((disc_price * (100 + tx)).sum())))
        return out

    parts = over_slices(part, len(rf))
    rows = []
    for j, (fi, si) in enumerate(groups):
        n, sq, sp, sd, sdp, sch = (sum(p[j][k] for p in parts)
                                   for k in range(6))
        if not n:
            continue
        rows.append((
            RF_VOCAB[fi], LS_VOCAB[si], sq / 100, sp / 100, sdp / 10**4,
            sch / 10**6, _avg32(sq, 100, n), _avg32(sp, 100, n),
            _avg32(sd, 100, n), n,
        ))
    return rows


def _key_pos(keys, probe):
    """Each probe value's row in ``keys`` (unique positive integers), -1
    where it has none: a lookup table over the key range (a search of
    the sorted keys would pay a cache miss a step for unsorted probes)."""
    table = np.full(int(keys.max()) + 2, -1, dtype=np.int64)
    table[keys] = np.arange(len(keys))
    return table[np.clip(probe, 0, len(table) - 1)]


def expected_q3(lineitem, orders, customer, building) -> list:
    """Q3 in numpy over the same arrays: each line's order and each
    order's customer by key, the filters, exact revenues (scale 4) per
    order, and the first ten by revenue descending, then order date,
    then order key."""
    cut = _day("1995-03-15")
    cpos = _key_pos(customer["c_custkey"], orders["o_custkey"])
    o_ok = (cpos >= 0) & (customer["c_mktsegment"][cpos] == building) & (
        orders["o_orderdate"] < cut)
    ok_ = orders["o_orderkey"]
    opos = _key_pos(ok_, lineitem["l_orderkey"])
    m = (opos >= 0) & o_ok[opos] & (lineitem["l_shipdate"] > cut)
    rev = lineitem["l_extendedprice"][m] * (100 - lineitem["l_discount"][m])
    # float64 sums are exact here: every order's sum is far below 2^53
    sums = np.rint(np.bincount(opos[m], weights=rev, minlength=len(ok_))
                   ).astype(np.int64)
    has = np.bincount(opos[m], minlength=len(ok_)) > 0
    g = np.nonzero(has)[0]
    top = g[np.lexsort((ok_[g], orders["o_orderdate"][g], -sums[g]))[:10]]
    return [(int(ok_[o]), int(sums[o]) / 10**4,
             str(np.datetime64(int(orders["o_orderdate"][o]), "D")),
             int(orders["o_shippriority"][o])) for o in top]


# bench.py's TPC-H SF100 leg (bench.py:1645): int-typed columns (dates
# as day numbers, prices and discounts as integers), one datanode, the
# three tables round robin; lineitem 2^26 * 9 rows (SF 100.6), which the
# window budget halves evenly into 16 windows, orders a quarter of it
# (dense keys 1..N/4), customer a fortieth
SF100_ROWS = 603_979_776
SF100_DDL = (
    "create table lineitem (l_orderkey int, l_quantity int, "
    "l_extendedprice int, l_discount int, l_shipdate int) "
    "distribute by roundrobin",
    "create table orders (o_orderkey int, o_custkey int, "
    "o_orderdate int, o_shippriority int) distribute by roundrobin",
    "create table customer (c_custkey int, c_mktsegment int) "
    "distribute by roundrobin",
)
SF100_Q6 = (
    "select sum(l_extendedprice * l_discount) from lineitem "
    "where l_shipdate >= 8766 and l_shipdate < 9131 "
    "and l_discount between 5 and 7 and l_quantity < 2400"
)
SF100_Q3 = (
    "select l_orderkey, sum(l_extendedprice * (10 - l_discount)), "
    "o_orderdate, o_shippriority "
    "from customer, orders, lineitem "
    "where c_mktsegment = 0 and c_custkey = o_custkey "
    "and l_orderkey = o_orderkey and o_orderdate < 9204 "
    "and l_shipdate > 9204 "
    "group by l_orderkey, o_orderdate, o_shippriority "
    "order by 2 desc, o_orderdate limit 10"
)


def sf100_domains(n: int) -> dict:
    """Each generated column's [lo, hi) (bench.py's specs_li, specs_ord
    and customer's segment) for ``n`` lineitem rows."""
    no, nc = n // 4, n // 40
    return {
        "lineitem": {
            "l_orderkey": (1, no + 1), "l_quantity": (100, 5100),
            "l_extendedprice": (900, 105001), "l_discount": (0, 11),
            "l_shipdate": (8036, 8036 + 2556)},
        "orders": {
            "o_custkey": (1, nc + 1), "o_orderdate": (8036, 8036 + 2405),
            "o_shippriority": (0, 3)},
        "customer": {"c_mktsegment": (0, 5)},
    }


def make_sf100(n: int, seed: int = 42) -> dict:
    """bench.py's SF100 tables at ``n`` lineitem rows, made from
    ``seed`` with numpy (one stream a column, so each column is the same
    whatever else is made): {table: {column: int32 array}}."""
    out = {"orders": {"o_orderkey": np.arange(1, n // 4 + 1,
                                              dtype=np.int32)},
           "customer": {"c_custkey": np.arange(1, n // 40 + 1,
                                               dtype=np.int32)},
           "lineitem": {}}
    rows = {"lineitem": n, "orders": n // 4, "customer": n // 40}
    cols = [(table, name, lo, hi)
            for table, domains in sf100_domains(n).items()
            for name, (lo, hi) in domains.items()]
    made = in_threads({
        i: functools.partial(np.random.default_rng([seed, i]).integers,
                             lo, hi, rows[table], dtype=np.int32)
        for i, (table, _name, lo, hi) in enumerate(cols)})
    for i, (table, name, _lo, _hi) in enumerate(cols):
        out[table][name] = made[i]
    return out


def expected_sf100_q6(t) -> list:
    li = t["lineitem"]

    def part(sl):
        ship, disc = li["l_shipdate"][sl], li["l_discount"][sl]
        keep = ((ship >= 8766) & (ship < 9131) & (disc >= 5) & (disc <= 7)
                & (li["l_quantity"][sl] < 2400))
        return int(keep.sum()), int(np.sum(
            li["l_extendedprice"][sl][keep].astype(np.int64) * disc[keep]))

    parts = over_slices(part, len(li["l_shipdate"]))
    if not sum(n for n, _s in parts):
        return [(None,)]
    return [(sum(v for _n, v in parts),)]


def expected_sf100_q3(t) -> list:
    """All ten rows of SF100_Q3 in numpy: revenue per order of the lines
    shipped after day 9204 of orders placed before it by segment-0
    customers; ranked by revenue descending, then order date, then order
    key (the device keeps the lowest key on a full tie). Order and
    customer keys are dense from 1, so a key is its row + 1."""
    li, od, cu = t["lineitem"], t["orders"], t["customer"]
    seg0 = np.zeros(len(cu["c_custkey"]) + 1, dtype=bool)
    seg0[cu["c_custkey"][cu["c_mktsegment"] == 0]] = True
    okeep = np.zeros(len(od["o_orderkey"]) + 1, dtype=bool)
    okeep[od["o_orderkey"]] = (od["o_orderdate"] < 9204) & seg0[
        od["o_custkey"]]

    def part(sl):
        ok = li["l_orderkey"][sl]
        m = li["l_shipdate"][sl] > 9204
        m &= okeep[ok]
        return ok[m], li["l_extendedprice"][sl][m].astype(np.int64) * (
            10 - li["l_discount"][sl][m])

    parts = over_slices(part, len(li["l_orderkey"]))
    key = np.concatenate([k for k, _r in parts])
    rev = np.concatenate([r for _k, r in parts])
    # float64 sums are exact: every order's revenue is far below 2^53
    sums = np.rint(np.bincount(key, weights=rev, minlength=len(okeep))
                   ).astype(np.int64)
    g = np.nonzero(np.bincount(key, minlength=len(okeep)))[0]
    date = od["o_orderdate"][g - 1]
    top = np.lexsort((g, date, -sums[g]))[:10]
    return [(int(g[i]), int(sums[g[i]]), int(date[i]),
             int(od["o_shippriority"][g[i] - 1])) for i in top]


# hits' columns the queries here read, typed as ClickBench's create.sql
CLICKBENCH_DDL = (
    "create table hits (UserID bigint, AdvEngineID smallint, "
    "ResolutionWidth smallint, EventDate date) distribute by roundrobin")
# ClickBench queries.sql, the top-10 users by hits
CLICKBENCH_Q = ("SELECT UserID, COUNT(*) FROM hits GROUP BY UserID "
                "ORDER BY COUNT(*) DESC LIMIT 10")
# hits_100m: 99 997 497 rows, 17 630 976 distinct UserIDs
HITS_DISTINCT_SHARE = 17_630_976 / 99_997_497


def make_hits(n: int, users: int, seed: int = 42) -> dict:
    """hits' UserID column: ``users`` distinct ids drawn over the signed
    64-bit range, each in at least one row, the other rows' users drawn
    with Zipf weights (s = 1.1) over a random ranking of the ids, so
    the largest counts are far apart; rows shuffled."""
    rng = np.random.default_rng(seed)
    ids, rows = _hits_users(rng, n, users)
    # the scalar queries' columns, synthetic (drawn after the UserIDs,
    # which stay as they were): AdvEngineID 0 on 99 % of the rows, else
    # one of ADV_ENGINES with Zipf weights; ResolutionWidth one of
    # SCREEN_WIDTHS with their weights; EventDate uniform over July 2013
    adv = np.zeros(n, dtype=np.int32)
    ad = rng.random(n) < 0.01
    w = 1.0 / np.arange(1, len(ADV_ENGINES) + 1)
    adv[ad] = np.array(ADV_ENGINES, np.int32)[
        rng.choice(len(ADV_ENGINES), int(ad.sum()), p=w / w.sum())]
    sw = np.array([wt for _w, wt in SCREEN_WIDTHS], np.float64)
    width = np.array([w_ for w_, _wt in SCREEN_WIDTHS], np.int32)[
        rng.choice(len(SCREEN_WIDTHS), n, p=sw / sw.sum())]
    date = (_day("2013-07-01") + rng.integers(0, 31, n)).astype(np.int32)
    return {"userid": ids[rows], "advengineid": adv,
            "resolutionwidth": width, "eventdate": date}


def _hits_users(rng, n: int, users: int):
    """(the distinct UserIDs, each row's index into them): make_hits'
    UserID draws. The Zipf inversion (a binary search of every row's
    draw in the CDF) runs on the card where there is one: the same
    float64 comparisons, so the same indices as numpy's searchsorted,
    in a fraction of the host's time."""
    import torch

    ids = np.unique(rng.integers(-(2**63), 2**63 - 1, users + users // 100
                                 + 16, dtype=np.int64))
    ids = rng.permutation(ids)[:users]
    cdf = np.cumsum(np.arange(1, users + 1, dtype=np.float64) ** -1.1)
    cdf /= cdf[-1]
    draws = rng.random(n - users)
    if torch.cuda.is_available():
        extra = torch.searchsorted(
            torch.from_numpy(cdf).cuda(), torch.from_numpy(draws).cuda(),
            right=True).cpu().numpy()
    else:
        extra = np.searchsorted(cdf, draws, side="right")
    rows = np.concatenate([np.arange(users), np.minimum(extra, users - 1)])
    rng.shuffle(rows)
    return ids, rows


def make_hits_userids(n: int, users: int, seed: int = 42):
    """make_hits' UserID column alone (the same draws), and the numpy
    top ten of CLICKBENCH_Q from each id's row count (ties by UserID)."""
    ids, rows = _hits_users(np.random.default_rng(seed), n, users)
    counts = np.bincount(rows, minlength=users)
    top = np.lexsort((ids, -counts))[:10]
    return ids[rows], [(int(ids[i]), int(counts[i])) for i in top]


ADV_ENGINES = (2, 3, 4, 8, 12, 13, 16, 17, 21, 22, 27, 30, 32, 35, 41, 48,
               52, 58)
SCREEN_WIDTHS = ((1366, 30), (1920, 20), (1280, 10), (1440, 8), (1600, 6),
                 (1024, 6), (1536, 5), (360, 5), (375, 3), (414, 3),
                 (768, 2), (1680, 1), (2560, 1))
# ClickBench queries.sql Q0, Q1, Q2, Q6 and Q7: single-table scalar and
# small grouped aggregates (Q3, AVG(UserID), is left out: its sum over
# full-range keys overflows int64 in the reference too)
CLICKBENCH_SCALAR_Q = {
    "ClickBench Q0": "SELECT COUNT(*) FROM hits",
    "ClickBench Q1": "SELECT COUNT(*) FROM hits WHERE AdvEngineID <> 0",
    "ClickBench Q2": ("SELECT SUM(AdvEngineID), COUNT(*), "
                      "AVG(ResolutionWidth) FROM hits"),
    "ClickBench Q6": "SELECT MIN(EventDate), MAX(EventDate) FROM hits",
    "ClickBench Q7": ("SELECT AdvEngineID, COUNT(*) FROM hits "
                      "WHERE AdvEngineID <> 0 GROUP BY AdvEngineID "
                      "ORDER BY COUNT(*) DESC"),
}
# what answers each on the port (and on the reference, one device):
# route, and the fragment program's rung (tests/test_torch_fragment.py
# fixes the same at CPU sizes)
FRAGMENT_ROUTES = {
    "TPC-H Q1 (spec)": ("program", ("hash", 64)),
    "ClickBench Q0": ("scan_agg", None),
    "ClickBench Q1": ("scan_agg", None),
    "ClickBench Q2": ("scan_agg", None),
    "ClickBench Q6": ("program", ("scalar", None)),
    "ClickBench Q7": ("program", ("hash", 64)),
}


def expected_clickbench(hits) -> list:
    """The top ten (UserID, count) pairs in numpy: counts by np.unique,
    ties in count by UserID."""
    u, c = np.unique(hits["userid"], return_counts=True)
    top = np.lexsort((u, -c))[:10]
    return [(int(u[i]), int(c[i])) for i in top]


def _date(day: int) -> str:
    return str(np.datetime64(int(day), "D"))


def expected_clickbench_scalar(hits, q: str) -> list:
    """ClickBench ``q`` in numpy over the same arrays; AVG as the
    reference computes an int column's: its partial sum is typed FLOAT8
    (float64) and the count cast to FLOAT8 (float32), divided in
    float64."""
    adv = hits["advengineid"]
    n = len(adv)
    if q == "ClickBench Q0":
        return [(n,)]
    if q == "ClickBench Q1":
        return [(int(np.count_nonzero(adv)),)]
    if q == "ClickBench Q2":
        s = int(hits["resolutionwidth"].sum(dtype=np.int64))
        return [(int(adv.sum(dtype=np.int64)), n,
                 float(np.float64(s) / np.float64(np.float32(n))))]
    if q == "ClickBench Q6":
        d = hits["eventdate"]
        return [(_date(d.min()), _date(d.max()))]
    u, c = np.unique(adv[adv != 0], return_counts=True)
    order = np.lexsort((u, -c))
    return [(int(u[i]), int(c[i])) for i in order]


SSB_DDL = (
    "create table lineorder (lo_orderdate int, lo_quantity int, "
    "lo_discount int, lo_extendedprice bigint) distribute by roundrobin",
    "create table date_dim (d_datekey int, d_year int, d_yearmonthnum int, "
    "d_weeknuminyear int) distribute by replication",
)
SSB_Q = {
    "Q1.1": (
        "select sum(lo_extendedprice * lo_discount) as revenue "
        "from lineorder, date_dim where lo_orderdate = d_datekey "
        "and d_year = 1993 and lo_discount between 1 and 3 "
        "and lo_quantity < 25"
    ),
    "Q1.2": (
        "select sum(lo_extendedprice * lo_discount) as revenue "
        "from lineorder, date_dim where lo_orderdate = d_datekey "
        "and d_yearmonthnum = 199401 and lo_discount between 4 and 6 "
        "and lo_quantity between 26 and 35"
    ),
    "Q1.3": (
        "select sum(lo_extendedprice * lo_discount) as revenue "
        "from lineorder, date_dim where lo_orderdate = d_datekey "
        "and d_weeknuminyear = 6 and d_year = 1994 "
        "and lo_discount between 5 and 7 and lo_quantity between 26 and 35"
    ),
}
# Flights 1-4 in one cluster: every column some flight reads (spec rev. 3,
# section 2; the others are left out, as no scan would upload them).
SSB_FULL_DDL = (
    "create table lineorder (lo_orderdate int, lo_quantity int, "
    "lo_discount int, lo_extendedprice bigint, lo_custkey int, "
    "lo_partkey int, lo_suppkey int, lo_revenue bigint, "
    "lo_supplycost int, lo_orderkey bigint) distribute by roundrobin",
    "create table date_dim (d_datekey int, d_year int, d_yearmonthnum int, "
    "d_weeknuminyear int, d_yearmonth text) distribute by replication",
    "create table part (p_partkey int, p_mfgr text, p_category text, "
    "p_brand1 text) distribute by replication",
    "create table supplier (s_suppkey int, s_city text, s_nation text, "
    "s_region text) distribute by replication",
    "create table customer (c_custkey int, c_city text, c_nation text, "
    "c_region text) distribute by replication",
)
# Flights 2-4 as published (spec rev. 3, section 3), DATE named date_dim.
_F2 = (
    "select sum(lo_revenue), d_year, p_brand1 "
    "from lineorder, date_dim, part, supplier "
    "where lo_orderdate = d_datekey and lo_partkey = p_partkey "
    "and lo_suppkey = s_suppkey and {} "
    "group by d_year, p_brand1 order by d_year, p_brand1"
)
_F3 = (
    "select {g}, d_year, sum(lo_revenue) as revenue "
    "from customer, lineorder, supplier, date_dim "
    "where lo_custkey = c_custkey and lo_suppkey = s_suppkey "
    "and lo_orderdate = d_datekey and {w} "
    "group by {g}, d_year order by d_year asc, revenue desc"
)
_CITIES = ("(c_city = 'UNITED KI1' or c_city = 'UNITED KI5') "
           "and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')")
_F4 = (
    "select {sel}, sum(lo_revenue - lo_supplycost) as profit "
    "from date_dim, customer, supplier, part, lineorder "
    "where lo_custkey = c_custkey and lo_suppkey = s_suppkey "
    "and lo_partkey = p_partkey and lo_orderdate = d_datekey and {w} "
    "group by {g} order by {g}"
)
_MFGR12 = "(p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')"


def _f3(cols, where):
    return _F3.format(w=where, g=", ".join(cols))


SSB_GROUPED_Q = {
    "Q2.1": _F2.format("p_category = 'MFGR#12' and s_region = 'AMERICA'"),
    "Q2.2": _F2.format("p_brand1 between 'MFGR#2221' and 'MFGR#2228' "
                       "and s_region = 'ASIA'"),
    "Q2.3": _F2.format("p_brand1 = 'MFGR#2239' and s_region = 'EUROPE'"),
    "Q3.1": _f3(("c_nation", "s_nation"),
                "c_region = 'ASIA' and s_region = 'ASIA' "
                "and d_year >= 1992 and d_year <= 1997"),
    "Q3.2": _f3(("c_city", "s_city"),
                "c_nation = 'UNITED STATES' and s_nation = 'UNITED STATES' "
                "and d_year >= 1992 and d_year <= 1997"),
    "Q3.3": _f3(("c_city", "s_city"),
                _CITIES + " and d_year >= 1992 and d_year <= 1997"),
    "Q3.4": _f3(("c_city", "s_city"),
                _CITIES + " and d_yearmonth = 'Dec1997'"),
    "Q4.1": _F4.format(sel="d_year, c_nation", g="d_year, c_nation",
                       w="c_region = 'AMERICA' and s_region = 'AMERICA' "
                       "and " + _MFGR12),
    "Q4.2": _F4.format(sel="d_year, s_nation, p_category",
                       g="d_year, s_nation, p_category",
                       w="c_region = 'AMERICA' and s_region = 'AMERICA' "
                       "and (d_year = 1997 or d_year = 1998) and "
                       + _MFGR12),
    "Q4.3": _F4.format(sel="d_year, s_city, p_brand1",
                       g="d_year, s_city, p_brand1",
                       w="c_region = 'AMERICA' "
                       "and s_nation = 'UNITED STATES' "
                       "and (d_year = 1997 or d_year = 1998) "
                       "and p_category = 'MFGR#14'"),
}


def _isin(*vals):
    return lambda a: np.isin(a, vals)


def _eq(v):
    return lambda a: a == v


def _between(lo, hi):
    return lambda a: (a >= lo) & (a <= hi)


# per query: (filters (table, column, test), output columns in select
# order ((table, column) or "sum"), the summed value, ORDER BY as
# (output position, descending))
_CITY2 = _isin("UNITED KI1", "UNITED KI5")
_Y9297 = ("date_dim", "d_year", _between(1992, 1997))
SSB_GROUPED_SPEC = {
    "Q2.1": ([("part", "p_category", _eq("MFGR#12")),
              ("supplier", "s_region", _eq("AMERICA"))],
             ["sum", ("date_dim", "d_year"), ("part", "p_brand1")],
             "revenue", [(1, False), (2, False)]),
    "Q2.2": ([("part", "p_brand1", _between("MFGR#2221", "MFGR#2228")),
              ("supplier", "s_region", _eq("ASIA"))],
             ["sum", ("date_dim", "d_year"), ("part", "p_brand1")],
             "revenue", [(1, False), (2, False)]),
    "Q2.3": ([("part", "p_brand1", _eq("MFGR#2239")),
              ("supplier", "s_region", _eq("EUROPE"))],
             ["sum", ("date_dim", "d_year"), ("part", "p_brand1")],
             "revenue", [(1, False), (2, False)]),
    "Q3.1": ([("customer", "c_region", _eq("ASIA")),
              ("supplier", "s_region", _eq("ASIA")), _Y9297],
             [("customer", "c_nation"), ("supplier", "s_nation"),
              ("date_dim", "d_year"), "sum"],
             "revenue", [(2, False), (3, True)]),
    "Q3.2": ([("customer", "c_nation", _eq("UNITED STATES")),
              ("supplier", "s_nation", _eq("UNITED STATES")), _Y9297],
             [("customer", "c_city"), ("supplier", "s_city"),
              ("date_dim", "d_year"), "sum"],
             "revenue", [(2, False), (3, True)]),
    "Q3.3": ([("customer", "c_city", _CITY2),
              ("supplier", "s_city", _CITY2), _Y9297],
             [("customer", "c_city"), ("supplier", "s_city"),
              ("date_dim", "d_year"), "sum"],
             "revenue", [(2, False), (3, True)]),
    "Q3.4": ([("customer", "c_city", _CITY2),
              ("supplier", "s_city", _CITY2),
              ("date_dim", "d_yearmonth", _eq("Dec1997"))],
             [("customer", "c_city"), ("supplier", "s_city"),
              ("date_dim", "d_year"), "sum"],
             "revenue", [(2, False), (3, True)]),
    "Q4.1": ([("customer", "c_region", _eq("AMERICA")),
              ("supplier", "s_region", _eq("AMERICA")),
              ("part", "p_mfgr", _isin("MFGR#1", "MFGR#2"))],
             [("date_dim", "d_year"), ("customer", "c_nation"), "sum"],
             "profit", [(0, False), (1, False)]),
    "Q4.2": ([("customer", "c_region", _eq("AMERICA")),
              ("supplier", "s_region", _eq("AMERICA")),
              ("date_dim", "d_year", _isin(1997, 1998)),
              ("part", "p_mfgr", _isin("MFGR#1", "MFGR#2"))],
             [("date_dim", "d_year"), ("supplier", "s_nation"),
              ("part", "p_category"), "sum"],
             "profit", [(0, False), (1, False), (2, False)]),
    "Q4.3": ([("customer", "c_region", _eq("AMERICA")),
              ("supplier", "s_nation", _eq("UNITED STATES")),
              ("date_dim", "d_year", _isin(1997, 1998)),
              ("part", "p_category", _eq("MFGR#14"))],
             [("date_dim", "d_year"), ("supplier", "s_city"),
              ("part", "p_brand1"), "sum"],
             "profit", [(0, False), (1, False), (2, False)]),
}
# each dimension's join: (lineorder's foreign key, the dimension's key)
SSB_JOIN_KEYS = {"date_dim": ("lo_orderdate", "d_datekey"),
                 "part": ("lo_partkey", "p_partkey"),
                 "supplier": ("lo_suppkey", "s_suppkey"),
                 "customer": ("lo_custkey", "c_custkey")}


def ssb_positions(tables) -> dict:
    """Each lineorder row's row in every dimension, by key: DATE's keys
    are unique but gapped (a search of the sorted keys), the others
    1..N (the key less one)."""
    lo = tables["lineorder"]
    out = {}
    for dim, (fk, pk) in SSB_JOIN_KEYS.items():
        keys = tables[dim][pk]
        if np.array_equal(keys, np.arange(1, len(keys) + 1)):
            out[dim] = lo[fk].astype(np.int64) - 1
        else:
            order = np.argsort(keys)
            out[dim] = order[np.searchsorted(keys, lo[fk], sorter=order)]
    return out


def expected_ssb_grouped(tables, q: str, pos=None) -> list:
    """Flights 2-4 in numpy over the same arrays: each dimension's filter
    as a mask over its rows gathered through the key join, the grouping
    by np.unique of the passing rows' keys, exact int64 sums, and the
    ORDER BY in Python's order (strings by code point)."""
    pos = pos if pos is not None else ssb_positions(tables)
    lo = tables["lineorder"]
    filters, outs, value, order = SSB_GROUPED_SPEC[q]
    m = np.ones(len(lo["lo_orderdate"]), dtype=bool)
    for dim, col, test in filters:
        m &= test(tables[dim][col])[pos[dim]]
    idx = np.nonzero(m)[0]
    val = lo["lo_revenue"][idx].astype(np.int64)
    if value == "profit":
        val = val - lo["lo_supplycost"][idx]
    keys = [tables[o[0]][o[1]][pos[o[0]][idx]] for o in outs if o != "sum"]
    if not len(idx):
        return []
    inv = np.zeros(len(idx), dtype=np.int64)
    for k in keys:
        _u, ki = np.unique(k, return_inverse=True)
        inv = inv * (ki.max() + 1) + ki.reshape(-1)
    groups, gi = np.unique(inv, return_inverse=True)
    sums = np.zeros(len(groups), dtype=np.int64)
    np.add.at(sums, gi.reshape(-1), val)
    first = np.zeros(len(groups), dtype=np.int64)
    first[gi.reshape(-1)[::-1]] = np.arange(len(idx))[::-1]
    rows = []
    for g in range(len(groups)):
        it = iter(keys)
        rows.append(tuple(
            int(sums[g]) if o == "sum" else _py(next(it)[first[g]])
            for o in outs))
    for p, desc in reversed(order):  # stable: the last key first
        rows.sort(key=lambda r: r[p], reverse=desc)
    return rows


def _py(x):
    return x.item() if isinstance(x, np.generic) else x


# SSB spec rev. 3: DATE has 2556 rows; lineorder's dates span the first
# 2405 of them
SSB_DATES = 2556
SSB_ORDER_DATES = 2405


def make_date_dim():
    """SSB's DATE table (spec rev. 3, section 2): 2556 rows, one a day
    from 1992-01-01 (as SSB's dbgen makes them, so the last is
    1998-12-30), keyed yyyymmdd; the five columns flights 1-4 read. The
    week number counts 7-day runs from January 1 (1-53); d_yearmonth is
    the month's abbreviation and the year ('Dec1997')."""
    days = np.datetime64("1992-01-01") + np.arange(SSB_DATES)
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    mday = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    yday = (days - days.astype("datetime64[Y]")).astype(np.int64) + 1
    return {
        "d_datekey": (year * 10000 + month * 100 + mday).astype(np.int32),
        "d_year": year.astype(np.int32),
        "d_yearmonthnum": (year * 100 + month).astype(np.int32),
        "d_weeknuminyear": ((yday - 1) // 7 + 1).astype(np.int32),
        "d_yearmonth": _tight(np.char.add(
            np.array(MONTHS)[month - 1], year.astype(str))),
    }


MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
          "Oct", "Nov", "Dec")


def make_lineorder(n: int, date_dim, seed: int = 42, dims=None):
    """SSB lineorder's columns from ``seed``: flight 1's four (an order
    date uniform over the first 2405 dates, quantity 1-50, discount
    0-10, the extended price as quantity times a retail price in
    [90000, 209999]), then the five flights 2-4 read: customer, part and
    supplier keys uniform over each dimension's keys (``dims``: their
    row counts, ``ssb_dim_rows`` of n's scale factor by default), the
    revenue extendedprice * (100 - discount) / 100 and the supply cost
    6/10 of the retail price (dbgen's rules), and the order key, orders
    of 1-7 lines in key order as dbgen writes them (drawn from a stream
    of their own, phase 8's DELETE reads them). Flight 1's columns are
    the same for a seed whatever follows them."""
    # a third more orders than the mean needs: their lines cover n rows
    lines = np.random.default_rng(seed + 7).integers(1, 8, n // 3 + 8)
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, n).astype(np.int32)
    keys = date_dim["d_datekey"][:SSB_ORDER_DATES]
    orderdate = keys[rng.integers(0, SSB_ORDER_DATES, n)]
    disc = rng.integers(0, 11, n).astype(np.int32)
    retail = rng.integers(90_000, 210_000, n)
    price = qty.astype(np.int64) * retail
    dims = dims or ssb_dim_rows(n / SSB_LINEORDER_SF1)
    return {
        "lo_orderdate": orderdate,
        "lo_quantity": qty,
        "lo_discount": disc,
        "lo_extendedprice": price,
        "lo_custkey": rng.integers(1, dims["customer"] + 1, n).astype(
            np.int32),
        "lo_partkey": rng.integers(1, dims["part"] + 1, n).astype(np.int32),
        "lo_suppkey": rng.integers(1, dims["supplier"] + 1, n).astype(
            np.int32),
        "lo_revenue": price * (100 - disc) // 100,
        "lo_supplycost": (retail * 6 // 10).astype(np.int32),
        "lo_orderkey": np.repeat(np.arange(1, len(lines) + 1), lines)[:n],
    }


# SSB spec rev. 3, section 2: rows at scale factor SF (lineorder 6 M x SF)
SSB_LINEORDER_SF1 = 6_000_000
# TPC-H's 25 nations and their regions (SSB's supplier and customer draw
# one each)
SSB_NATIONS = (
    ("ALGERIA", "AFRICA"), ("ARGENTINA", "AMERICA"), ("BRAZIL", "AMERICA"),
    ("CANADA", "AMERICA"), ("EGYPT", "MIDDLE EAST"), ("ETHIOPIA", "AFRICA"),
    ("FRANCE", "EUROPE"), ("GERMANY", "EUROPE"), ("INDIA", "ASIA"),
    ("INDONESIA", "ASIA"), ("IRAN", "MIDDLE EAST"), ("IRAQ", "MIDDLE EAST"),
    ("JAPAN", "ASIA"), ("JORDAN", "MIDDLE EAST"), ("KENYA", "AFRICA"),
    ("MOROCCO", "AFRICA"), ("MOZAMBIQUE", "AFRICA"), ("PERU", "AMERICA"),
    ("CHINA", "ASIA"), ("ROMANIA", "EUROPE"),
    ("SAUDI ARABIA", "MIDDLE EAST"), ("VIETNAM", "ASIA"),
    ("RUSSIA", "EUROPE"), ("UNITED KINGDOM", "EUROPE"),
    ("UNITED STATES", "AMERICA"),
)


def ssb_dim_rows(sf: float) -> dict:
    """Dimension rows at scale factor ``sf`` (spec rev. 3, section 2):
    part 200 000 x floor(1 + log2 SF), supplier 2 000 x SF, customer
    30 000 x SF; below SF 1 each in proportion to lineorder."""
    part = (200_000 * int(1 + np.log2(sf)) if sf >= 1
            else max(1, round(200_000 * sf)))
    return {"part": part, "supplier": max(1, round(2_000 * sf)),
            "customer": max(1, round(30_000 * sf))}


def make_part(n: int, seed: int = 42):
    """SSB PART's columns the flights read: key 1..n, p_mfgr MFGR#1-5,
    p_category the mfgr and a digit 1-5, p_brand1 the category and a
    number 1-40 (so 'MFGR#2221' is category MFGR#22, brand 21), as
    strings in numpy arrays."""
    rng = np.random.default_rng(seed)
    mfgr = rng.integers(1, 6, n)
    cat = rng.integers(1, 6, n)
    brand = rng.integers(1, 41, n)
    mf = _tight(np.char.add("MFGR#", mfgr.astype(str)))
    ca = _tight(np.char.add(mf, cat.astype(str)))
    return {
        "p_partkey": np.arange(1, n + 1, dtype=np.int32),
        "p_mfgr": mf,
        "p_category": ca,
        "p_brand1": _tight(np.char.add(ca, brand.astype(str))),
    }


def _tight(a):
    """A numpy string array at the width of its longest value."""
    return a.astype(f"U{max(1, int(np.char.str_len(a).max(initial=1)))}")


def _geo(n: int, rng, prefix: str):
    """City, nation and region of n suppliers or customers: a nation
    uniform over the 25, its region, and a city that is the nation's
    name cut or padded to 9 characters and a digit 0-9 (dbgen's
    '%-9.9s%d', so 'UNITED KI1')."""
    nat = rng.integers(0, len(SSB_NATIONS), n)
    names = np.array([a for a, _ in SSB_NATIONS])
    regions = np.array([b for _, b in SSB_NATIONS])
    stem = np.array([f"{a[:9]:<9}" for a, _ in SSB_NATIONS])
    city = _tight(np.char.add(stem[nat], rng.integers(0, 10, n).astype(str)))
    return {f"{prefix}_city": city, f"{prefix}_nation": names[nat],
            f"{prefix}_region": regions[nat]}


def make_supplier(n: int, seed: int = 42):
    rng = np.random.default_rng(seed)
    return {"s_suppkey": np.arange(1, n + 1, dtype=np.int32),
            **_geo(n, rng, "s")}


def make_customer(n: int, seed: int = 42):
    rng = np.random.default_rng(seed)
    return {"c_custkey": np.arange(1, n + 1, dtype=np.int32),
            **_geo(n, rng, "c")}


def make_ssb(n: int, seed: int = 42) -> dict:
    """All five SSB tables flights 1-4 read, for a lineorder of n rows
    (the dimensions at n's scale factor), each from its own stream of
    ``seed``."""
    dims = ssb_dim_rows(n / SSB_LINEORDER_SF1)
    dd = make_date_dim()
    return {
        "lineorder": make_lineorder(n, dd, seed, dims),
        "date_dim": dd,
        "part": make_part(dims["part"], seed + 1),
        "supplier": make_supplier(dims["supplier"], seed + 2),
        "customer": make_customer(dims["customer"], seed + 3),
    }


def expected_ssb(lo, dd, q: str) -> list:
    """Flight 1's answer in numpy over the same arrays: each order date's
    DATE row by its (unique) key, the filters, the exact int64 sum."""
    order = np.argsort(dd["d_datekey"])
    pos = order[np.searchsorted(dd["d_datekey"], lo["lo_orderdate"],
                                sorter=order)]
    year, ym, week = (dd[c][pos] for c in (
        "d_year", "d_yearmonthnum", "d_weeknuminyear"))
    disc, qty = lo["lo_discount"], lo["lo_quantity"]
    m = {
        "Q1.1": (year == 1993) & (disc >= 1) & (disc <= 3) & (qty < 25),
        "Q1.2": (ym == 199401) & (disc >= 4) & (disc <= 6)
        & (qty >= 26) & (qty <= 35),
        "Q1.3": (week == 6) & (year == 1994) & (disc >= 5) & (disc <= 7)
        & (qty >= 26) & (qty <= 35),
    }[q]
    if not m.any():
        return [(None,)]
    return [(int(np.sum(lo["lo_extendedprice"][m] * disc[m])),)]


def bulk_append(cluster, table: str, arrays) -> int:
    """Pre-sharded append straight into the stores at one commit
    timestamp (bench.py's _bulk_append): a replicated table gets every
    row on every replica. Returns the commit timestamp."""
    from opentenbase_tpu_torch.storage.column import Column
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    meta = cluster.catalog.get(table)
    arrays = {name: encode_text(meta, name, arrays[name])
              for name in meta.schema}
    n = len(next(iter(arrays.values())))
    nn = len(meta.node_indices)
    commit_ts = cluster.gts.get_gts()
    for i, node in enumerate(meta.node_indices):
        sl = (
            slice(0, n) if meta.dist.is_replicated
            else slice(i * n // nn, (i + 1) * n // nn)
        )
        cols = {
            name: Column(meta.schema[name], arrays[name][sl],
                         None, meta.dictionaries.get(name))
            for name in meta.schema
        }
        batch = ColumnBatch(cols, sl.stop - sl.start)
        cluster.stores[node][table].append_batch(batch, commit_ts)
    return commit_ts


class ExtStore:
    """Planner and version stub for a device-resident external table
    (bench.py's _ExtStore): no host rows, the device cache holds the
    data (``DeviceCache.register_external``)."""

    def __init__(self, nrows: int):
        self.nrows = nrows
        self.version = 1
        self.structure_version = 0
        self.mvcc_seq = 0


def sf100_stats(n: int) -> dict:
    """The optimizer stats bench.py gives the SF100 tables (what ANALYZE
    would produce) at ``n`` lineitem rows."""
    no, nc = n // 4, n // 40
    return {
        "lineitem": {"rows": n,
                     "ndv": {"l_orderkey": no, "l_shipdate": 2556}},
        "orders": {"rows": no, "ndv": {"o_orderkey": no, "o_custkey": nc}},
        "customer": {"rows": nc,
                     "ndv": {"c_custkey": nc, "c_mktsegment": 5}},
    }


def register_sf100(cluster, tables: dict) -> None:
    """bench.py's SF100 registration: the DDL, a stub store and the
    stats per table, and each table's columns ({column: [n] tensor on
    the cluster's device}) handed to the device cache as one [1, n]
    external table."""
    s = cluster.session()
    for ddl in SF100_DDL:
        s.execute(ddl)
    fx = cluster.fused_executor()
    stats = sf100_stats(len(tables["lineitem"]["l_orderkey"]))
    for table, cols in tables.items():
        meta = cluster.catalog.get(table)
        node = meta.node_indices[0]
        rows = len(next(iter(cols.values())))
        cluster.stores[node][table] = ExtStore(rows)
        meta.stats = stats[table]
        fx.cache.register_external(
            table, meta, (node,), {c: a.reshape(1, rows)
                                   for c, a in cols.items()}, [rows])


def encode_text(meta, name: str, arr):
    """A TEXT column's strings as codes into the table's dictionary,
    minted in order of first appearance, as row-by-row inserts would
    mint them (so code order is not string order); other columns pass
    through."""
    dic = meta.dictionaries.get(name)
    if dic is None:
        return arr
    if isinstance(arr, Text):
        # the vocabulary entries in order of their first row
        used, first = np.unique(arr.idx, return_index=True)
        seen = used[np.argsort(first)]
        codes = np.zeros(len(arr.vocab), dtype=np.int32)
        codes[seen] = dic.encode(arr.vocab[seen].tolist())
        return codes[arr.idx]
    vocab, first, inv = np.unique(arr, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first)
    codes = np.empty(len(vocab), dtype=np.int32)
    codes[order] = dic.encode(vocab[order].tolist())
    return codes[inv.reshape(-1)]


def _day(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def q6_revenue(a, lo: str = "1994-01-01", hi: str = "1995-01-01",
               dlo: int = 5, dhi: int = 7, qty: int = 2400):
    """Q6's sum(l_extendedprice * l_discount) over ``a`` in the columns'
    integer units (None where no row qualifies), over row slices in
    threads; the spec's parameters unless others are given (the
    discounts and the quantity in hundredths)."""
    def part(sl):
        ship, disc = a["l_shipdate"][sl], a["l_discount"][sl]
        m = ((ship >= _day(lo)) & (ship < _day(hi))
             & (disc >= dlo) & (disc <= dhi) & (a["l_quantity"][sl] < qty))
        return int(m.sum()), int(np.sum(a["l_extendedprice"][sl][m]
                                        * disc[m]))

    parts = over_slices(part, len(a["l_shipdate"]))
    if not sum(n for n, _s in parts):
        return None
    return sum(v for _n, v in parts)


def expected_q6(a) -> list:
    s = q6_revenue(a)
    return [(None if s is None else s / 10**4,)]


def expected_q1(a) -> list:
    m = a["l_shipdate"] <= _day("1998-09-02")
    rows = []
    for f in np.unique(a["l_returnflag"][m]):
        for st in np.unique(a["l_linestatus"][m]):
            g = m & (a["l_returnflag"] == f) & (a["l_linestatus"] == st)
            if not g.any():
                continue
            price = a["l_extendedprice"][g]
            rows.append((
                int(f), int(st),
                int(a["l_quantity"][g].sum()) / 100,
                int(price.sum()) / 100,
                int((price * a["l_discount"][g]).sum()) / 10**4,
                int(g.sum()),
            ))
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def hbm_rate(name: str) -> float:
    if name not in HBM_RATE:
        raise RuntimeError(f"no HBM rate known for {name!r}")
    return HBM_RATE[name]


def _cuda_ms(fn, iters: int) -> float:
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_cases(device, seed: int):
    """(name, cols, xmin, xmax, nrows, snap, spec) cases covering the
    kernel's branches: column widths, G=1/G=6, compact and full MVCC
    planes with invisible rows (and a run hidden mid-tile), shards whose
    nrows is no tile multiple, shorter than a tile or empty, a spec with
    no predicate, and the widest spec compile_spec accepts."""
    import torch

    from opentenbase_tpu_torch import types as t
    from opentenbase_tpu_torch.ops import scan_agg as sa
    from opentenbase_tpu_torch.plan import texpr as E

    rng = np.random.default_rng(seed)
    S, R = 3, 1 << 16
    nrows = np.array([R - 123, 0, 40_000], dtype=np.int64)
    c0 = rng.integers(-5000, 5000, (S, R)).astype(np.int32)
    c1 = rng.integers(0, 9_000_000, (S, R)).astype(np.int64)
    c2 = rng.integers(0, 3, (S, R)).astype(np.int32)
    c3 = rng.integers(0, 2, (S, R)).astype(np.int64)
    c4 = rng.integers(0, 2, (S, R)).astype(np.bool_)
    cols = [torch.from_numpy(c).to(device) for c in (c0, c1, c2, c3, c4)]

    def C(i, ty=t.INT8):
        return E.Col(i, ty)

    def K(v, ty=t.INT8):
        return E.Const(v, ty)

    pred = E.BinE(
        "or",
        E.BinE("and", E.BinE(">=", C(0, t.INT4), K(-1000), t.BOOL),
               E.BinE("<", C(1), K(7_000_000), t.BOOL), t.BOOL),
        E.UnaryE("not", E.InListE(C(2, t.INT4), (K(1), K(2)), False), t.BOOL),
        t.BOOL,
    )
    key = sa.key_expr_from_decoders(
        [(2, 0, 3, 1), (3, 0, 2, 3)], [C(2, t.INT4), C(3)]
    )
    vals = [
        E.BinE("*", C(1), C(2, t.INT4), t.INT8),
        E.UnaryE("-", C(0, t.INT4), t.INT8),
        E.BinE("+", C(4, t.BOOL), K(7), t.INT8),
    ]
    grouped = sa.compile_spec([pred], key, vals, 6)
    scalar = sa.compile_spec(
        [E.BinE("<>", C(3), K(1), t.BOOL)],
        None, [E.BinE("-", C(1), C(0, t.INT4), t.INT8)],
    )
    # MVCC: compact planes with shard 2 invisible; full planes with a
    # third of the rows inserted after the snapshot and some deleted
    snap = 1000
    xmin_c = torch.tensor([[10], [2000], [2000]], dtype=torch.int64)
    xmax_c = torch.full((S, 1), 2**62, dtype=torch.int64)
    xmin_f = torch.from_numpy(
        rng.choice([5, 1000, 1500], (S, R)).astype(np.int64))
    xmax_f = torch.from_numpy(
        rng.choice([2**62, 2**62, 900, 1000, 1001], (S, R)).astype(np.int64))
    # full planes hiding a run of rows in the middle of the first tiles
    xmin_m = torch.full((S, R), 5, dtype=torch.int64)
    xmin_m[:, 1000:1500] = 1500
    xmax_m = torch.full((S, R), 2**62, dtype=torch.int64)
    xmax_m[:, 3001:3077] = 1000
    nr = torch.from_numpy(nrows).to(device)
    out = []
    for pname, xmin, xmax in (("compact", xmin_c, xmax_c),
                              ("full", xmin_f, xmax_f)):
        for sname, spec in (("G6", grouped), ("G1", scalar)):
            sel = [cols[i] for i in spec.cols]
            out.append((f"{sname}/{pname}", sel, xmin.to(device),
                        xmax.to(device), nr, snap, spec))
    sel = [cols[i] for i in grouped.cols]
    out.append(("G6/rows hidden mid-tile", sel, xmin_m.to(device),
                xmax_m.to(device), nr, snap, grouped))
    # shards shorter than a tile (and one empty)
    short = torch.tensor([100, 0, 1], dtype=torch.int64, device=device)
    out.append(("G6/short shards", sel, xmin_c.to(device),
                xmax_c.to(device), short, snap, grouped))
    # no predicate: every visible row is counted
    nopred = sa.compile_spec([], key, vals[:2], 6)
    out.append(("G6/no predicate", [cols[i] for i in nopred.cols],
                xmin_f.to(device), xmax_f.to(device), nr, snap, nopred))
    # the widest spec compile_spec accepts: 16 columns (int64, int32,
    # bool), a predicate of stack depth 16, 16 groups, 8 values (one of
    # depth 16, so the value programs run one after another)
    wide = [rng.integers(-1000, 1000, (S, R)).astype(np.int64)
            for _ in range(10)]
    wide += [rng.integers(0, 4, (S, R)).astype(np.int32) for _ in range(2)]
    wide += [rng.integers(-7, 7, (S, R)).astype(np.int32) for _ in range(2)]
    wide += [rng.integers(0, 2, (S, R)).astype(np.bool_) for _ in range(2)]
    wcols = [torch.from_numpy(c).to(device) for c in wide]
    tys = [t.INT8] * 10 + [t.INT4] * 4 + [t.BOOL] * 2

    def chain(idx):  # c[i0] + (c[i1] + (...)): stack depth len(idx)
        e = C(idx[-1], tys[idx[-1]])
        for i in reversed(idx[:-1]):
            e = E.BinE("+", C(i, tys[i]), e, t.INT8)
        return e

    wpred = E.BinE(">", chain(list(range(16))), K(-2000), t.BOOL)
    wkey = sa.key_expr_from_decoders(
        [(10, 0, 4, 1), (11, 0, 4, 4)], [C(10, t.INT4), C(11, t.INT4)])
    wvals = [C(i, tys[i]) for i in (0, 12, 14)] + [
        E.BinE("*", C(1), C(13, t.INT4), t.INT8),
        E.UnaryE("-", C(2), t.INT8),
        E.BinE("-", C(3), K(5), t.INT8),
        E.BinE("*", C(4), C(5), t.INT8),
        chain([6, 7, 8, 9, 0, 1, 2, 3, 4, 5, 12, 13, 14, 15, 10, 11]),
    ]
    widest = sa.compile_spec([wpred], wkey, wvals, 16)
    assert widest.pred_depth == 16 and widest.n_values == 8
    for pname, xmin, xmax in (("compact", xmin_c, xmax_c),
                              ("full", xmin_f, xmax_f)):
        out.append((f"widest G16xE8 depth 16/{pname}",
                    [wcols[i] for i in widest.cols], xmin.to(device),
                    xmax.to(device), nr, snap, widest))
    # full planes at the GTM's hybrid magnitude (about 2^60.7: wall ms
    # << 20): stamps one apart around the snapshot, the deletes of a
    # prepared transaction at RESERVED_TS (2^62 - 1), and deletes
    # stamped just above the snapshot (still visible)
    hsnap = HYBRID_SNAP
    xmin_h = torch.from_numpy(rng.choice(
        [hsnap - (5 << 20), hsnap - 1, hsnap, hsnap + 1],
        (S, R)).astype(np.int64))
    xmax_h = torch.from_numpy(rng.choice(
        [2**62, 2**62, 2**62 - 1, hsnap + 1, hsnap + (3 << 20), hsnap,
         hsnap - 1], (S, R)).astype(np.int64))
    for sname, spec in (("G6", grouped), ("G1", scalar)):
        out.append((f"{sname}/full, hybrid timestamps and RESERVED_TS",
                    [cols[i] for i in spec.cols], xmin_h.to(device),
                    xmax_h.to(device), nr, hsnap, spec))
    return out


# a snapshot as the GTM issues them: wall-clock ms of 2029-07-29 << 20
# logical bits (about 2^60.7), fixed so the case is the same every run
HYBRID_SNAP = 1_880_000_000_000 << 20


def full_plane_case(device, seed: int, rows: int):
    """K1 at a main path's scale over full MVCC planes, as a table has
    them after a commit: TPC-H Q6's predicate and product over ``rows``
    rows in 2 shards (int64 price, discount and quantity, int32 dates,
    made on the card from ``seed``), about 0.1 % of the rows hidden,
    half in runs of 1000 deleted rows and half scattered (deleted, or
    inserted after the snapshot)."""
    import torch

    from opentenbase_tpu_torch import types as t
    from opentenbase_tpu_torch.ops import scan_agg as sa
    from opentenbase_tpu_torch.plan import texpr as E

    S, n = 2, rows // 2
    R = 1 << max(n - 1, 1).bit_length()
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(lo, hi, size, dtype=torch.int64):
        return torch.randint(lo, hi, size, generator=g, device=device,
                             dtype=dtype)

    date = draw(8036, 8036 + 2556, (S, R), torch.int32)
    disc = draw(0, 11, (S, R))
    qty = draw(100, 5100, (S, R))
    price = draw(90_000, 10_500_000, (S, R))
    xmin = torch.full((S, R), 5, dtype=torch.int64, device=device)
    xmax = torch.full((S, R), 2**62, dtype=torch.int64, device=device)
    hidden = max(rows // 1000, 2)
    run = 1000
    for st, sh in zip(draw(0, max(n - run, 1), (hidden // 2 // run,)).tolist(),
                      draw(0, S, (hidden // 2 // run,)).tolist()):
        xmax[sh, st:st + run] = 1000  # deleted before the snapshot
    k = hidden // 2
    pos, sh = draw(0, n, (k,)), draw(0, S, (k,))
    xmax[sh[: k // 2], pos[: k // 2]] = 900
    xmin[sh[k // 2:], pos[k // 2:]] = 1500  # inserted after it
    nr = torch.full((S,), n, dtype=torch.int64, device=device)

    def C(i, ty=t.INT8):
        return E.Col(i, ty)

    def K(v):
        return E.Const(v, t.INT8)

    def both(a, b):
        return E.BinE("and", a, b, t.BOOL)

    pred = both(
        both(E.BinE(">=", C(0, t.INT4), K(8766), t.BOOL),
             E.BinE("<", C(0, t.INT4), K(9131), t.BOOL)),
        both(both(E.BinE(">=", C(1), K(5), t.BOOL),
                  E.BinE("<=", C(1), K(7), t.BOOL)),
             E.BinE("<", C(2), K(2400), t.BOOL)))
    spec = sa.compile_spec([pred], None, [E.BinE("*", C(3), C(1), t.INT8)])
    planes = [date, disc, qty, price]
    visible = int(((xmin <= 1000) & (1000 < xmax)).sum()) - S * (R - n)
    return (f"G1/Q6 over {S * n} rows, full planes, "
            f"{S * n - visible} hidden in runs and scattered",
            [planes[i] for i in spec.cols], xmin, xmax, nr, 1000, spec)


def check_kernel_vs_plain(device, seed: int, card: str,
                          rows: int | None = None) -> None:
    import torch

    from opentenbase_tpu_torch.ops import scan_agg as sa

    n0 = sa.scan_agg.launches
    cases = kernel_cases(device, seed)
    if rows:
        cases.append(full_plane_case(device, seed, rows))
    for name, cols, xmin, xmax, nr, snap, spec in cases:
        ks, kc = sa.scan_agg(cols, xmin, xmax, nr, snap, spec)
        ps, pc = sa.scan_agg_plain(cols, xmin, xmax, nr, snap, spec)
        torch.cuda.synchronize()
        if not (torch.equal(ks, ps) and torch.equal(kc, pc)):
            raise AssertionError(f"scan_agg {name}: kernel != plain")
        if int(kc.sum()) == 0:
            raise AssertionError(f"scan_agg {name}: no row passed")
        plan = sa.launch_plan(spec, [c.element_size() for c in cols],
                              xmin.shape[1] != 1)
        print(f"kernel vs plain: scan_agg {name} equal (rows passed "
              f"{int(kc.sum())}; depth {plan.depth}, tile {plan.tile}, "
              f"{plan.stages} stages, {plan.smem_bytes} B shared) [{card}]",
              flush=True)
    sa.scan_agg.launches = n0  # comparison launches are not counted


# ---------------------------------------------------------------------------
# phase 4/5: the main path
# ---------------------------------------------------------------------------


def run_main_path(args, device, card: str) -> dict:
    import torch

    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    t0 = time.perf_counter()
    arrays = make_lineitem(args.rows, args.seed)
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    s.execute(LINEITEM_DDL)
    bulk_append(cluster, "lineitem", arrays)
    print(f"load: {args.rows} rows in 2 datanodes, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    want = {"Q6": expected_q6(arrays), "Q1": expected_q1(arrays)}

    first_ms, launches, k2 = {}, {}, {}
    for q, sql in (("Q6", Q6), ("Q1", Q1)):
        sa.scan_agg.launches = 0
        rp.radix_probe.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        first_ms[q] = (time.perf_counter() - t1) * 1000
        launches[q] = sa.scan_agg.launches
        k2[q] = rp.radix_probe.launches
        if got != want[q]:
            raise AssertionError(f"{q}: port {got} != numpy {want[q]}")
        if launches[q] != 1:
            raise AssertionError(
                f"{q}: scan_agg launched {launches[q]} times, want 1")
        print(f"main path: {q} exact through the kernel (scan_agg "
              f"launches {launches[q]}; first run incl. upload "
              f"{first_ms[q]:.3f} ms) {got[:2]}... [{card}]", flush=True)

    e2e = {}
    for q, sql in (("Q6", Q6), ("Q1", Q1)):
        ts = []
        for _ in range(args.repeats):
            t1 = time.perf_counter()
            got = s.query(sql)
            ts.append((time.perf_counter() - t1) * 1000)
            if got != want[q]:
                raise AssertionError(f"{q}: answer changed between runs")
        e2e[q] = statistics.median(ts)
        print(f"end to end: {q} median {e2e[q]:.3f} ms over "
              f"{args.repeats} runs, {args.rows / e2e[q] * 1e3:.4g} rows/s "
              f"[{card}]", flush=True)
    breakdown = {q: layer_breakdown(cluster, sql, args.repeats)
                 for q, sql in (("Q6", Q6), ("Q1", Q1))}
    for q, b in breakdown.items():
        print(f"layers: {q} median ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in b.items()) + f" [{card}]", flush=True)
    trace = {}
    for q, sql in (("Q6", Q6), ("Q1", Q1)):
        trace[q] = trace_query(s, sql, args.repeats)
        tr = trace[q]
        idle = ("not measured (no device events in the trace)"
                if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
        print(f"trace: {q} one query under torch.profiler, median of "
              f"{args.repeats}: host {tr['wall_ms']:.3f} ms, device busy "
              f"{tr['busy_ms']:.3f} ms, idle share {idle}; device events "
              f"{tr['events']} [{card}]", flush=True)
    return {"cluster": cluster, "e2e": e2e, "launches": launches,
            "breakdown": breakdown, "trace": trace, "arrays": arrays,
            "k2_launches": k2}


def trace_query(session, sql: str, repeats: int, before=None,
                warm: bool = True) -> dict:
    """Device busy time and idle share of single warm queries, each
    traced alone: busy is the union of the device intervals (kernels,
    copies, fills) in a torch.profiler trace of one Session.query, and
    the share is taken against the host clock around that same query,
    which the profiler's own host work lengthens. The run returned is
    the median of those whose trace holds device activity (of all of
    them where none does). ``before``, if given, runs before each query,
    untraced; ``warm`` False skips the untimed first trace (the tracer
    already started in this process)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    before = before or (lambda: None)
    if warm:
        before()
        with profile(activities=acts):  # the tracer's start-up, untimed
            session.query(sql)
    runs = []
    for _ in range(repeats):
        before()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            session.query(sql)
            t1 = time.perf_counter()
        dev = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        busy_us, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in dev):
            if b > end:
                busy_us += b - max(a, end)
                end = b
        by_kind: dict = {}
        for e in dev:  # device ms by kind, the name cut at its template
            k = e.name.split("<")[0].split("(")[0][:60]
            by_kind[k] = by_kind.get(k, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
        wall = (t1 - t0) * 1e3
        runs.append({
            "wall_ms": wall, "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall if dev else None,
            "events": sorted({e.name for e in dev}),
            "top": sorted(by_kind.items(), key=lambda kv: -kv[1])[:5],
        })
    # the profiler sometimes records no device activity for a run
    runs = [r for r in runs if r["events"]] or runs
    runs.sort(key=lambda r: r["wall_ms"])
    return runs[len(runs) // 2]


def layer_breakdown(cluster, sql: str, repeats: int, dag: bool = False):
    """Median ms of one warm query's layers, each timed on its own:
    parse + analyze + optimize + distribute on the host; the device path
    on the host clock — the fused fragment (K1's route) or, with ``dag``,
    the fused DAG (device-cache hit, program, launches, the copies back
    to the host); the coordinator merge (on the device ``merge_device``
    picks, as the session's); and the device time of the device path
    from CUDA events around it."""
    import torch

    from opentenbase_tpu_torch.engine import merge_device
    from opentenbase_tpu_torch.executor.local import LocalExecutor
    from opentenbase_tpu_torch.plan import analyze_statement
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse_one

    fx = cluster.fused_executor()
    cat = cluster.catalog
    host, dev = ("dag", "dag_device") if dag else (
        "fragment", "fragment_device")
    out = {"plan": [], host: [], dev: [], "merge": []}
    s = cluster.session()
    for _ in range(repeats):
        t0 = time.perf_counter()
        # the session's rewrites (SQL functions, WITH, views) first
        stmt = s._expand_views(s._expand_functions(parse_one(sql)))
        dplan = distribute_statement(optimize_statement(
            analyze_statement(stmt, cat), cat), cat)
        t1 = time.perf_counter()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        snap = cluster.gts.snapshot_ts()
        a.record()
        if dag:
            idx, part = fx.dag_output(dplan, snap)
        else:
            idx, part = 0, fx.fragment_output(dplan.fragments[0], snap)
        b.record()
        t2 = time.perf_counter()
        LocalExecutor(cat, {idx: part}, device=merge_device(
            cluster, part.nrows)).run_plan(dplan.root)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        out["plan"].append((t1 - t0) * 1e3)
        out[host].append((t2 - t1) * 1e3)
        out[dev].append(a.elapsed_time(b))
        out["merge"].append((t3 - t2) * 1e3)
    return {k: statistics.median(v) for k, v in out.items()}


def time_kernels(main: dict, card: str, rate: float) -> list:
    """Kernel, plain-version and bound times at the main path's shapes:
    the resident lineitem planes and the specs Q6 and Q1 compiled."""
    import torch

    from opentenbase_tpu_torch.ops import scan_agg as sa

    cluster = main["cluster"]
    fx = cluster.fused_executor()
    (dtab,) = fx.cache._tables.values()
    snap = cluster.gts.snapshot_ts()
    rows = []
    # the programs the main path compiled, in query order (Q6, Q1)
    for qname, (spec, _kinds, scan_cols) in zip(
        ("Q6", "Q1"), [v for k, v in fx._programs.items()
                       if k[0] == "scan_agg"]
    ):
        cols = [dtab.columns[scan_cols[i]] for i in spec.cols]
        args = (cols, dtab.xmin, dtab.xmax, dtab.nrows_dev, snap, spec)
        n0 = sa.scan_agg.launches
        ks, kc = sa.scan_agg(*args, max_nrows=int(dtab.nrows.max()))
        ps, pc = sa.scan_agg_plain(*args)
        err = max(int((ks - ps).abs().max()), int((kc - pc).abs().max()))
        if err:
            raise AssertionError(f"scan_agg {qname}: kernel != plain")
        ms = _cuda_ms(lambda: sa.scan_agg(
            *args, max_nrows=int(dtab.nrows.max())), 20)
        plain_ms = _cuda_ms(lambda: sa.scan_agg_plain(*args), 3)
        sa.scan_agg.launches = n0  # comparison launches are not counted
        nbytes = sa.spec_bytes(*args)
        bound = nbytes / rate * 1e3
        rows.append({
            "query": qname, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
            "max_abs_err": float(err),
        })
        plan = sa.launch_plan(spec, [c.element_size() for c in cols],
                              dtab.xmin.shape[1] != 1)
        print(f"kernel: scan_agg {qname} {ms:.4f} ms, "
              f"{nbytes / ms / 1e6:.1f} GB/s, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({nbytes} bytes at "
              f"{rate / 1e12:.2f} TB/s; rows passed {int(kc.sum())}; "
              f"tile {plan.tile}, {plan.stages} stages, {plan.smem_bytes} "
              f"B shared) [{card}]", flush=True)
    return rows


def ptxas_summary(log) -> str:
    """One line of what ptxas reported per kernel: registers, stack,
    spills, shared memory (or that the library was already built)."""
    if log is None:
        return "library already built (no ptxas report in this run)"
    keep = []
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            keep.append(line.split("'")[1] if "'" in line else line)
        elif "Used" in line or "spill" in line:
            keep.append(line.replace("ptxas info    : ", ""))
    return "; ".join(keep) or log.strip()


# ---------------------------------------------------------------------------
# phase 3b: radix_probe against its plain version
# ---------------------------------------------------------------------------


def radix_cases(device, seed: int):
    """(name, build keys, build real, probe keys, probe real, P, B)
    cases covering the kernel's branches: the reference test's data
    (tests/test_join_device.py:176), int32 keys, keys near +-2^62, dead
    and NULL probe rows, an empty build, duplicate build keys. Multi-pass
    plans are checked pass by pass in ``check_radix_vs_plain``."""
    from opentenbase_tpu_torch.plan import batchplan

    rng = np.random.default_rng(seed)

    def plan(nb, npr):
        p = batchplan.plan_radix_join(
            nb, npr, batchplan.DEFAULT_EXCHANGE_BUDGET)
        return (p.partitions, p.bucket) if p is not None else (1, 8)

    out = []
    nb, npr = 1500, 4000
    bk = (rng.permutation(np.arange(5000))[:nb] * 9 - 10**10).astype(
        np.int64)
    breal = rng.random(nb) > 0.1
    pk = np.concatenate([bk[rng.integers(0, nb, npr - 300)],
                         rng.integers(-(10**14), 10**14, 300)])
    preal = rng.random(npr) > 0.1
    out.append(("reference test data, int64", bk, breal, pk, preal,
                *plan(nb, npr)))
    bk32 = (rng.permutation(np.arange(1 << 20))[:50_000] * 37 - 2**30)
    pk32 = np.concatenate([bk32[rng.integers(0, 50_000, 150_000)],
                           rng.integers(-(2**31), 2**31 - 1, 50_000)])
    out.append(("int32 keys", bk32.astype(np.int32),
                np.ones(50_000, bool), pk32.astype(np.int32),
                np.ones(200_000, bool), *plan(50_000, 200_000)))
    wide = rng.integers(-(2**62), 2**62, 20_000, dtype=np.int64)
    wide[:4] = [2**62, -(2**62), 2**62 - 1, -(2**62) + 1]
    pw = np.concatenate([wide[rng.integers(0, 20_000, 60_000)],
                         rng.integers(-(2**62), 2**62, 20_000)])
    out.append(("keys near +-2^62", wide, np.ones(20_000, bool), pw,
                np.ones(80_000, bool), *plan(20_000, 80_000)))
    dead = rng.random(80_000) > 0.5  # half the probe rows dead or NULL
    out.append(("dead and NULL probe rows", wide, rng.random(20_000) > 0.2,
                pw, dead, *plan(20_000, 80_000)))
    out.append(("empty build", np.zeros(0, np.int64), np.zeros(0, bool),
                pw, np.ones(80_000, bool), 1, 8))
    dups = np.repeat(rng.integers(-50, 50, 600), 3).astype(np.int64)
    pd_ = rng.integers(-60, 60, 7000).astype(np.int64)
    out.append(("duplicate build keys", dups, np.ones(1800, bool), pd_,
                np.ones(7000, bool), *plan(1800, 7000)))
    # n not a multiple of the 16 rows a thread takes
    out.append(("ragged n, int32", bk32.astype(np.int32),
                np.ones(50_000, bool), pk32[:80_003].astype(np.int32),
                rng.random(80_003) > 0.3, *plan(50_000, 80_003)))
    out = [(n, *[torch_from(x, device) for x in (b, br, p, pr)], P, B)
           for n, b, br, p, pr, P, B in out]
    # probes that start at an offset view (no 16-byte alignment)
    for name, bk_, br_, pk_, pr_, P, B in out[:2]:
        out.append((f"{name}, offset view", bk_, br_, pk_[3:-4],
                    pr_[3:-4], P, B))
    return out


def torch_from(a, device):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _radix_equal(name, table, pk, preal, P, B, card, extra=""):
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp

    km, kb = rp.radix_probe(*table, pk, preal, P, B)
    pm, pb = rp.radix_probe_plain(*table, pk, preal, P, B)
    torch.cuda.synchronize()
    if not (torch.equal(km, pm) and torch.equal(kb, pb)):
        raise AssertionError(f"radix_probe {name}: kernel != plain")
    print(f"kernel vs plain: radix_probe {name} equal (P={P}, B={B}, "
          f"{pk.shape[0]} {str(pk.dtype).split('.')[-1]} probe rows, "
          f"{int(km.sum())} matched{extra}) [{card}]", flush=True)
    return km


def radix_full_plane_case(device, seed: int, rows: int):
    """K2 at SSB flight 1's scale over a probe side with deleted rows:
    DATE's 2556 keys built, ``rows`` lineorder order dates probed (a
    percent of them missing from DATE), a row real where it passes a
    filter of about half the rows and is visible, about 0.1 % of the
    rows deleted in runs and scattered."""
    from opentenbase_tpu_torch.plan import batchplan

    rng = np.random.default_rng(seed + 2)
    dd = make_date_dim()["d_datekey"].astype(np.int32)
    pk = dd[rng.integers(0, SSB_ORDER_DATES, rows)]
    pk[rng.random(rows) < 0.01] = 19_000_101
    deleted = np.zeros(rows, dtype=bool)
    for st in rng.integers(0, rows - 1000, rows // 2000 // 1000):
        deleted[st:st + 1000] = True
    deleted[rng.integers(0, rows, rows // 2000)] = True
    preal = (rng.random(rows) < 0.5) & ~deleted
    p = batchplan.plan_radix_join(len(dd), rows,
                                  batchplan.DEFAULT_EXCHANGE_BUDGET)
    P, B = (p.partitions, p.bucket) if p is not None else (1, 8)
    return (f"DATE probed by {rows} rows, {int(deleted.sum())} deleted",
            *[torch_from(x, device) for x in (
                dd, np.ones(len(dd), bool), pk, preal)], P, B)


def check_radix_vs_plain(device, seed: int, card: str,
                         rows: int | None = None) -> None:
    """radix_probe against radix_probe_plain on the card, exactly equal
    (matched everywhere, bidx everywhere: both write 0 on a miss)."""
    import torch

    from opentenbase_tpu_torch.executor import fused_dag
    from opentenbase_tpu_torch.ops import join as join_ops
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.plan import batchplan

    n0 = rp.radix_probe.launches
    cases = radix_cases(device, seed)
    if rows:
        cases.append(radix_full_plane_case(device, seed, rows))
    for name, bk, breal, pk, preal, P, B in cases:
        *table, dup, ovf = join_ops.build_radix_table(bk, breal, P, B)
        m = _radix_equal(name, table, pk, preal, P, B, card,
                         f", dup flag {bool(dup)}, overflow {bool(ovf)}")
        if name == "duplicate build keys" and not bool(dup):
            raise AssertionError("radix_probe: the dup flag did not fire")
        if name != "empty build" and not bool(m.any()):
            raise AssertionError(f"radix_probe {name}: nothing matched")
    # a multi-pass plan: every pass's table, then the DAG's lookup over
    # all passes against the sort-merge lookup
    rng = np.random.default_rng(seed + 1)
    nb, npr = 200_000, 1_000_000
    bk = torch_from(rng.permutation(np.arange(4 * nb))[:nb], device)
    pk = torch_from(np.concatenate([
        bk.cpu().numpy()[rng.integers(0, nb, npr - 100_000)],
        rng.integers(4 * nb, 8 * nb, 100_000)]), device)
    bmask = torch_from(rng.random(nb) > 0.1, device)
    pmask = torch_from(rng.random(npr) > 0.1, device)
    budget, plan = 1 << 16, None
    while plan is None:  # the least budget that admits a plan
        budget *= 2
        plan = batchplan.plan_radix_join(nb, npr, budget)
    if plan.passes < 2:
        raise AssertionError(f"radix_probe: no multi-pass plan ({plan})")
    chunk = -(-nb // plan.passes)
    for p in range(plan.passes):
        s0, e0 = p * chunk, min((p + 1) * chunk, nb)
        *table, _d, _o = join_ops.build_radix_table(
            bk[s0:e0], bmask[s0:e0], plan.partitions, plan.bucket)
        _radix_equal(f"multi-pass plan, pass {p + 1} of {plan.passes}",
                     table, pk, pmask, plan.partitions, plan.bucket, card)
    got = fused_dag._lookup_radix((pk, None), pmask, (bk, None), bmask,
                                  budget, fused_dag._lookup)
    want = fused_dag._lookup((pk, None), pmask, (bk, None), bmask,
                             check_dup=True)
    m = want[0]
    if bool(got[2]) or not torch.equal(got[0], m) or not torch.equal(
            got[1][m], want[1][m]):
        raise AssertionError("multi-pass _lookup_radix != sort-merge")
    print(f"kernel vs plain: multi-pass _lookup_radix ({plan.passes} "
          f"passes) equals the sort-merge lookup ({int(m.sum())} matched) "
          f"[{card}]", flush=True)
    rp.radix_probe.launches = n0  # comparison launches are not counted


# ---------------------------------------------------------------------------
# phase 5: SSB flight 1 through the fused DAG
# ---------------------------------------------------------------------------


def run_ssb_path(args, device, card: str) -> dict:
    import torch

    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    t0 = time.perf_counter()
    tables = make_ssb(args.ssb_rows, args.seed)
    lo, dd = tables["lineorder"], tables["date_dim"]
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    for ddl in SSB_FULL_DDL:
        s.execute(ddl)
    for name, arrays in tables.items():
        bulk_append(cluster, name, arrays)
    print(f"load: SSB lineorder {args.ssb_rows} rows in 2 datanodes; "
          + ", ".join(f"{k} {len(next(iter(v.values())))}"
                      for k, v in tables.items() if k != "lineorder")
          + f" rows replicated; {time.perf_counter() - t0:.3f} s",
          flush=True)
    want = {q: expected_ssb(lo, dd, q) for q in SSB_Q}
    runner = None
    first_ms, launches, modes, k1 = {}, {}, {}, {}
    for q, sql in SSB_Q.items():
        rp.radix_probe.launches = 0
        sa.scan_agg.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        torch.cuda.synchronize()
        first_ms[q] = (time.perf_counter() - t1) * 1000
        launches[q] = rp.radix_probe.launches
        k1[q] = sa.scan_agg.launches
        runner = cluster.fused_executor()._dag
        modes[q] = runner.last_join_modes
        if got != want[q]:
            raise AssertionError(f"{q}: port {got} != numpy {want[q]}")
        if launches[q] < 1:
            raise AssertionError(f"{q}: radix_probe never launched")
        if "radix" not in modes[q]:
            raise AssertionError(f"{q}: join modes {modes[q]} lack radix")
        print(f"main path: SSB {q} exact through the fused DAG (join modes "
              f"{modes[q]}, radix_probe launches {launches[q]}, scan_agg "
              f"launches {sa.scan_agg.launches}; first run incl. upload "
              f"{first_ms[q]:.3f} ms) {got} [{card}]", flush=True)
    e2e = {}
    for q, sql in SSB_Q.items():
        ts = []
        for _ in range(args.repeats):
            t1 = time.perf_counter()
            got = s.query(sql)
            ts.append((time.perf_counter() - t1) * 1000)
            if got != want[q]:
                raise AssertionError(f"{q}: answer changed between runs")
        e2e[q] = statistics.median(ts)
        print(f"end to end: SSB {q} median {e2e[q]:.3f} ms over "
              f"{args.repeats} runs (join modes {runner.last_join_modes}), "
              f"{args.ssb_rows / e2e[q] * 1e3:.4g} rows/s [{card}]",
              flush=True)
    breakdown = {q: layer_breakdown(cluster, sql, args.repeats, dag=True)
                 for q, sql in SSB_Q.items()}
    for q, b in breakdown.items():
        print(f"layers: SSB {q} median ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in b.items()) + f" [{card}]", flush=True)
    trace = {}
    for q, sql in SSB_Q.items():
        trace[q] = tr = trace_query(s, sql, args.repeats)
        idle = ("not measured (no device events in the trace)"
                if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
        print(f"trace: SSB {q} one query under torch.profiler, median of "
              f"{args.repeats}: host {tr['wall_ms']:.3f} ms, device busy "
              f"{tr['busy_ms']:.3f} ms, idle share {idle}; device events "
              f"{len(tr['events'])} kinds [{card}]", flush=True)
    return {"cluster": cluster, "session": s, "e2e": e2e,
            "launches": launches, "breakdown": breakdown, "trace": trace,
            "first_ms": first_ms, "tables": tables, "k1_launches": k1}


# ---------------------------------------------------------------------------
# phase 5b: SSB flights 2-4 through the DAG's grouped mode
# ---------------------------------------------------------------------------


def run_ssb_grouped(ssb: dict, args, card: str) -> dict:
    """Flights 2-4 (Q2.1-Q4.3) in flight 1's cluster: each a star join of
    lineorder with three or four dimensions, filtered and grouped on
    TEXT attributes, through the fused DAG's grouped mode (DATE by the
    radix probe, the dense-keyed dimensions by the fold). Each answer
    must equal numpy exactly, run in the grouped mode, and launch the
    radix probe (its count set to 0 just before the query and read just
    after)."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    cluster, s = ssb["cluster"], ssb["session"]
    runner = cluster.fused_executor()._dag
    t0 = time.perf_counter()
    pos = ssb_positions(ssb["tables"])
    # one thread a query (numpy's gathers and sorts free the GIL): the
    # same answers in less of the time limit
    want = in_threads({q: functools.partial(expected_ssb_grouped,
                                            ssb["tables"], q, pos)
                       for q in SSB_GROUPED_Q}, workers=5)
    print(f"numpy: flights 2-4 answered in "
          f"{time.perf_counter() - t0:.3f} s (five threads)", flush=True)
    first_ms, launches, modes, k1 = {}, {}, {}, {}
    for q, sql in SSB_GROUPED_Q.items():
        rp.radix_probe.launches = 0
        sa.scan_agg.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        torch.cuda.synchronize()
        first_ms[q] = (time.perf_counter() - t1) * 1000
        launches[q] = rp.radix_probe.launches
        k1[q] = sa.scan_agg.launches
        modes[q] = (runner.last_mode, runner.last_join_modes)
        if got != want[q]:
            raise AssertionError(
                f"{q}: port {got[:4]}... ({len(got)} rows) != numpy "
                f"{want[q][:4]}... ({len(want[q])} rows)")
        if modes[q] != ("grouped", ("fold", "radix")):
            raise AssertionError(f"{q}: mode and join modes {modes[q]}, "
                                 "want grouped with fold and radix")
        if launches[q] < 1:
            raise AssertionError(f"{q}: radix_probe never launched")
        print(f"main path: SSB {q} exact through the fused DAG (mode "
              f"{modes[q][0]}, join modes {modes[q][1]}, radix_probe "
              f"launches {launches[q]}, scan_agg launches "
              f"{sa.scan_agg.launches}; {len(got)} groups; first run incl. "
              f"upload {first_ms[q]:.3f} ms) {got[:2]}... [{card}]",
              flush=True)
    e2e = {}
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for q, sql in SSB_GROUPED_Q.items():
        ts = []
        for _ in range(args.repeats):
            t1 = time.perf_counter()
            got = s.query(sql)
            ts.append((time.perf_counter() - t1) * 1000)
            if got != want[q]:
                raise AssertionError(f"{q}: answer changed between runs")
        e2e[q] = statistics.median(ts)
        print(f"end to end: SSB {q} median {e2e[q]:.3f} ms over "
              f"{args.repeats} runs (mode {runner.last_mode}, join modes "
              f"{runner.last_join_modes}), "
              f"{args.ssb_rows / e2e[q] * 1e3:.4g} rows/s [{card}]",
              flush=True)
    print(f"memory: flights 2-4 resident {resident / 1e9:.3f} GB "
          f"(the SSB tables' planes), peak over the warm runs "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]",
          flush=True)
    breakdown = {q: layer_breakdown(cluster, sql, args.repeats, dag=True)
                 for q, sql in SSB_GROUPED_Q.items()}
    for q, b in breakdown.items():
        print(f"layers: SSB {q} median ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in b.items()) + f" [{card}]", flush=True)
    trace = {}
    for q, sql in SSB_GROUPED_Q.items():
        trace[q] = tr = trace_query(s, sql, args.repeats)
        idle = ("not measured (no device events in the trace)"
                if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
        top = "; ".join(f"{k} {v:.3f} ms" for k, v in tr["top"])
        print(f"trace: SSB {q} one query under torch.profiler, median of "
              f"{args.repeats}: host {tr['wall_ms']:.3f} ms, device busy "
              f"{tr['busy_ms']:.3f} ms, idle share {idle}; device events "
              f"{len(tr['events'])} kinds, the most device time: {top} "
              f"[{card}]", flush=True)
    return {"e2e": e2e, "launches": launches, "breakdown": breakdown,
            "trace": trace, "first_ms": first_ms, "k1_launches": k1}


# ---------------------------------------------------------------------------
# phase 5c: TPC-H Q3 and ClickBench through the DAG's device top-k modes
# ---------------------------------------------------------------------------


def run_topk_query(name: str, cluster, sql: str, want: list, mode: str,
                   join_modes: tuple, folded: int, repeats: int,
                   card: str) -> dict:
    """One top-k query of phase 5c, as phases 5 and 5b run theirs: the
    first run exact against numpy in the mode and join modes the CPU
    tests fixed (tests/test_torch_dag_topk.py), K1's and K2's launches
    counted from 0 around it; then the warm median, the memory, the
    layers and one traced run."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    s = cluster.session()
    c0 = dict(cluster.fused_executor().cache.stats)
    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    t1 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    refresh = {k: n - c0[k]
               for k, n in cluster.fused_executor().cache.stats.items()}
    runner = cluster.fused_executor()._dag
    seen = (runner.last_mode, runner.last_join_modes,
            len(runner.last_folded))
    if got != want:
        raise AssertionError(f"{name}: port {got} != numpy {want}")
    if seen != (mode, join_modes, folded) or not s._fused_via_dag:
        raise AssertionError(f"{name}: mode, join modes, folded joins "
                             f"{seen}, want {(mode, join_modes, folded)}")
    print(f"main path: {name} exact through the fused DAG (mode {seen[0]}, "
          f"join modes {seen[1]}, {seen[2]} joins folded; scan_agg launches "
          f"{launches['scan_agg']}, radix_probe launches "
          f"{launches['radix_probe']}; {len(got)} groups; first run incl. "
          f"upload {first_ms:.3f} ms) {got[:2]}... [{card}]", flush=True)
    return {"launches": launches, "first_ms": first_ms, "refresh": refresh,
            **measure_warm(name, cluster, sql, want, repeats, card, True,
                           f" (mode {runner.last_mode})")}


def measure_warm(name: str, cluster, sql: str, want: list, repeats: int,
                 card: str, dag: bool, note: str,
                 trace_warm: bool = True, layered: bool = True,
                 first_ms: float = None) -> dict:
    """The rest of a query whose first run was checked: the median of
    ``repeats`` warm runs (each still equal to ``want``; with none, the
    first run's ``first_ms`` stands for them), the resident and peak
    device memory over them, the layers (the device path through the
    fused DAG where ``dag``; not run where ``layered`` is False) and one
    traced run (after an untimed one where ``trace_warm``; none where
    ``first_ms`` is past TRACE_MAX_FIRST_MS), each printed; returned as
    {e2e, layers, trace, resident_gb, peak_gb}."""
    import torch

    s = cluster.session()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ts = []
    for _ in range(repeats):
        t1 = time.perf_counter()
        got = s.query(sql)
        ts.append((time.perf_counter() - t1) * 1000)
        if got != want:
            raise AssertionError(f"{name}: answer changed between runs")
    e2e = statistics.median(ts) if ts else first_ms
    peak = torch.cuda.max_memory_allocated()
    print(f"end to end: {name} median {e2e:.3f} ms over {repeats} "
          f"runs{note} [{card}]", flush=True)
    print(f"memory: {name} resident {resident / 1e9:.3f} GB (the cluster's "
          f"planes), peak over the warm runs {peak / 1e9:.3f} GB [{card}]",
          flush=True)
    layers = None
    if layered:
        layers = layer_breakdown(cluster, sql, repeats, dag=dag)
        print(f"layers: {name} median ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in layers.items()) + f" [{card}]",
            flush=True)
    else:
        print(f"layers: {name} not measured (a cut for the time limit)",
              flush=True)
    if first_ms is not None and first_ms > TRACE_MAX_FIRST_MS:
        return {"e2e": e2e, "layers": layers,
                "trace": untraced(name, first_ms),
                "resident_gb": resident / 1e9, "peak_gb": peak / 1e9}
    traced = max(repeats, 1)
    tr = trace_query(s, sql, traced, warm=trace_warm)
    idle = ("not measured (no device events in the trace)"
            if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
    top = "; ".join(f"{k} {v:.3f} ms" for k, v in tr["top"])
    print(f"trace: {name} one query under torch.profiler, median of "
          f"{traced}: host {tr['wall_ms']:.3f} ms, device busy "
          f"{tr['busy_ms']:.3f} ms, idle share {idle}; device events "
          f"{len(tr['events'])} kinds, the most device time: {top} "
          f"[{card}]", flush=True)
    return {"e2e": e2e, "layers": layers, "trace": tr,
            "resident_gb": resident / 1e9, "peak_gb": peak / 1e9}


def run_q3_dense(main: dict, args, card: str) -> dict:
    """Phase 5c (b): bench.py's Q3 — orders and customer (make_q3_dims)
    beside phase 4's lineitem, dense order keys: gagg over two chain
    folds."""
    cluster = main["cluster"]
    s = cluster.session()
    t0 = time.perf_counter()
    orders, customer = make_q3_dims(args.rows, 43)
    for ddl in Q3_DENSE_DDL:
        s.execute(ddl)
    bulk_append(cluster, "orders", orders)
    bulk_append(cluster, "customer", customer)
    want = expected_q3(main["arrays"], orders, customer, 0)
    print(f"load: orders {len(orders['o_orderkey'])} and customer "
          f"{len(customer['c_custkey'])} rows beside lineitem, numpy Q3; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return run_topk_query("TPC-H Q3 (dense keys)", cluster, Q3_DENSE, want,
                          "gagg", ("fold",), 2, args.repeats, card)


def run_q3_spec(args, device, card: str) -> dict:
    """Phase 5c (a): TPC-H Q3 as the spec writes it over make_q3_spec at
    ``--q3-sf`` (sparse order keys, TEXT segments), every table round
    robin over 2 datanodes: the top join by the gsort co-sort, customer
    folded into orders."""
    from opentenbase_tpu_torch import Cluster

    t0 = time.perf_counter()
    tables = make_q3_spec(args.q3_sf, args.seed)
    # numpy's Q3 and Q1, and phase 15's columns, while the stores load
    answers = start_threads({
        "Q3": lambda: expected_q3(tables["lineitem"], tables["orders"],
                                  tables["customer"], "BUILDING"),
        "Q1": lambda: expected_q1_spec(tables["lineitem"]),
        "p15": lambda: make_phase15(tables, args.q3_sf, args.seed)})
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    for ddl in SPEC15_DDL:
        s.execute(ddl)
    bulk_append(cluster, "orders", tables["orders"])
    got = answers()
    want, want_q1, p15 = got["Q3"], got["Q1"], got["p15"]
    t1 = time.perf_counter()
    for name in ("customer", "lineitem"):
        bulk_append(cluster, name, {**tables[name], **p15[name]})
    for name in P15_TABLES:
        bulk_append(cluster, name, p15[name])
    print(f"load: TPC-H SF{args.q3_sf:g} for Q3: " + ", ".join(
        f"{k} {len(next(iter(v.values())))}" for k, v in tables.items())
        + f" rows round robin in 2 datanodes, numpy Q3; phase 15's "
        + ", ".join(f"{k} {len(next(iter(p15[k].values())))}"
                    for k in P15_TABLES)
        + f" rows (nation and region replicated), their load "
        f"{time.perf_counter() - t1:.3f} s; "
        f"{time.perf_counter() - t0:.3f} s", flush=True)
    out = run_topk_query("TPC-H Q3 (spec keys)", cluster, Q3_SPEC, want,
                         "gsort", ("fold",), 1, args.repeats, card)
    # phase 6: Q1 as the spec writes it, over the same lineitem
    out["fragment"] = {"TPC-H Q1 (spec)": run_fragment_query(
        "TPC-H Q1 (spec)", cluster, Q1_SPEC, want_q1, args.repeats, card)}
    # phase 8 (a) writes into these tables after every earlier query
    out["phase8"] = {"cluster": cluster, "tables": tables, "p15": p15}
    return out


def run_clickbench(args, device, card: str) -> dict:
    """Phase 5c (c): ClickBench's top-10 UserIDs over ``--hits-rows``
    rows of make_hits, round robin over 2 datanodes. The full-range
    UserIDs overflow every packed key, so the run ends in the grouped
    mode with every group shipped, as the reference's does."""
    from opentenbase_tpu_torch import Cluster

    t0 = time.perf_counter()
    users = int(args.hits_rows * HITS_DISTINCT_SHARE)
    hits = make_hits(args.hits_rows, users, args.seed)
    # numpy's answers while the stores load
    answers = start_threads({
        "top 10": lambda: expected_clickbench(hits),
        **{q: functools.partial(expected_clickbench_scalar, hits, q)
           for q in CLICKBENCH_SCALAR_Q}})
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    s.execute(CLICKBENCH_DDL)
    bulk_append(cluster, "hits", hits)
    want_scalar = answers()
    want = want_scalar.pop("top 10")
    counts = [c for _u, c in want]
    print(f"load: hits {args.hits_rows} rows, {users} distinct UserIDs, "
          f"round robin in 2 datanodes, numpy top 10 (counts {counts}, "
          f"distinct: {len(set(counts)) == len(counts)}); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    del hits
    out = run_topk_query("ClickBench top-10 UserID", cluster, CLICKBENCH_Q,
                         want, "grouped", (), 0, max(2, args.repeats // 2),
                         card)
    # phase 6: the scalar queries over the same hits
    out["fragment"] = {
        q: run_fragment_query(q, cluster, sql, want_scalar[q],
                              args.repeats, card)
        for q, sql in CLICKBENCH_SCALAR_Q.items()}
    out["k1_rows"] = time_k1_at(cluster, {
        q: CLICKBENCH_SCALAR_Q[q] for q, (route, _r) in
        FRAGMENT_ROUTES.items() if route == "scan_agg"}, card)
    return out


# ---------------------------------------------------------------------------
# phase 6: single-table aggregates off the kernel, coordinator expressions
# ---------------------------------------------------------------------------


def certified_route(cluster, sql: str) -> str:
    """What the port's copy of the reference certifier decides for the
    query's fragment on the resident arrays' bounds: "scan_agg" where
    it takes the fragment, "program" where it does not."""
    from opentenbase_tpu_torch.executor.fused import _match_partial_fragment
    from opentenbase_tpu_torch.ops import scan_agg as sa
    from opentenbase_tpu_torch.plan import analyze_statement
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse_one

    cat = cluster.catalog
    dplan = distribute_statement(optimize_statement(
        analyze_statement(parse_one(sql), cat), cat), cat)
    (frag,) = dplan.fragments
    m = _match_partial_fragment(frag.root)
    fx = cluster.fused_executor()
    meta = cat.get(m.scan.table)
    dtab = fx.cache.get(m.scan.table, meta, fx.node_stores, frag.nodes,
                        columns=m.scan.columns)
    if any(dtab.validity[c] is not None for c in m.scan.columns):
        return "program"
    try:
        fx._scan_agg_plan(m, [dtab.col_maxabs.get(c) for c in
                              m.scan.columns],
                          [dtab.col_range.get(c) for c in m.scan.columns])
    except sa.PallasUnsupported:
        return "program"
    return "scan_agg"


def run_fragment_query(name: str, cluster, sql: str, want: list,
                       repeats: int, card: str, route=None) -> dict:
    """One query of phase 6: the first run exact against numpy on the
    route and rung FRAGMENT_ROUTES names (which the certifier's verdict
    on the resident arrays must confirm), K1's and K2's launches and the
    device cache's counters counted around it (K1 once on its route,
    never on the program's); then the
    warm median, the memory, the layers and one traced run. ``route``
    (route, rung) stands in for FRAGMENT_ROUTES' entry."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    route, rung = route or FRAGMENT_ROUTES[name]
    s = cluster.session()
    fx = cluster.fused_executor()
    c0 = dict(fx.cache.stats)
    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    t1 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    refresh = {k: n - c0[k] for k, n in fx.cache.stats.items()}
    seen = (fx.last_route, fx.last_rung)
    if certified_route(cluster, sql) != route:
        raise AssertionError(f"{name}: the certifier does not route it "
                             f"to {route}")
    if got != want:
        raise AssertionError(f"{name}: port {got} != numpy {want}")
    if seen != (route, rung) or s._fused_via_dag:
        raise AssertionError(f"{name}: route and rung {seen}, want "
                             f"{(route, rung)}")
    k1 = 1 if route == "scan_agg" else 0
    if launches != {"scan_agg": k1, "radix_probe": 0}:
        raise AssertionError(f"{name}: launches {launches}, want "
                             f"scan_agg {k1}, radix_probe 0")
    print(f"main path: {name} exact through {route} (rung {rung}; "
          f"scan_agg launches {launches['scan_agg']}, radix_probe "
          f"launches {launches['radix_probe']}; {len(got)} rows; first "
          f"run incl. upload {first_ms:.3f} ms) {got[:2]}... [{card}]",
          flush=True)
    return {"launches": launches, "first_ms": first_ms, "route": seen,
            "refresh": refresh,
            **measure_warm(name, cluster, sql, want, repeats, card, False,
                           f" ({route})")}


def time_k1_at(cluster, queries: dict, card: str) -> list:
    """K1's kernel, plain-version and bound times at the inputs the main
    path hands it for each query (captured by one more warm run with the
    wrapper swapped for a recorder that delegates to it), held equal to
    the plain version there; as ``time_kernels`` for Q6 and Q1."""
    from opentenbase_tpu_torch.ops import scan_agg as sa

    kernel = sa.scan_agg
    n0 = kernel.launches
    rows = []
    for q, sql in queries.items():
        with k1_recorder() as calls:
            cluster.session().query(sql)
        if len(calls) != 1:
            raise AssertionError(f"{q}: expected one K1 launch, saw "
                                 f"{len(calls)}")
        rows += k1_check_calls(q, calls, card)
    kernel.launches = n0  # comparison and timing launches are not counted
    return rows


class k1_recorder:
    """``with k1_recorder() as calls:`` swaps K1's wrapper for a recorder
    that delegates to it and keeps each call's (args, kwargs); the
    wrapper's own count goes on as before."""

    def __enter__(self) -> list:
        from opentenbase_tpu_torch.ops import scan_agg as sa

        self.kernel = kernel = sa.scan_agg
        self.calls: list = []

        def record(*a, **kw):
            self.calls.append((a, kw))
            return kernel(*a, **kw)

        record.launches = 0  # the wrapper counts under its module name
        sa.scan_agg = record
        return self.calls

    def __exit__(self, *exc) -> None:
        from opentenbase_tpu_torch.ops import scan_agg as sa

        sa.scan_agg = self.kernel


def k1_check_calls(name: str, calls: list, card: str) -> list:
    """Each recorded K1 call run again through the kernel and its plain
    version, exactly equal, and timed: one kernel-table row a call. The
    caller puts back the launch count these runs add."""
    import torch

    from opentenbase_tpu_torch.ops import scan_agg as sa

    rate = hbm_rate(torch.cuda.get_device_name(0))
    kernel = sa.scan_agg
    rows = []
    for i, (args, kw) in enumerate(calls):
        q = name if len(calls) == 1 else f"{name} (call {i + 1})"
        ks, kc = kernel(*args, **kw)
        ps, pc = sa.scan_agg_plain(*args)
        torch.cuda.synchronize()
        err = max(int((ks - ps).abs().max()) if ks.numel() else 0,
                  int((kc - pc).abs().max()))
        if err:
            raise AssertionError(f"scan_agg {q}: kernel != plain")
        ms = _cuda_ms(lambda: kernel(*args, **kw), 20)
        plain_ms = _cuda_ms(lambda: sa.scan_agg_plain(*args), 3)
        nbytes = sa.spec_bytes(*args)
        bound = nbytes / rate * 1e3
        rows.append({"query": q, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": "bytes",
                     "bytes": nbytes, "max_abs_err": float(err)})
        print(f"kernel: scan_agg {q} {ms:.4f} ms, {nbytes / ms / 1e6:.1f} "
              f"GB/s, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes} bytes at {rate / 1e12:.2f} TB/s; "
              f"{len(args[0])} columns; rows passed {int(kc.sum())}) "
              f"[{card}]", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 7: bench.py's TPC-H SF100 leg, device-resident external tables
# ---------------------------------------------------------------------------


def sf100_rows(requested: int) -> int:
    """``requested`` lineitem rows, cut as bench.py cuts them to what the
    host can hold for the numpy check (MemAvailable / 2 at 40 bytes a
    row), rounded down to a multiple of 2^20 so the window halving still
    divides it; a cut is printed."""
    avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    avail = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    cap = avail // 2 // 40
    if avail and requested > cap:
        n = cap >> 20 << 20
        print(f"reduced: SF100 lineitem {requested} -> {n} rows ({avail} "
              f"bytes of host memory available)", flush=True)
        return n
    return requested


def run_sf100_query(name: str, cluster, sql: str, want: list, check,
                    k1: int, repeats: int, card: str) -> dict:
    """One query of phase 7: the first run exact against numpy, in the
    state ``check`` confirms (it returns that state's description), with
    K1 launched ``k1`` times and K2 never (counts from 0 around it); then
    ``measure_warm``."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    s = cluster.session()
    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    t1 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    if got != want:
        raise AssertionError(f"{name}: port {got} != numpy {want}")
    state = check()
    if launches != {"scan_agg": k1, "radix_probe": 0}:
        raise AssertionError(f"{name}: launches {launches}, want "
                             f"scan_agg {k1}, radix_probe 0")
    print(f"main path: {name} exact ({state}; scan_agg launches "
          f"{launches['scan_agg']}, radix_probe launches "
          f"{launches['radix_probe']}; {len(got)} rows; first run "
          f"{first_ms:.3f} ms) {got[:2]}... [{card}]", flush=True)
    fx = cluster.fused_executor()
    dag = bool(s._fused_via_dag)
    route = ("dag", fx._dag.last_mode) if dag else (fx.last_route,
                                                    fx.last_rung)
    return {"launches": launches, "first_ms": first_ms, "route": route,
            **measure_warm(name, cluster, sql, want, repeats, card, dag,
                           "")}


def run_sf100(args, device, card: str) -> dict:
    """Phase 7: bench.py's SF100 leg at ``--sf100-rows`` (default its
    603 979 776): the tables made from ``--seed`` on the host, checked
    there in numpy, and registered on the card as external tables in one
    datanode (``register_sf100``). Q6 through K1 in one launch; Q3
    through the windowed gagg (16 windows at the full size) with the
    orders side hoisted and every join folded, all ten rows exact; then
    K1 held against its plain version at Q6's inputs."""
    import torch

    from opentenbase_tpu_torch import Cluster

    n = sf100_rows(args.sf100_rows)
    t0 = time.perf_counter()
    tables = make_sf100(n, args.seed)
    t1 = time.perf_counter()
    want = in_threads({6: lambda: expected_sf100_q6(tables),
                       3: lambda: expected_sf100_q3(tables)})
    want6, want3 = want[6], want[3]
    t2 = time.perf_counter()
    cluster = Cluster(num_datanodes=1, shard_groups=16, device=device)
    register_sf100(cluster, {
        t: {c: torch.from_numpy(a).to(device) for c, a in cols.items()}
        for t, cols in tables.items()})
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"load: TPC-H SF100 (bench.py's leg): lineitem {n}, orders "
          f"{n // 4}, customer {n // 40} rows made on the host in "
          f"{t1 - t0:.3f} s, numpy Q6 and Q3 in {t2 - t1:.3f} s, "
          f"registered on the card as external tables in {t3 - t2:.3f} s "
          f"({torch.cuda.memory_allocated() / 1e9:.3f} GB); kept out of "
          f"the query times [{card}]", flush=True)
    del tables
    fx = cluster.fused_executor()

    def q6_state():
        if fx.last_route != "scan_agg":
            raise AssertionError(f"SF100 Q6: route {fx.last_route}")
        return "route scan_agg"

    def q3_state():
        r = fx._dag
        seen = (r.last_mode, r.last_hoisted, r.last_join_modes)
        # joins post-order: customer into orders 0 (folded inside the
        # prep), orders into lineitem 1 (folded in every window)
        if seen != ("wgagg", True, ("fold",)) or r.last_folded != {1}:
            raise AssertionError(f"SF100 Q3: mode, hoisted, join modes "
                                 f"{seen}, folded {r.last_folded}")
        if not any(k[0] == "prep" for k in r._programs):
            raise AssertionError("SF100 Q3: no prep program compiled")
        nwin, width, cap = r.last_windows
        return (f"mode wgagg over {nwin} windows of {width} rows, final "
                f"capacity {cap}, build side hoisted, join modes "
                f"{r.last_join_modes}, joins folded {sorted(r.last_folded)}, "
                f"reruns {r.last_retries}")

    out = {"rows": n}
    out["SF100 Q6"] = run_sf100_query("SF100 Q6", cluster, SF100_Q6, want6,
                                      q6_state, 1, args.repeats, card)
    # a depth cut for the time limit: 2 warm, layered and traced runs of
    # the 0.6 s query, not --repeats
    out["SF100 Q3"] = run_sf100_query("SF100 Q3", cluster, SF100_Q3, want3,
                                      q3_state, 0, min(args.repeats, 2),
                                      card)
    out["windows"] = fx._dag.last_windows
    out["k1_rows"] = time_k1_at(cluster, {"SF100 Q6": SF100_Q6}, card)
    return out


# ---------------------------------------------------------------------------
# phase 8: the write path: TPC-H's refresh functions, bench.py's HTAP loop
# and SSB flight 1 after a DELETE
# ---------------------------------------------------------------------------

RF_STMT_ROWS = 5000  # rows an RF1 INSERT carries
# keys an RF2 DELETE names: a statement's cost is mostly fixed (each
# node uploads the key column and reads its visibility planes), so
# RF2 takes six statements as RF1 takes its 5 000-row INSERTs
RF_STMT_KEYS = 5000
REFRESH_STATS = ("full_uploads", "delta_tail_rows", "mvcc_replays",
                 "h2d_bytes")


def make_rf1(tables: dict, sf: float, seed: int) -> dict:
    """RF1's new rows (TPC-H rev. 3, section 2.5.2): SF x 1500 orders
    whose keys take unused slots of make_q3_spec's sparse scheme (the
    9th to 16th of a block of 32, in blocks the loaded orders use), and
    their 1-7 lineitems, drawn in make_q3_spec's domains from ``seed``."""
    rng = np.random.default_rng(seed + 100)
    n_o = len(tables["orders"]["o_orderkey"])
    n_c = len(tables["customer"]["c_custkey"])
    n_p = max(int(200_000 * sf), 1)
    n_new = max(int(1500 * sf), 1)
    i = rng.choice(n_o, n_new, replace=False)
    okey = (i // 8 * 32 + 8 + i % 8 + 1).astype(np.int64)
    j = rng.integers(0, n_c - n_c // 3, n_new)
    odate = rng.integers(_day("1992-01-01"), _day("1998-08-02") + 1,
                         n_new).astype(np.int32)
    lines = rng.integers(1, 8, n_new)
    oi = np.repeat(np.arange(n_new), lines)
    n_l = len(oi)
    pk = rng.integers(1, n_p + 1, n_l)
    retail = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000)
    qty = rng.integers(1, 51, n_l)
    ship = (odate[oi] + rng.integers(1, 122, n_l)).astype(np.int32)
    receipt = (ship + rng.integers(1, 31, n_l)).astype(np.int32)
    current = _day("1995-06-17")
    flag = np.where(receipt <= current,
                    np.where(rng.random(n_l) < 0.5, 0, 2), 1)
    q4 = q4_columns(odate, oi, seed + 100)
    ep = (qty * retail).astype(np.int64)
    disc = rng.integers(0, 11, n_l).astype(np.int64)
    tax = rng.integers(0, 9, n_l).astype(np.int64)
    pick = np.random.default_rng(seed + 501).integers(0, COMMENT_POOL, n_new)
    return {
        "orders": {
            "o_orderkey": okey,
            "o_custkey": (j + j // 2 + 1).astype(np.int64),
            "o_orderdate": odate,
            "o_shippriority": np.zeros(n_new, dtype=np.int32),
            "o_orderpriority": q4["o_orderpriority"],
            "o_weight": q4["o_weight"],
            "o_totalprice": order_totals(oi, ep, disc, tax, n_new),
            "o_comment": Text(tables["orders"]["o_comment"].vocab,
                              pick.astype(np.int32)),
        },
        "lineitem": {
            "l_orderkey": okey[oi],
            "l_extendedprice": ep,
            "l_discount": disc,
            "l_shipdate": ship,
            "l_quantity": (qty * 100).astype(np.int64),
            "l_tax": tax,
            "l_receiptdate": receipt,
            "l_returnflag": Text(RF_VOCAB, flag.astype(np.int8)),
            "l_linestatus": Text(LS_VOCAB, (ship > current).astype(np.int8)),
            "l_commitdate": q4["l_commitdate"],
        },
    }


def _cents(c: int) -> str:
    return f"{c // 100}.{c % 100:02d}"


def _cents_signed(c: int) -> str:
    return ("-" if c < 0 else "") + _cents(abs(c))


def rf1_sql(rf1: dict) -> list:
    """RF1 as SQL: INSERT ... VALUES of at most RF_STMT_ROWS rows, the
    orders first, in Q3_SPEC_DDL's column order."""
    o, li = rf1["orders"], rf1["lineitem"]
    pool = o["o_comment"].vocab
    orows = [f"({k}, {c}, '{_date(d)}', {p}, '{PRIORITIES[op]}', {w!r}, "
             f"{_cents(tp)}, '{pool[oc]}')"
             for k, c, d, p, op, w, tp, oc in zip(
                 o["o_orderkey"].tolist(), o["o_custkey"].tolist(),
                 o["o_orderdate"].tolist(), o["o_shippriority"].tolist(),
                 o["o_orderpriority"].idx.tolist(), o["o_weight"].tolist(),
                 o["o_totalprice"].tolist(), o["o_comment"].idx.tolist())]
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    lrows = [
        f"({k}, {_cents(p)}, {_cents(d)}, '{_date(sd)}', {_cents(q)}, "
        f"{_cents(tx)}, '{_date(rd)}', '{RF_VOCAB[f]}', '{LS_VOCAB[s]}', "
        f"'{_date(cd)}')"
        for k, p, d, sd, q, tx, rd, f, s, cd in zip(
            li["l_orderkey"].tolist(), li["l_extendedprice"].tolist(),
            li["l_discount"].tolist(), li["l_shipdate"].tolist(),
            li["l_quantity"].tolist(), li["l_tax"].tolist(),
            li["l_receiptdate"].tolist(), rf.idx.tolist(), ls.idx.tolist(),
            li["l_commitdate"].tolist())
    ]
    return [f"insert into {table} values " + ",".join(rows[i:i + RF_STMT_ROWS])
            for table, rows in (("orders", orows), ("lineitem", lrows))
            for i in range(0, len(rows), RF_STMT_ROWS)]


def _select(arrays: dict, m) -> dict:
    return {k: Text(v.vocab, v.idx[m]) if isinstance(v, Text) else v[m]
            for k, v in arrays.items()}


def _concat(a: dict, b: dict) -> dict:
    return {k: Text(v.vocab, np.concatenate([v.idx, b[k].idx]))
            if isinstance(v, Text) else np.concatenate([v, b[k]])
            for k, v in a.items()}


def run_in_txn(session, stmts: list) -> tuple:
    """``stmts`` inside one BEGIN ... COMMIT: (ms of the whole, rows
    each statement changed)."""
    t0 = time.perf_counter()
    session.execute("begin")
    counts = [session.execute(sql).rowcount for sql in stmts]
    session.execute("commit")
    return (time.perf_counter() - t0) * 1000, counts


def refresh_queries(label: str, cluster, state: dict, args,
                    card: str) -> dict:
    """Q6, Q1 and Q3 as the spec writes them after a refresh function:
    each first run exact against numpy over ``state`` (the generator's
    arrays with the refresh applied) on the route or mode the earlier
    phases fixed, with the device cache's refresh counters of that run;
    then the warm runs, layers and a trace; K1 held to its plain version
    at Q6's inputs."""
    li, o, c = state["lineitem"], state["orders"], state["customer"]
    out = {}
    q6, q1, q3 = (f"TPC-H {q} (spec, {label})" for q in ("Q6", "Q1", "Q3"))
    out[q6] = run_fragment_query(q6, cluster, Q6, expected_q6(li),
                                 args.repeats, card, ("scan_agg", None))
    out[q1] = run_fragment_query(q1, cluster, Q1_SPEC, expected_q1_spec(li),
                                 args.repeats, card, ("program", ("hash", 64)))
    out[q3] = run_topk_query(q3, cluster, Q3_SPEC,
                             expected_q3(li, o, c, "BUILDING"), "gsort",
                             ("fold",), 1, args.repeats, card)
    for q, r in out.items():
        print(f"refresh: {q} first run's device-cache refresh " + ", ".join(
            f"{k} {r['refresh'][k]}" for k in REFRESH_STATS) + f" [{card}]",
            flush=True)
    dt = cluster.fused_executor().cache._tables[("lineitem", (0, 1))]
    print(f"refresh: lineitem's MVCC planes {tuple(dt.xmin.shape)} int64 "
          f"each, {2 * dt.xmin.numel() * 8 / 1e9:.3f} GB [{card}]",
          flush=True)
    return out


def run_refresh(q3: dict, args, card: str) -> dict:
    """Phase 8 (a): TPC-H's refresh functions as the power test runs
    them (rev. 3, section 5.3.3: RF1, the queries, RF2) over phase 5c's
    tables at ``--q3-sf``, after Q6 over the loaded rows (K1 over
    compact planes): RF1 inserts SF x 1500 orders and their
    lineitems through INSERT ... VALUES in one transaction, RF2 deletes
    SF x 1500 existing orders and their lineitems through DELETE ...
    WHERE ... IN (...) in one transaction; Q6, Q1 and Q3 after each,
    exact against numpy over the generator's arrays so changed."""
    cluster, tables = q3["cluster"], q3["tables"]
    s = cluster.session()
    # Q6 over the loaded rows first: K1 over compact MVCC planes, the
    # shape the refreshes change
    q6 = "TPC-H Q6 (spec)"
    out = {"before RF1": {q6: run_fragment_query(
        q6, cluster, Q6, expected_q6(tables["lineitem"]), args.repeats,
        card, ("scan_agg", None))}}
    out["k1_rows"] = time_k1_at(cluster, {q6: Q6}, card)
    rf1 = make_rf1(tables, args.q3_sf, args.seed)
    stmts = rf1_sql(rf1)
    state = {"customer": tables["customer"],
             "orders": _concat(tables["orders"], rf1["orders"]),
             "lineitem": _concat(tables["lineitem"], rf1["lineitem"])}
    # RF1's transaction, with phase 10 (c)'s reads between its INSERTs
    # and its COMMIT (not in RF1's time)
    t1 = time.perf_counter()
    s.execute("begin")
    counts = [s.execute(sql).rowcount for sql in stmts]
    ms = (time.perf_counter() - t1) * 1000
    out["txn_reads"] = run_txn_reads(s, state, args, card)
    t1 = time.perf_counter()
    s.execute("commit")
    ms += (time.perf_counter() - t1) * 1000
    n_o, n_l = len(rf1["orders"]["o_orderkey"]), len(
        rf1["lineitem"]["l_orderkey"])
    if sum(counts) != n_o + n_l:
        raise AssertionError(f"RF1 inserted {sum(counts)} rows, not "
                             f"{n_o + n_l}")
    print(f"write: RF1 {n_o} orders and {n_l} lineitems in {len(stmts)} "
          f"INSERT statements, one transaction, {ms:.3f} ms [{card}]",
          flush=True)
    out["RF1 ms"] = ms
    out["after RF1"] = refresh_queries("after RF1", cluster, state, args,
                                       card)
    out["k1_rows"] += time_k1_at(cluster, {"TPC-H Q6 (spec, after RF1)": Q6},
                                 card)
    rng = np.random.default_rng(args.seed + 200)
    okeys = tables["orders"]["o_orderkey"]
    gone = np.sort(okeys[rng.choice(len(okeys), n_o, replace=False)])
    stmts = []
    for i in range(0, len(gone), RF_STMT_KEYS):
        keys = ", ".join(map(str, gone[i:i + RF_STMT_KEYS].tolist()))
        stmts.append(f"delete from orders where o_orderkey in ({keys})")
        stmts.append(f"delete from lineitem where l_orderkey in ({keys})")
    ms, counts = run_in_txn(s, stmts)
    # numpy's key sets as boolean tables over the key range (a sorting
    # np.isin of 60 M keys takes seconds)
    gone_t = np.zeros(max(int(state["lineitem"]["l_orderkey"].max()),
                          int(state["orders"]["o_orderkey"].max())) + 1,
                      dtype=bool)
    gone_t[gone] = True
    lkeep = ~gone_t[state["lineitem"]["l_orderkey"]]
    if sum(counts) != len(gone) + int((~lkeep).sum()):
        raise AssertionError(f"RF2 deleted {sum(counts)} rows, not "
                             f"{len(gone) + int((~lkeep).sum())}")
    print(f"write: RF2 {len(gone)} orders and {int((~lkeep).sum())} "
          f"lineitems in {len(stmts)} DELETE statements, one transaction, "
          f"{ms:.3f} ms [{card}]", flush=True)
    state["orders"] = _select(state["orders"],
                              ~gone_t[state["orders"]["o_orderkey"]])
    state["lineitem"] = _select(state["lineitem"], lkeep)
    out["RF2 ms"] = ms
    out["after RF2"] = refresh_queries("after RF2", cluster, state, args,
                                       card)
    out["k1_rows"] += time_k1_at(cluster, {"TPC-H Q6 (spec, after RF2)": Q6},
                                 card)
    out["state"] = state  # phase 16's numpy truth
    return out


HTAP_FOLD_BATCHES = 40  # phase 17's batches with enable_delta_scan off
HTAP_TOPK = ("select g, count(*), sum(v) from ht "
             "group by g order by 3 desc, g limit 5")


def expected_htap(v: np.ndarray) -> list:
    """The top five groups g = k mod 64 by sum(v) descending, then g,
    over the loop's own record of every row's v (row k at index k)."""
    g = np.arange(len(v)) % 64
    cnt = np.bincount(g, minlength=64)
    tot = np.bincount(g, weights=v, minlength=64)  # exact below 2^53
    top = np.lexsort((np.arange(64), -tot))[:5]
    return [(int(x), int(cnt[x]), int(tot[x])) for x in top]


def htap_rmax(fx) -> int:
    """The resident ``ht`` planes' padded rows a shard (``rmax``)."""
    (dt,) = [d for (name, _), d in fx.cache._tables.items() if name == "ht"]
    return dt.rmax


def run_htap(args, device, card: str) -> dict:
    """Phase 8 (b): bench.py's HTAP leg (bench.py:1210) at its own
    parameters on the card: ``ht (k, g, v)`` sharded by k over 2
    datanodes with 100 000 rows loaded by INSERT and compacted, then
    for 4 s: a 500-row INSERT, 8 UPDATEs of 10 consecutive keys (v + 1),
    and the top-5 query, each answer exact against numpy over the
    loop's record of the writes. The device cache's counters stand for
    the reference's pg_stat_fused and pg_stat_wal."""
    import random

    import torch

    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    secs, preload, ins_rows, upd_stmts = 4.0, 100_000, 500, 8
    cluster = Cluster(num_datanodes=2, shard_groups=64, device=device)
    s = cluster.session()
    s.execute("create table ht (k bigint, g bigint, v bigint) "
              "distribute by shard(k)")

    def rows(lo, n):
        return ",".join(f"({k}, {k % 64}, {k % 9973})"
                        for k in range(lo, lo + n))

    for lo in range(0, preload, 8000):
        s.execute("insert into ht values "
                  + rows(lo, min(8000, preload - lo)))
    cluster.compact_deltas()
    v = np.arange(preload, dtype=np.int64) % 9973
    if s.query(HTAP_TOPK) != expected_htap(v):
        raise AssertionError("HTAP warm top-5 != numpy")
    fx = cluster.fused_executor()
    c0 = dict(fx.cache.stats)
    rmax0 = htap_rmax(fx)
    absorbed0 = sum(st.deltas_absorbed for tabs in cluster.stores.values()
                    for st in tabs.values())
    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    rng = random.Random(11)
    k_next, written, scans, checking = preload, 0, 0, 0.0
    stop_at = time.monotonic() + secs
    t0 = time.perf_counter()
    while time.monotonic() < stop_at:
        s.execute("insert into ht values " + rows(k_next, ins_rows))
        v = np.concatenate([v, np.arange(k_next, k_next + ins_rows) % 9973])
        k_next += ins_rows
        written += ins_rows
        for _ in range(upd_stmts):
            lo = rng.randrange(0, k_next - 10)
            s.execute(f"update ht set v = v + 1 where k >= {lo} "
                      f"and k < {lo + 10}")
            v[lo:lo + 10] += 1
            written += 10
        got = s.query(HTAP_TOPK)
        scans += 1
        t1 = time.perf_counter()
        if got != expected_htap(v):
            raise AssertionError(f"HTAP scan {scans}: port {got} != numpy")
        checking += time.perf_counter() - t1
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0 - checking
    moved = {k: fx.cache.stats[k] - c0[k] for k in fx.cache.stats}
    on_folds = sum(st.deltas_absorbed for tabs in cluster.stores.values()
                   for st in tabs.values()) - absorbed0
    runner = fx._dag
    print(f"main path: HTAP loop {scans} top-5 scans exact (mode "
          f"{runner.last_mode}, scan_agg launches {sa.scan_agg.launches}, "
          f"radix_probe launches {rp.radix_probe.launches}); "
          f"{written / elapsed:.1f} rows/s written over {elapsed:.3f} s "
          f"({k_next} rows at the end; programs cached "
          f"{len(runner._programs)}) [{card}]", flush=True)
    print("refresh: HTAP loop device cache " + ", ".join(
        f"{k} {n}" for k, n in moved.items())
        + f"; rows a shard can hold {rmax0} -> {htap_rmax(fx)} [{card}]",
        flush=True)
    # the one full upload the reference also makes here: a shard's rows
    # outgrow the padded capacity (how many scans the loop fits decides
    # whether it does); any other rebuild means a refresh went wrong
    if moved["full_uploads"] != moved["rmax_rebuilds"]:
        raise AssertionError(
            f"HTAP loop: {moved['full_uploads']} full uploads after warm-up, "
            f"only {moved['rmax_rebuilds']} of them by a shard past rmax")
    if moved["rmax_rebuilds"] and htap_rmax(fx) <= rmax0:
        raise AssertionError("HTAP loop: rebuilt past rmax without growing it")
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    # phase 17 (a): as many batches again with enable_delta_scan off, the
    # fold-on-read baseline bench.py's HTAP leg differentials against
    wal = "select stat, value from pg_stat_wal where stat in " \
        "('deltas_absorbed', 'pending_delta_rows') order by stat"
    before = dict(s.query(wal))
    s.execute("set enable_delta_scan = off")
    off_batches = min(scans, HTAP_FOLD_BATCHES)
    off_written, t0, checking = 0, time.perf_counter(), 0.0
    for _ in range(off_batches):
        s.execute("insert into ht values " + rows(k_next, ins_rows))
        v = np.concatenate([v, np.arange(k_next, k_next + ins_rows) % 9973])
        k_next += ins_rows
        off_written += ins_rows
        for _ in range(upd_stmts):
            lo = rng.randrange(0, k_next - 10)
            s.execute(f"update ht set v = v + 1 where k >= {lo} "
                      f"and k < {lo + 10}")
            v[lo:lo + 10] += 1
            off_written += 10
        got = s.query(HTAP_TOPK)
        t1 = time.perf_counter()
        if got != expected_htap(v):
            raise AssertionError(f"HTAP scan, delta scan off: port {got} "
                                 "!= numpy")
        checking += time.perf_counter() - t1
    torch.cuda.synchronize()
    off_elapsed = time.perf_counter() - t0 - checking
    s.execute("reset enable_delta_scan")
    after = dict(s.query(wal))
    folds = after["deltas_absorbed"] - before["deltas_absorbed"]
    print(f"main path: HTAP loop with enable_delta_scan = off, "
          f"{off_batches} batches exact: {off_written / off_elapsed:.1f} rows/s written "
          f"over {off_elapsed:.3f} s against {written / elapsed:.1f} rows/s "
          f"with it on; deltas_absorbed +{folds} (on: +{on_folds}), "
          f"pending_delta_rows {after['pending_delta_rows']} [{card}]",
          flush=True)
    if folds <= 0 or after["pending_delta_rows"]:
        raise AssertionError(f"enable_delta_scan off did not fold on read: "
                             f"{before} -> {after}")
    return {"rows_per_sec": written / elapsed, "scans": scans,
            "rows_per_sec_fold": off_written / off_elapsed,
            "folds": {"on": on_folds, "off": folds},
            "cache": moved, "launches": launches}


def run_ssb_delete(ssb: dict, args, card: str) -> dict:
    """Phase 8 (c): in phase 5's SSB cluster, after flights 1-4 and their
    kernel timings: DELETE the rows of the first 0.1 % of lo_orderkeys,
    then flight 1 again, each exact against numpy over the remaining
    rows, K2 launched in each run over the now full MVCC planes."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp

    cluster, s = ssb["cluster"], ssb["session"]
    lo, dd = ssb["tables"]["lineorder"], ssb["tables"]["date_dim"]
    cut = max(int(lo["lo_orderkey"].max()) // 1000, 1)
    fx = cluster.fused_executor()
    t0 = time.perf_counter()
    n = s.execute(f"delete from lineorder where lo_orderkey <= {cut}"
                  ).rowcount
    ms = (time.perf_counter() - t0) * 1000
    keep = lo["lo_orderkey"] > cut
    if n != int((~keep).sum()):
        raise AssertionError(f"SSB delete: {n} rows, not {(~keep).sum()}")
    print(f"write: SSB DELETE of lineorder's first {cut} order keys: {n} "
          f"rows, {ms:.3f} ms [{card}]", flush=True)
    rest = {c: lo[c][keep] for c in ("lo_orderdate", "lo_quantity",
                                     "lo_discount", "lo_extendedprice")}
    queries, launches, e2e, wants = {}, {}, {}, {}
    for q, sql in SSB_Q.items():
        name = f"{q} after delete"
        queries[name] = sql
        wants[q] = want = expected_ssb(rest, dd, q)
        c0 = dict(fx.cache.stats)
        rp.radix_probe.launches = 0
        got = s.query(sql)
        torch.cuda.synchronize()
        launches[name] = rp.radix_probe.launches
        moved = {k: fx.cache.stats[k] - c0[k] for k in REFRESH_STATS}
        modes = fx._dag.last_join_modes
        if got != want:
            raise AssertionError(f"SSB {name}: port {got} != numpy {want}")
        if launches[name] < 1 or "radix" not in modes:
            raise AssertionError(f"SSB {name}: radix_probe launches "
                                 f"{launches[name]}, join modes {modes}")
        ts = []
        for _ in range(args.repeats):
            t1 = time.perf_counter()
            if s.query(sql) != want:
                raise AssertionError(f"SSB {name}: answer changed")
            ts.append((time.perf_counter() - t1) * 1000)
        e2e[name] = statistics.median(ts)
        print(f"main path: SSB {name} exact through the fused DAG (join "
              f"modes {modes}, radix_probe launches {launches[name]}; the "
              f"first run's refresh " + ", ".join(
                  f"{k} {v}" for k, v in moved.items())
              + f"; warm median {e2e[name]:.3f} ms) {got} [{card}]",
              flush=True)
    dt = fx.cache._tables[("lineorder", (0, 1))]
    if dt.xmin.shape[1] == 1:
        raise AssertionError("SSB delete: lineorder's planes stayed compact")
    return {"queries": queries, "launches": launches, "e2e": e2e,
            "wants": wants}


def capture_probe_inputs(ssb: dict, sql: str):
    """The arguments the fused DAG hands radix_probe for ``sql``: one more
    warm run with the DAG's handle on the wrapper swapped for a recorder
    that delegates to it (so the launch still counts nowhere that a
    check reads)."""
    import types

    from opentenbase_tpu_torch.executor import fused_dag
    from opentenbase_tpu_torch.ops import radix_probe as rp

    calls = []

    def record(*a):
        calls.append(a)
        return rp.radix_probe(*a)

    fused_dag.rp = types.SimpleNamespace(radix_probe=record)
    try:
        ssb["session"].query(sql)
    finally:
        fused_dag.rp = rp
    if len(calls) != 1:
        raise AssertionError(f"expected one probe, saw {len(calls)}")
    return calls[0]


def time_radix(ssb: dict, card: str, rate: float, queries,
               label: str = "SSB") -> list:
    """radix_probe's kernel, plain-version and bound times at the main
    path's own inputs (the SF10 shapes), held equal to the plain version
    there too. Bound: the bytes the probe must move (ops/radix_probe
    probe_bytes: each row's real flag read and its matched flag and bidx
    written, the real rows' keys, the table once) over the HBM rate."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp

    rows = []
    n0 = rp.radix_probe.launches
    for q, sql in queries.items():
        args = capture_probe_inputs(ssb, sql)
        tk, tv, ti, pk, preal, P, B = args
        km, kb = rp.radix_probe(*args)
        pm, pb = rp.radix_probe_plain(*args)
        torch.cuda.synchronize()
        err = max(int((km != pm).sum()), int((kb - pb).abs().max()))
        if err:
            raise AssertionError(f"radix_probe {q}: kernel != plain")
        ms = _cuda_ms(lambda: rp.radix_probe(*args), 20)
        plain_ms = _cuda_ms(lambda: rp.radix_probe_plain(*args), 3)
        n = pk.shape[0]
        nbytes = rp.probe_bytes(tk, pk, preal)
        bound = nbytes / rate * 1e3
        rows.append({
            "query": q, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "bytes": nbytes, "max_abs_err": float(err),
        })
        print(f"kernel: radix_probe {label} {q} {ms:.4f} ms, "
              f"{nbytes / ms / 1e6:.1f} GB/s, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms "
              f"({nbytes} bytes at {rate / 1e12:.2f} TB/s; P={P}, B={B}, "
              f"{n} probe rows, {int(preal.sum())} real, "
              f"{int(km.sum())} matched) [{card}]", flush=True)
    rp.radix_probe.launches = n0  # timing launches are not counted
    return rows


# ---------------------------------------------------------------------------
# phase 9: semi and anti joins, join rows, gseg, the zone window, the
# chunked scan
# ---------------------------------------------------------------------------

ORDER_STATUS = (
    "select o_orderkey, o_orderdate, l_extendedprice, l_quantity, "
    "l_shipdate from orders, lineitem where o_orderkey = l_orderkey "
    "and o_custkey = {c} "
    "order by o_orderkey, l_extendedprice, l_quantity, l_shipdate"
)
_MONTH = ("from orders, lineitem where o_orderkey = l_orderkey "
          "and o_orderdate >= date '1995-01-01' "
          "and o_orderdate < date '1995-02-01' ")
MONTH_LINES = ("select l_orderkey, l_extendedprice, l_quantity, o_orderdate "
               + _MONTH + "order by l_orderkey, l_extendedprice, l_quantity")
MONTH_TOP = ("select l_orderkey, l_extendedprice, o_orderdate " + _MONTH
             + "order by l_extendedprice desc, l_orderkey limit 100")
# grouped by the build key of the top join and a FLOAT8 build column
# (gagg takes integer and TEXT keys only), with an aggregate over the
# build side (gsort reads the probe side only): gseg
GSEG_Q = (
    "select o_orderkey, o_weight, count(*), sum(l_extendedprice), "
    "max(o_orderdate) from orders, lineitem "
    "where l_orderkey = o_orderkey and o_orderdate < date '1995-03-15' "
    "group by o_orderkey, o_weight order by 4 desc, 1 limit 10"
)


def _lines_of(orders, lineitem, omask):
    """(order row, line row) of every line whose order ``omask`` marks,
    in line order."""
    opos = _key_pos(orders["o_orderkey"], lineitem["l_orderkey"])
    lm = (opos >= 0) & omask[np.maximum(opos, 0)]
    return opos[lm], np.nonzero(lm)[0]


def expected_order_status(orders, li, cust: int) -> list:
    o, ln = _lines_of(orders, li, orders["o_custkey"] == cust)
    ok, p, q = orders["o_orderkey"][o], li["l_extendedprice"][ln], \
        li["l_quantity"][ln]
    sd = li["l_shipdate"][ln]
    order = np.lexsort((sd, q, p, ok))
    return [(int(ok[i]), _date(orders["o_orderdate"][o[i]]),
             int(p[i]) / 100, int(q[i]) / 100, _date(sd[i])) for i in order]


def expected_month(orders, li, top: bool) -> list:
    """MONTH_LINES' rows, or MONTH_TOP's (``top``), in numpy."""
    od = orders["o_orderdate"]
    o, ln = _lines_of(orders, li, (od >= _day("1995-01-01"))
                      & (od < _day("1995-02-01")))
    ok, p = li["l_orderkey"][ln], li["l_extendedprice"][ln]
    if top:
        order = np.lexsort((ok, -p))[:100]
        return [(int(ok[i]), int(p[i]) / 100, _date(od[o[i]]))
                for i in order]
    q = li["l_quantity"][ln]
    order = np.lexsort((q, p, ok))
    return [(int(ok[i]), int(p[i]) / 100, int(q[i]) / 100, _date(od[o[i]]))
            for i in order]


def expected_gseg(orders, li) -> list:
    o, ln = _lines_of(orders, li, orders["o_orderdate"] < _day("1995-03-15"))
    n_o = len(orders["o_orderkey"])
    cnt = np.bincount(o, minlength=n_o)
    # float64 sums are exact here: every order's sum is far below 2^53
    sums = np.rint(np.bincount(o, weights=li["l_extendedprice"][ln],
                               minlength=n_o)).astype(np.int64)
    ok = orders["o_orderkey"]
    g = np.nonzero(cnt)[0]
    top = g[np.lexsort((ok[g], -sums[g]))[:10]]
    return [(int(ok[i]), float(orders["o_weight"][i]), int(cnt[i]),
             int(sums[i]) / 100, _date(orders["o_orderdate"][i]))
            for i in top]


def run_dag_query(name: str, cluster, sql: str, want: list, mode: str,
                  join_modes: tuple, repeats: int, card: str) -> dict:
    """One DAG query of phase 9: the first run exact against numpy in
    ``mode`` with ``join_modes`` (the reference's one-device runner's on
    the same shape, tests/test_torch_semi_anti.py, test_torch_rows.py,
    test_torch_dag_topk.py), K1's and K2's launches counted from 0 around
    it (K2 at least once where the join modes name the radix table, else
    never; K1 never); then the warm median, the layers and a trace."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    s = cluster.session()
    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    t1 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    r = cluster.fused_executor()._dag
    seen = (r.last_mode, r.last_join_modes)
    if got != want:
        raise AssertionError(f"{name}: port {got[:3]}... ({len(got)} rows) "
                             f"!= numpy {want[:3]}... ({len(want)} rows)")
    if seen != (mode, join_modes) or not s._fused_via_dag:
        raise AssertionError(f"{name}: mode and join modes {seen}, want "
                             f"{(mode, join_modes)}")
    k2 = "radix" in join_modes
    if launches["scan_agg"] or bool(launches["radix_probe"]) != k2:
        raise AssertionError(f"{name}: launches {launches}")
    print(f"main path: {name} exact through the fused DAG (mode {mode}, "
          f"join modes {join_modes}; scan_agg launches "
          f"{launches['scan_agg']}, radix_probe launches "
          f"{launches['radix_probe']}; {len(got)} rows; first run incl. "
          f"upload {first_ms:.3f} ms) {got[:2]}... [{card}]", flush=True)
    # a query over 1 s (the month of lines ships 772 479 rows) gets one
    # warm, layered and traced run, and the tracer started long before
    slow = first_ms > 1000
    return {"launches": launches, "first_ms": first_ms,
            **measure_warm(name, cluster, sql, want,
                           max(1, warm_repeats(first_ms, repeats)), card,
                           True, f" (mode {mode})", trace_warm=not slow)}


def run_phase9(q3: dict, args, card: str) -> dict:
    """Phase 9 (a, b, c, e) in phase 5c's SF10 cluster, after its Q3 and
    Q1 and before phase 8 writes into it: TPC-H Q4 (grouped over a semi
    join) and its NOT EXISTS complement (scalar over an anti join); an
    order-status lookup (TPC-C's Order-Status read, clause 2.6: one
    customer's order lines) and one month of order lines (rows), the
    month's 100 largest lines (rows_topk); GSEG_Q (gseg); then CREATE
    INDEX on lineitem (l_orderkey) and Q1's select list over the first
    1 % of order keys through the fragment program's zone window, timed
    beside the same query before the index. The zone window comes before
    the refreshes because RF1 appends keys from the whole range at every
    shard's tail, after which no contiguous window can leave a block
    out."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp

    cluster, tables = q3["cluster"], q3["tables"]
    o, li = tables["orders"], tables["lineitem"]
    print("load: o_weight (FLOAT8, k / 1000 for k uniform in [0, 10^6)) "
          "is an addition to TPC-H's orders, the build-side key of the "
          f"gseg query [{card}]", flush=True)
    q4, q4_anti = expected_q4(o, li)
    cust = int(o["o_custkey"][len(o["o_custkey"]) // 2])
    status = ORDER_STATUS.format(c=cust)
    rf = ("fold", "radix")
    queries = {
        "TPC-H Q4": (Q4, q4, "grouped", ()),
        "TPC-H Q4 NOT EXISTS": (Q4_ANTI, q4_anti, "scalar", ()),
        "Order-Status lines": (status, expected_order_status(o, li, cust),
                               "rows", rf),
        "month of lines": (MONTH_LINES, expected_month(o, li, False),
                           "rows", rf),
        "month top 100": (MONTH_TOP, expected_month(o, li, True),
                          "rows_topk", rf),
        "gseg": (GSEG_Q, expected_gseg(o, li), "gseg", rf),
    }
    out = {"dag": {}, "fragment": {}}
    for name, (sql, want, mode, jm) in queries.items():
        out["dag"][name] = run_dag_query(name, cluster, sql, want, mode, jm,
                                         args.repeats, card)
    rate = hbm_rate(torch.cuda.get_device_name(0))
    probes = {q: queries[q][0] for q in ("month of lines", "gseg")}
    out["radix_rows"] = time_radix({"session": cluster.session()}, card,
                                   rate, probes, label="TPC-H SF10")
    out["k2_launches"] = {q: out["dag"][q]["launches"]["radix_probe"]
                          for q in queries}
    rp.radix_probe.launches = 0
    out["fragment"] = run_zone(cluster, li, args, card)
    return out


def run_zone(cluster, li, args, card: str) -> dict:
    """Phase 9e: Q1's select list over the first 1 % of order keys,
    before and after CREATE INDEX on lineitem (l_orderkey); lineitem is
    in order-key order on every shard (make_q3_spec's lines follow their
    orders, bulk_append cuts contiguous halves)."""
    keys = li["l_orderkey"]
    n = len(keys)
    for a, b in ((0, n // 2), (n // 2, n)):
        if np.any(np.diff(keys[a:b]) < 0):
            raise AssertionError("lineitem is not in order-key order")
    cut = int(np.unique(keys)[len(np.unique(keys)) // 100])
    sql = Q1_SPEC.replace(
        "where l_shipdate <= date '1998-12-01' - interval '90 days'",
        f"where l_orderkey < {cut}")
    want = expected_q1_spec(li, keys < cut)
    fx = cluster.fused_executor()
    out = {}
    name = "Q1 over 1 % of order keys"
    route = ("program", ("hash", 64))
    out[f"{name}, no index"] = run_fragment_query(
        f"{name}, no index", cluster, sql, want, args.repeats, card, route)
    t0 = time.perf_counter()
    cluster.session().execute(
        "create index li_orderkey on lineitem (l_orderkey)")
    print(f"write: CREATE INDEX li_orderkey on lineitem (l_orderkey): zone "
          f"maps of {n} rows in {(time.perf_counter() - t0) * 1000:.3f} ms "
          f"[{card}]", flush=True)
    out[f"{name}, zone window"] = run_fragment_query(
        f"{name}, zone window", cluster, sql, want, args.repeats, card,
        route)
    z0 = dict(fx.zone_stats)
    if cluster.session().query(sql) != want:
        raise AssertionError(f"{name}: answer changed")
    moved = {k: fx.zone_stats[k] - z0[k] for k in z0}
    if moved["pruned_blocks"] <= 0:
        raise AssertionError(f"{name}: no block pruned ({moved})")
    print(f"zone: {name} (l_orderkey < {cut}): {moved['pruned_blocks']}"
          f" of {moved['total_blocks']} blocks pruned a query; "
          f"median {out[f'{name}, zone window']['e2e']:.3f} ms against "
          f"{out[f'{name}, no index']['e2e']:.3f} ms without the index "
          f"[{card}]", flush=True)
    return out


# the lineitem columns Q1 as the spec writes it and Q6 read
Q1_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
Q6_COLUMNS = ("l_extendedprice", "l_discount", "l_shipdate", "l_quantity")
# Q1 and Q6's columns of lineitem: the chunked scan's table
CHUNKED_DDL = (
    "create table lineitem (l_extendedprice numeric(12,2), "
    "l_discount numeric(4,2), l_shipdate date, l_quantity numeric(10,2), "
    "l_tax numeric(4,2), l_returnflag text, l_linestatus text) "
    "distribute by roundrobin"
)


def run_chunked(args, device, card: str) -> dict:
    """Phase 9d: TPC-H Q1 as the spec writes it and Q6 over make_q3_spec's
    lineitem at ``--chunk-sf`` (default 30: 180 M rows, 2 datanodes round
    robin; cut where the host cannot hold it) under the default
    OTB_SCAN_HBM_BUDGET (8 GB): both scans' resident footprints pass it,
    so each streams shard-row windows through the fragment program, one
    window resident at a time, K1 never launched. Each exact against
    numpy, its windows equal to the footprint model's count."""
    import torch

    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.executor import fused

    sf = chunk_sf(args.chunk_sf)
    t0 = time.perf_counter()
    li = make_q3_spec(sf, args.seed, lineitem_only=True)["lineitem"]
    want = in_threads({"Q1": lambda: expected_q1_spec(li),
                       "Q6": lambda: expected_q6(li)})
    t1 = time.perf_counter()
    cluster = Cluster(num_datanodes=2, device=device)
    cluster.session().execute(CHUNKED_DDL)
    bulk_append(cluster, "lineitem", li)
    n = len(li["l_shipdate"])
    del li
    gc.collect()
    print(f"load: TPC-H SF{sf:g} lineitem (Q1's and Q6's columns), {n} rows "
          f"round robin in 2 datanodes, made on the host with numpy's Q1 "
          f"and Q6 in {t1 - t0:.3f} s, stored in "
          f"{time.perf_counter() - t1:.3f} s [{card}]", flush=True)
    budget = fused.SCAN_HBM_BUDGET
    fused.SCAN_HBM_BUDGET = fused.DEFAULT_SCAN_HBM_BUDGET
    out = {"sf": sf}
    fx = cluster.fused_executor()
    meta = cluster.catalog.get("lineitem")
    try:
        for q, sql, cols in (("Q1", Q1_SPEC, Q1_COLUMNS),
                             ("Q6", Q6, Q6_COLUMNS)):
            name = f"TPC-H {q} (spec, SF{sf:g}, chunked)"
            foot = fx._scan_footprint(meta, cols)[0]
            if foot <= fused.SCAN_HBM_BUDGET:  # a reduced scale
                print(f"reduced: {name} not run: its footprint "
                      f"{foot / 1e9:.3f} GB stays under the budget at "
                      f"SF{sf:g}", flush=True)
                continue
            # one warm run: each takes 6-8 s, and the whole script
            # must stay inside its time limit
            out[name] = run_chunked_query(name, cluster, sql, want[q], 1,
                                          card)
    finally:
        fused.SCAN_HBM_BUDGET = budget
    return out


def chunk_sf(requested: float) -> float:
    """The scale factor 9d runs at: ``requested``, cut to what the host
    can hold, printed as ``reduced:``. The generator, numpy's answers
    and the stores peak near 0.7 GB of host memory a scale factor (1.18
    GB of resident set at SF 1, the interpreter and torch included); the
    cut leaves half again as much. Below about SF 23 Q6's footprint no
    longer passes the budget, and below SF 12 Q1's does not either."""
    try:
        with open("/proc/meminfo") as f:
            avail = next(int(ln.split()[1]) * 1024 for ln in f
                         if ln.startswith("MemAvailable"))
    except (OSError, StopIteration):
        return requested
    fit = avail / 1.05e9
    if fit >= requested:
        return requested
    sf = max(float(int(fit)), 12.0)
    print(f"reduced: the chunked scan at SF{sf:g}, not SF{requested:g} "
          f"(MemAvailable {avail / 1e9:.1f} GB)", flush=True)
    return sf


def run_chunked_query(name: str, cluster, sql: str, want: list,
                      repeats: int, card: str) -> dict:
    """One chunked query of phase 9d: the first run exact against numpy,
    one chunked scan of exactly the windows the footprint model gives
    (the budget's rows a shard, bucketed and halved where the bucket
    overshoots), K1 and K2 never launched, only the last window
    resident; then the warm median, the peak device memory, the layers
    and a trace."""
    import torch

    from opentenbase_tpu_torch.executor import fused
    from opentenbase_tpu_torch.executor.fused import _match_partial_fragment
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa
    from opentenbase_tpu_torch.plan import analyze_statement
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse_one

    fx = cluster.fused_executor()
    cat = cluster.catalog
    (frag,) = distribute_statement(optimize_statement(
        analyze_statement(parse_one(sql), cat), cat), cat).fragments
    m = _match_partial_fragment(frag.root)
    meta = cat.get("lineitem")
    foot, row_bytes, S, mx = fx._scan_footprint(meta, m.scan.columns)
    budget_rows = max(fused.SCAN_HBM_BUDGET // (S * row_bytes), 4096)
    width = 1 << (budget_rows - 1).bit_length()
    if width > budget_rows:
        width //= 2
    windows = -(-mx // width)
    s = cluster.session()
    st = fx.cache.stats
    c0 = dict(st)
    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    moved = {k: st[k] - c0[k] for k in ("chunked_scans", "scan_chunks",
                                        "window_uploads")}
    if got != want:
        raise AssertionError(f"{name}: port {got} != numpy {want}")
    if moved != {"chunked_scans": 1, "scan_chunks": windows,
                 "window_uploads": windows}:
        raise AssertionError(f"{name}: {moved}, want {windows} windows")
    if launches != {"scan_agg": 0, "radix_probe": 0} \
            or fx.last_route != "program":
        raise AssertionError(f"{name}: launches {launches}, route "
                             f"{fx.last_route}")
    resident = [k for k in fx.cache._tables if k[0] == "lineitem"]
    if len(resident) != 1 or resident[0][2] != "win":
        raise AssertionError(f"{name}: resident {resident}")
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: {name} exact through the chunked scan (footprint "
          f"{foot / 1e9:.3f} GB at {row_bytes} bytes a row over {S} shards "
          f"of up to {mx} rows, budget {fused.SCAN_HBM_BUDGET / 1e9:.3f} "
          f"GB; chunked_scans {moved['chunked_scans']}, scan_chunks "
          f"{moved['scan_chunks']} of {width} shard rows, window_uploads "
          f"{moved['window_uploads']}; scan_agg launches 0, radix_probe "
          f"launches 0; first run {first_ms:.3f} ms, peak device "
          f"{peak / 1e9:.3f} GB) {got[:1]}... [{card}]", flush=True)
    return {"launches": launches, "first_ms": first_ms, "route":
            (fx.last_route, fx.last_rung), "windows": moved,
            # the tracer started in earlier phases: no untimed trace
            # first, and no layered run; each run of a chunked scan takes
            # 6-9 s, so the first run's time stands for the warm ones
            **measure_warm(name, cluster, sql, want,
                           warm_repeats(first_ms, repeats), card, False,
                           " (chunked)", trace_warm=False, layered=False,
                           first_ms=first_ms)}


# ---------------------------------------------------------------------------
# phase 10: the host executor and the distributed loop
# ---------------------------------------------------------------------------

# TPC-H rev. 3 Q18 (section 2.4.18) with its validation QUANTITY 300
Q18 = (
    "select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, "
    "sum(l_quantity) from customer, orders, lineitem "
    "where o_orderkey in (select l_orderkey from lineitem "
    "group by l_orderkey having sum(l_quantity) > {quantity}) "
    "and c_custkey = o_custkey and o_orderkey = l_orderkey "
    "group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice "
    "order by o_totalprice desc, o_orderdate limit 100"
)
# TPC-H rev. 3 Q13 (section 2.4.13) with its validation WORD1 'special'
# and WORD2 'requests'; the derived table's column list (c_orders
# (c_custkey, c_count)) written as select-list aliases, the one form
# both parsers take
Q13 = (
    "select c_count, count(*) as custdist from (select c_custkey, "
    "count(o_orderkey) as c_count from customer left outer join orders "
    "on c_custkey = o_custkey and o_comment not like '%special%requests%' "
    "group by c_custkey) as c_orders "
    "group by c_count order by custdist desc, c_count desc"
)
# one day's order lines, no aggregate: the DAG's "trivial scan"
BARE_SCAN = ("select l_orderkey, l_extendedprice, l_discount from lineitem "
             "where l_shipdate = date '1995-03-15'")
# each customer's three largest orders, ties kept, through rank()
TOP3_ORDERS = (
    "select o_custkey, o_orderkey, o_totalprice, r from (select o_custkey, "
    "o_orderkey, o_totalprice, rank() over (partition by o_custkey order "
    "by o_totalprice desc) as r from orders) x where r <= 3 "
    "order by o_custkey, r, o_orderkey limit 1000"
)
ORDERS_COUNT = "select count(*) from orders"
# ClickBench's top ten on its own table: the UserID column alone
HITS_USERS_DDL = ("create table hits (UserID bigint) "
                  "distribute by roundrobin")
HITS_FULL_ROWS = 99_997_497
HITS_FULL_USERS = 17_630_976


def expected_q18(li, o, c, quantity: int = 300) -> tuple:
    """Q18 in numpy: (the rows in the query's order, ties in price and
    date by order key; whether the 100th and 101st rows tie on the sort
    keys, so that the limit's cut is not determined)."""
    okey = o["o_orderkey"]
    opos = _key_pos(okey, li["l_orderkey"])
    qsum = np.rint(np.bincount(opos, weights=li["l_quantity"],
                               minlength=len(okey))).astype(np.int64)
    big = np.nonzero(qsum > quantity * 100)[0]
    tp, od = o["o_totalprice"][big], o["o_orderdate"][big]
    order = big[np.lexsort((okey[big], od, -tp))]
    cpos = _key_pos(c["c_custkey"], o["o_custkey"][order])
    names = c["c_name"].vocab[c["c_name"].idx[cpos]]
    rows = [(str(n), int(ck), int(k), _date(int(d)), int(p) / 100,
             int(q) / 100)
            for n, ck, k, d, p, q in zip(
                names, o["o_custkey"][order], okey[order],
                o["o_orderdate"][order], o["o_totalprice"][order],
                qsum[order])]
    tie = len(rows) > 100 and rows[99][3:5] == rows[100][3:5]
    return rows[:100], tie


def expected_q13(o, c) -> list:
    """Q13 in numpy: each customer's orders whose comment does not match
    '%special%requests%' counted (0 for a customer with none), then the
    customers per count, by that number descending, then count
    descending."""
    pool = o["o_comment"].vocab
    bad = like_mask(pool, "%special%requests%")[o["o_comment"].idx]
    cpos = _key_pos(c["c_custkey"], o["o_custkey"][~bad])
    cnt = np.bincount(cpos[cpos >= 0], minlength=len(c["c_custkey"]))
    vals, dist = np.unique(cnt, return_counts=True)
    order = np.lexsort((-vals, -dist))
    return [(int(vals[i]), int(dist[i])) for i in order]


def expected_bare_scan(li) -> list:
    """BARE_SCAN's rows in numpy, sorted (the query has no ORDER BY)."""
    m = li["l_shipdate"] == _day("1995-03-15")
    return sorted(zip(li["l_orderkey"][m].tolist(),
                      (li["l_extendedprice"][m] / 100).tolist(),
                      (li["l_discount"][m] / 100).tolist()))


def expected_top3(o) -> list:
    """TOP3_ORDERS in numpy: each order's rank among its customer's by
    price descending (ties share the lowest), ranks 1-3 kept, the first
    1000 by customer, rank, order key."""
    ck, tp, ok = o["o_custkey"], o["o_totalprice"], o["o_orderkey"]
    order = np.lexsort((-tp, ck))
    sck, stp = ck[order], tp[order]
    idx = np.arange(len(order))
    newpart = np.r_[True, sck[1:] != sck[:-1]]
    newpeer = newpart | np.r_[True, stp[1:] != stp[:-1]]
    pos = idx - np.maximum.accumulate(np.where(newpart, idx, 0))
    rank = pos[np.maximum.accumulate(np.where(newpeer, idx, -1))] + 1
    keep = order[rank <= 3]
    r = rank[rank <= 3]
    pick = np.lexsort((ok[keep], r, ck[keep]))[:1000]
    return [(int(ck[keep[i]]), int(ok[keep[i]]), int(tp[keep[i]]) / 100,
             int(r[i])) for i in pick]


def host_query(name: str, cluster, sql: str, check, repeats: int,
               card: str, session=None, fresh_dag: bool = False) -> dict:
    """One phase-10 query: the first run on the host route (the fused
    executors declined it, or the session turned them off), K1's and
    K2's launches counted from 0 around it and both 0, the answer held
    by ``check`` (which raises on a wrong one); its route, declines,
    join modes, per fragment and node ms and rows, motions, coordinator
    ms and bytes uploaded printed; then the warm median of the runs
    ``warm_repeats`` allows (a cut that keeps the whole script inside
    its time limit; each checked), the resident
    and peak device memory over them, and one traced run's device busy
    time and idle share (none past TRACE_MAX_FIRST_MS). With
    ``fresh_dag`` every run starts from a fresh DAG runner, so each
    takes the first run's route (the runner's retry state would
    otherwise remember a refusal and change the route of later runs)."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    s = session if session is not None else cluster.session()

    def query():
        if fresh_dag:
            s.cluster.fused_executor()._dag = None
        out = s.query(sql)
        if s.last_route != "host":
            raise AssertionError(f"{name}: route {s.last_route}, want "
                                 "host")
        return out

    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    t1 = time.perf_counter()
    got = query()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    if launches["scan_agg"] or launches["radix_probe"]:
        raise AssertionError(f"{name}: kernel launches {launches} on the "
                             "host route")
    check(got)
    ex = s.last_executor
    repeats = warm_repeats(first_ms, repeats)
    print(f"host path: {name} exact on the host route (declined: "
          f"{'; '.join(s.last_declines)}; join modes {ex.join_modes}; "
          f"scan_agg launches 0, radix_probe launches 0; {len(got)} rows; "
          f"first run {first_ms:.3f} ms) {got[:2]}... [{card}]", flush=True)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ts = []
    for _ in range(repeats):
        t1 = time.perf_counter()
        got = query()
        ts.append((time.perf_counter() - t1) * 1000)
        check(got)
    e2e = statistics.median(ts) if ts else first_ms
    peak = torch.cuda.max_memory_allocated()
    ex = s.last_executor
    frags = "; ".join(
        f"fragment {r['fragment']} @ dn{r['node']} {r['ms']:.3f} ms "
        f"{r['rows']} rows" for r in ex.instrumentation)
    motions = "; ".join(
        f"fragment {k} {m['kind']} {m['rows']} rows {m['bytes']} B "
        f"{m['ms']:.3f} ms" for k, m in ex.motion_stats.items())
    layers = {
        "fragments": sum(r["ms"] for r in ex.instrumentation),
        "motions": sum(m["ms"] for m in ex.motion_stats.values()),
        "coordinator": ex.coordinator_ms,
    }
    print(f"host path: {name} last warm run: {frags}; motions: {motions}; "
          f"coordinator {ex.coordinator_ms:.3f} ms; uploaded "
          f"{ex.h2d_bytes} B [{card}]", flush=True)
    print(f"end to end: {name} median {e2e:.3f} ms over {repeats} runs "
          f"(host route) [{card}]", flush=True)
    print(f"memory: {name} resident {resident / 1e9:.3f} GB, peak over the "
          f"warm runs {peak / 1e9:.3f} GB [{card}]", flush=True)
    if first_ms > TRACE_MAX_FIRST_MS:
        tr = untraced(name, first_ms)
    else:
        tr = trace_query(s, sql, 1, before=(
            (lambda: setattr(s.cluster.fused_executor(), "_dag", None))
            if fresh_dag else None), warm=False)
        if s.last_route != "host":
            raise AssertionError(f"{name}: traced route {s.last_route}")
        idle = ("not measured (no device events in the trace)"
                if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
        top = "; ".join(f"{k} {v:.3f} ms" for k, v in tr["top"])
        print(f"trace: {name} one query under torch.profiler: host "
              f"{tr['wall_ms']:.3f} ms, device busy {tr['busy_ms']:.3f} "
              f"ms, idle share {idle}; the most device time: {top} "
              f"[{card}]", flush=True)
    return {"route": "host", "launches": launches, "first_ms": first_ms,
            "e2e": e2e, "layers": layers, "trace": tr,
            "resident_gb": resident / 1e9, "peak_gb": peak / 1e9,
            "h2d_bytes": ex.h2d_bytes, "join_modes": list(ex.join_modes)}


def equal_to(name: str, want):
    def check(got):
        if got != want:
            raise AssertionError(f"{name}: port {got[:3]}... ({len(got)} "
                                 f"rows) != numpy {want[:3]}... "
                                 f"({len(want)} rows)")
    return check


def sorted_equal_to(name: str, want):
    return lambda got: equal_to(name, want)(sorted(got))


def q18_check(want):
    """Q18's rows as a set, and their order on the query's sort keys
    (price descending, date): rows that tie on both may come either
    way."""
    def check(got):
        equal_to("TPC-H Q18", sorted(want))(sorted(got))
        keys = [(-r[4], r[3]) for r in got]
        if keys != sorted(keys):
            raise AssertionError("TPC-H Q18: rows out of order")
    return check


def start_phase10_answers(tables: dict):
    """numpy's phase-10 answers over phase 5c's tables, started in threads
    (beside phase 9's queries: a cut for the time limit); returns
    ``start_threads``' waiting function."""
    li, o, c = tables["lineitem"], tables["orders"], tables["customer"]
    return start_threads({
        "Q18": lambda: expected_q18(li, o, c),
        "Q13": lambda: expected_q13(o, c), "Q6": lambda: expected_q6(li),
        "Q1 (spec)": lambda: expected_q1_spec(li),
        "Q3 (spec)": lambda: expected_q3(li, o, c, "BUILDING"),
        "bare scan": lambda: expected_bare_scan(li),
        "top-3 orders": lambda: expected_top3(o)})


def run_phase10(q3: dict, args, card: str, answers=None) -> dict:
    """Phase 10 (b) in phase 5c's SF10 cluster, before phase 8's writes:
    TPC-H Q18 and Q13, the bare scan and the top-3 window query on the
    host route (the fused executors decline them as the reference's
    do), then Q6, Q1 and Q3 as the spec writes them with
    ``enable_fused_execution`` off. Each exact against numpy's answers
    (``answers``: ``start_phase10_answers``' function, started earlier;
    started here where None)."""
    cluster = q3["cluster"]
    t0 = time.perf_counter()
    ans = (answers or start_phase10_answers(q3["tables"]))()
    q18, tie = ans["Q18"]
    if tie:
        raise AssertionError("TPC-H Q18: the limit cuts a tie")
    ans["Q18"] = q18
    # numpy's answers over the loaded rows, kept for phase 12
    q3["answers"] = {k: ans[k] for k in
                     ("Q18", "Q13", "Q6", "Q1 (spec)", "Q3 (spec)")}
    wants = {
        "TPC-H Q18": (Q18.format(quantity=300), q18_check(q18)),
        "TPC-H Q13": (Q13, equal_to("TPC-H Q13", ans["Q13"])),
        "bare scan": (BARE_SCAN, sorted_equal_to("bare scan",
                                                 ans["bare scan"])),
        "top-3 orders (rank)": (TOP3_ORDERS, equal_to(
            "top-3 orders", ans["top-3 orders"])),
    }
    print(f"load: phase 10 numpy answers waited for "
          f"{time.perf_counter() - t0:.3f} s (begun before phase 9); o_comment from a pool of {COMMENT_POOL} grammar strings "
          f"(reduced from one a row), Q18 {len(q18)} rows [{card}]",
          flush=True)
    out = {}
    for name, (sql, check) in wants.items():
        out[name] = host_query(name, cluster, sql, check, args.repeats, card)
    s = cluster.session()
    s.execute("set enable_fused_execution = off")
    for name, sql, want in (
            ("TPC-H Q6 (spec, fused off)", Q6, ans["Q6"]),
            ("TPC-H Q1 (spec, fused off)", Q1_SPEC, ans["Q1 (spec)"]),
            ("TPC-H Q3 (spec, fused off)", Q3_SPEC, ans["Q3 (spec)"])):
        out[name] = host_query(name, cluster, sql, equal_to(name, want),
                               args.repeats, card, session=s)
    return out


# -- phase 15: the expression library and the query sugar -----------------

# TPC-H rev. 3, section 4.2.3: NATION and REGION, the P_NAME word list
# and P_TYPE's syllables
NATIONS = (
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
)
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
P_NAME_WORDS = (
    "almond", "antique", "aquamarine", "azure", "beige", "bisque",
    "black", "blanched", "blue", "blush", "brown", "burlywood",
    "burnished", "chartreuse", "chiffon", "chocolate", "coral",
    "cornflower", "cornsilk", "cream", "cyan", "dark", "deep", "dim",
    "dodger", "drab", "firebrick", "floral", "forest", "frosted",
    "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew", "hot",
    "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive",
    "orange", "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
    "powder", "puff", "purple", "red", "rose", "rosy", "royal", "saddle",
    "salmon", "sandy", "seashell", "sienna", "sky", "slate", "smoke",
    "snow", "spring", "steel", "tan", "thistle", "tomato", "turquoise",
    "violet", "wheat", "white", "yellow",
)
P_TYPES = tuple(f"{a} {b} {c}" for a in (
    "STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
    for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
    for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
# phase 5c's SF10 tables with phase 15's columns (appended, so RF1's
# positional INSERTs keep their meaning) and tables; phase 12 loads
# Q3_SPEC_DDL's columns only
SPEC15_DDL = (
    Q3_SPEC_DDL[0].replace(
        "c_name text)",
        "c_name text, c_nationkey int, c_phone text, "
        "c_acctbal numeric(12,2))"),
    Q3_SPEC_DDL[1],
    Q3_SPEC_DDL[2].replace(
        "l_commitdate date)",
        "l_commitdate date, l_partkey bigint, l_suppkey bigint)"),
    "create table nation (n_nationkey int, n_name text, n_regionkey int) "
    "distribute by replication",
    "create table region (r_regionkey int, r_name text) "
    "distribute by replication",
    "create table supplier (s_suppkey bigint, s_name text, s_address text, "
    "s_nationkey int, s_phone text) distribute by roundrobin",
    "create table part (p_partkey bigint, p_name text, p_type text) "
    "distribute by roundrobin",
    "create table partsupp (ps_partkey bigint, ps_suppkey bigint, "
    "ps_supplycost numeric(12,2)) distribute by roundrobin",
)
Q7 = (
    "select supp_nation, cust_nation, l_year, sum(volume) as revenue "
    "from (select n1.n_name as supp_nation, n2.n_name as cust_nation, "
    "extract(year from l_shipdate) as l_year, "
    "l_extendedprice * (1 - l_discount) as volume "
    "from supplier, lineitem, orders, customer, nation n1, nation n2 "
    "where s_suppkey = l_suppkey and o_orderkey = l_orderkey "
    "and c_custkey = o_custkey and s_nationkey = n1.n_nationkey "
    "and c_nationkey = n2.n_nationkey "
    "and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY') "
    "or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE')) "
    "and l_shipdate between date '1995-01-01' and date '1996-12-31'"
    ") as shipping group by supp_nation, cust_nation, l_year "
    "order by supp_nation, cust_nation, l_year"
)
Q8 = (
    "select o_year, sum(case when nation = 'BRAZIL' then volume else 0 "
    "end) / sum(volume) as mkt_share "
    "from (select extract(year from o_orderdate) as o_year, "
    "l_extendedprice * (1 - l_discount) as volume, n2.n_name as nation "
    "from part, supplier, lineitem, orders, customer, nation n1, "
    "nation n2, region where p_partkey = l_partkey "
    "and s_suppkey = l_suppkey and l_orderkey = o_orderkey "
    "and o_custkey = c_custkey and c_nationkey = n1.n_nationkey "
    "and n1.n_regionkey = r_regionkey and r_name = 'AMERICA' "
    "and s_nationkey = n2.n_nationkey "
    "and o_orderdate between date '1995-01-01' and date '1996-12-31' "
    "and p_type = 'ECONOMY ANODIZED STEEL') as all_nations "
    "group by o_year order by o_year"
)
Q9 = (
    "select nation, o_year, sum(amount) as sum_profit "
    "from (select n_name as nation, extract(year from o_orderdate) "
    "as o_year, l_extendedprice * (1 - l_discount) "
    "- ps_supplycost * l_quantity as amount "
    "from part, supplier, lineitem, partsupp, orders, nation "
    "where s_suppkey = l_suppkey and ps_suppkey = l_suppkey "
    "and ps_partkey = l_partkey and p_partkey = l_partkey "
    "and o_orderkey = l_orderkey and s_nationkey = n_nationkey "
    "and p_name like '%green%') as profit "
    "group by nation, o_year order by nation, o_year desc"
)
# Q15's revenue0 over its quarter (1996-01-01 + interval '3' month
# written as the date it folds to), as a view, a WITH and a table
Q15_REVENUE = (
    "select l_suppkey as supplier_no, "
    "sum(l_extendedprice * (1 - l_discount)) as total_revenue "
    "from lineitem where l_shipdate >= date '1996-01-01' "
    "and l_shipdate < date '1996-04-01' group by l_suppkey"
)
Q15_QUERY = (
    "select s_suppkey, s_name, s_address, s_phone, total_revenue "
    "from supplier, revenue0 where s_suppkey = supplier_no "
    "and total_revenue = (select max(total_revenue) from revenue0) "
    "order by s_suppkey"
)
Q15_WITH = f"with revenue0 as ({Q15_REVENUE}) {Q15_QUERY}"
Q22_CORE = (
    "select substring(c_phone from 1 for 2) as cntrycode, count(*) "
    "as numcust, sum(c_acctbal) as totacctbal from customer "
    "group by substring(c_phone from 1 for 2) order by cntrycode"
)
Q6_VIEW = ("create view q6_lines as select l_extendedprice, l_discount, "
           "l_shipdate, l_quantity from lineitem")
Q6_MONTH_DDL = ("create table q6_month (l_extendedprice numeric(12,2), "
                "l_discount numeric(4,2), l_shipdate date, "
                "l_quantity numeric(10,2)) distribute by roundrobin")
Q6_MONTH_INSERT = (
    "insert into q6_month select l_extendedprice, l_discount, l_shipdate, "
    "l_quantity from lineitem where l_shipdate >= date '1994-03-01' "
    "and l_shipdate < date '1994-04-01'")


def _text_rows(n: int, parts) -> np.ndarray:
    """n strings assembled from byte columns: ``parts`` is a list of
    [n, w] uint8 arrays (a literal is one row broadcast), joined left to
    right into fixed-width bytes, decoded to str."""
    cols = [np.broadcast_to(p, (n, p.shape[1])) for p in parts]
    m = np.ascontiguousarray(np.concatenate(cols, axis=1))
    return m.view(f"S{m.shape[1]}").reshape(-1).astype(str)


def _digits(rng, n: int, k: int) -> np.ndarray:
    """[n, k] ASCII digits of a uniform integer in [10^(k-1), 10^k)."""
    v = rng.integers(10 ** (k - 1), 10 ** k, n)
    out = np.empty((n, k), dtype=np.uint8)
    for j in range(k - 1, -1, -1):
        out[:, j] = 48 + v % 10
        v //= 10
    return out


def _lit(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8).reshape(1, -1)


def _phones(rng, nationkey) -> np.ndarray:
    """dbgen's phone numbers: the country code (nation key + 10), then
    three, three and four random digits."""
    n = len(nationkey)
    cc = np.stack([48 + (nationkey + 10) // 10, 48 + (nationkey + 10) % 10],
                  axis=1).astype(np.uint8)
    return _text_rows(n, [cc, _lit("-"), _digits(rng, n, 3), _lit("-"),
                          _digits(rng, n, 3), _lit("-"),
                          _digits(rng, n, 4)])


def _suppkey(partkey, i, n_s: int):
    """The spec's supplier of a part's i-th partsupp row (4.2.3)."""
    return (partkey + i * (n_s // 4 + (partkey - 1) // n_s)) % n_s + 1


def make_phase15(tables: dict, sf: float, seed: int = 42) -> dict:
    """Phase 15's columns and tables as dbgen makes them (TPC-H rev. 3,
    4.2.3) beside ``make_q3_spec(sf, seed)``'s ``tables``: lineitem's
    l_partkey (the part make_q3_spec priced each line by, its stream
    drawn again) and l_suppkey (one of the part's four suppliers,
    uniform), customer's c_nationkey, c_phone and c_acctbal, nation,
    region, supplier (10 000 x SF: s_name, s_address, s_nationkey,
    s_phone), part (200 000 x SF: p_name of five distinct P_NAME words,
    p_type) and partsupp (four rows a part, the spec's suppliers,
    ps_supplycost). Each random column from a stream of its own
    (``seed`` + 1501 ...), so the columns phases 5-14 read keep their
    values. Left out (PERF.md's reduced list): every other column of
    the five tables."""
    n_c = len(tables["customer"]["c_custkey"])
    n_l = len(tables["lineitem"]["l_orderkey"])
    n_p = max(int(200_000 * sf), 1)
    n_s = max(int(10_000 * sf), 4)

    def rng(k):
        return np.random.default_rng(seed + 1500 + k)

    def partkey():
        # make_q3_spec's own stream for the part behind each price
        return np.random.default_rng(np.random.SeedSequence(seed).spawn(
            11)[2]).integers(1, n_p + 1, n_l)

    def customer():
        nk = rng(2).integers(0, 25, n_c).astype(np.int32)
        return {"c_nationkey": nk,
                "c_phone": Text(_phones(rng(3), nk), np.arange(n_c)),
                "c_acctbal": rng(4).integers(-99_999, 1_000_000, n_c)}

    def supplier():
        nk = rng(5).integers(0, 25, n_s).astype(np.int32)
        k = np.arange(1, n_s + 1)
        name = np.char.add("Supplier#", np.char.zfill(k.astype(str), 9))
        r = rng(6)
        length = r.integers(10, 41, n_s)
        alnum = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMN"
                              b"OPQRSTUVWXYZ0123456789,.", dtype=np.uint8)
        addr = alnum[r.integers(0, len(alnum), (n_s, 40))]
        addr[np.arange(40) >= length[:, None]] = 0
        return {"s_suppkey": k.astype(np.int64),
                "s_name": Text(name, np.arange(n_s)),
                "s_address": Text(_text_rows(n_s, [addr]), np.arange(n_s)),
                "s_nationkey": nk,
                "s_phone": Text(_phones(rng(7), nk), np.arange(n_s))}

    def part():
        r = rng(8)
        w = r.integers(0, len(P_NAME_WORDS), (n_p, 5))
        while True:  # five distinct words a name
            s = np.sort(w, axis=1)
            dup = (s[:, 1:] == s[:, :-1]).any(axis=1)
            if not dup.any():
                break
            w[dup] = r.integers(0, len(P_NAME_WORDS), (int(dup.sum()), 5))
        key = w @ (len(P_NAME_WORDS) ** np.arange(5)).astype(np.int64)
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        words = np.asarray(P_NAME_WORDS)
        vocab = words[w[first, 0]]
        for j in range(1, 5):
            vocab = np.char.add(np.char.add(vocab, " "), words[w[first, j]])
        return {"p_partkey": np.arange(1, n_p + 1, dtype=np.int64),
                "p_name": Text(vocab, inv.reshape(-1)),
                "p_type": Text(np.asarray(P_TYPES),
                               rng(9).integers(0, len(P_TYPES), n_p)),
                "words": w}

    def partsupp():
        pk = np.repeat(np.arange(1, n_p + 1, dtype=np.int64), 4)
        i = np.tile(np.arange(4, dtype=np.int64), n_p)
        return {"ps_partkey": pk, "ps_suppkey": _suppkey(pk, i, n_s),
                "ps_supplycost": rng(10).integers(100, 100_001, 4 * n_p)}

    got = in_threads({"pk": partkey, "choice": lambda: rng(1).integers(
        0, 4, n_l), "customer": customer, "supplier": supplier,
        "part": part, "partsupp": partsupp}, workers=6)
    pk, choice = got["pk"], got["choice"]
    return {
        "lineitem": {"l_partkey": pk,
                     "l_suppkey": _suppkey(pk, choice, n_s)},
        "choice": choice, "customer": got["customer"],
        "nation": {"n_nationkey": np.arange(25, dtype=np.int32),
                   "n_name": np.asarray([n for n, _r in NATIONS]),
                   "n_regionkey": np.asarray([r for _n, r in NATIONS],
                                             dtype=np.int32)},
        "region": {"r_regionkey": np.arange(5, dtype=np.int32),
                   "r_name": np.asarray(REGIONS)},
        "supplier": got["supplier"], "part": got["part"],
        "partsupp": got["partsupp"],
    }


P15_TABLES = ("nation", "region", "supplier", "part", "partsupp")


def _years(days) -> np.ndarray:
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def _order_pos(okey):
    """make_q3_spec's order index of each order key (k = i // 8 * 32 +
    i % 8 + 1)."""
    k = okey - 1
    return k // 32 * 8 + k % 32


def expected_q7(t, x) -> list:
    li, o = t["lineitem"], t["orders"]
    sn = x["supplier"]["s_nationkey"][x["lineitem"]["l_suppkey"] - 1]
    op = _order_pos(li["l_orderkey"])
    cn = x["customer"]["c_nationkey"][o["o_custkey"][op] - 1]
    fr, de = 6, 7
    ship = li["l_shipdate"]
    m = (((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))) & (
        ship >= _day("1995-01-01")) & (ship <= _day("1996-12-31"))
    vol = li["l_extendedprice"][m] * (100 - li["l_discount"][m])
    key = sn[m].astype(np.int64) * 100_000 + cn[m] * 10_000 + _years(ship[m])
    rows = []
    for k in np.unique(key):
        s, c, y = k // 100_000, k // 10_000 % 10, k % 10_000
        rows.append((NATIONS[s][0], NATIONS[c][0], int(y),
                     int(vol[key == k].sum()) / 10**4))
    return sorted(rows)


def expected_q8(t, x) -> list:
    li, o = t["lineitem"], t["orders"]
    pk, sk = x["lineitem"]["l_partkey"], x["lineitem"]["l_suppkey"]
    p_type = x["part"]["p_type"]
    steel = P_TYPES.index("ECONOMY ANODIZED STEEL")
    op = _order_pos(li["l_orderkey"])
    odate = o["o_orderdate"][op]
    cn = x["customer"]["c_nationkey"][o["o_custkey"][op] - 1]
    america = np.asarray([r == 1 for _n, r in NATIONS])
    m = (p_type.idx[pk - 1] == steel) & america[cn] & (
        odate >= _day("1995-01-01")) & (odate <= _day("1996-12-31"))
    vol = li["l_extendedprice"][m] * (100 - li["l_discount"][m])
    brazil = x["supplier"]["s_nationkey"][sk[m] - 1] == 2
    years = _years(odate[m])
    rows = []
    for y in np.unique(years):
        g = years == y
        num, den = int(vol[g & brazil].sum()), int(vol[g].sum())
        # the analyzer's FLOAT8 quotient of two scale-4 sums: each cast
        # to float32 on the device (its _dev_dtype), divided there
        share = np.float32(num / 10**4) / np.float32(den / 10**4)
        rows.append((int(y), float(share)))
    return rows


def expected_q9(t, x) -> list:
    li, o = t["lineitem"], t["orders"]
    pk = x["lineitem"]["l_partkey"]
    green = (x["part"]["words"] == P_NAME_WORDS.index("green")).any(axis=1)
    m = green[pk - 1]
    cost = x["partsupp"]["ps_supplycost"][(pk[m] - 1) * 4
                                          + x["choice"][m]]
    amount = (li["l_extendedprice"][m] * (100 - li["l_discount"][m])
              - cost * li["l_quantity"][m])
    nk = x["supplier"]["s_nationkey"][x["lineitem"]["l_suppkey"][m] - 1]
    years = _years(o["o_orderdate"][_order_pos(li["l_orderkey"][m])])
    key = nk.astype(np.int64) * 10_000 + years
    uk, inv = np.unique(key, return_inverse=True)
    sums = np.zeros(len(uk), dtype=np.int64)
    np.add.at(sums, inv, amount)
    rows = [(NATIONS[k // 10_000][0], int(k % 10_000), int(s) / 10**4)
            for k, s in zip(uk.tolist(), sums.tolist())]
    return sorted(rows, key=lambda r: (r[0], -r[1]))


def q15_revenue(t, x):
    """Each supplier's Q15 revenue in the quarter (scale 4), and whether
    it has lines there."""
    li = t["lineitem"]
    ship = li["l_shipdate"]
    m = (ship >= _day("1996-01-01")) & (ship < _day("1996-04-01"))
    sk = x["lineitem"]["l_suppkey"][m]
    n_s = len(x["supplier"]["s_suppkey"])
    rev = li["l_extendedprice"][m] * (100 - li["l_discount"][m])
    # float64 sums are exact: each supplier's sum is far below 2^53
    sums = np.rint(np.bincount(sk - 1, weights=rev, minlength=n_s)
                   ).astype(np.int64)
    return sums, np.bincount(sk - 1, minlength=n_s) > 0


def expected_q15(t, x) -> list:
    sums, has = q15_revenue(t, x)
    top = sums[has].max()
    sup = x["supplier"]
    return [(int(k), str(sup["s_name"].vocab[k - 1]),
             str(sup["s_address"].vocab[k - 1]),
             str(sup["s_phone"].vocab[k - 1]), int(sums[k - 1]) / 10**4)
            for k in (np.nonzero(has & (sums == top))[0] + 1).tolist()]


def expected_q22_core(x) -> list:
    c = x["customer"]
    n = np.bincount(c["c_nationkey"], minlength=25)
    bal = np.zeros(25, dtype=np.int64)
    np.add.at(bal, c["c_nationkey"], c["c_acctbal"])
    return [(str(k + 10), int(n[k]), int(bal[k]) / 100)
            for k in range(25) if n[k]]


def p15_query(name: str, s, sql: str, check, args, card: str,
              k1: bool = False) -> dict:
    """One phase-15 query: the first run exact (``check`` raises on a
    wrong answer), K1's and K2's launches counted from 0 around it (K1
    must launch where ``k1``), the route and the fused executors' mode
    or rung, the host-text tables' build ms; then the warm median of
    the runs ``warm_repeats`` allows, and the
    layers of one more run: the plan on the host, and the device path
    (fragment or DAG, CUDA events) or the host route's fragments,
    motions and coordinator."""
    import torch

    from opentenbase_tpu_torch.ops import expr as ex
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    tables_ms: list = []
    builders = {}
    for fn in ("_str_transform_table", "_pair_concat_table"):
        orig = builders[fn] = getattr(ex, fn)

        def timed(*a, _orig=orig):
            t0 = time.perf_counter()
            try:
                return _orig(*a)
            finally:
                tables_ms.append((time.perf_counter() - t0) * 1e3)
        setattr(ex, fn, timed)
    try:
        rp.radix_probe.launches = 0
        sa.scan_agg.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t1) * 1000
        first_tables = list(tables_ms)
    finally:
        for fn, orig in builders.items():
            setattr(ex, fn, orig)
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    check(got)
    if k1 and not launches["scan_agg"]:
        raise AssertionError(f"{name}: scan_agg never launched")
    fx = s.cluster.fused_executor()
    if s.last_route == "host":
        how = (f"host route (declined: {'; '.join(s.last_declines)}; join "
               f"modes {s.last_executor.join_modes})")
    elif s._fused_via_dag:
        how = (f"fused DAG (mode {fx._dag.last_mode}, join modes "
               f"{fx._dag.last_join_modes})")
    else:
        how = f"fused fragment ({fx.last_route}, rung {fx.last_rung})"
    repeats = warm_repeats(first_ms, args.repeats)
    ts = []
    for _ in range(repeats):
        t1 = time.perf_counter()
        check(s.query(sql))
        ts.append((time.perf_counter() - t1) * 1000)
    e2e = statistics.median(ts) if ts else first_ms
    if s.last_route == "host":
        ex_ = s.last_executor
        layers = {"fragments": sum(r["ms"] for r in ex_.instrumentation),
                  "motions": sum(m["ms"] for m in
                                 ex_.motion_stats.values()),
                  "coordinator": ex_.coordinator_ms}
    else:
        layers = layer_breakdown(s.cluster, sql, 1, dag=s._fused_via_dag)
    text = ("; text tables built " + ", ".join(
        f"{m:.3f}" for m in first_tables) + " ms") if first_tables else ""
    print(f"main path: {name} exact through the {how}; scan_agg launches "
          f"{launches['scan_agg']}, radix_probe launches "
          f"{launches['radix_probe']}; {len(got)} rows; first run "
          f"{first_ms:.3f} ms{text}) {got[:2]}... [{card}]", flush=True)
    print(f"end to end: {name} median {e2e:.3f} ms over {repeats} runs; "
          f"layers " + ", ".join(f"{k} {v:.3f}" for k, v in layers.items())
          + f" ms [{card}]", flush=True)
    return {"route": s.last_route, "launches": launches,
            "first_ms": first_ms, "e2e": e2e, "layers": layers,
            "text_tables_ms": first_tables}


def run_phase15(q3: dict, args, card: str) -> dict:
    """Phase 15 in phase 5c's SF10 cluster, after phase 10b and before
    phase 8's writes (see the module's docstring). Returns each query's
    result ({route, launches, ...}) under its name."""
    cluster, t, x = q3["cluster"], q3["tables"], q3["p15"]
    t0 = time.perf_counter()
    ans = in_threads({
        "Q7": lambda: expected_q7(t, x), "Q8": lambda: expected_q8(t, x),
        "Q9": lambda: expected_q9(t, x), "Q15": lambda: expected_q15(t, x),
        "Q22": lambda: expected_q22_core(x),
        "Q6": lambda: expected_q6(t["lineitem"]),
        "revenue": lambda: q15_revenue(t, x)})
    li = t["lineitem"]
    month = (li["l_shipdate"] >= _day("1994-03-01")) & (
        li["l_shipdate"] < _day("1994-04-01"))
    copy_q6 = expected_q6(_select(
        {k: li[k] for k in ("l_extendedprice", "l_discount", "l_shipdate",
                            "l_quantity")}, month))
    sums, has = ans["revenue"]
    ctas_want = [(int(has.sum()), int(sums[has].sum()) / 10**4,
                  int(sums[has].max()) / 10**4)]
    print(f"load: phase 15 numpy answers in "
          f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    s = cluster.session()
    out = {}
    for name, sql, key in (("TPC-H Q7", Q7, "Q7"), ("TPC-H Q8", Q8, "Q8"),
                           ("TPC-H Q9", Q9, "Q9"),
                           ("TPC-H Q15 (WITH)", Q15_WITH, "Q15"),
                           ("TPC-H Q22 core (substring)", Q22_CORE,
                            "Q22")):
        out[name] = p15_query(name, s, sql, equal_to(name, ans[key]),
                              args, card)
    # Q15 as the spec writes it: the view, the query, the view dropped
    s.execute(f"create view revenue0 as {Q15_REVENUE}")
    out["TPC-H Q15 (view)"] = p15_query(
        "TPC-H Q15 (view)", s, Q15_QUERY, equal_to("Q15", ans["Q15"]),
        args, card)
    s.execute("drop view revenue0")
    s.execute(Q6_VIEW)
    out["TPC-H Q6 (view)"] = p15_query(
        "TPC-H Q6 (view)", s, Q6.replace("from lineitem", "from q6_lines"),
        equal_to("Q6 (view)", ans["Q6"]), args, card, k1=True)
    s.execute("drop view q6_lines")
    t1 = time.perf_counter()
    r = s.execute(f"create table revenue_s15 as {Q15_REVENUE}")
    ms = (time.perf_counter() - t1) * 1e3
    if r.rowcount != ctas_want[0][0]:
        raise AssertionError(f"CREATE TABLE AS: {r.rowcount} rows, numpy "
                             f"{ctas_want[0][0]}")
    print(f"write: CREATE TABLE AS of Q15's revenue rows, {r.rowcount} rows "
          f"in {ms:.3f} ms [{card}]", flush=True)
    out["CTAS revenue_s15 (read)"] = p15_query(
        "CTAS revenue_s15 (read)", s, "select count(*), sum(total_revenue),"
        " max(total_revenue) from revenue_s15",
        equal_to("CTAS", ctas_want), args, card)
    s.execute(Q6_MONTH_DDL)
    t1 = time.perf_counter()
    r = s.execute(Q6_MONTH_INSERT)
    ms = (time.perf_counter() - t1) * 1e3
    if r.rowcount != int(month.sum()):
        raise AssertionError(f"INSERT ... SELECT: {r.rowcount} rows, numpy "
                             f"{int(month.sum())}")
    print(f"write: INSERT ... SELECT of one month of lineitem, {r.rowcount} "
          f"rows through the delta plane in {ms:.3f} ms [{card}]",
          flush=True)
    out["TPC-H Q6 (INSERT ... SELECT copy)"] = p15_query(
        "TPC-H Q6 (INSERT ... SELECT copy)", s,
        Q6.replace("from lineitem", "from q6_month"),
        equal_to("Q6 copy", copy_q6), args, card, k1=True)
    for table in ("revenue_s15", "q6_month"):
        s.execute(f"drop table {table}")
    return out


# -- phase 16: the DML and transaction statements ---------------------------

CUST_ACCT_DDL = (
    "create table cust_acct (c_custkey bigint primary key, "
    "c_nationkey int not null, c_acctbal decimal(15,2) not null, "
    "c_mktsegment text default 'UNKNOWN') distribute by hash(c_custkey)")
ACCT_BY_NATION = ("select c_nationkey, count(*), sum(c_acctbal) from "
                  "cust_acct group by c_nationkey order by 1")
RF2_KEYS_SUM = "select count(*), sum(k) from rf2_keys"
# the same as a grouped read, which the fused DAG takes over a
# replicated table (the scalar form takes the host route in both
# packages)
RF2_KEYS_GROUPED = ("select count(*), sum(k) from rf2_keys where k > 0 "
                    "group by k > 0")
PRIORITY_COUNTS = ("select o_orderpriority, count(*) from orders "
                   "group by o_orderpriority order by o_orderpriority")
# the reference's messages (opentenbase_tpu/engine.py _check_not_null,
# _check_unique_pk; lmgr.py)
NOT_NULL_MSG = ('null value in column "c_nationkey" violates not-null '
                "constraint")
DUP_KEY_MSG = 'duplicate key value violates primary key "c_custkey"'
LOCK_TIMEOUT_MSG = "canceling statement due to lock timeout"
NOWAIT_MSG = "could not obtain lock on row in relation 'cust_acct'"


class Accounts:
    """numpy's cust_acct: keys, nations and balances in cents."""

    def __init__(self, keys, nat, bal):
        # copies: the balances change in place, the generator's arrays
        # (customer's columns, which phase 17 reads back) must not
        self.key = np.array(keys, dtype=np.int64)
        self.nat = np.array(nat, dtype=np.int64)
        self.bal = np.array(bal, dtype=np.int64)

    def pos(self, keys):
        """Each key's index (every key present)."""
        order = np.argsort(self.key, kind="stable")
        i = order[np.searchsorted(self.key, keys, sorter=order)]
        if not np.array_equal(self.key[i], keys):
            raise AssertionError("Accounts.pos: a key is missing")
        return i

    def has(self, keys):
        order = np.argsort(self.key, kind="stable")
        i = np.minimum(np.searchsorted(self.key, keys, sorter=order),
                       len(order) - 1)
        return self.key[order[i]] == keys

    def add(self, keys, nat, bal):
        self.key = np.concatenate([self.key, np.asarray(keys, np.int64)])
        self.nat = np.concatenate([self.nat, np.asarray(nat, np.int64)])
        self.bal = np.concatenate([self.bal, np.asarray(bal, np.int64)])

    def by_nation(self, zero_nation=None) -> list:
        bal = self.bal if zero_nation is None else np.where(
            self.nat == zero_nation, 0, self.bal)
        cnt = np.bincount(self.nat, minlength=25)
        tot = np.bincount(self.nat, weights=bal, minlength=25)
        # float64 bincount sums are exact below 2^53 cents
        return [(n, int(cnt[n]), int(round(tot[n])) / 100)
                for n in np.nonzero(cnt)[0].tolist()]


def _values(*cols) -> str:
    return ",".join("(" + ", ".join(r) + ")" for r in zip(*cols))


def _signed_cents(c: int) -> str:
    return ("-" if c < 0 else "") + _cents(abs(c))


def p16_write(name: str, s, sql: str, card: str, rows=None):
    """One statement of phase 16, timed: its result, and a ``write:``
    line (rows, ms); ``rows`` is numpy's row count, held to it."""
    t0 = time.perf_counter()
    r = s.execute(sql)
    ms = (time.perf_counter() - t0) * 1000
    if rows is not None and r.rowcount != rows:
        raise AssertionError(f"{name}: {r.rowcount} rows, numpy {rows}")
    print(f"write: {name} {r.command} {r.rowcount} rows in {ms:.3f} ms "
          f"[{card}]", flush=True)
    return r, ms


def p16_refused(name: str, s, sql: str, msg: str, card: str,
                sqlstate: str = "XX000") -> float:
    """A statement phase 16 expects refused with the reference's message
    and SQLSTATE: the ms it took to fail."""
    from opentenbase_tpu_torch import SQLError

    t0 = time.perf_counter()
    try:
        s.execute(sql)
    except SQLError as e:
        ms = (time.perf_counter() - t0) * 1000
        if str(e) != msg or e.sqlstate != sqlstate:
            raise AssertionError(f"{name}: {e.sqlstate} {e}, want "
                                 f"{sqlstate} {msg}") from e
        print(f"write: {name} refused in {ms:.3f} ms: {e.sqlstate} {e} "
              f"[{card}]", flush=True)
        return ms
    raise AssertionError(f"{name}: not refused")


def p16_read(name: str, s, sql: str, want: list, args, card: str,
             k1: bool = False, route: str = None) -> dict:
    """One read of phase 16: the first run exact against numpy, K1's and
    K2's launches counted from 0 around it (one K1 launch where ``k1``),
    the route, the device cache's refresh counters of that run; then the
    warm median of the runs ``warm_repeats`` allows, each exact."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    fx = s.cluster.fused_executor()
    c0 = dict(fx.cache.stats)
    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    t1 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    refresh = {k: fx.cache.stats[k] - c0[k] for k in REFRESH_STATS}
    if got != want:
        raise AssertionError(f"{name}: port {got} != numpy {want}")
    if s.last_route == "host":
        how = f"host route (declined: {'; '.join(s.last_declines)})"
    elif s._fused_via_dag:
        how = f"fused DAG (mode {fx._dag.last_mode})"
    else:
        how = f"fused fragment ({fx.last_route}, rung {fx.last_rung})"
    if k1 and (launches["scan_agg"] != 1 or fx.last_route != "scan_agg"
               or s._fused_via_dag):
        raise AssertionError(f"{name}: {how}, launches {launches}; want "
                             "one scan_agg launch")
    if route is not None and s.last_route != route:
        raise AssertionError(f"{name}: the {how}, want the {route} route")
    repeats = warm_repeats(first_ms, args.repeats)
    ts = []
    for _ in range(repeats):
        t1 = time.perf_counter()
        if s.query(sql) != want:
            raise AssertionError(f"{name}: answer changed between runs")
        ts.append((time.perf_counter() - t1) * 1000)
    e2e = statistics.median(ts) if ts else first_ms
    print(f"main path: {name} exact through the {how}; scan_agg launches "
          f"{launches['scan_agg']}, radix_probe launches "
          f"{launches['radix_probe']}; {len(got)} rows; first run "
          f"{first_ms:.3f} ms, warm median {e2e:.3f} ms over {repeats}) "
          f"{got[:2]}... [{card}]", flush=True)
    print(f"refresh: {name} first run's device-cache refresh " + ", ".join(
        f"{k} {refresh[k]}" for k in REFRESH_STATS) + f" [{card}]",
        flush=True)
    return {"route": s.last_route, "launches": launches,
            "first_ms": first_ms, "e2e": e2e, "refresh": refresh}


def run_phase16(q3: dict, state: dict, args, card: str) -> dict:
    """Phase 16 in phase 5c's SF10 cluster after phase 8 (a)'s RF2 (see
    the module's docstring), every answer exact against numpy over
    ``state`` (run_refresh's arrays), which it keeps up to date. Returns
    {"reads": {query: result}, "fragment": {Q6: ...}, "topk": {Q3:
    ...}, "k1_rows": [...], "writes": {statement: ms}}."""
    import threading

    cluster = q3["cluster"]
    cust = state["customer"]
    s = cluster.session()
    n_rf = max(int(1500 * args.q3_sf), 1)
    reads: dict = {}
    writes: dict = {}

    def write(name, sql, rows=None):
        r, writes[name] = p16_write(name, s, sql, card, rows)
        return r

    # (a) constraints, defaults and the upsert
    acct = Accounts(cust["c_custkey"],
                    q3["p15"]["customer"]["c_nationkey"],
                    q3["p15"]["customer"]["c_acctbal"])
    write("CREATE TABLE cust_acct (primary key, not null, default, hash)",
          CUST_ACCT_DDL)
    write("INSERT ... SELECT of customer into cust_acct",
          "insert into cust_acct select c_custkey, c_nationkey, c_acctbal,"
          " c_mktsegment from customer", len(acct.key))
    rng = np.random.default_rng(args.seed + 300)
    old = rng.choice(acct.key, n_rf // 2, replace=False)
    new = acct.key.max() + 1 + rng.choice(10 * n_rf, n_rf - len(old),
                                          replace=False)
    ukey = rng.permutation(np.concatenate([old, new]))
    unat = rng.integers(0, 25, n_rf)
    ubal = rng.integers(-99_999, 1_000_000, n_rf)
    t0 = time.perf_counter()
    for i in range(0, n_rf, RF_STMT_ROWS):
        sl = slice(i, i + RF_STMT_ROWS)
        r = s.execute(
            "insert into cust_acct (c_custkey, c_nationkey, c_acctbal) "
            "values " + _values(map(str, ukey[sl].tolist()),
                                map(str, unat[sl].tolist()),
                                map(_signed_cents, ubal[sl].tolist()))
            + " on conflict (c_custkey) do update set "
            "c_acctbal = excluded.c_acctbal returning c_custkey")
        if (r.rowcount != len(ukey[sl])
                or sorted(k for (k,) in r.rows) != sorted(ukey[sl].tolist())):
            raise AssertionError("upsert: RETURNING != the statement's keys")
    writes["upsert"] = ms = (time.perf_counter() - t0) * 1000
    was = acct.has(ukey)
    acct.bal[acct.pos(ukey[was])] = ubal[was]
    acct.add(ukey[~was], unat[~was], ubal[~was])
    n_default = int((~was).sum())
    print(f"write: INSERT ... ON CONFLICT DO UPDATE ... RETURNING, "
          f"{n_rf} rows ({len(old)} existing keys) in "
          f"{-(-n_rf // RF_STMT_ROWS)} statements, {ms:.3f} ms [{card}]",
          flush=True)
    nk = np.concatenate([rng.choice(acct.key, 500, replace=False),
                         acct.key.max() + 1 + np.arange(500)])
    nn, nb = rng.integers(0, 25, len(nk)), rng.integers(0, 10**5, len(nk))
    fresh = ~acct.has(nk)
    write("INSERT ... ON CONFLICT DO NOTHING",
          "insert into cust_acct (c_custkey, c_nationkey, c_acctbal) "
          "values " + _values(map(str, nk.tolist()), map(str, nn.tolist()),
                              map(_cents, nb.tolist()))
          + " on conflict do nothing", int(fresh.sum()))
    acct.add(nk[fresh], nn[fresh], nb[fresh])
    n_default += int(fresh.sum())
    # refused statements inside an explicit transaction leave it intact
    kv, kd = int(acct.key.max()) + 1, int(acct.key[0])
    s.execute("begin")
    write("INSERT one row in a transaction",
          f"insert into cust_acct values ({kv}, 3, 12.34, 'TXN')", 1)
    p16_refused("a NULL for NOT NULL c_nationkey", s,
                f"insert into cust_acct (c_custkey, c_acctbal) values "
                f"({kv + 1}, 1.00)", NOT_NULL_MSG, card)
    p16_refused("a duplicate primary key", s,
                f"insert into cust_acct values ({kd}, 1, 1.00, 'X')",
                DUP_KEY_MSG, card)
    s.execute("commit")
    acct.add([kv], [3], [1234])
    reads["cust_acct txn rows"] = p16_read(
        "cust_acct after the refused statements", s,
        f"select c_custkey, c_acctbal, c_mktsegment from cust_acct where "
        f"c_custkey in ({kv}, {kv + 1}, {kd}) order by 1", [
            (kd, int(acct.bal[acct.pos([kd])[0]]) / 100, str(
                cust["c_mktsegment"][kd - 1])), (kv, 12.34, "TXN")],
        args, card)
    reads["cust_acct defaults"] = p16_read(
        "cust_acct rows with the DEFAULT segment", s,
        "select count(*) from cust_acct where c_mktsegment = 'UNKNOWN'",
        [(n_default,)], args, card)
    want_a = acct.by_nation()
    reads["cust_acct by nation"] = p16_read(
        "cust_acct by nation", s, ACCT_BY_NATION, want_a, args, card)
    # (b) a savepoint
    s.execute("begin")
    s.execute("savepoint s")
    write("UPDATE under a savepoint",
          "update cust_acct set c_acctbal = 0 where c_nationkey = 7",
          int((acct.nat == 7).sum()))
    reads["cust_acct in the transaction"] = p16_read(
        "cust_acct by nation inside the transaction", s, ACCT_BY_NATION,
        acct.by_nation(zero_nation=7), args, card, route="host")
    write("ROLLBACK TO SAVEPOINT", "rollback to savepoint s")
    write("COMMIT", "commit")
    reads["cust_acct after the rollback-to"] = p16_read(
        "cust_acct by nation after ROLLBACK TO SAVEPOINT", s,
        ACCT_BY_NATION, want_a, args, card)
    # (c) RF2 as users write it
    okeys = state["orders"]["o_orderkey"]
    gone = np.sort(np.random.default_rng(args.seed + 301).choice(
        okeys, n_rf, replace=False))
    write("CREATE TABLE rf2_keys (replicated)",
          "create table rf2_keys (k bigint primary key) "
          "distribute by replication")
    for i in range(0, n_rf, RF_STMT_ROWS):
        ks = gone[i:i + RF_STMT_ROWS].tolist()
        write(f"INSERT rf2_keys {i // RF_STMT_ROWS}",
              "insert into rf2_keys values " + _values(map(str, ks)),
              len(ks))
    # numpy's key sets as boolean tables over the key range (a sorting
    # np.isin of 60 M keys takes seconds)
    gone_t = np.zeros(max(int(state["lineitem"]["l_orderkey"].max()),
                          int(state["orders"]["o_orderkey"].max())) + 1,
                      dtype=bool)
    gone_t[gone] = True
    lkeep = ~gone_t[state["lineitem"]["l_orderkey"]]
    t0 = time.perf_counter()
    s.execute("begin")
    r = write("DELETE FROM orders USING rf2_keys ... RETURNING",
              "delete from orders using rf2_keys where o_orderkey = "
              "rf2_keys.k returning o_orderkey", n_rf)
    if sorted(k for (k,) in r.rows) != gone.tolist():
        raise AssertionError("DELETE ... RETURNING: keys != numpy's")
    write("DELETE FROM lineitem USING rf2_keys",
          "delete from lineitem using rf2_keys where l_orderkey = "
          "rf2_keys.k", int((~lkeep).sum()))
    write("COMMIT of RF2 as a join", "commit")
    writes["RF2 as a join"] = ms = (time.perf_counter() - t0) * 1000
    print(f"write: RF2 as a join, {n_rf} orders and {int((~lkeep).sum())} "
          f"lineitems in one transaction, {ms:.3f} ms [{card}]", flush=True)
    state["orders"] = _select(state["orders"], ~gone_t[okeys])
    # the columns the later checks read (Q6's and Q3's)
    state["lineitem"] = _select({k: state["lineitem"][k] for k in (
        "l_orderkey", "l_extendedprice", "l_discount", "l_shipdate",
        "l_quantity")}, lkeep)
    li, o = state["lineitem"], state["orders"]
    q6 = "TPC-H Q6 (spec, phase 16)"
    fragment = {q6: run_fragment_query(q6, cluster, Q6, expected_q6(li),
                                       args.repeats, card,
                                       ("scan_agg", None))}
    k1_rows = time_k1_at(cluster, {q6: Q6}, card)
    q3q = "TPC-H Q3 (spec, phase 16)"
    topk = {q3q: run_topk_query(q3q, cluster, Q3_SPEC,
                                expected_q3(li, o, cust, "BUILDING"),
                                "gsort", ("fold",), 1, 1, card)}
    # (d) updates: a join, a scalar subquery, expressions in VALUES
    p = acct.pos(o["o_custkey"])
    hit = (acct.nat[p] == 7) & (acct.bal[p] < 0)
    write("UPDATE orders ... FROM cust_acct",
          "update orders set o_orderpriority = '1-URGENT' from cust_acct "
          "where o_custkey = c_custkey and c_nationkey = 7 and "
          "c_acctbal < 0", int(hit.sum()))
    prio = o["o_orderpriority"].idx.copy()
    prio[hit] = PRIORITIES.index("1-URGENT")
    o["o_orderpriority"] = Text(PRIORITIES, prio)
    write("UPDATE with a scalar subquery",
          "update cust_acct set c_acctbal = (select max(c_acctbal) from "
          "cust_acct) where c_custkey = 1", 1)
    acct.bal[acct.pos([1])] = acct.bal.max()
    kx = int(acct.key.max()) + 1
    write("INSERT with expressions in VALUES",
          f"insert into cust_acct values ({kx}, 3 + 4, 10.25 * 2, "
          f"upper('new'))", 1)
    acct.add([kx], [7], [2050])
    counts = np.bincount(prio, minlength=len(PRIORITIES))
    reads["orders by priority"] = p16_read(
        "orders by priority after UPDATE ... FROM", s, PRIORITY_COUNTS,
        [(PRIORITIES[i], int(counts[i])) for i in range(len(PRIORITIES))
         if counts[i]], args, card)
    want_a = acct.by_nation()
    reads["cust_acct after the updates"] = p16_read(
        "cust_acct by nation after the updates", s, ACCT_BY_NATION, want_a,
        args, card)
    # (e) ALTER TABLE and TRUNCATE
    write("ALTER TABLE lineitem ADD COLUMN",
          "alter table lineitem add column l_note int")
    reads["TPC-H Q6 after ADD COLUMN"] = p16_read(
        "TPC-H Q6 (spec) after ADD COLUMN", s, Q6, expected_q6(li), args,
        card, k1=True)
    write("ALTER TABLE lineitem DROP COLUMN",
          "alter table lineitem drop column l_note")
    write("ALTER TABLE cust_acct DISTRIBUTE BY MODULO",
          "alter table cust_acct distribute by modulo(c_custkey)",
          len(acct.key))
    reads["cust_acct after DISTRIBUTE BY"] = p16_read(
        "cust_acct by nation after DISTRIBUTE BY MODULO", s, ACCT_BY_NATION,
        want_a, args, card)
    reads["rf2_keys"] = p16_read(
        "rf2_keys count and sum", s, RF2_KEYS_SUM,
        [(n_rf, int(gone.sum()))], args, card)
    reads["rf2_keys grouped"] = p16_read(
        "rf2_keys count and sum, grouped", s, RF2_KEYS_GROUPED,
        [(n_rf, int(gone.sum()))], args, card, route="fused")
    write("TRUNCATE rf2_keys", "truncate table rf2_keys")
    other = np.sort(np.random.default_rng(args.seed + 302).choice(
        o["o_orderkey"], n_rf, replace=False))  # live keys: none of gone
    for i in range(0, n_rf, RF_STMT_ROWS):
        ks = other[i:i + RF_STMT_ROWS].tolist()
        write(f"INSERT rf2_keys after TRUNCATE {i // RF_STMT_ROWS}",
              "insert into rf2_keys values " + _values(map(str, ks)),
              len(ks))
    reads["rf2_keys after TRUNCATE"] = p16_read(
        "rf2_keys count and sum after TRUNCATE", s, RF2_KEYS_SUM,
        [(n_rf, int(other.sum()))], args, card)
    reads["rf2_keys grouped after TRUNCATE"] = p16_read(
        "rf2_keys count and sum, grouped, after TRUNCATE (the old planes "
        "would answer the old keys)", s, RF2_KEYS_GROUPED,
        [(n_rf, int(other.sum()))], args, card, route="fused")
    # (f) row and table locks, two sessions
    s2 = cluster.session()
    kl = int(acct.key[1])
    s2.execute("begin")
    r = s2.execute(f"select c_custkey from cust_acct where c_custkey = {kl}"
                   " for update")
    if r.rows != [(kl,)]:
        raise AssertionError(f"FOR UPDATE: {r.rows}")
    s.execute("set lock_timeout = '200ms'")
    writes["lock timeout"] = ms = p16_refused(
        "UPDATE of a row another session holds FOR UPDATE", s,
        f"update cust_acct set c_acctbal = 0 where c_custkey = {kl}",
        LOCK_TIMEOUT_MSG, card)
    if not 190 <= ms < 5000:
        raise AssertionError(f"lock_timeout 200ms: failed after {ms} ms")
    writes["nowait"] = ms = p16_refused(
        "FOR UPDATE NOWAIT of that row", s,
        f"select * from cust_acct where c_custkey = {kl} for update nowait",
        NOWAIT_MSG, card)
    if ms >= 190:
        raise AssertionError(f"NOWAIT waited {ms} ms")
    s2.execute("rollback")
    s.execute("reset lock_timeout")
    s3, s4 = cluster.session(), cluster.session()
    s3.execute("begin")
    p16_write("LOCK TABLE orders IN EXCLUSIVE MODE (another session)", s3,
              "lock table orders in exclusive mode", card)
    ko = int(o["o_orderkey"].max()) + 1
    done, errs = [], []

    def insert():
        try:
            s4.execute(f"insert into orders (o_orderkey, o_custkey, "
                       f"o_orderdate, o_shippriority, o_orderpriority) "
                       f"values ({ko}, 1, '1995-01-01', 0, '5-LOW')")
            done.append(time.perf_counter())
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)

    th = threading.Thread(target=insert)
    t0 = time.perf_counter()
    th.start()
    time.sleep(0.5)
    if done or errs:
        raise AssertionError(f"INSERT did not wait for LOCK TABLE: {errs}")
    # phase 17 (e): pg_locks during the wait, LOCK TABLE's grant on each
    # node of orders and the INSERT's table lock waiting behind it
    locks = s.query("select node_index, mode, granted, session_id from "
                    "pg_locks where relation = 'orders' order by granted, "
                    "node_index")
    if locks[-2:] != [(0, "exclusive", True, s3.session_id),
                      (1, "exclusive", True, s3.session_id)] or locks[:1] \
            != [(locks[0][0], "shared", False, s4.session_id)]:
        raise AssertionError(f"pg_locks during the LOCK TABLE wait: {locks}")
    print(f"views: pg_locks during the wait {locks} [{card}]", flush=True)
    t1 = time.perf_counter()
    s3.execute("commit")
    th.join(timeout=60)
    if th.is_alive() or errs or not done or done[0] < t1:
        raise AssertionError(f"INSERT after LOCK TABLE: {errs}")
    writes["INSERT held off by LOCK TABLE"] = (done[0] - t0) * 1000
    print(f"write: an INSERT into orders held off by LOCK TABLE until "
          f"COMMIT, done {(done[0] - t1) * 1000:.3f} ms after it "
          f"({(done[0] - t0) * 1000:.3f} ms after it began) [{card}]",
          flush=True)
    reads["orders count"] = p16_read(
        "orders count after the held-off INSERT", s,
        "select count(*) from orders", [(len(o["o_orderkey"]) + 1,)],
        args, card)
    # (g) one pass of the compaction job's verb
    t0 = time.perf_counter()
    folded = cluster.compact_deltas()
    writes["compaction"] = ms = (time.perf_counter() - t0) * 1000
    print(f"write: compact_deltas folded {folded} delta batches in "
          f"{ms:.3f} ms [{card}]", flush=True)
    reads["TPC-H Q6 after compaction"] = p16_read(
        "TPC-H Q6 (spec) after compaction", s, Q6, expected_q6(li), args,
        card, k1=True)
    return {"reads": reads, "fragment": fragment, "topk": topk,
            "k1_rows": k1_rows, "writes": writes}


# -- phase 17: session statements and introspection -------------------------

P17_INSERT_ROWS = 1000  # the prepared one-row INSERT's executions
Q6P = ("prepare q6p (date, date, numeric, numeric, numeric) as "
       "select sum(l_extendedprice * l_discount) from lineitem "
       "where l_shipdate >= $1 and l_shipdate < $2 "
       "and l_discount between $3 and $4 and l_quantity < $5")
# (SQL arguments, numpy's: days, discount and quantity in hundredths)
Q6P_ARGS = (
    ("'1994-01-01', '1995-01-01', 0.05, 0.07, 24",
     ("1994-01-01", "1995-01-01", 5, 7, 2400)),
    ("'1995-03-01', '1995-09-01', 0.02, 0.04, 30",
     ("1995-03-01", "1995-09-01", 2, 4, 3000)),
)


def p17_query(name: str, s, sql: str, want, card: str, scan_agg=None,
              radix_probe=None) -> dict:
    """One statement of phase 17, run once: its rows exact against
    ``want`` (None: not checked), K1's and K2's launches counted from 0
    around it and held to ``scan_agg`` / ``radix_probe`` where given."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    sa.scan_agg.launches = rp.radix_probe.launches = 0
    t0 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    if want is not None and got != want:
        raise AssertionError(f"{name}: port {got[:3]} != numpy {want[:3]}")
    for k, n in (("scan_agg", scan_agg), ("radix_probe", radix_probe)):
        if n is not None and launches[k] != n:
            raise AssertionError(f"{name}: {launches[k]} {k} launches, "
                                 f"want {n}")
    fx = s.cluster._fused
    how = (f"host route ({'; '.join(s.last_declines)})"
           if s.last_route == "host" else
           f"fused DAG (join modes {fx._dag.last_join_modes})"
           if s._fused_via_dag else f"fused fragment ({fx.last_route})")
    print(f"main path: {name} {'exact' if want is not None else 'ran'} "
          f"through the {how}; scan_agg launches {launches['scan_agg']}, "
          f"radix_probe launches {launches['radix_probe']}; {ms:.3f} ms; "
          f"{len(got)} rows {got[:2]} [{card}]", flush=True)
    return {"launches": launches, "ms": ms, "rows": got}


def explain_check(name: str, s, sql: str, nrows: int, card: str,
                  fused: bool, scan_agg=None, radix_probe=None,
                  join_mode=None, remote: bool = False) -> dict:
    """EXPLAIN ANALYZE of ``sql``: its Total line counts ``nrows``; on the
    fused route the device ms (CUDA events) is no more than the end to
    end ms, on the host route the coordinator's root operator returns
    ``nrows``; the launches as ``p17_query`` holds them; ``join_mode``
    must be in the fused join modes line; ``remote``: every fragment ran
    in a datanode process (no operator records from them, a summary
    line each). The report's lines print."""
    import re

    r = p17_query(f"EXPLAIN ANALYZE of {name}", s, "explain analyze " + sql,
                  None, card, scan_agg, radix_probe)
    lines = [ln for (ln,) in r["rows"]]
    m = [re.match(r"Total: rows=(\d+) time=([\d.]+) ms", ln) for ln in lines]
    total = [x for x in m if x]
    if len(total) != 1 or int(total[0].group(1)) != nrows:
        raise AssertionError(f"{name}: Total line {total}, want {nrows} rows")
    total_ms = float(total[0].group(2))
    out = {"launches": r["launches"], "total_ms": total_ms, "ms": r["ms"]}
    if fused:
        ph = [re.match(r"Fused device execution: compile=([\d.]+) ms "
                       r"device=([\d.]+) ms host_merge=([\d.]+) ms", ln)
              for ln in lines]
        ph = [x for x in ph if x]
        if len(ph) != 1:
            raise AssertionError(f"{name}: not on the fused route: {lines}")
        out["compile_ms"], out["device_ms"], out["host_ms"] = (
            float(x) for x in ph[0].groups())
        if out["device_ms"] > total_ms:
            raise AssertionError(f"{name}: device {out['device_ms']} ms > "
                                 f"end to end {total_ms} ms")
        if join_mode is not None and not any(
                ln.startswith("Fused join modes:") and join_mode in ln
                for ln in lines):
            raise AssertionError(f"{name}: no {join_mode} join: {lines}")
    else:
        # the analyzed tree's coordinator (the plan text has one too)
        root = lines[len(lines) - lines[::-1].index("Coordinator:")]
        got = int(re.search(r" rows=(\d+) ", root).group(1))
        if got != nrows:
            raise AssertionError(f"{name}: root operator rows {got} != "
                                 f"{nrows}: {root}")
        ex = s.last_executor
        if remote and not (
                all(i.get("remote") for i in ex.instrumentation)
                and any("(no per-operator instrumentation" in ln
                        for ln in lines)):
            raise AssertionError(f"{name}: not every fragment remote: "
                                 f"{ex.instrumentation}")
    for ln in lines:
        print(f"explain: {name} | {ln}", flush=True)
    print(f"explain: {name}: Total rows {nrows}, {total_ms:.3f} ms inside "
          + (f"(compile {out['compile_ms']:.3f} ms, device "
             f"{out['device_ms']:.3f} ms by CUDA events, host merge "
             f"{out['host_ms']:.3f} ms)" if fused else "(host route)")
          + f", {r['ms']:.3f} ms end to end [{card}]", flush=True)
    return out


def run_phase17_ssb(ssb: dict, want_q11: list, card: str) -> dict:
    """Phase 17 (a) and (c) in the SSB cluster after phase 8 (c)'s
    DELETE: SSB Q1.1 under ``join_mode`` sortmerge (no K2 launch) and
    radix (one), each exact, then its EXPLAIN ANALYZE on the fused DAG
    with K2."""
    s = ssb["cluster"].session()
    sql = SSB_Q["Q1.1"]
    out = {}
    for mode, k2 in (("sortmerge", 0), ("radix", 1)):
        s.execute(f"set join_mode = {mode}")
        out[f"SSB Q1.1 join_mode {mode}"] = p17_query(
            f"SSB Q1.1 under join_mode = {mode}", s, sql, want_q11, card,
            radix_probe=k2)
    s.execute("reset join_mode")
    out["EXPLAIN ANALYZE SSB Q1.1"] = explain_check(
        "SSB Q1.1 (fused DAG, K2)", s, sql, 1, card, fused=True,
        radix_probe=1, join_mode="radix")
    return out


def write_tbl(path: str, columns: list) -> int:
    """dbgen's .tbl form of ``columns`` (each a list of strings, one a
    row): fields joined by '|', every line ending in '|'."""
    with open(path, "w") as f:
        f.writelines("|".join(r) + "|\n" for r in zip(*columns))
    return len(columns[0])


def rf1_tbl(rf1: dict, pool, seed: int) -> tuple:
    """RF1's orders and lineitems as dbgen writes them, in SPEC15_DDL's
    column order (l_partkey and l_suppkey drawn from ``seed``)."""
    o, li = rf1["orders"], rf1["lineitem"]
    n = len(li["l_orderkey"])
    rng = np.random.default_rng(seed)
    pk = rng.integers(1, 2_000_001, n)
    orders = [
        list(map(str, o["o_orderkey"].tolist())),
        list(map(str, o["o_custkey"].tolist())),
        list(map(_date, o["o_orderdate"].tolist())),
        list(map(str, o["o_shippriority"].tolist())),
        [PRIORITIES[i] for i in o["o_orderpriority"].idx.tolist()],
        list(map(repr, o["o_weight"].tolist())),
        list(map(_cents, o["o_totalprice"].tolist())),
        [str(pool[i]) for i in o["o_comment"].idx.tolist()],
    ]
    lines = [
        list(map(str, li["l_orderkey"].tolist())),
        list(map(_cents, li["l_extendedprice"].tolist())),
        list(map(_cents, li["l_discount"].tolist())),
        list(map(_date, li["l_shipdate"].tolist())),
        list(map(_cents, li["l_quantity"].tolist())),
        list(map(_cents, li["l_tax"].tolist())),
        list(map(_date, li["l_receiptdate"].tolist())),
        [RF_VOCAB[i] for i in li["l_returnflag"].idx.tolist()],
        [LS_VOCAB[i] for i in li["l_linestatus"].idx.tolist()],
        list(map(_date, li["l_commitdate"].tolist())),
        list(map(str, pk.tolist())),
        list(map(str, (pk % 100_000 + 1).tolist())),
    ]
    return orders, lines


def check_customer_file(path: str, cust: dict, p15: dict) -> int:
    """COPY customer TO's file read back: ordered by key, every line
    equals the one the generator's row makes (its six fields as COPY
    writes them, the balance a float of cents / 100)."""
    with open(path) as f:
        lines = f.read().splitlines()
    n = len(cust["c_custkey"])
    key = np.fromiter((int(ln[:ln.find(",")]) for ln in lines),
                      dtype=np.int64, count=len(lines))
    order = np.argsort(key)
    want = (f"{k},{s},{nm},{nk},{ph},{b / 100}" for k, s, nm, nk, ph, b in zip(
        cust["c_custkey"].tolist(), cust["c_mktsegment"].tolist(),
        cust["c_name"].vocab[cust["c_name"].idx].tolist(),
        p15["c_nationkey"].tolist(),
        p15["c_phone"].vocab[p15["c_phone"].idx].tolist(),
        p15["c_acctbal"].tolist()))
    if len(lines) != n or not np.array_equal(key[order], cust["c_custkey"]) \
            or any(lines[i] != w for i, w in zip(order.tolist(), want)):
        raise AssertionError("COPY TO customer: the file differs from the "
                             "generator's rows")
    return n


def run_phase17(q3: dict, state: dict, args, card: str) -> dict:
    """Phase 17 in phase 5c's SF10 cluster after phase 16 (see the
    module's docstring), every answer exact against numpy over
    ``state`` (phase 16's arrays). Returns {"reads": {statement:
    result}, "k1_rows": [K1 at Q6's inputs after COPY], "rates":
    {statement: rows/s}}."""
    import shutil
    import tempfile
    import threading

    from opentenbase_tpu_torch import SQLError

    cluster = q3["cluster"]
    s = cluster.session()
    li, o, cust = state["lineitem"], state["orders"], state["customer"]
    p15 = q3["p15"]["customer"]
    reads, rates = {}, {}
    t_phase = time.perf_counter()

    # (a) the settings
    show = s.execute("show all")
    print(f"settings: SHOW ALL, {show.rowcount} settings: "
          + ", ".join(f"{k}={v}" for k, v in show.rows) + f" [{card}]",
          flush=True)
    for value, n in (("off", 0), ("on", 1)):
        s.execute(f"set enable_pallas_scan = {value}")
        reads[f"TPC-H Q6 enable_pallas_scan {value}"] = r = p17_query(
            f"TPC-H Q6 (spec) under enable_pallas_scan = {value}", s, Q6,
            expected_q6(li), card, scan_agg=n)
        route = cluster.fused_executor().last_route
        if route != ("scan_agg" if n else "program"):
            raise AssertionError(f"enable_pallas_scan {value}: route {route}")
        r["route"] = route
    s.execute("reset enable_pallas_scan")

    # (b) PREPARE / EXECUTE
    s.execute(Q6P)
    for i, (sql_args, (lo, hi, dlo, dhi, qty)) in enumerate(Q6P_ARGS):
        v = q6_revenue(li, lo, hi, dlo, dhi, qty)
        reads[f"TPC-H Q6 EXECUTE {i + 1}"] = p17_query(
            f"EXECUTE q6p({sql_args})", s, f"execute q6p({sql_args})",
            [(None if v is None else v / 10**4,)], card, scan_agg=1)
    s.execute("create table p17_ins (k bigint, v numeric(12,2), note text) "
              "distribute by shard(k)")
    s.execute("prepare ins1 as insert into p17_ins values ($1, $2, $3)")
    t0 = time.perf_counter()
    for k in range(P17_INSERT_ROWS):
        s.execute(f"execute ins1({k}, {k}.25, 'n{k % 7}')")
    ms = (time.perf_counter() - t0) * 1000
    rates["prepared INSERT rows/s"] = P17_INSERT_ROWS / ms * 1000
    print(f"write: EXECUTE of a prepared one-row INSERT x "
          f"{P17_INSERT_ROWS} in {ms:.3f} ms, "
          f"{rates['prepared INSERT rows/s']:.1f} rows/s [{card}]",
          flush=True)
    n = P17_INSERT_ROWS
    reads["p17_ins sums"] = p17_query(
        "p17_ins count and sums", s, "select count(*), sum(k), sum(v) "
        "from p17_ins", [(n, n * (n - 1) // 2, (n * (n - 1) // 2 * 100
                                                  + 25 * n) / 100)], card)

    # (c) EXPLAIN ANALYZE: Q6 on K1, Q3 on the host route
    reads["EXPLAIN ANALYZE Q6"] = explain_check(
        "TPC-H Q6 (fused, K1)", s, Q6, 1, card, fused=True, scan_agg=1)
    s.execute("set enable_fused_execution = off")
    reads["EXPLAIN ANALYZE Q3"] = explain_check(
        "TPC-H Q3 (spec, host route)", s, Q3_SPEC, 10, card, fused=False,
        scan_agg=0, radix_probe=0)
    s.execute("reset enable_fused_execution")

    # (d) COPY: RF1's shape as dbgen .tbl files, then customer out and in
    os.makedirs(args.data_dir, exist_ok=True)
    d = tempfile.mkdtemp(prefix="p17_", dir=args.data_dir)
    rf1 = make_rf1({"orders": q3["tables"]["orders"], "customer": cust},
                   args.q3_sf, args.seed + 17)
    for part in ("orders", "lineitem"):  # the 17th-24th slots of a block
        key = "o_orderkey" if part == "orders" else "l_orderkey"
        rf1[part][key] = rf1[part][key] + 8
    otbl, ltbl = rf1_tbl(rf1, q3["tables"]["orders"]["o_comment"].vocab,
                         args.seed + 18)
    for table, cols in (("orders", otbl), ("lineitem", ltbl)):
        path = os.path.join(d, f"{table}.tbl")
        n = write_tbl(path, cols)
        t0 = time.perf_counter()
        r = s.execute(f"copy {table} from '{path}' delimiter '|'")
        ms = (time.perf_counter() - t0) * 1000
        if r.rowcount != n:
            raise AssertionError(f"COPY {table}: {r.rowcount} rows, not {n}")
        rates[f"COPY {table} FROM rows/s"] = n / ms * 1000
        print(f"write: COPY {table} FROM a dbgen .tbl file, {n} rows in "
              f"{ms:.3f} ms, {n / ms * 1000:.1f} rows/s [{card}]",
              flush=True)
    li = _concat(li, {k: rf1["lineitem"][k] for k in li})
    o_live = len(o["o_orderkey"]) + 1 + len(rf1["orders"]["o_orderkey"])
    q6 = "TPC-H Q6 (spec, after COPY)"
    fx = cluster.fused_executor()
    c0 = dict(fx.cache.stats)
    reads[q6] = r = p17_query(q6, s, Q6, expected_q6(li), card, scan_agg=1)
    refresh = {k: fx.cache.stats[k] - c0[k] for k in REFRESH_STATS}
    print(f"refresh: {q6} device-cache refresh " + ", ".join(
        f"{k} {refresh[k]}" for k in REFRESH_STATS) + f" [{card}]",
        flush=True)
    if refresh["full_uploads"] or not refresh["delta_tail_rows"]:
        raise AssertionError(f"{q6}: the refresh was not a delta tail: "
                             f"{refresh}")
    r["refresh"] = refresh
    k1_rows = time_k1_at(cluster, {q6: Q6}, card)
    path = os.path.join(d, "customer.csv")
    t0 = time.perf_counter()
    n = s.execute(f"copy customer to '{path}'").rowcount
    ms = (time.perf_counter() - t0) * 1000
    rates["COPY customer TO rows/s"] = n / ms * 1000
    check_customer_file(path, cust, p15)
    print(f"write: COPY customer TO a file, {n} rows in {ms:.3f} ms "
          f"({n / ms * 1000:.1f} rows/s, {os.path.getsize(path)} bytes), "
          f"read back: every line equal to the generator's row [{card}]",
          flush=True)
    s.execute(SPEC15_DDL[0].replace("table customer", "table customer_copy"))
    t0 = time.perf_counter()
    r = s.execute(f"copy customer_copy from '{path}'")
    ms = (time.perf_counter() - t0) * 1000
    rates["COPY customer_copy FROM rows/s"] = r.rowcount / ms * 1000
    print(f"write: COPY customer_copy FROM that file, {r.rowcount} rows in "
          f"{ms:.3f} ms ({r.rowcount / ms * 1000:.1f} rows/s) [{card}]",
          flush=True)
    shutil.rmtree(d, ignore_errors=True)
    seg = cust["c_mktsegment"]
    want = [(g, int((seg == g).sum()),
             int(p15["c_acctbal"][seg == g].sum()) / 100)
            for g in sorted(set(seg.tolist()))]
    reads["customer_copy by segment"] = p17_query(
        "customer_copy by segment", s, "select c_mktsegment, count(*), "
        "sum(c_acctbal) from customer_copy group by c_mktsegment "
        "order by c_mktsegment", want, card)

    # (e) the views, each against the state it reports
    got = dict(s.query("select stat, value from pg_stat_device_cache"))
    if got != {k: int(v) for k, v in fx.cache.stats.items()}:
        raise AssertionError(f"pg_stat_device_cache {got} != "
                             f"{fx.cache.stats}")
    fused = dict(s.query("select event, detail from pg_stat_fused"))
    for k, v in fx.last_phases.items():
        if fused.get(f"last_{k}") != f"{v:.3f}":
            raise AssertionError(f"pg_stat_fused last_{k}: {fused}")
    if fx._dag is not None and fused["completed"] != str(fx._dag.completed):
        raise AssertionError(f"pg_stat_fused completed: {fused}")
    print(f"views: pg_stat_device_cache equals DeviceCache.stats "
          f"({len(got)} counters: full_uploads {got['full_uploads']}, "
          f"delta_tail_rows {got['delta_tail_rows']}); pg_stat_fused's "
          f"last phases {fx.last_phases} [{card}]", flush=True)
    live = dict(s.query(
        "select relname, sum(n_live_tup) from pg_stat_user_tables where "
        "relname in ('lineitem', 'orders', 'customer', 'customer_copy', "
        "'p17_ins') group by relname"))
    want = {"lineitem": len(li["l_orderkey"]), "orders": o_live,
            "customer": len(cust["c_custkey"]),
            "customer_copy": len(cust["c_custkey"]),
            "p17_ins": P17_INSERT_ROWS}
    if live != want:
        raise AssertionError(f"pg_stat_user_tables {live} != numpy {want}")
    nodes = s.query("select node_name, node_type, mesh_index from pgxc_node "
                    "order by node_name")
    shards = s.query("select node_index, count(*) from pgxc_shard_map "
                     "group by node_index order by node_index")
    sm = np.asarray(cluster.shardmap.map)
    if (nodes != [("cn0", "coordinator", -1), ("dn0", "datanode", 0),
                  ("dn1", "datanode", 1), ("gtm0", "gtm", -1)]
            or shards != [(i, int((sm == i).sum())) for i in (0, 1)]):
        raise AssertionError(f"pgxc_node {nodes}, pgxc_shard_map {shards}")
    print(f"views: pg_stat_user_tables live rows equal numpy's {live}; "
          f"pgxc_node {nodes}; pgxc_shard_map {shards} [{card}]", flush=True)

    # (e) the deadlock breaker on two sessions' cycle
    s1, s2 = cluster.session(), cluster.session()
    for x in (s1, s2):
        x.execute("set deadlock_timeout = 600000")
        x.execute("begin")
    s1.execute("update p17_ins set v = 0 where k = 1")
    s2.execute("update p17_ins set v = 0 where k = 2")
    outcome = {}

    def wait(sess, key, sql):
        try:
            sess.execute(sql)
            outcome[key] = "ok"
        except SQLError as e:
            outcome[key] = f"{e.sqlstate} {e}"

    ths = [threading.Thread(target=wait, args=(s1, "s1", "update p17_ins "
                                               "set v = 0 where k = 2")),
           threading.Thread(target=wait, args=(s2, "s2", "update p17_ins "
                                               "set v = 0 where k = 1"))]
    for th in ths:
        th.start()
        time.sleep(0.1)
    t0 = time.perf_counter()
    deadline = time.monotonic() + 10
    while True:  # until both sessions wait
        locks = s.query("select relation, mode, granted from pg_locks "
                        "where relation = 'p17_ins' and not granted")
        if len(locks) == 2 or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    cycles = s.query("select pg_unlock_check_deadlock()")
    victims = s.query("select pg_unlock_execute()")
    for th in ths:
        th.join(timeout=30)
    ms = (time.perf_counter() - t0) * 1000
    if (len(locks) != 2 or len(cycles) != 1 or len(victims) != 1
            or sorted(outcome) != ["s1", "s2"]
            or sorted(v == "ok" for v in outcome.values()) != [False, True]):
        raise AssertionError(f"pg_unlock: waits {locks}, cycles {cycles}, "
                             f"victims {victims}, outcome {outcome}")
    (s1 if outcome["s1"] == "ok" else s2).execute("rollback")
    print(f"views: pg_locks showed both waits {locks}; pg_unlock_check_"
          f"deadlock {cycles}; pg_unlock_execute cancelled {victims}, the "
          f"cycle broken in {ms:.3f} ms: {outcome} [{card}]", flush=True)
    print(f"time: phase 17 in the SF10 cluster {time.perf_counter() - t_phase:.1f} "
          f"s [{card}]", flush=True)
    # phase 18's numpy truth: RF1's COPYed orders, lineitem with its lines
    return {"reads": reads, "k1_rows": k1_rows, "rates": rates,
            "rf1_orders": rf1["orders"], "lineitem": li}


# -- phase 18: partitioned tables, WITH RECURSIVE, PL/pgSQL, foreign tables --

ORDERS_P_DDL = (
    "create table orders_p (o_orderkey bigint, o_custkey bigint, "
    "o_orderdate date, o_orderpriority text, o_totalprice numeric(12,2)) "
    "partition by range (o_orderdate) begin ('1992-01-01') step (1 year) "
    "partitions (7) distribute by shard (o_orderkey)")
ORDERS_P_COLS = ("o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority",
                 "o_totalprice")
P18_YEAR = "o_orderdate >= '1994-01-01' and o_orderdate < '1995-01-01'"
BY_PRIORITY = ("select o_orderpriority, count(*) from {} {}"
               "group by o_orderpriority order by o_orderpriority")
EMP_ROWS = 1_000_000  # one company's HR schema
PL_ROWS = 1000  # the RF1-shaped INSERTs a PL/pgSQL call loops over
Q6_REV = (
    "create function q6_rev(lo date, hi date, qty numeric) returns numeric "
    "as 'declare r numeric; begin "
    "select sum(l_extendedprice * l_discount) into r from lineitem "
    "where l_shipdate >= lo and l_shipdate < hi "
    "and l_discount between 0.05 and 0.07 and l_quantity < qty; "
    "return r; end' language plpgsql")
# (SQL arguments, numpy's: the days and the quantity in hundredths)
Q6_REV_ARGS = (("'1994-01-01', '1995-01-01', 24",
                ("1994-01-01", "1995-01-01", 2400)),
               ("'1995-03-01', '1996-03-01', 30",
                ("1995-03-01", "1996-03-01", 3000)))
RF1_PL = (
    "create function rf1_batch(k0 bigint, n bigint, fail bigint) returns "
    "bigint as 'begin "
    "for i in 0 .. n - 1 loop "
    "insert into p18_rf1 values (k0 + i, 1 + i % 1000, "
    "date ''1995-06-17'', ''3-MEDIUM'', 100.25 + i); "
    "end loop; "
    "if fail = 1 then "
    "raise exception ''rf1_batch: asked to fail after % rows'', n; "
    "end if; "
    "return n; end' language plpgsql")
# TPC-H Q11 over phase 15's partsupp, which carries ps_supplycost alone:
# the value is sum(ps_supplycost) (the spec's sums supplycost x
# availqty), FRACTION 0.0001 / SF
Q11_FT = (
    "select ps_partkey, sum(ps_supplycost) as value "
    "from partsupp, {s}, nation where ps_suppkey = s_suppkey "
    "and s_nationkey = n_nationkey and n_name = 'GERMANY' "
    "group by ps_partkey having sum(ps_supplycost) > "
    "(select sum(ps_supplycost) * {f} from partsupp, {s}, nation "
    "where ps_suppkey = s_suppkey and s_nationkey = n_nationkey "
    "and n_name = 'GERMANY') order by value desc, ps_partkey")
SUPPLIER_FT_DDL = (
    "create foreign table supplier_ft (s_suppkey bigint, s_name text, "
    "s_address text, s_nationkey int, s_phone text, "
    "s_acctbal numeric(12,2), s_comment text) server file "
    "options (filename '{}', format 'csv')")


def explain_scans(s, sql: str) -> list:
    """The relations the plain EXPLAIN of ``sql`` scans, in plan order."""
    return [ln.split("Scan on ", 1)[1].split()[0]
            for (ln,) in s.query("explain " + sql) if "Scan on " in ln]


def by_priority(prio_idx) -> list:
    """numpy's count by o_orderpriority, in the vocabulary's order."""
    counts = np.bincount(prio_idx, minlength=len(PRIORITIES))
    return [(p, int(n)) for p, n in zip(PRIORITIES, counts) if n]


def make_org_chart(n: int, seed: int) -> dict:
    """emp(id, mgr, salary): a tree of ``n`` employees grown a level at a
    time from one root (id 1, mgr 0: no employee has id 0): each
    employee of a level manages 3-5 of the next with probability 3/4
    (a fan-out of 3-5 and a depth of about 12), ids numbered level by
    level; salaries in whole units from ``seed``."""
    rng = np.random.default_rng(seed)
    mgr = np.zeros(n, dtype=np.int64)
    depth = np.zeros(n, dtype=np.int32)
    frontier = np.array([1], dtype=np.int64)
    nxt, d = 2, 0
    while nxt <= n:
        d += 1
        managers = frontier[rng.random(len(frontier)) < 0.75]
        if not len(managers):
            managers = frontier[:1]
        kids = np.repeat(managers, rng.integers(3, 6, len(managers)))
        kids = kids[:n - nxt + 1]
        ids = np.arange(nxt, nxt + len(kids), dtype=np.int64)
        mgr[ids - 1] = kids
        depth[ids - 1] = d
        frontier, nxt = ids, nxt + len(kids)
    return {"id": np.arange(1, n + 1, dtype=np.int64), "mgr": mgr,
            "salary": rng.integers(30_000, 200_001, n).astype(np.int64),
            "depth": depth}


def bfs_levels(src, dst, start: int, n: int) -> list:
    """numpy's breadth-first search over the edges ``src`` -> ``dst``
    (ids 1..n) from ``start``: the new ids of each level, the start's
    first (a visited id is never new again: UNION's semantics)."""
    order = np.argsort(src, kind="stable")
    s_sorted = src[order]
    seen = np.zeros(n + 1, dtype=bool)
    seen[start] = True
    levels = [np.array([start], dtype=np.int64)]
    while True:
        f = levels[-1]
        lo = np.searchsorted(s_sorted, f, "left")
        cnt = np.searchsorted(s_sorted, f, "right") - lo
        if not cnt.sum():
            break
        first = np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
        nxt = np.unique(dst[order[first + np.arange(cnt.sum())]])
        nxt = nxt[~seen[nxt]]
        if not len(nxt):
            break
        seen[nxt] = True
        levels.append(nxt)
    return levels


def run_phase18_partitions(cluster, s, o: dict, args, card: str) -> dict:
    """Phase 18 (a): orders_p partitioned by year over phase 17's orders
    (``o``: numpy's columns of every live order)."""
    reads, writes = {}, {}
    days = o["o_orderdate"]
    years = _years(days)
    prio = o["o_orderpriority"].idx.astype(np.int64)
    n = len(days)
    p16_write("CREATE TABLE orders_p PARTITION BY RANGE (o_orderdate) 7 "
              "years", s, ORDERS_P_DDL, card)
    _r, writes["INSERT INTO orders_p SELECT"] = p16_write(
        "INSERT INTO orders_p SELECT ... FROM orders (the partition split)",
        s, f"insert into orders_p select {', '.join(ORDERS_P_COLS)} "
        "from orders", card, rows=n)
    want = [(f"orders_p$p{i}", int((years == 1992 + i).sum()))
            for i in range(7)]
    got = s.query("select partition, n_live_tup from pg_partitions where "
                  "parent = 'orders_p' order by index")
    if got != want:
        raise AssertionError(f"orders_p's children {got} != numpy {want}")
    print(f"partitions: orders_p's children's rows {got}, exact [{card}]",
          flush=True)
    year = (days >= _day("1994-01-01")) & (days < _day("1995-01-01"))
    q_year = BY_PRIORITY.format("orders_p", f"where {P18_YEAR} ")
    scans = explain_scans(s, q_year)
    if sorted(scans) != ["orders_p$p2", "orders_p$p3"]:
        raise AssertionError(f"pruning kept {scans}")
    print(f"partitions: {P18_YEAR} prunes orders_p to {sorted(scans)} (the "
          f"'<' bound keeps p3, as the reference's) [{card}]", flush=True)
    reads["orders_p 1994 by priority"] = p16_read(
        "orders_p one year's count by priority (pruned parent)", s, q_year,
        by_priority(prio[year]), args, card, route="host")
    reads["orders_p count"] = p16_read(
        "orders_p count (the whole parent)", s,
        "select count(*) from orders_p", [(n,)], args, card, route="host")
    q_child = BY_PRIORITY.format("orders_p$p2", "")
    reads["orders_p$p2 by priority"] = p16_read(
        "orders_p$p2 (1994) by priority, the child by name", s, q_child,
        by_priority(prio[years == 1994]), args, card, k1=True)
    k1_rows = time_k1_at(cluster, {"orders_p$p2 by priority": q_child},
                         card)
    # writes fanned out over one year's children (the '<' bound keeps
    # the next child too, as the reference's pruning does); the extra
    # conjuncts keep each to about 230 000 rows (every changed row takes
    # a row lock on the host, about 10 us)
    cust = o["o_custkey"]
    upd = ((days >= _day("1995-01-01")) & (days < _day("1996-01-01"))
           & (prio == PRIORITIES.index("5-LOW")) & (cust % 2 == 0))
    _r, writes["UPDATE orders_p (fan-out)"] = p16_write(
        "UPDATE orders_p over 1995 (fans out to p3 and p4)", s,
        "update orders_p set o_orderpriority = '1-URGENT' where "
        "o_orderdate >= '1995-01-01' and o_orderdate < '1996-01-01' and "
        "o_orderpriority = '5-LOW' and o_custkey % 2 = 0", card,
        rows=int(upd.sum()))
    prio = prio.copy()
    prio[upd] = PRIORITIES.index("1-URGENT")
    gone = ((days >= _day("1997-01-01")) & (days < _day("1998-01-01"))
            & (prio == PRIORITIES.index("4-NOT SPECIFIED"))
            & (cust % 2 == 0))
    _r, writes["DELETE orders_p (fan-out)"] = p16_write(
        "DELETE FROM orders_p over 1997 (fans out to p5 and p6)", s,
        "delete from orders_p where o_orderdate >= '1997-01-01' and "
        "o_orderdate < '1998-01-01' and o_orderpriority = "
        "'4-NOT SPECIFIED' and o_custkey % 2 = 0", card,
        rows=int(gone.sum()))
    p16_refused("UPDATE of the partition key", s,
                "update orders_p set o_orderdate = '1994-06-01' where "
                f"o_orderkey = {int(o['o_orderkey'][0])}",
                "updating the partition key (moving rows between "
                "partitions) is not supported", card)
    p16_write("ALTER TABLE orders_p ADD PARTITIONS (1)", s,
              "alter table orders_p add partitions (1)", card)
    k_new = int(o["o_orderkey"].max()) + 100
    p16_write("INSERT into the new partition", s,
              f"insert into orders_p values ({k_new}, 1, '1999-03-01', "
              "'3-MEDIUM', 10.00)", card, rows=1)
    keep = ~gone
    want_all = by_priority(np.concatenate(
        [prio[keep], [PRIORITIES.index("3-MEDIUM")]]))
    reads["orders_p by priority after the writes"] = p16_read(
        "orders_p by priority after the UPDATE, DELETE and ADD PARTITIONS",
        s, BY_PRIORITY.format("orders_p", ""), want_all, args, card,
        route="host")
    reads["orders_p$p7"] = p16_read(
        "orders_p$p7 (the added partition) by priority", s,
        BY_PRIORITY.format("orders_p$p7", ""), [("3-MEDIUM", 1)], args,
        card, k1=True)
    # teardown: the name again, new rows, no stale plane of a child
    p16_write("DROP TABLE orders_p", s, "drop table orders_p", card)
    p16_write("CREATE TABLE orders_p again", s, ORDERS_P_DDL, card)
    p16_write("INSERT into the new orders_p", s,
              "insert into orders_p values (1, 1, '1994-02-01', '5-LOW', 1.00),"
              " (2, 1, '1994-03-01', '5-LOW', 2.00), "
              "(3, 1, '1994-04-01', '2-HIGH', 3.00)", card, rows=3)
    reads["orders_p$p2 re-created"] = p16_read(
        "orders_p$p2 of the re-created table by priority", s, q_child,
        [("2-HIGH", 1), ("5-LOW", 2)], args, card, k1=True)
    p16_write("DROP TABLE orders_p (end of (a))", s, "drop table orders_p",
              card)
    return {"reads": reads, "writes": writes, "k1_rows": k1_rows}


def run_phase18_recursive(cluster, s, args, card: str) -> dict:
    """Phase 18 (b): a generated org chart and WITH RECURSIVE, UNION ALL
    down a manager's reports and UNION reachability over its edges plus
    back edges that close cycles, each against numpy's BFS with the
    iterations counted."""
    reads = {}
    emp = make_org_chart(EMP_ROWS, args.seed + 1800)
    n = EMP_ROWS
    depth = emp["depth"]
    rng = np.random.default_rng(args.seed + 1801)
    # back edges: 1 % of the employees four levels or more down point at
    # their manager's manager
    cand = np.flatnonzero(depth >= 4)
    back = np.sort(rng.choice(cand, len(cand) // 100, replace=False))
    src = np.concatenate([emp["mgr"][1:], back + 1])
    dst = np.concatenate([emp["id"][1:], emp["mgr"][emp["mgr"][back] - 1]])
    s.execute("create table emp (id bigint, mgr bigint, salary bigint) "
              "distribute by roundrobin")
    s.execute("create table emp_edge (src bigint, dst bigint) "
              "distribute by roundrobin")
    t0 = time.perf_counter()
    bulk_append(cluster, "emp", {k: emp[k] for k in ("id", "mgr", "salary")})
    bulk_append(cluster, "emp_edge", {"src": src, "dst": dst})
    print(f"load: emp {n} employees (depth {int(depth.max())}, fan-out 3-5) "
          f"and emp_edge {len(src)} edges ({len(back)} back edges closing "
          f"cycles) in {(time.perf_counter() - t0) * 1000:.3f} ms [{card}]",
          flush=True)
    # UNION ALL: the reports under the first manager of level 1
    m = int(emp["id"][depth == 1][0])
    sub = bfs_levels(emp["mgr"][1:], emp["id"][1:], m, n)
    ids = np.concatenate(sub)
    want = [(len(ids), int(emp["salary"][ids - 1].sum()))]
    sql = ("with recursive sub(id, salary) as ("
           f"select id, salary from emp where id = {m} union all "
           "select e.id, e.salary from emp e join sub s on e.mgr = s.id) "
           "select count(*), sum(salary) from sub")
    reads["emp reports UNION ALL"] = r = p17_query(
        f"WITH RECURSIVE UNION ALL: the reports under manager {m}", s, sql,
        want, card)
    it = s.recursive_iterations.get("sub")
    if it != len(sub):
        raise AssertionError(f"UNION ALL: {it} iterations, numpy's BFS "
                             f"{len(sub)} levels")
    r["iterations"] = it
    print(f"recursive: UNION ALL under manager {m}: {it} iterations (the "
          f"last one empty), {len(ids)} rows, levels "
          f"{[len(x) for x in sub]} [{card}]", flush=True)
    # UNION: reachability from the first employee of level 2 over the
    # edges and the back edges (a cycle closes under every back edge)
    root = int(emp["id"][depth == 2][0])
    reach = bfs_levels(src, dst, root, n)
    ids = np.concatenate(reach)
    want = [(len(ids), int(ids.sum()))]
    sql = ("with recursive reach(node) as ("
           f"select {root} union select e.dst from emp_edge e "
           "join reach r on e.src = r.node) select count(*), sum(node) "
           "from reach")
    reads["emp_edge reach UNION"] = r = p17_query(
        f"WITH RECURSIVE UNION: reachability from {root} over cycles", s,
        sql, want, card)
    it = s.recursive_iterations.get("reach")
    if it != len(reach):
        raise AssertionError(f"UNION: {it} iterations, numpy's BFS "
                             f"{len(reach)} levels")
    r["iterations"] = it
    print(f"recursive: UNION from {root}: {it} iterations, {len(ids)} rows "
          f"reached, levels {[len(x) for x in reach]} [{card}]", flush=True)
    left = [t for t in cluster.catalog.table_names() if t.startswith("__rec")]
    if left:
        raise AssertionError(f"recursive temporaries left behind: {left}")
    for t in ("emp", "emp_edge"):
        s.execute(f"drop table {t}")
    return {"reads": reads}


def run_phase18_plpgsql(cluster, s, li: dict, args, card: str) -> dict:
    """Phase 18 (c): Q6 in a PL/pgSQL body (K1 inside the call), and a
    call looping over RF1-shaped INSERTs, atomic."""
    from opentenbase_tpu_torch import SQLError

    reads, writes = {}, {}
    s.execute(Q6_REV)
    for i, (sql_args, (lo, hi, qty)) in enumerate(Q6_REV_ARGS):
        v = q6_revenue(li, lo, hi, 5, 7, qty)
        r = p17_query(f"q6_rev({sql_args}) (PL/pgSQL body's SELECT INTO)",
                      s, f"select q6_rev({sql_args})",
                      [(None if v is None else v / 10**4,)], card)
        if r["launches"]["scan_agg"] < 1:
            raise AssertionError(f"q6_rev call {i + 1}: no K1 launch")
        reads[f"q6_rev call {i + 1}"] = r
    k1_rows = time_k1_at(
        cluster, {"q6_rev call 1": f"select q6_rev({Q6_REV_ARGS[0][0]})"},
        card)
    s.execute("create table p18_rf1 (o_orderkey bigint, o_custkey bigint, "
              "o_orderdate date, o_orderpriority text, "
              "o_totalprice numeric(12,2)) distribute by shard(o_orderkey)")
    s.execute(RF1_PL)
    k0 = 1
    t0 = time.perf_counter()
    got = s.query(f"select rf1_batch({k0}, {PL_ROWS}, 0)")
    ms = (time.perf_counter() - t0) * 1000
    writes["rf1_batch"] = ms
    n = PL_ROWS
    want = [(n, n * k0 + n * (n - 1) // 2, (n * 10025 + 100 * n * (n - 1)
                                            // 2) / 100)]
    if got != [(n,)]:
        raise AssertionError(f"rf1_batch returned {got}")
    print(f"write: a PL/pgSQL call looping over {n} RF1-shaped INSERTs in "
          f"{ms:.3f} ms ({n / ms * 1000:.1f} rows/s) [{card}]", flush=True)
    q = ("select count(*), sum(o_orderkey), sum(o_totalprice) from p18_rf1")
    reads["p18_rf1 after the call"] = p17_query(
        "p18_rf1 after the call: every row visible", s, q, want, card)
    t0 = time.perf_counter()
    try:
        s.query(f"select rf1_batch({k0 + 10 * n}, {n}, 1)")
    except SQLError as e:
        ms = (time.perf_counter() - t0) * 1000
        if str(e) != f"rf1_batch: asked to fail after {n} rows":
            raise AssertionError(f"rf1_batch's RAISE: {e}") from e
        print(f"write: the same call asked to RAISE after {n} INSERTs "
              f"failed in {ms:.3f} ms: {e} [{card}]", flush=True)
    else:
        raise AssertionError("rf1_batch(fail = 1) did not raise")
    writes["rf1_batch raised"] = ms
    reads["p18_rf1 after the RAISE"] = p17_query(
        "p18_rf1 after the RAISE: none of its rows visible", s, q, want,
        card)
    s.execute("drop table p18_rf1")
    return {"reads": reads, "writes": writes, "k1_rows": k1_rows}


def run_phase18_foreign(q3: dict, s, d: str, args, card: str) -> dict:
    """Phase 18 (d): dbgen's supplier (SF x 10 000 rows, its seven
    columns) written as CSV without trailing delimiters, read as a
    foreign table by Q11; its writes refused; the file rewritten."""
    import csv

    reads = {}
    sup, ps = q3["p15"]["supplier"], q3["p15"]["partsupp"]
    n_s = len(sup["s_suppkey"])
    rng = np.random.default_rng(args.seed + 1810)
    acct = rng.integers(-99_999, 1_000_000, n_s)
    pool = q3["tables"]["orders"]["o_comment"].vocab
    comment = pool[rng.integers(0, len(pool), n_s)]
    rows = zip(sup["s_suppkey"].tolist(),
               sup["s_name"].vocab[sup["s_name"].idx].tolist(),
               sup["s_address"].vocab[sup["s_address"].idx].tolist(),
               sup["s_nationkey"].tolist(),
               sup["s_phone"].vocab[sup["s_phone"].idx].tolist(),
               map(_cents_signed, acct.tolist()), comment.tolist())
    path = os.path.join(d, "supplier.csv")
    t0 = time.perf_counter()
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    print(f"load: supplier.csv, {n_s} rows of dbgen's seven columns, "
          f"{os.path.getsize(path)} bytes in "
          f"{(time.perf_counter() - t0) * 1000:.3f} ms [{card}]", flush=True)
    p16_write("CREATE FOREIGN TABLE supplier_ft", s,
              SUPPLIER_FT_DDL.format(path), card)
    ger = [nm for nm, _r in NATIONS].index("GERMANY")
    m = sup["s_nationkey"][ps["ps_suppkey"] - 1] == ger
    cost, pk = ps["ps_supplycost"][m], ps["ps_partkey"][m]
    total = int(cost.sum())
    uniq, inv = np.unique(pk, return_inverse=True)
    value = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(value, inv, cost)
    frac = f"{0.0001 / args.q3_sf:.10f}".rstrip("0")
    scale = 10 ** (len(frac) - 2)  # value > total * frac, in integers
    keep = value * scale > total * int(round(float(frac) * scale))
    order = np.lexsort((uniq[keep], -value[keep]))
    want = [(int(k), int(v) / 100) for k, v in
            zip(uniq[keep][order], value[keep][order])]
    sql = Q11_FT.format(s="supplier_ft", f=frac)
    reads["TPC-H Q11 over supplier_ft"] = p16_read(
        f"TPC-H Q11 (FRACTION {frac}) over the foreign supplier_ft", s,
        sql, want, args, card, route="host")
    for name, stmt in (("INSERT", "insert into supplier_ft values "
                        "(0, 'x', 'y', 0, 'z', 0.00, 'c')"),
                       ("COPY FROM", f"copy supplier_ft from '{path}'")):
        p16_refused(f"{name} into the foreign table", s, stmt,
                    'cannot change foreign table "supplier_ft"', card)
    half = n_s // 2
    with open(path) as f:
        head = [next(f) for _ in range(half)]
    with open(path, "w") as f:
        f.writelines(head)
    reads["supplier_ft after the rewrite"] = p16_read(
        "supplier_ft after the file was rewritten with its first half", s,
        "select count(*), sum(s_suppkey) from supplier_ft",
        [(half, half * (half + 1) // 2)], args, card, route="host")
    s.execute("drop table supplier_ft")
    return {"reads": reads}


def run_phase18(q3: dict, p17: dict, state: dict, args, card: str) -> dict:
    """Phase 18 in phase 5c's SF10 cluster after phase 17 (see the
    module's docstring), every answer exact against numpy. Returns
    {"reads": {statement: result}, "writes": {statement: ms},
    "k1_rows": [K1 at orders_p$p2's and q6_rev's inputs]}."""
    import shutil
    import tempfile

    cluster = q3["cluster"]
    s = cluster.session()
    t_phase = time.perf_counter()
    # numpy's orders after phase 17: phase 16's state, the INSERT held
    # off by LOCK TABLE and RF1's COPYed orders
    o = {k: state["orders"][k] for k in ORDERS_P_COLS}
    ko = int(o["o_orderkey"].max()) + 1
    held = {"o_orderkey": np.array([ko]), "o_custkey": np.array([1]),
            "o_orderdate": np.array([_day("1995-01-01")], dtype=np.int32),
            "o_orderpriority": Text(PRIORITIES,
                                    [PRIORITIES.index("5-LOW")]),
            "o_totalprice": np.array([0])}  # NULL there; (a) sums none
    o = _concat(_concat(o, held), {k: p17["rf1_orders"][k]
                                   for k in ORDERS_P_COLS})
    out = {"reads": {}, "writes": {}, "k1_rows": []}
    for part, fn in (
            ("a", lambda: run_phase18_partitions(cluster, s, o, args, card)),
            ("b", lambda: run_phase18_recursive(cluster, s, args, card)),
            ("c", lambda: run_phase18_plpgsql(cluster, s, p17["lineitem"],
                                              args, card))):
        t0 = time.perf_counter()
        r = fn()
        for k in out:
            if isinstance(out[k], list):
                out[k] += r.get(k, [])
            else:
                out[k].update(r.get(k, {}))
        print(f"time: phase 18 ({part}) {time.perf_counter() - t0:.1f} s "
              f"[{card}]", flush=True)
    os.makedirs(args.data_dir, exist_ok=True)
    d = tempfile.mkdtemp(prefix="p18_", dir=args.data_dir)
    t0 = time.perf_counter()
    try:
        out["reads"].update(run_phase18_foreign(q3, s, d, args, card)[
            "reads"])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"time: phase 18 (d) {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    print(f"time: phase 18 in the SF10 cluster "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: workload management, parallel workers, matviews, replication
# ---------------------------------------------------------------------------

P19_HOLD_S = 1.5  # the two slot holders' pg_sleep in phase 19 (a)


def _attempt(fn):
    """(status, result, ms): "ok" or the SQLSTATE of the failure."""
    t0 = time.perf_counter()
    try:
        out = fn()
        return "ok", out, (time.perf_counter() - t0) * 1000
    except Exception as e:  # noqa: BLE001 - the SQLSTATE is the result
        state = getattr(e, "sqlstate", None)
        if state is None:
            raise
        return state, str(e), (time.perf_counter() - t0) * 1000


def _wait_for(pred, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def run_phase19_wlm(q3: dict, li: dict, card: str) -> dict:
    """Phase 19 (a): a resource group of concurrency 2 and queue depth 2
    in phase 5c's SF10 cluster after phase 18: two sessions of its role
    hold the slots with pg_sleep, four more send Q6 at once (two queue
    and run Q6 on K1, two are shed with 53000, and pg_stat_wlm counts
    what the threads saw); a memory_limit between Q6's and Q3's
    estimates sheds Q3 with 53200 and admits Q6; a queued Q6 under
    statement_timeout 500 fails with 57014."""
    import threading

    from opentenbase_tpu_torch.engine import Session
    from opentenbase_tpu_torch.ops import scan_agg as sa
    from opentenbase_tpu_torch.sql import parse
    from opentenbase_tpu_torch.wlm.estimate import estimate_statement_memory

    cluster = q3["cluster"]
    admin = cluster.session()
    want_q6 = expected_q6(li)
    admin.execute("create resource group p19 with "
                  "(concurrency = 2, queue_depth = 2)")
    admin.execute("alter role p19 resource group p19")
    g = cluster.wlm.groups["p19"]
    out: dict = {"reads": {}}

    def user():
        return Session(cluster, user="p19")

    def hold(n: int) -> list:
        """``n`` sessions of the role asleep in the group's slots."""
        ths = []
        for _ in range(n):
            u = user()
            th = threading.Thread(target=lambda u=u: u.query(
                f"select pg_sleep({P19_HOLD_S})"))
            th.start()
            ths.append(th)
        _wait_for(lambda: g.running >= n, 30, "the slot holders")
        return ths

    # 1. two holders, then four Q6s at once
    st0 = dict(g.stats)
    holders = hold(2)
    sa.scan_agg.launches = 0
    results: list = [None] * 4
    sessions = [user() for _ in range(4)]
    gate = threading.Event()

    def send(i):
        gate.wait(30)
        results[i] = _attempt(lambda: sessions[i].query(Q6))

    threads = [threading.Thread(target=send, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    gate.set()
    _wait_for(lambda: g.stats["queued"] - st0["queued"]
              + g.stats["shed"] - st0["shed"] >= 4, 30, "the four Q6s")
    for th in threads + holders:
        th.join(timeout=600)
    k1 = sa.scan_agg.launches
    states = sorted(r[0] for r in results)
    if states != ["53000", "53000", "ok", "ok"]:
        raise AssertionError(f"phase 19 (a): the four Q6s ended {states}")
    for st, rows, _ms in results:
        if st == "ok" and rows != want_q6:
            raise AssertionError(f"phase 19 (a): queued Q6 {rows} != numpy "
                                 f"{want_q6}")
    if k1 != 2:
        raise AssertionError(f"phase 19 (a): {k1} K1 launches for the two "
                             "admitted Q6s, want one each")
    view = admin.query("select admitted, queued, shed, timed_out, "
                       "queue_wait_ms, peak_running from pg_stat_wlm "
                       "where group_name = 'p19'")[0]
    seen = (4, 2, 2, 0)  # the holders and the queued Q6s; queued; shed
    got = (view[0] - st0["admitted"], view[1] - st0["queued"],
           view[2] - st0["shed"], view[3] - st0["timed_out"])
    if got != seen:
        raise AssertionError(f"pg_stat_wlm {got} != the threads' {seen}")
    waits = sorted(ms for st, _r, ms in results if st == "ok")
    print(f"wlm: concurrency 2, queue depth 2; two pg_sleep({P19_HOLD_S}) "
          f"holders, then 4 Q6s at once: 2 queued then ran exact on K1 "
          f"(scan_agg launches {k1}, one each), 2 shed with 53000 in "
          f"{max(ms for st, _r, ms in results if st != 'ok'):.3f} ms; "
          f"pg_stat_wlm admitted/queued/shed/timed_out {got} equal to the "
          f"threads'; queue wait {view[4] - st0['queue_wait_ms']:.3f} ms in "
          f"all, queued Q6s end to end {waits[0]:.3f} / {waits[1]:.3f} ms "
          f"[{card}]", flush=True)
    out["queue"] = {"states": states, "k1": k1, "view": got,
                    "queue_wait_ms": view[4] - st0["queue_wait_ms"],
                    "queued_e2e_ms": waits}

    # 2. a memory budget between Q6's and Q3's estimates
    work_mem = admin.gucs["work_mem"]
    est = {n: estimate_statement_memory(parse(sql)[0], cluster.catalog,
                                        work_mem=work_mem)
           for n, sql in (("Q6", Q6), ("Q3 (spec)", Q3_SPEC))}
    if not est["Q6"] < est["Q3 (spec)"]:
        raise AssertionError(f"phase 19 (a): estimates {est} leave no "
                             "budget between Q6 and Q3")
    limit = (est["Q6"] + est["Q3 (spec)"]) // 2
    admin.execute(f"alter resource group p19 with (memory_limit = {limit})")
    u = user()
    st, msg, ms = _attempt(lambda: u.query(Q3_SPEC))
    if st != "53200":
        raise AssertionError(f"phase 19 (a): Q3 under the budget: {st} "
                             f"{msg}")
    out["reads"]["Q6 under the memory budget"] = p17_query(
        "TPC-H Q6 admitted under a memory_limit between Q6's and Q3's "
        "estimates", u, Q6, want_q6, card, scan_agg=1)
    print(f"wlm: estimates Q6 {est['Q6']} bytes, Q3 (spec) "
          f"{est['Q3 (spec)']} bytes (work_mem {work_mem}); memory_limit "
          f"{limit}: Q3 shed with 53200 in {ms:.3f} ms, Q6 admitted and "
          f"exact on K1 [{card}]", flush=True)
    out["estimates"] = est

    # 3. a queued Q6 under statement_timeout = 500
    admin.execute("alter resource group p19 with (memory_limit = 0)")
    holders = hold(2)
    u = user()
    u.execute("set statement_timeout = 500")
    st, msg, ms = _attempt(lambda: u.query(Q6))
    for th in holders:
        th.join(timeout=600)
    if st != "57014":
        raise AssertionError(f"phase 19 (a): queued Q6 under "
                             f"statement_timeout 500: {st} {msg}")
    print(f"wlm: a queued Q6 under statement_timeout = 500 failed with "
          f"57014 after {ms:.3f} ms in the queue ({msg}) [{card}]",
          flush=True)
    out["timeout_ms"] = ms
    admin.execute("alter role p19 no resource group")
    admin.execute("drop resource group p19")
    return out


def run_clickbench_full(args, device, card: str) -> dict:
    """Phase 10 (a): ClickBench's top-10 UserIDs over its published
    99 997 497 rows and 17 630 976 distinct UserIDs (make_hits' draws,
    the UserID column alone), round robin over 2 datanodes in a cluster
    of its own. The fused DAG and the fragment program decline it, as
    the reference's do, and the host executor answers."""
    from opentenbase_tpu_torch import Cluster

    t0 = time.perf_counter()
    userid, want = make_hits_userids(HITS_FULL_ROWS, HITS_FULL_USERS,
                                     args.seed)
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    s.execute(HITS_USERS_DDL)
    bulk_append(cluster, "hits", {"userid": userid})
    del userid
    print(f"load: hits {HITS_FULL_ROWS} rows, {HITS_FULL_USERS} distinct "
          f"UserIDs (reduced: the UserID column alone), round robin in 2 "
          f"datanodes, numpy top 10 {[c for _u, c in want]}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    name = "ClickBench top-10 UserID (99 997 497 rows)"
    out = {name: host_query(name, cluster, CLICKBENCH_Q,
                            equal_to(name, want), 2, card, fresh_dag=True)}
    out[name]["steady"] = clickbench_same_runner(name, cluster, s, want,
                                                 card)
    return out


def clickbench_same_runner(name: str, cluster, s, want, card: str) -> dict:
    """The top 10 repeated on one DAG runner, as a user's repeated query
    runs: the runner's retry state remembers the ranking overflow, so
    the repeats take the DAG's grouped mode (the reference's route on a
    reused runner) and merge its partial groups. The warm median of 2
    is the query's steady-state end to end; the layers show where it
    goes. K1 and K2 launch 0 times here too."""
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    ts, routes = [], []
    for _ in range(3):
        t1 = time.perf_counter()
        got = s.query(CLICKBENCH_Q)
        ts.append((time.perf_counter() - t1) * 1000)
        equal_to(name, want)(got)
        routes.append(s.last_route)
    if sa.scan_agg.launches or rp.radix_probe.launches:
        raise AssertionError(f"{name}: kernel launches on the same runner")
    runner = cluster.fused_executor()._dag
    mode = runner.last_mode if runner is not None else None
    e2e = statistics.median(ts[1:])
    print(f"main path: {name} again on the same DAG runner: routes "
          f"{routes} (mode {mode}; declined: "
          f"{'; '.join(s.last_declines) or 'none'}), first {ts[0]:.3f} ms, "
          f"exact; scan_agg launches 0, radix_probe launches 0 [{card}]",
          flush=True)
    print(f"end to end: {name} steady state (same runner) median {e2e:.3f} "
          f"ms over 2 runs (route {routes[-1]}, mode {mode}) [{card}]",
          flush=True)
    layers = layer_breakdown(cluster, CLICKBENCH_Q, 2, dag=True)
    print(f"layers: {name} steady state median ms " + ", ".join(
        f"{k} {v:.3f}" for k, v in layers.items()) + f" [{card}]", flush=True)
    return {"routes": routes, "mode": mode, "first_ms": ts[0], "e2e": e2e,
            "layers": layers}


def run_txn_reads(session, state: dict, args, card: str) -> dict:
    """Phase 10 (c), inside RF1's transaction after its INSERTs: Q6 as
    the spec writes it and a count of orders, on the host route (the
    transaction's own rows laid over the scans), exact against numpy
    over the base rows and RF1's."""
    out = {}
    for name, sql, want in (
            ("TPC-H Q6 (spec, inside RF1)", Q6,
             expected_q6(state["lineitem"])),
            ("count(orders) (inside RF1)", ORDERS_COUNT,
             [(len(state["orders"]["o_orderkey"]),)])):
        out[name] = host_query(name, None, sql, equal_to(name, want),
                               args.repeats, card, session=session)
    return out


# ---------------------------------------------------------------------------
# phase 11: the durable server (WAL, checkpoints, crash recovery, the JSON
# and PostgreSQL wire servers, otb_server / otb_bench)
# ---------------------------------------------------------------------------

DURABLE_INSERT_ROWS = 60_000  # TPC-H RF1's lineitem rows at SF10
DURABLE_INSERT_STMTS = 16
DURABLE_DELETE_KEYS = 1_000
DURABLE_TAIL_ROWS = 500  # the transaction after the checkpoint
TPCB_SCALE = 100  # otb_bench accounts: 1 000 a scale unit (pgbench's 1)
TPCB_CLIENTS = 8
TPCB_TXNS = 25  # a client, first run
TPCB_KILL_S = 2.0


def fs_type(path: str) -> str:
    """The filesystem type under ``path`` (the longest mount point that
    holds it, from /proc/mounts): fsync costs nothing on tmpfs."""
    real = os.path.realpath(path)
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                mnt = parts[1].replace("\\040", " ")
                if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) >= len(best):
                    best, kind = mnt, parts[2]
    except OSError:
        pass
    return f"{kind} at {best or '?'}"


def lineitem_values(a: dict, lo: int, hi: int) -> str:
    """Rows [lo, hi) of make_lineitem's arrays as INSERT VALUES tuples,
    in LINEITEM_DDL's column order (scaled integers as decimals)."""
    return ",".join(
        f"({k}, {_cents(q)}, {_cents(p)}, {_cents(d)}, '{_date(sd)}', "
        f"{rf}, {ls})"
        for k, q, p, d, sd, rf, ls in zip(
            a["l_orderkey"][lo:hi].tolist(), a["l_quantity"][lo:hi].tolist(),
            a["l_extendedprice"][lo:hi].tolist(),
            a["l_discount"][lo:hi].tolist(), a["l_shipdate"][lo:hi].tolist(),
            a["l_returnflag"][lo:hi].tolist(),
            a["l_linestatus"][lo:hi].tolist()))


def wire_query(name: str, conn, sql: str, want: list, card: str,
               launches_want: int = 1) -> dict:
    """One query over a wire connection: exact against ``want``, K1
    launched ``launches_want`` times (count set to 0 just before and
    read just after), timed on the host's clock."""
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    sa.scan_agg.launches = 0
    rp.radix_probe.launches = 0
    t0 = time.perf_counter()
    got = conn.query(sql)
    ms = (time.perf_counter() - t0) * 1000
    k1, k2 = sa.scan_agg.launches, rp.radix_probe.launches
    if got != want:
        raise AssertionError(f"{name}: port {got} != numpy {want}")
    if k1 != launches_want:
        raise AssertionError(f"{name}: scan_agg launched {k1} times, "
                             f"want {launches_want}")
    return {"ms": ms, "launches": {"scan_agg": k1, "radix_probe": k2}}


def run_durable(args, device, card: str) -> dict:
    """Phase 11 (a): TPC-H SF10's lineitem in a durable cluster, written,
    read and checkpointed over the JSON wire, then recovered."""
    import shutil

    import torch

    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.net.client import connect_tcp
    from opentenbase_tpu_torch.net.server import ClusterServer

    d = os.path.join(args.data_dir, "durable")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    fs = fs_type(d)
    out = {"fs": fs, "queries": {}}
    try:
        t0 = time.perf_counter()
        arrays = make_lineitem(args.rows, args.seed)
        cluster = Cluster(num_datanodes=2, data_dir=d, device=device)
        s = cluster.session()
        s.execute(LINEITEM_DDL)
        cts = bulk_append(cluster, "lineitem", arrays)
        t1 = time.perf_counter()
        # the bulk loader bypasses the commit path: log the load as ONE
        # commit frame (bench.py's DN-process leg does the same)
        meta = cluster.catalog.get("lineitem")
        cluster.persistence.log_commit_group(
            [(node, "lineitem", [(0, cluster.stores[node]["lineitem"].nrows)],
              []) for node in meta.node_indices],
            cluster.stores, cts)
        load_frame_s = time.perf_counter() - t1
        wal_load = cluster.persistence.wal.position
        print(f"durable: load {args.rows} rows in 2 datanodes "
              f"{t1 - t0:.3f} s; its one G frame {wal_load} bytes, written "
              f"and fsynced in {load_frame_s:.3f} s; data dir {d} ({fs}) "
              f"[{card}]", flush=True)

        # RF1's lineitem shape: new order keys above the loaded ones
        rng = np.random.default_rng(args.seed + 1101)
        ins = make_lineitem(DURABLE_INSERT_ROWS, args.seed + 1100)
        ins["l_orderkey"] = ins["l_orderkey"] + int(
            arrays["l_orderkey"].max())
        per = -(-DURABLE_INSERT_ROWS // DURABLE_INSERT_STMTS)
        inserts = [
            "insert into lineitem values "
            + lineitem_values(ins, i, min(i + per, DURABLE_INSERT_ROWS))
            for i in range(0, DURABLE_INSERT_ROWS, per)]
        keys = rng.choice(int(arrays["l_orderkey"].max()),
                          DURABLE_DELETE_KEYS, replace=False) + 1
        delete = ("delete from lineitem where l_orderkey in ("
                  + ",".join(str(k) for k in sorted(keys.tolist())) + ")")
        srv = ClusterServer(cluster).start()
        try:
            with connect_tcp(srv.host, srv.port, timeout=3600) as c:
                t2 = time.perf_counter()
                c.execute("begin")
                n_ins = sum(c.execute(q).rowcount for q in inserts)
                c.execute("commit")
                ins_ms = (time.perf_counter() - t2) * 1000
                t2 = time.perf_counter()
                c.execute("begin")
                n_del = c.execute(delete).rowcount
                c.execute("commit")
                del_ms = (time.perf_counter() - t2) * 1000
                both = _concat(arrays, ins)
                live = ~np.isin(both["l_orderkey"], keys)
                if n_ins != DURABLE_INSERT_ROWS or n_del != int(
                        (~live).sum()):
                    raise AssertionError(f"durable writes: {n_ins} inserted, "
                                         f"{n_del} deleted")
                state = _select(both, live)
                print(f"write: durable RF1-shape transaction {n_ins} rows in "
                      f"{len(inserts)} INSERTs over the JSON wire "
                      f"{ins_ms:.3f} ms; a DELETE of {DURABLE_DELETE_KEYS} "
                      f"order keys ({n_del} rows) {del_ms:.3f} ms; "
                      f"synchronous_commit local, {fs} [{card}]", flush=True)
                want = {"Q6": expected_q6(state), "Q1": expected_q1(state)}
                for q, sql in (("Q6", Q6), ("Q1", Q1)):
                    r = wire_query(f"durable {q}", c, sql, want[q], card)
                    out["queries"][f"durable {q}"] = r
                    print(f"main path: durable {q} over the JSON wire exact "
                          f"through the kernel (scan_agg launches "
                          f"{r['launches']['scan_agg']}; {r['ms']:.3f} ms) "
                          f"[{card}]", flush=True)
                t2 = time.perf_counter()
                vac = c.execute("vacuum lineitem").rowcount
                vac_s = time.perf_counter() - t2
                ckpt_bytes = cluster.persistence.checkpoint_bytes()
                tail = make_lineitem(DURABLE_TAIL_ROWS, args.seed + 1102)
                tail["l_orderkey"] = tail["l_orderkey"] + int(
                    ins["l_orderkey"].max())
                c.execute("begin")
                c.execute("insert into lineitem values "
                          + lineitem_values(tail, 0, DURABLE_TAIL_ROWS))
                c.execute("commit")
                state = _concat(state, tail)
                print(f"durable: VACUUM removed {vac} rows and took the "
                      f"checkpoint ({ckpt_bytes} bytes) in {vac_s:.3f} s; "
                      f"then a {DURABLE_TAIL_ROWS}-row transaction in the "
                      f"WAL tail [{card}]", flush=True)
                # phase 17 (e): pg_stat_wal over the wire against the WAL
                view = dict(c.query("select stat, value from pg_stat_wal"))
                w = cluster.persistence.wal.stat_snapshot()
                want = {"wal_position": w["position"], "fsyncs": w["fsyncs"],
                        "group_fsyncs": w["group_fsyncs"],
                        "commit_flushes": w["commit_flushes"]}
                if {k: view[k] for k in want} != want:
                    raise AssertionError(f"pg_stat_wal {view} != {w}")
                print("views: pg_stat_wal over the JSON wire equals the "
                      "WAL's counters: " + ", ".join(
                          f"{k} {view[k]}" for k in sorted(view))
                      + f" [{card}]", flush=True)
        finally:
            srv.stop()
        wal = cluster.persistence.wal.stat_snapshot()
        cluster.close()
        del cluster, s, srv
        gc.collect()
        torch.cuda.empty_cache()

        t3 = time.perf_counter()
        rec = Cluster.recover(d, 2, device=device)
        rec_s = time.perf_counter() - t3
        lr = rec.persistence.last_recovery
        out["recovery"] = {"seconds": rec_s, **lr, "wal": wal, "fs": fs}
        print(f"durable: Cluster.recover {rec_s:.3f} s, {lr['records']} WAL "
              f"records replayed ({lr['wal_bytes_replayed']} of "
              f"{lr['wal_bytes']} WAL bytes), checkpoint "
              f"{lr['checkpoint_bytes']} bytes; before the crash WAL "
              f"fsyncs {wal['fsyncs']} for {wal['commit_flushes']} durable "
              f"commits (group fsyncs {wal['group_fsyncs']}); {fs} "
              f"[{card}]", flush=True)
        want = {"Q6": expected_q6(state), "Q1": expected_q1(state)}
        srv = ClusterServer(rec).start()
        try:
            with connect_tcp(srv.host, srv.port, timeout=3600) as c:
                for q, sql in (("Q6", Q6), ("Q1", Q1)):
                    name = f"durable {q} recovered"
                    r = wire_query(name, c, sql, want[q], card)
                    ts = []
                    for _ in range(args.repeats):
                        t4 = time.perf_counter()
                        if c.query(sql) != want[q]:
                            raise AssertionError(f"{name}: answer changed")
                        ts.append((time.perf_counter() - t4) * 1000)
                    r["e2e"] = statistics.median(ts)
                    out["queries"][name] = r
                    print(f"main path: {name} over the JSON wire exact "
                          f"through the kernel (scan_agg launches "
                          f"{r['launches']['scan_agg']}); first run incl. "
                          f"upload {r['ms']:.3f} ms, warm median "
                          f"{r['e2e']:.3f} ms over {args.repeats} [{card}]",
                          flush=True)
                # phase 19 (c, d): matviews and a subscriber, recovered
                t_p19 = time.perf_counter()
                out["phase19"] = run_phase19_durable(
                    rec, srv, c, state, args, device, card)
                print(f"time: phase 19 (c, d) "
                      f"{time.perf_counter() - t_p19:.1f} s [{card}]",
                      flush=True)
        finally:
            srv.stop()
        rec.close()
        del rec, srv
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 4's Q1 with its aggregates named and without its ORDER BY (a
# scan of a matview cannot keep an order): the matview's definition
Q1_MV = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice) as sum_price, "
    "sum(l_extendedprice * l_discount) as sum_disc, "
    "count(*) as count_order from lineitem "
    "where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus"
)
P19_DELETE_KEYS = 100  # order keys of (c)'s batch whose lines go


def run_phase19_durable(cluster, srv, c, state: dict, args, device,
                        card: str) -> dict:
    """Phase 19 (c, d) in phase 11 (a)'s recovered durable cluster,
    through its JSON server ``srv`` (connection ``c``): a publication of
    lineitem and a second durable cluster on the card subscribed to it
    without the initial copy; Q1 as a matview (populated on K1, K1 held
    against its plain version there), answered through the rewrite
    without K1 and with it off through K1; RF1's lineitem shape written
    with another seed and the lines of 100 of its order keys deleted
    (the rewrite skipped: stale); REFRESH incremental beside a full one,
    each exact; the subscriber's count(*) and Q6 on K1 exact over the
    batch less its deleted lines, with the apply lag."""
    import shutil

    import torch

    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.ops import scan_agg as sa

    out: dict = {"k1_rows": [], "reads": {}}
    sub_dir = os.path.join(args.data_dir, "p19_sub")
    shutil.rmtree(sub_dir, ignore_errors=True)
    os.makedirs(sub_dir)
    sub = None
    try:
        # (d) 1: the publication, and the subscriber before (c)'s writes
        c.execute("create publication p19 for table lineitem")
        sub = Cluster(num_datanodes=2, data_dir=sub_dir, device=device)
        ss = sub.session()
        ss.execute(LINEITEM_DDL)
        t0 = time.perf_counter()
        ss.execute(f"create subscription p19s connection 'host={srv.host} "
                   f"port={srv.port}' publication p19 "
                   "with (copy_data = false)")
        print(f"logical: publication p19 for lineitem; a durable "
              f"Cluster(num_datanodes=2) on {device} subscribed without "
              f"the initial copy in {(time.perf_counter() - t0) * 1000:.3f} "
              f"ms (slot at WAL offset {sub.subscriptions['p19s'].lsn}) "
              f"[{card}]", flush=True)

        # (c) 1: the matview of Q1, populated on K1
        n0 = sa.scan_agg.launches
        with k1_recorder() as calls:
            t0 = time.perf_counter()
            c.execute(f"create materialized view p19_q1 as {Q1_MV}")
            ms = (time.perf_counter() - t0) * 1000
        if not calls:
            raise AssertionError("the matview's populate launched no K1")
        out["k1_rows"] += k1_check_calls("matview populate (Q1)", calls,
                                         card)
        sa.scan_agg.launches = n0
        out["populate"] = {"ms": ms, "launches": len(calls)}
        sa.scan_agg.launches = 0
        c.execute("create materialized view p19_q1_full with "
                  f"(incremental = off) as {Q1_MV}")
        full_launches = sa.scan_agg.launches
        want = sorted(expected_q1(state))
        for mv in ("p19_q1", "p19_q1_full"):
            if sorted(c.query(f"select * from {mv}")) != want:
                raise AssertionError(f"{mv}: rows != numpy's Q1")
        print(f"matview: p19_q1 = Q1 (phase 4's, aggregates named, no "
              f"ORDER BY) populated exact in {ms:.3f} ms, K1 launched "
              f"{len(calls)} times (its rows and its aux partial state), "
              f"each equal to the plain version; p19_q1_full (incremental "
              f"= off) {full_launches} launch [{card}]", flush=True)

        # (c) 2: Q1 through the rewrite (no K1), and with it off (K1)
        def q1_read(what: str, launches: int, rewrite: bool) -> dict:
            lines = [r[0] for r in c.query(f"explain {Q1_MV}")]
            if any("Matview rewrite" in ln for ln in lines) != rewrite:
                raise AssertionError(f"{what}: EXPLAIN {lines[:2]}")
            sa.scan_agg.launches = 0
            t1 = time.perf_counter()
            got = c.query(Q1_MV)
            ms1 = (time.perf_counter() - t1) * 1000
            if sorted(got) != want or sa.scan_agg.launches != launches:
                raise AssertionError(
                    f"{what}: {sorted(got)[:2]} vs {want[:2]}, "
                    f"{sa.scan_agg.launches} K1 launches")
            print(f"matview: {what}: exact, EXPLAIN "
                  f"{'with' if rewrite else 'without'} the rewrite line, "
                  f"scan_agg launches {launches}; {ms1:.3f} ms [{card}]",
                  flush=True)
            return {"ms": ms1, "launches": {"scan_agg": launches,
                                            "radix_probe": 0}}

        out["reads"]["Q1 through the rewrite"] = q1_read(
            "Q1 answered through the rewrite", 0, True)
        c.execute("set enable_matview_rewrite = off")
        out["reads"]["Q1 rewrite off"] = q1_read(
            "Q1 with enable_matview_rewrite = off", 1, False)
        c.execute("set enable_matview_rewrite = on")

        # (c) 3: RF1's lineitem shape with another seed, and 100 of its
        # order keys' lines deleted
        ins = make_lineitem(DURABLE_INSERT_ROWS, args.seed + 1900)
        ins["l_orderkey"] = ins["l_orderkey"] + int(
            state["l_orderkey"].max())
        rng = np.random.default_rng(args.seed + 1901)
        keys = np.sort(rng.choice(np.unique(ins["l_orderkey"]),
                                  P19_DELETE_KEYS, replace=False))
        # written as dbgen writes a refresh: a .tbl file COPYed in (phase
        # 11 (a) times the INSERT form of the same shape)
        tbl = os.path.join(args.data_dir, "p19_lineitem.tbl")
        write_tbl(tbl, [
            list(map(str, ins["l_orderkey"].tolist())),
            list(map(_cents, ins["l_quantity"].tolist())),
            list(map(_cents, ins["l_extendedprice"].tolist())),
            list(map(_cents, ins["l_discount"].tolist())),
            list(map(_date, ins["l_shipdate"].tolist())),
            list(map(str, ins["l_returnflag"].tolist())),
            list(map(str, ins["l_linestatus"].tolist()))])
        t0 = time.perf_counter()
        n_ins = c.execute(f"copy lineitem from '{tbl}' delimiter '|'"
                          ).rowcount
        os.remove(tbl)
        if n_ins != DURABLE_INSERT_ROWS:
            raise AssertionError(f"phase 19 (c): COPY wrote {n_ins} rows")
        n_del = c.execute("delete from lineitem where l_orderkey in ("
                          + ",".join(map(str, keys.tolist())) + ")").rowcount
        t_written = time.perf_counter()
        batch = _select(ins, ~np.isin(ins["l_orderkey"], keys))
        if n_del != DURABLE_INSERT_ROWS - len(batch["l_orderkey"]):
            raise AssertionError(f"phase 19 (c): deleted {n_del} lines")
        after = _concat(state, batch)
        want = sorted(expected_q1(after))
        print(f"write: RF1-shaped batch of {DURABLE_INSERT_ROWS} rows "
              f"(seed {args.seed + 1900}) by COPY FROM a .tbl file "
              f"and a DELETE of {P19_DELETE_KEYS} of its order keys "
              f"({n_del} lines) over the JSON wire in "
              f"{(t_written - t0) * 1000:.3f} ms [{card}]", flush=True)
        lines = [r[0] for r in c.query(f"explain {Q1_MV}")]
        if any("Matview rewrite" in ln for ln in lines) or c.query(
                "select is_fresh from pg_matviews where matviewname = "
                "'p19_q1'") != [(False,)]:
            raise AssertionError("phase 19 (c): a stale matview served")

        # (d) 2: the subscriber applies the batch's frames
        pub_end = cluster.persistence.wal.position
        worker = sub.subscriptions["p19s"]
        _wait_for(lambda: worker.lsn >= pub_end, 600,
                  f"the subscriber to apply WAL offset {pub_end} "
                  f"(last error {worker.last_error!r})")
        lag_ms = (time.perf_counter() - t_written) * 1000

        # (c) 4: REFRESH, incremental and full
        refresh = {}
        for mv, mode in (("p19_q1", "incremental"), ("p19_q1_full", "full")):
            sa.scan_agg.launches = 0
            t0 = time.perf_counter()
            n_deltas = c.execute(f"refresh materialized view {mv}").rowcount
            ms = (time.perf_counter() - t0) * 1000
            got_mode = c.query("select last_mode from pg_stat_matview "
                               f"where matviewname = '{mv}'")
            if got_mode != [(mode,)]:
                raise AssertionError(f"REFRESH {mv}: mode {got_mode}")
            if sorted(c.query(f"select * from {mv}")) != want:
                raise AssertionError(f"REFRESH {mv}: rows != numpy's Q1")
            refresh[mode] = {"ms": ms, "deltas": n_deltas,
                             "launches": sa.scan_agg.launches}
        print(f"matview: REFRESH p19_q1 {refresh['incremental']['ms']:.3f} "
              f"ms incremental ({refresh['incremental']['deltas']} delta "
              f"rows from the WAL, scan_agg launches "
              f"{refresh['incremental']['launches']}) beside p19_q1_full "
              f"{refresh['full']['ms']:.3f} ms full (scan_agg launches "
              f"{refresh['full']['launches']}); both exact against numpy's "
              f"Q1 over the new arrays [{card}]", flush=True)
        out["refresh"] = refresh
        out["reads"]["Q1 through the rewrite after REFRESH"] = q1_read(
            "Q1 through the rewrite after REFRESH", 0, True)

        # (d) 2: the subscriber's rows
        n_rows = DURABLE_INSERT_ROWS + n_del
        n_live = len(batch["l_orderkey"])
        if ss.query("select count(*) from lineitem") != [(n_live,)]:
            raise AssertionError("phase 19 (d): the subscriber's count")
        out["reads"]["subscriber Q6"] = p17_query(
            "TPC-H Q6 on the subscriber (the batch less its deleted lines)",
            ss, Q6, expected_q6(batch), card, scan_agg=1)
        print(f"logical: the subscriber applied (c)'s frames (WAL offset "
              f"{pub_end}) {lag_ms:.3f} ms after they committed: "
              f"{n_rows} row changes ({n_rows / lag_ms * 1000:.1f} rows/s); "
              f"count(*) {n_live} and Q6 on K1 exact [{card}]", flush=True)
        out["apply"] = {"lag_ms": lag_ms, "rows": n_rows}
        ss.execute("drop subscription p19s")
    finally:
        if sub is not None:
            w = sub.subscriptions.get("p19s")
            if w is not None:
                w.stop()
            sub.close()
        shutil.rmtree(sub_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def pg_text(v) -> str | None:
    """A value as PostgreSQL's text format writes it (DataRow)."""
    if v is None:
        return None
    if isinstance(v, bool):
        return "t" if v else "f"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def pg_simple_query(host: str, port: int, sql: str, user: str = "otb"):
    """A minimal PostgreSQL v3 client: StartupMessage, one simple Query,
    then RowDescription / DataRow / CommandComplete up to ReadyForQuery.
    Returns (column names, text rows, command tag)."""
    import socket
    import struct

    sock = socket.create_connection((host, port), timeout=600)

    def read(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
        return buf

    def message():
        tag = read(1)
        (ln,) = struct.unpack("!I", read(4))
        return tag, read(ln - 4)

    try:
        body = (struct.pack("!I", 196608) + b"user\0" + user.encode()
                + b"\0database\0otb\0\0")
        sock.sendall(struct.pack("!I", len(body) + 4) + body)
        while True:
            tag, payload = message()
            if tag == b"E":
                raise RuntimeError(payload.decode(errors="replace"))
            if tag == b"R" and struct.unpack("!I", payload[:4])[0] != 0:
                raise RuntimeError("authentication requested")
            if tag == b"Z":
                break
        q = sql.encode() + b"\0"
        sock.sendall(b"Q" + struct.pack("!I", len(q) + 4) + q)
        cols, rows, done, err = [], [], None, None
        while True:
            tag, payload = message()
            if tag == b"T":
                (n,) = struct.unpack("!H", payload[:2])
                off = 2
                for _ in range(n):
                    end = payload.index(b"\0", off)
                    cols.append(payload[off:end].decode())
                    off = end + 1 + 18
            elif tag == b"D":
                (n,) = struct.unpack("!H", payload[:2])
                off, row = 2, []
                for _ in range(n):
                    (ln,) = struct.unpack_from("!i", payload, off)
                    off += 4
                    if ln < 0:
                        row.append(None)
                    else:
                        row.append(payload[off:off + ln].decode())
                        off += ln
                rows.append(tuple(row))
            elif tag == b"C":
                done = payload.rstrip(b"\0").decode()
            elif tag == b"E":
                err = payload.decode(errors="replace")
            elif tag == b"Z":
                if err is not None:
                    raise RuntimeError(err)
                return cols, rows, done
        # unreachable
    finally:
        x = b"X" + struct.pack("!I", 4)
        try:
            sock.sendall(x)
        except OSError:
            pass
        sock.close()


def run_pgwire(ssb: dict, want_rows: list, card: str) -> dict:
    """Phase 11 (b): SSB Q1.1 through a PgWireServer on phase 5's SSB
    cluster (after phase 8c's DELETE), exact as text, K2 launched."""
    import torch

    from opentenbase_tpu_torch.net.pgwire import PgWireServer
    from opentenbase_tpu_torch.ops import radix_probe as rp

    srv = PgWireServer(ssb["cluster"]).start()
    try:
        rp.radix_probe.launches = 0
        t0 = time.perf_counter()
        cols, rows, tag = pg_simple_query(srv.host, srv.port, SSB_Q["Q1.1"])
        ms = (time.perf_counter() - t0) * 1000
        torch.cuda.synchronize()
        k2 = rp.radix_probe.launches
    finally:
        srv.stop()
    want = [tuple(pg_text(v) for v in r) for r in want_rows]
    if rows != want or tag != f"SELECT {len(want)}":
        raise AssertionError(f"pgwire SSB Q1.1: {rows} {tag!r} != {want}")
    if k2 < 1:
        raise AssertionError("pgwire SSB Q1.1: radix_probe never launched")
    print(f"main path: SSB Q1.1 over the PostgreSQL wire (v3 simple query) "
          f"exact as text {rows} {tag!r} (radix_probe launches {k2}; "
          f"{ms:.3f} ms incl. startup) [{card}]", flush=True)
    return {"ms": ms, "launches": {"radix_probe": k2}}


def _spawn_server(data_dir: str, device, extra=(), timeout: float = 600.0):
    """``python -m opentenbase_tpu_torch.cli.otb_server`` on its own
    port (the cluster on the card; on the CPU only for a CPU rehearsal),
    its port read off the banner with a deadline."""
    import queue
    import re
    import threading

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    cmd = [sys.executable, "-m", "opentenbase_tpu_torch.cli.otb_server",
           "--data-dir", data_dir, "--port", "0", *extra]
    if str(device) == "cpu":
        cmd += ["--device", "cpu"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put("")

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + timeout
    seen = []
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
        except queue.Empty:
            break
        if not line:
            break
        seen.append(line.strip())
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
        if m:
            return proc, int(m.group(1)), seen
    proc.kill()
    proc.wait(timeout=60)
    raise RuntimeError(f"otb_server did not start: {seen}")


def _stop(proc, grace_s: float = 60.0) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


def run_crash(args, device, card: str) -> dict:
    """Phase 11 (c): otb_server as its own process on the card, the
    otb_bench TPC-B load at pgbench's scale 1, a second run SIGKILLed,
    then --recover: every acknowledged transaction is there, and the
    books balance."""
    import shutil
    import signal
    import threading

    from opentenbase_tpu_torch.cli import otb_bench
    from opentenbase_tpu_torch.net.client import connect_tcp

    d = os.path.join(args.data_dir, "server")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    fs = fs_type(d)
    proc = None
    try:
        t0 = time.perf_counter()
        proc, port, _ = _spawn_server(d, device)
        start_s = time.perf_counter() - t0

        def connect():
            return connect_tcp("127.0.0.1", port, timeout=600)

        with connect() as s:
            t1 = time.perf_counter()
            otb_bench.initialize(s, scale=TPCB_SCALE)
            init_s = time.perf_counter() - t1
        first = otb_bench.bench(connect, TPCB_CLIENTS, TPCB_TXNS, TPCB_SCALE)
        print(f"durable: otb_server process up in {start_s:.3f} s; "
              f"otb_bench -i -s {TPCB_SCALE} "
              f"({otb_bench.NACCOUNTS * TPCB_SCALE} accounts) {init_s:.3f} "
              f"s; first run {first['transactions']} transactions by "
              f"{TPCB_CLIENTS} clients, {first['retries']} retries, "
              f"{first['elapsed_s']} s, TPS {first['tps']} "
              f"(synchronous_commit local, {fs}) [{card}]", flush=True)
        box: dict = {}
        lost = []  # the clients' connection errors after the kill
        hook = threading.excepthook
        threading.excepthook = lambda a: lost.append(a.exc_value)
        try:
            runner = threading.Thread(target=lambda: box.update(
                otb_bench.bench(connect, TPCB_CLIENTS, 10**6, TPCB_SCALE)))
            runner.start()
            time.sleep(TPCB_KILL_S)
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
            runner.join(timeout=300)
        finally:
            threading.excepthook = hook
        if runner.is_alive() or "transactions" not in box:
            raise RuntimeError("otb_bench clients did not end after the kill")
        acked = first["transactions"] + box["transactions"]
        t2 = time.perf_counter()
        proc, port, lines = _spawn_server(d, device, ["--recover"])
        restart_s = time.perf_counter() - t2
        with connect() as s:
            n_hist, sum_delta = s.query(
                "select count(*), sum(delta) from history")[0]
            (sum_bal,), = s.query("select sum(abalance) from accounts")
            (n_acc,), = s.query("select count(*) from accounts")
        if sum_bal != sum_delta:
            raise AssertionError(f"TPC-B books: sum(abalance) {sum_bal} != "
                                 f"sum(delta) {sum_delta}")
        if not acked <= n_hist <= acked + TPCB_CLIENTS:
            raise AssertionError(f"history {n_hist} rows for {acked} "
                                 f"acknowledged transactions")
        if n_acc != otb_bench.NACCOUNTS * TPCB_SCALE:
            raise AssertionError(f"{n_acc} accounts after recovery")
        print(f"durable: SIGKILL {TPCB_KILL_S} s into the second run "
              f"({box['transactions']} transactions acknowledged, "
              f"{len(lost)} clients cut off), "
              f"--recover in {restart_s:.3f} s ({'; '.join(lines[:-1])}): "
              f"history {n_hist} rows for {acked} acknowledged (at most "
              f"{TPCB_CLIENTS} more in flight), sum(abalance) = sum(delta) "
              f"= {sum_bal} [{card}]", flush=True)
        return {"tps": first["tps"], "first": first, "acked": acked,
                "history": n_hist, "restart_s": restart_s, "fs": fs}
    finally:
        if proc is not None:
            _stop(proc)
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 12: the process topology (a walsender, datanode processes, a hot
# standby, 2PC-shipped writes)
# ---------------------------------------------------------------------------

# phase 5c's tables distributed as the reference's tests and README
# distribute them: lineitem and orders by the order key, customer by its
TOPOLOGY_DDL = tuple(
    ddl.replace("distribute by roundrobin", f"distribute by shard({key})")
    for ddl, key in zip(Q3_SPEC_DDL,
                        ("c_custkey", "o_orderkey", "l_orderkey")))
# rows a load commit frame carries (lineitem: about 240 MB, far below
# the frame's u32 length)
TOPOLOGY_FRAME_ROWS = 4_000_000
TOPOLOGY_START_S = 600.0  # a datanode process's READY
TOPOLOGY_CATCHUP_S = 600.0  # a replica's replay of the whole load
SYNC_PROBE_DDL = ("create table sync_probe (k bigint, v bigint) "
                  "distribute by shard(k)")


def q1_text_sums(li) -> dict:
    """Q1's (phase 4's form: no averages) exact sums over make_q3_spec's
    lineitem, whose flags are TEXT: {(flag, status): [sum l_quantity,
    sum l_extendedprice, sum l_extendedprice * l_discount, count]} in
    the columns' integer units, for each group that has rows."""
    m = li["l_shipdate"] <= _day("1998-09-02")
    rf, ls = li["l_returnflag"].idx, li["l_linestatus"].idx
    out = {}
    for fi, flag in enumerate(RF_VOCAB):
        for si, status in enumerate(LS_VOCAB):
            g = m & (rf == fi) & (ls == si)
            if g.any():
                price = li["l_extendedprice"][g]
                out[(flag, status)] = [
                    int(li["l_quantity"][g].sum()), int(price.sum()),
                    int((price * li["l_discount"][g]).sum()), int(g.sum())]
    return out


def expected_q1_text(*sums) -> list:
    """Q1's rows (groups in string order) over the union of disjoint row
    sets, each given by its ``q1_text_sums``."""
    tot: dict = {}
    for part in sums:
        for key, v in part.items():
            tot[key] = [a + b for a, b in zip(tot.get(key, (0,) * 4), v)]
    return [(flag, status, q / 100, price / 100, disc / 10**4, n)
            for (flag, status), (q, price, disc, n) in sorted(tot.items())]


def durable_load(cluster, table: str, arrays, frame_rows: int) -> dict:
    """``arrays`` into ``table`` at one commit timestamp, each row on the
    node its locator names (bench.py's bulk load, routed), then logged as
    commit frames of at most ``frame_rows`` rows, made durable by one
    fsync after the last: what a standby replays. Returns the frames,
    WAL bytes and seconds."""
    from opentenbase_tpu_torch.storage.column import Column
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    t0 = time.perf_counter()
    meta = cluster.catalog.get(table)
    enc = {name: encode_text(meta, name, arrays[name])
           for name in meta.schema}
    n = len(next(iter(enc.values())))
    routes = meta.locator.route_insert(
        {k: Column(meta.schema[k], enc[k], None, meta.dictionaries.get(k))
         for k in meta.dist.key_columns}, n)
    cts = cluster.gts.get_gts()
    p = cluster.persistence
    pos0, frames = p.wal.position, 0
    for node in meta.node_indices:
        idx = np.nonzero(routes == node)[0]
        store = cluster.stores[node][table]
        start = store.nrows
        store.append_batch(ColumnBatch(
            {name: Column(meta.schema[name], enc[name][idx], None,
                          meta.dictionaries.get(name))
             for name in meta.schema}, len(idx)), cts)
        for lo in range(start, start + len(idx), frame_rows):
            hi = min(lo + frame_rows, start + len(idx))
            p.log_commit_group([(node, table, [(lo, hi)], [])],
                               cluster.stores, cts, sync_mode="off")
            frames += 1
    p.wal.flush_to(p.wal.position)
    return {"rows": n, "frames": frames, "bytes": p.wal.position - pos0,
            "s": time.perf_counter() - t0}


def txn_bulk_insert(session, table: str, arrays) -> int:
    """``arrays`` into ``table`` inside the session's open transaction,
    as INSERT parks its rows (the table's shared lock; each row on the
    node its locator names; delta batches at PENDING_TS until the
    commit stamps them): RF1's rows without parsing 75 000 VALUES
    tuples. Returns the rows appended."""
    from opentenbase_tpu_torch.lmgr import TABLE_SHARED
    from opentenbase_tpu_torch.storage.column import Column
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    c, txn = session.cluster, session.txn
    meta = c.catalog.get(table)
    enc = {name: encode_text(meta, name, arrays[name])
           for name in meta.schema}
    batch = ColumnBatch(
        {name: Column(meta.schema[name], enc[name], None,
                      meta.dictionaries.get(name)) for name in meta.schema},
        len(next(iter(enc.values()))))
    c.locks.acquire(session.session_id, txn.gxid,
                    [(node, table) for node in meta.node_indices],
                    TABLE_SHARED)
    return session._route_and_append(meta, batch, txn)


def _proc_lines(proc):
    """A process's stdout lines, read by one thread ('' at its end)."""
    import queue
    import threading

    q: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            q.put(line)
        q.put("")

    threading.Thread(target=pump, daemon=True).start()
    return q


def start_datanodes(data_dir: str, sender, device, nodes=(0, 1)) -> list:
    """One ``python -m opentenbase_tpu_torch.dn.server`` a node (Popen:
    a fork after CUDA started would break the child), all started at
    once; ``datanode_ports`` reads their READY lines."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    procs = []
    try:
        for node in nodes:
            cmd = [sys.executable, "-m", "opentenbase_tpu_torch.dn.server",
                   "--data-dir", os.path.join(data_dir, f"dn{node}"),
                   "--wal-host", sender.host, "--wal-port", str(sender.port),
                   "--num-datanodes", "2"]
            if str(device) == "cpu":
                cmd += ["--device", "cpu"]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          text=True, env=env, cwd=ROOT))
        return procs
    except BaseException:
        for proc in procs:
            _stop(proc)
        raise


def datanode_ports(procs) -> list:
    """Each datanode's READY port, read with a deadline; a datanode that
    does not start raises (the caller reaps the children)."""
    import queue

    ports = []
    for node, proc in enumerate(procs):
        try:
            line = _proc_lines(proc).get(timeout=TOPOLOGY_START_S)
        except queue.Empty:
            line = ""
        if not line.startswith("READY "):
            raise RuntimeError(f"datanode {node} did not start: {line!r} "
                               f"(exit {proc.poll()})")
        ports.append(int(line.split()[1]))
    return ports


def _rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    return 0.0


def memory_report(label: str, cluster, card: str) -> dict:
    """RSS and device memory of this process (the coordinator and the
    standby) and of each datanode process (its ping), and what
    nvidia-smi says each process holds on the card (contexts
    included)."""
    import torch

    out = {"coordinator+standby": {
        "rss_gb": _rss_gb(),
        "device_peak_gb": torch.cuda.max_memory_allocated() / 1e9
        if torch.cuda.is_available() else None}}
    for n, ch in sorted(cluster.dn_channels.items()):
        pg = ch.rpc({"op": "ping"})
        peak = pg.get("device_peak_bytes")
        out[f"dn{n}"] = {"rss_gb": pg["rss_bytes"] / 1e9,
                         "device_peak_gb": None if peak is None
                         else peak / 1e9}
    smi = "not measured"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ") or "none listed"
    except (OSError, subprocess.TimeoutExpired):
        pass
    print(f"topology: memory {label}: " + "; ".join(
        f"{k} RSS {v['rss_gb']:.3f} GB, device peak (allocator) "
        + ("n/a" if v["device_peak_gb"] is None
           else f"{v['device_peak_gb']:.3f} GB")
        for k, v in out.items()) + f"; nvidia-smi per process: {smi} "
        f"[{card}]", flush=True)
    out["nvidia_smi"] = smi
    return out


def wait_replicas(cluster, standby, card: str, label: str) -> dict:
    """Until each datanode and the standby replayed the coordinator's
    WAL end: the seconds each took from now, its lag bytes when the wait
    began."""
    pos = cluster.persistence.wal.position
    t0 = time.perf_counter()
    lag = {f"dn{n}": pos - ch.rpc({"op": "ping"})["applied"]
           for n, ch in cluster.dn_channels.items()}
    lag["standby"] = pos - standby.applied
    took: dict = {}
    deadline = time.monotonic() + TOPOLOGY_CATCHUP_S
    while len(took) < len(lag):
        if time.monotonic() > deadline:
            raise RuntimeError(f"replicas behind WAL end {pos}: done {took}")
        for n, ch in cluster.dn_channels.items():
            if f"dn{n}" not in took:
                pg = ch.rpc({"op": "ping"})
                if pg.get("stream_error"):
                    raise RuntimeError(f"dn{n}: {pg['stream_error']}")
                if pg["applied"] >= pos:
                    took[f"dn{n}"] = time.perf_counter() - t0
        if "standby" not in took:
            if standby.stream_error:
                raise RuntimeError(f"standby: {standby.stream_error}")
            if standby.applied >= pos:
                took["standby"] = time.perf_counter() - t0
        time.sleep(0.01)
    print(f"topology: catch-up {label} to WAL end {pos}: " + "; ".join(
        f"{k} lag {lag[k]} bytes, caught up in {took[k]:.3f} s"
        for k in lag) + f" [{card}]", flush=True)
    return {"wal_end": pos, "lag_bytes": lag, "s": took}


def run_phase19_parallel(cluster, s, ans: dict, args, card: str) -> dict:
    """Phase 19 (b), in phase 12 after its (a): Q6 and Q1 as the spec
    writes it through the datanode processes with dn_parallel_workers
    at its default 4 and at 1, each exact; each datanode's
    parallel_fragments rises by one a fragment a run at 4 and not at
    1. First and warm ms of each, then every process's memory."""
    def counts() -> list:
        return [ch.rpc({"op": "ping"})["dml_stats"].get(
            "parallel_fragments", 0)
            for _n, ch in sorted(cluster.dn_channels.items())]

    out: dict = {"queries": {}, "memory": {}}
    t0 = time.perf_counter()
    for k in (4, 1):
        s.execute(f"set dn_parallel_workers = {k}")
        for name, sql in (("Q6", Q6), ("Q1 (spec)", Q1_SPEC)):
            n0 = counts()
            r = dn_query(f"TPC-H {name} through the datanodes, "
                         f"dn_parallel_workers {k}", s, sql,
                         equal_to(name, ans[name]), args, card)
            runs = 1 + r["repeats"]
            rose = [b - a for a, b in zip(n0, counts())]
            if rose != [runs if k > 1 else 0] * len(rose):
                raise AssertionError(
                    f"{name} at {k} workers: parallel_fragments rose "
                    f"{rose} over {runs} runs")
            r["parallel_fragments"] = rose
            out["queries"][f"topology {name} ({k} workers)"] = r
            print(f"parallel: TPC-H {name}, dn_parallel_workers {k}: "
                  f"first {r['first_ms']:.3f} ms, warm {r['e2e']:.3f} ms; "
                  f"parallel_fragments rose {rose} over {runs} runs "
                  f"[{card}]", flush=True)
        out["memory"][k] = memory_report(
            f"after phase 19 (b) at {k} workers", cluster, card)
    s.execute("reset dn_parallel_workers")
    print(f"time: phase 19 (b) {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return out


def dn_query(name: str, s, sql: str, check, args, card: str) -> dict:
    """One query on the host route with every fragment in the datanode
    processes: exact (``check``), K1 and K2 launched 0 times here; its
    first run, the warm median (the runs ``warm_repeats`` allows, a
    cut that keeps the whole script inside its time
    limit), each fragment's datanode ms, rows and wire bytes, the
    motions (peer: datanode to datanode)."""
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    def run():
        got = s.query(sql)
        ex = s.last_executor
        if s.last_route != "host" or not ex.instrumentation or not all(
                i.get("remote") for i in ex.instrumentation):
            raise AssertionError(f"{name}: route {s.last_route}, "
                                 f"fragments {ex and ex.instrumentation}")
        check(got)
        return got

    sa.scan_agg.launches = rp.radix_probe.launches = 0
    t0 = time.perf_counter()
    got = run()
    first = (time.perf_counter() - t0) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    if any(launches.values()):
        raise AssertionError(f"{name}: a kernel launched in the "
                             f"coordinator on the datanode route: {launches}")
    repeats = warm_repeats(first, args.repeats)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        ts.append((time.perf_counter() - t0) * 1000)
    ex = s.last_executor
    frags = [{"fragment": i["fragment"], "node": i["node"],
              "rows": i["rows"], "ms": i["ms"], "dn_ms": i["dn_ms"],
              "wire_bytes": i["wire_bytes"]} for i in ex.instrumentation]
    motions = {str(k): m for k, m in ex.motion_stats.items()}
    peer = any(m.get("peer") for m in ex.motion_stats.values())
    wire = sum(f["wire_bytes"] for f in frags)
    e2e = statistics.median(ts) if ts else first
    print(f"topology: {name} exact, every fragment in the datanode "
          f"processes ({len(frags)} calls, peer exchange "
          f"{'yes' if peer else 'no'}); first {first:.3f} ms, warm median "
          f"{e2e:.3f} ms over {repeats}; {len(got)} rows {got[:2]}... "
          f"[{card}]", flush=True)
    print(f"topology: {name} last warm run: " + "; ".join(
        f"fragment {f['fragment']} @ dn{f['node']} {f['ms']:.3f} ms "
        f"(in the datanode {f['dn_ms']:.3f} ms) {f['rows']} rows "
        f"{f['wire_bytes']} B on the wire" for f in frags)
        + "; motions: " + "; ".join(
            f"{k} {m['kind']}{' peer' if m.get('peer') else ''} "
            f"{m['rows']} rows {m['bytes']} B" for k, m in motions.items())
        + f"; coordinator {ex.coordinator_ms:.3f} ms [{card}]", flush=True)
    return {"route": "dn", "first_ms": first, "e2e": e2e,
            "repeats": repeats, "fragments": frags, "motions": motions,
            "peer": peer, "wire_bytes": wire, "launches": launches}


def k1_query(name: str, s, sql: str, want: list, args, card: str) -> dict:
    """One query through K1 on the fused route of ``s``'s cluster: exact,
    one K1 launch and no K2 launch (both counts set to 0 just before,
    read just after), then the warm median."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    sa.scan_agg.launches = rp.radix_probe.launches = 0
    t0 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1000
    k1, k2 = sa.scan_agg.launches, rp.radix_probe.launches
    inner = getattr(s, "session", s)
    if (got != want or k1 != 1 or k2 != 0
            or inner.last_route != "fused"):
        raise AssertionError(f"{name}: {got} (want {want}), scan_agg "
                             f"launched {k1}, radix_probe {k2}, route "
                             f"{inner.last_route}")
    ts = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        if s.query(sql) != want:
            raise AssertionError(f"{name}: answer changed")
        ts.append((time.perf_counter() - t0) * 1000)
    e2e = statistics.median(ts)
    print(f"topology: {name} exact through the kernel (scan_agg launches "
          f"{k1}, radix_probe {k2}); first {first:.3f} ms incl. upload, "
          f"warm median {e2e:.3f} ms over {args.repeats} [{card}]",
          flush=True)
    return {"route": "fused", "first_ms": first, "e2e": e2e,
            "launches": {"scan_agg": k1, "radix_probe": k2}}


def topology_answers(tables: dict) -> dict:
    """numpy's answers to phase 12's queries over the loaded rows (phase
    10 computes the same and keeps them)."""
    li, o, c = tables["lineitem"], tables["orders"], tables["customer"]
    q18, tie = expected_q18(li, o, c)
    if tie:
        raise AssertionError("TPC-H Q18: the limit cuts a tie")
    return {"Q18": q18, "Q13": expected_q13(o, c), "Q6": expected_q6(li),
            "Q1 (spec)": expected_q1_spec(li),
            "Q3 (spec)": expected_q3(li, o, c, "BUILDING")}


def run_topology(tables: dict, args, device, card: str,
                 answers=None, done=None) -> dict:
    """Phase 12: the process topology on the card over phase 5c's SF10
    arrays (see the module's docstring), checked against ``answers``
    (``topology_answers``; computed here when not given), the
    coordinator's GTM a native process of its own; then phase 14 (the
    GTM, ``run_gtm``) and phase 13 (``run_failover``) on the same live
    topology, ``done`` called between them. Every child (the GTM
    included) is reaped and the data directories removed at the end,
    whatever happened."""
    import shutil

    import torch

    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.storage.replication import (
        StandbyCluster,
        WalSender,
    )

    d = os.path.join(args.data_dir, "topology")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    fs = fs_type(d)
    li = tables["lineitem"]
    out: dict = {"queries": {}, "fs": fs}
    cluster = sender = standby = None
    procs: list = []
    # the live GTM client (phase 14 (d) respawns the process)
    gtm: dict = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        cluster = Cluster(num_datanodes=2, data_dir=os.path.join(d, "cn"),
                          device=device, gts_backend="native")
        gtm["gts"] = cluster.gts
        s = cluster.session()
        for ddl in TOPOLOGY_DDL:
            s.execute(ddl)
        sender = WalSender(cluster.persistence)
        # the datanodes start (and stream) while the coordinator loads
        t0 = time.perf_counter()
        procs = start_datanodes(d, sender, device)
        standby = StandbyCluster(os.path.join(d, "sb"), 2, device=device)
        standby.start_replication(sender.host, sender.port)
        loads = {}
        for name in ("customer", "orders", "lineitem"):
            loads[name] = durable_load(cluster, name, tables[name],
                                       TOPOLOGY_FRAME_ROWS)
        ports = datanode_ports(procs)
        for node, port in zip((0, 1), ports):
            # room for phase 20 (b)'s channels held open across a crash
            cluster.attach_datanode(node, "127.0.0.1", port,
                                    pool_size=P20_WARM_CHANNELS + 1,
                                    rpc_timeout=900)
        print(f"topology: walsender on {sender.port}, 2 datanode processes "
              f"(ports {ports}, device {device}) and the standby started "
              f"with the load, all up {time.perf_counter() - t0:.3f} s "
              f"after the first was; data under {d} ({fs}) [{card}]",
              flush=True)
        print("topology: load " + "; ".join(
            f"{k} {v['rows']} rows in {v['frames']} commit frames, "
            f"{v['bytes']} WAL bytes, {v['s']:.3f} s"
            for k, v in loads.items()) + f" (fsynced, {fs}) [{card}]",
            flush=True)
        out["load"] = loads
        out["catchup"] = wait_replicas(cluster, standby, card, "after the load")
        out["memory"] = {"after catch-up": memory_report(
            "after the catch-up", cluster, card)}

        # (a) the host route, every fragment in the datanode processes
        s.execute("set enable_fused_execution = off")
        ans = answers if answers is not None else topology_answers(tables)
        for name, sql, check in (
                ("Q6", Q6, equal_to("Q6", ans["Q6"])),
                ("Q1 (spec)", Q1_SPEC, equal_to("Q1 (spec)",
                                                ans["Q1 (spec)"])),
                ("Q3 (spec)", Q3_SPEC, equal_to("Q3 (spec)",
                                                ans["Q3 (spec)"])),
                ("Q13", Q13, equal_to("Q13", ans["Q13"])),
                ("Q18", Q18.format(quantity=300), q18_check(ans["Q18"]))):
            out["queries"][f"topology {name} (datanodes)"] = dn_query(
                f"TPC-H {name} through the datanodes", s, sql, check, args,
                card)
        if not any(out["queries"][f"topology {q} (datanodes)"]["peer"]
                   for q in ("Q3 (spec)", "Q18")):
            raise AssertionError("neither Q3 nor Q18 took the peer exchange")
        # phase 17 (c): EXPLAIN ANALYZE through the datanode processes
        out["explain"] = explain_check(
            "TPC-H Q1 (spec) through the datanodes", s, Q1_SPEC,
            len(ans["Q1 (spec)"]), card, fused=False, scan_agg=0,
            radix_probe=0, remote=True)
        out["memory"]["after (a)"] = memory_report("after (a)", cluster, card)
        # phase 19 (b): the datanodes' row-block workers, 4 and 1
        out["parallel"] = run_phase19_parallel(cluster, s, ans, args, card)
        # phase 20 (b): a datanode crash injected through pg_fault_inject
        out["phase20"] = run_phase20_crash(cluster, s, ans, args, card)

        # (b) the fused route answers on the coordinator's own stores
        s.execute("set enable_fused_execution = on")
        q1_sums = q1_text_sums(li)
        for name, sql, want in (("Q6", Q6, ans["Q6"]),
                                ("Q1", Q1, expected_q1_text(q1_sums))):
            out["queries"][f"topology {name} (coordinator, fused)"] = (
                k1_query(f"TPC-H {name} on the coordinator", s, sql, want,
                         args, card))

        # (c) RF1 through implicit 2PC with the write set shipped (its
        # rows appended in the transaction: phase 8a times RF1's INSERT
        # statements)
        rf1 = make_rf1(tables, args.q3_sf, args.seed)
        rf1_li = rf1["lineitem"]
        # numpy's answers after RF1: the loaded rows' plus RF1's
        n_rf1 = len(li["l_orderkey"]) + len(rf1_li["l_orderkey"])
        want_q6 = [((q6_revenue(li) + (q6_revenue(rf1_li) or 0))
                    / 10**4,)]
        want_q1 = expected_q1_text(q1_sums, q1_text_sums(rf1_li))
        prepared = [ch.rpc({"op": "ping"})["dml_stats"].get(
            "2pc_prepared", 0) for ch in cluster.dn_channels.values()]
        t1 = time.perf_counter()
        s.execute("begin")
        counts = [txn_bulk_insert(s, name, rf1[name])
                  for name in ("orders", "lineitem")]
        t2 = time.perf_counter()
        s.execute("commit")
        commit_ms = (time.perf_counter() - t2) * 1000
        rf1_ms = (time.perf_counter() - t1) * 1000
        n_o, n_l = len(rf1["orders"]["o_orderkey"]), len(
            rf1["lineitem"]["l_orderkey"])
        tp = s.last_2pc or {}
        if sum(counts) != n_o + n_l or tp.get("nodes") != [0, 1]:
            raise AssertionError(f"RF1: {sum(counts)} rows, 2PC {tp}")
        dml = [ch.rpc({"op": "ping"})["dml_stats"]
               for ch in cluster.dn_channels.values()]
        if [d.get("2pc_prepared", 0) - n for d, n in zip(dml, prepared)
            ] != [1, 1]:
            raise AssertionError(f"RF1: each datanode must have journaled "
                                 f"one vote: {prepared} -> {dml}")
        print(f"topology: RF1 {n_o} orders and {n_l} lineitems appended "
              f"in one transaction {rf1_ms:.3f} ms "
              f"(COMMIT {commit_ms:.3f} ms: implicit 2PC over datanodes "
              f"{tp['nodes']}, write set shipped, prepare "
              f"{tp['prepare_ms']:.3f} ms, commit {tp['commit_ms']:.3f} "
              f"ms); datanode dml_stats {dml} [{card}]", flush=True)
        s.execute("set enable_fused_execution = off")
        for name, sql, want in (
                ("count(lineitem) after RF1", "select count(*) from lineitem",
                 [(n_rf1,)]),
                ("Q6 after RF1", Q6, want_q6)):
            out["queries"][f"topology {name} (datanodes)"] = dn_query(
                f"TPC-H {name} through the datanodes", s, sql,
                equal_to(name, want), args, card)
        left = {n: ch.rpc({"op": "2pc_list"})["gids"]
                for n, ch in cluster.dn_channels.items()}
        if any(left.values()):
            raise AssertionError(f"2PC journals left behind: {left}")
        out["rf1"] = {"ms": rf1_ms, "commit_ms": commit_ms,
                      "prepare_ms": tp["prepare_ms"],
                      "phase2_ms": tp["commit_ms"], "dml_stats": dml}

        # (d) the synchronous_commit standby rungs
        s.execute(SYNC_PROBE_DDL)
        out["sync"] = {}
        for i, mode in enumerate(("on", "remote_write")):
            s.execute(f"set synchronous_commit = {mode}")
            t1 = time.perf_counter()
            s.execute("insert into sync_probe values " + ",".join(
                f"({k}, {i})" for k in range(2 * i, 2 * i + 64)))
            ms = (time.perf_counter() - t1) * 1000
            acks = sorted(a for _p, a in sender.peer_acks())
            if mode == "remote_write" and (
                    len(acks) < 2 or acks[-2] < s.last_commit_lsn):
                raise AssertionError(f"remote_write: acks {acks} below "
                                     f"{s.last_commit_lsn}")
            out["sync"][mode] = ms
            print(f"topology: a 64-row commit under synchronous_commit = "
                  f"{mode} {ms:.3f} ms (WAL {s.last_commit_lsn}; "
                  f"walsender acks {acks}) [{card}]", flush=True)
        s.execute("set synchronous_commit = local")
        got = s.query("select count(*), sum(v) from sync_probe")
        if got != [(128, 64)]:
            raise AssertionError(f"sync_probe: {got}")

        # (e) the hot standby on the card and a replica read
        if not standby.wait_caught_up(cluster.persistence,
                                      timeout_s=TOPOLOGY_CATCHUP_S):
            raise RuntimeError(f"standby behind the writes: "
                               f"{standby.stream_error}")
        rs = standby.session()
        for name, sql, want in (("Q6", Q6, want_q6), ("Q1", Q1, want_q1)):
            out["queries"][f"topology {name} (standby, fused)"] = k1_query(
                f"TPC-H {name} on the hot standby", rs, sql, want, args,
                card)
        # the datanode's host route: its fused route would first upload
        # its whole replica (phase 11 times such an upload)
        t1 = time.perf_counter()
        resp = cluster.dn_channels[0].rpc({
            "op": "query",
            "sql": "set enable_fused_execution = off; " + Q6,
            "min_lsn": cluster.persistence.wal.position})
        ms = (time.perf_counter() - t1) * 1000
        if [tuple(r) for r in resp.get("rows", ())] != want_q6:
            raise AssertionError(f"replica read: {resp}")
        print(f"topology: Q6 as a replica read on datanode 0 exact "
              f"{resp['rows']}: {ms:.3f} ms round trip, {resp['ms']:.3f} ms "
              f"in the datanode (its host route on its device) "
              f"[{card}]", flush=True)
        out["replica_read_ms"] = ms
        out["memory"]["end"] = memory_report("at the end", cluster, card)
        if done is not None:
            done("process topology (phase 12)")

        # phase 14: the GTM on the same topology, before phase 13's crash
        # (which (d)'s prepared transaction rides into)
        g = run_gtm(cluster, s, standby, tables, {
            "n_rows": n_rf1, "rf1_li": rf1_li, "q1_sums": q1_sums,
            "want_q6": want_q6}, os.path.join(d, "cn"), gtm, args, card)
        out["queries"].update(g.pop("queries"))
        wants = g.pop("wants")
        out["gtm"] = g
        if done is not None:
            done("GTM (phase 14)")

        # phase 13: self-healing HA on the same topology; it closes the
        # ex-primary itself (``live`` is emptied), so the teardown below
        # finds only what is still open
        live = {"cluster": cluster, "session": s, "sender": sender}
        del s
        cluster = sender = None
        try:
            fo = run_failover(live, standby, ports, d, wants, args, device,
                              card)
        finally:
            cluster, sender = live.get("cluster"), live.get("sender")
            del live
        out["queries"].update(fo.pop("queries"))
        out["failover"] = fo
        return out
    finally:
        t0 = time.perf_counter()
        if cluster is not None:
            for node in list(cluster.dn_channels):
                cluster.detach_datanode(node)
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            _stop(proc, grace_s=15.0)  # a datanode exits in 1-2 s
        t1 = time.perf_counter()
        if standby is not None:
            standby.close()
        if sender is not None:
            sender.stop()
        if cluster is not None:
            cluster.close()
        gts = gtm.pop("gts", None)
        if gts is not None:
            gts.close()  # idempotent: the coordinator's close reaps it
        gtm_rc = gts._proc.returncode if gts is not None else None
        del cluster, standby, sender, gts
        gc.collect()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        shutil.rmtree(d, ignore_errors=True)
        print(f"topology: teardown: datanode processes reaped in "
              f"{t1 - t0:.3f} s (exit codes {[p.returncode for p in procs]}),"
              f" standby, coordinator and GTM (exit code {gtm_rc}) closed "
              f"in {t2 - t1:.3f} s, data removed in "
              f"{time.perf_counter() - t2:.3f} s", flush=True)


# phase 14: explicit 2PC's gids, the table of (b)'s and (d)'s rows and
# (c)'s sequence
GTM_RF1_GID = "gtm_rf1"
GTM_RB_GID = "gtm_rb"
GTM_CRASH_GID = "gtm_crash"  # left prepared into phase 13 (e)
GTM_PROBE_DDL = ("create table gtm_probe (k bigint, v bigint) "
                 "distribute by shard(k)")
GTM_CRASH_KEYS = range(100, 164)
GTM_SEQ_ROWS = 4096
GTM_DEL_ORDERS = 8  # loaded orders whose lines (a) deletes


def _pid_rss_mb(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    return 0.0


def _negate(sums: dict) -> dict:
    return {k: [-x for x in v] for k, v in sums.items()}


def _frame_bytes(wal_path: str, start: int, tag: str) -> int:
    """Bytes of the ``tag`` records of the WAL from ``start`` on."""
    from opentenbase_tpu_torch.storage.persist import WAL

    total, prev = 0, start
    for t, _h, _a, end in WAL.read_records(wal_path, start,
                                           decode_arrays=False):
        if t == tag:
            total += end - prev
        prev = end
    return total


def _card_top_stamp(cluster) -> int:
    """The largest commit timestamp on the device cache's MVCC planes
    (PENDING_TS, INF_TS and RESERVED_TS left out)."""
    import torch

    from opentenbase_tpu_torch.storage.table import RESERVED_TS

    top = 0
    for dt in cluster.fused_executor().cache._tables.values():
        for plane in (dt.xmin, dt.xmax):
            real = plane[plane < int(RESERVED_TS)]
            if real.numel():
                top = max(top, int(torch.max(real)))
    return top


def run_gtm(cluster, s, standby, tables: dict, state: dict, gtm_dir: str,
            holder: dict, args, card: str) -> dict:
    """Phase 14 on phase 12's live topology (see the module docstring):
    the coordinator's GTM is the native server in its own process
    (``holder["gts"]`` names the live client, for the teardown).
    ``state`` carries phase 12's RF1 and numpy's answers after it;
    returns the new answers phase 13 checks, the queries and the
    numbers."""
    import argparse as _ap

    from opentenbase_tpu_torch.gtm.client import NativeGTS

    one = _ap.Namespace(**{**vars(args), "repeats": 1})
    out: dict = {"queries": {}}
    p = cluster.persistence
    gts = cluster.gts
    lat = []
    for _ in range(1000):
        t0 = time.perf_counter()
        gts.get_gts()
        lat.append((time.perf_counter() - t0) * 1e6)
    lat.sort()
    nodes = cluster.gtm_registered_nodes()
    if sorted(nodes) != ["cn0", "dn0", "dn1", "gtm0"]:
        raise AssertionError(f"GTM registry: {nodes}")
    out.update(gts_us=statistics.median(lat), gtm_rss_mb=_pid_rss_mb(
        gts.pid), gtm_pid=gts.pid)
    print(f"gtm: the coordinator's GTM is the native server (pid {gts.pid},"
          f" RSS {out['gtm_rss_mb']:.3f} MB, state under {gtm_dir}); "
          f"get_gts over its wire median {out['gts_us']:.3f} us over 1000 "
          f"(min {lat[0]:.3f}, p99 {lat[989]:.3f}); registered nodes "
          + ", ".join(f"{k} ({v['kind']})" for k, v in sorted(nodes.items()))
          + f" [{card}]", flush=True)

    # (a) explicit 2PC at SF10: a second RF1 batch and the lines of a few
    # loaded orders deleted, prepared, read, committed, read again
    li, o = tables["lineitem"], tables["orders"]
    rf1b = make_rf1(tables, args.q3_sf, args.seed + 14)
    step = max(len(o["o_orderkey"]) // GTM_DEL_ORDERS, 1)
    del_keys = o["o_orderkey"][::step][:GTM_DEL_ORDERS]
    dmask = np.isin(li["l_orderkey"], del_keys)
    li_del, b_li = _select(li, dmask), rf1b["lineitem"]
    n_before = state["n_rows"]
    n_after = n_before + len(b_li["l_orderkey"]) - int(dmask.sum())
    rev = (q6_revenue(li) or 0) + (q6_revenue(state["rf1_li"]) or 0) \
        + (q6_revenue(b_li) or 0) - (q6_revenue(li_del) or 0)
    want_q6 = [(rev / 10**4,)]
    want_q1 = expected_q1_text(state["q1_sums"],
                               q1_text_sums(state["rf1_li"]),
                               q1_text_sums(b_li),
                               _negate(q1_text_sums(li_del)))
    s.execute("set enable_fused_execution = on")
    t0 = time.perf_counter()
    s.execute("begin")
    n_ins = sum(txn_bulk_insert(s, name, rf1b[name])
                for name in ("orders", "lineitem"))
    n_del = s.execute("delete from lineitem where l_orderkey in ("
                      + ",".join(str(int(k)) for k in del_keys)
                      + ")").rowcount
    write_ms = (time.perf_counter() - t0) * 1000
    if n_del != int(dmask.sum()):
        raise AssertionError(f"deleted {n_del} lines, numpy "
                             f"{int(dmask.sum())}")
    pos0 = p.wal.position
    t0 = time.perf_counter()
    s.execute(f"prepare transaction '{GTM_RF1_GID}'")
    prepare_ms = (time.perf_counter() - t0) * 1000
    t_bytes = _frame_bytes(p.wal.path, pos0, "T")
    votes = {n: ch.rpc({"op": "2pc_list"})["gids"]
             for n, ch in cluster.dn_channels.items()}
    listed = [(i.gid, i.partnodes) for i in cluster.gts.prepared_txns()]
    if votes != {0: [GTM_RF1_GID], 1: [GTM_RF1_GID]} \
            or listed != [(GTM_RF1_GID, (0, 1))]:
        raise AssertionError(f"prepared: votes {votes}, GTM {listed}")
    # phase 17 (e): the view over the GTM's registry
    view = s.query("select gid, partnodes from pg_prepared_xacts")
    if view != [(GTM_RF1_GID, "0,1")]:
        raise AssertionError(f"pg_prepared_xacts while prepared: {view}")
    print(f"views: pg_prepared_xacts while prepared {view} [{card}]",
          flush=True)
    print(f"gtm (a): RF1's shape again ({n_ins} rows: make_rf1 seed "
          f"{args.seed + 14}) and the {n_del} lines of {GTM_DEL_ORDERS} "
          f"loaded orders deleted in one transaction in {write_ms:.3f} ms; "
          f"PREPARE TRANSACTION {prepare_ms:.3f} ms, its 'T' frame {t_bytes}"
          f" bytes (fsynced, {fs_type(p.dir)}); the gid listed by both "
          f"datanodes' 2pc_list and by the GTM over its wire {listed} "
          f"[{card}]", flush=True)
    prepared_q = {
        "gtm Q6 while prepared (coordinator, fused)": k1_query(
            "TPC-H Q6 on the coordinator while prepared (deleted lines "
            "visible at RESERVED_TS)", s, Q6, state["want_q6"], one, card)}
    s.execute("set enable_fused_execution = off")
    prepared_q["gtm count(lineitem) while prepared (datanodes)"] = dn_query(
        "count(lineitem) through the datanodes while prepared", s,
        "select count(*) from lineitem",
        equal_to("count while prepared", [(n_before,)]), one, card)
    t0 = time.perf_counter()
    s.execute(f"commit prepared '{GTM_RF1_GID}'")
    commit_ms = (time.perf_counter() - t0) * 1000
    print(f"gtm (a): COMMIT PREPARED {commit_ms:.3f} ms [{card}]",
          flush=True)
    s.execute("set enable_fused_execution = on")
    q = prepared_q
    for name, sql, want in (("Q6", Q6, want_q6), ("Q1", Q1, want_q1)):
        q[f"gtm {name} committed (coordinator, fused)"] = k1_query(
            f"TPC-H {name} on the coordinator after COMMIT PREPARED", s,
            sql, want, one, card)
    s.execute("set enable_fused_execution = off")
    for name, sql, want in (
            ("count(lineitem)", "select count(*) from lineitem",
             [(n_after,)]), ("Q6", Q6, want_q6)):
        q[f"gtm {name} committed (datanodes)"] = dn_query(
            f"{name} through the datanodes after COMMIT PREPARED", s, sql,
            equal_to(name, want), one, card)
    if not standby.wait_caught_up(cluster.persistence,
                                  timeout_s=TOPOLOGY_CATCHUP_S):
        raise RuntimeError(f"standby behind: {standby.stream_error}")
    q["gtm Q6 committed (standby, fused)"] = k1_query(
        "TPC-H Q6 on the hot standby after its 'C' frame",
        standby.session(), Q6, want_q6, one, card)
    left = {n: ch.rpc({"op": "2pc_list"})["gids"]
            for n, ch in cluster.dn_channels.items()}
    if any(left.values()) or cluster.gts.prepared_txns():
        raise AssertionError(f"after COMMIT PREPARED: journals {left}, "
                             f"GTM {cluster.gts.prepared_txns()}")
    out.update(prepare_ms=prepare_ms, commit_prepared_ms=commit_ms,
               t_frame_bytes=t_bytes, rf1_rows=n_ins, deleted=n_del)

    # (b) PREPARE then ROLLBACK PREPARED: nothing visible anywhere
    s.execute(GTM_PROBE_DDL)
    s.execute("begin")
    s.execute("insert into gtm_probe values " + ",".join(
        f"({k}, 1)" for k in range(64)))
    t0 = time.perf_counter()
    s.execute(f"prepare transaction '{GTM_RB_GID}'")
    s.execute(f"rollback prepared '{GTM_RB_GID}'")
    rb_ms = (time.perf_counter() - t0) * 1000
    if not standby.wait_caught_up(cluster.persistence,
                                  timeout_s=TOPOLOGY_CATCHUP_S):
        raise RuntimeError(f"standby behind: {standby.stream_error}")
    seen = {"datanodes": s.query("select count(*) from gtm_probe"),
            "standby": standby.session().query(
                "select count(*) from gtm_probe")}
    s.execute("set enable_fused_execution = on")
    seen["coordinator"] = s.query("select count(*) from gtm_probe")
    if any(v != [(0,)] for v in seen.values()) \
            or cluster.gts.prepared_txns():
        raise AssertionError(f"after ROLLBACK PREPARED: {seen}")
    print(f"gtm (b): 64 rows prepared and rolled back in {rb_ms:.3f} ms; "
          f"count(gtm_probe) {seen}; the registry empty [{card}]",
          flush=True)

    # (c) a sequence: one GTM range reservation for a 4 096-row INSERT
    s.execute("create sequence gtm_seq")
    s.execute("create table gtm_ids (id bigint, v int) "
              "distribute by shard(id)")
    calls = []
    nextval = cluster.gts.nextval

    def counted(name, cache=1):
        calls.append((name, cache))
        return nextval(name, cache)

    cluster.gts.nextval = counted
    try:
        t0 = time.perf_counter()
        s.execute("insert into gtm_ids values " + ",".join(
            f"(nextval('gtm_seq'), {i % 7})" for i in range(GTM_SEQ_ROWS)))
        seq_ms = (time.perf_counter() - t0) * 1000
    finally:
        del cluster.gts.nextval
    if calls != [("gtm_seq", GTM_SEQ_ROWS)]:
        raise AssertionError(f"nextval round trips: {calls}")
    n = GTM_SEQ_ROWS
    q["gtm sum(id) of a sequence (coordinator, fused)"] = k1_query(
        "sum(id), count(*) of the 4 096 nextval() rows", s,
        "select sum(id), count(*) from gtm_ids", [(n * (n + 1) // 2, n)],
        one, card)
    if not standby.wait_caught_up(cluster.persistence,
                                  timeout_s=TOPOLOGY_CATCHUP_S):
        raise RuntimeError(f"standby behind: {standby.stream_error}")
    try:
        standby.session().query("select nextval('gtm_seq')")
        raise AssertionError("the standby served nextval")
    except Exception as e:
        if "read-only" not in str(e):
            raise
        refusal = str(e)
    sb_next = standby.cluster.gts._seqs["gtm_seq"].next_value
    nxt = s.query("select nextval('gtm_seq')")
    if [(sb_next,)] != nxt or sb_next != n + 1:
        raise AssertionError(f"sequence: standby {sb_next}, primary {nxt}")
    print(f"gtm (c): INSERT of {n} rows of nextval('gtm_seq') {seq_ms:.3f} "
          f"ms with one GTM reservation {calls}; the standby refuses "
          f"nextval ({refusal!r}) and holds the primary's next value "
          f"{sb_next} [{card}]", flush=True)
    out["seq_insert_ms"] = seq_ms

    # (d) the GTM's own crash: SIGKILL, respawn from its state, re-point
    s.execute("begin")
    s.execute("insert into gtm_probe values " + ",".join(
        f"({k}, 2)" for k in GTM_CRASH_KEYS))
    s.execute(f"prepare transaction '{GTM_CRASH_GID}'")
    top = _card_top_stamp(cluster)
    old = cluster.gts
    old_pid = old.pid
    old.kill_server()  # SIGKILL
    t0 = time.perf_counter()
    new = NativeGTS.spawn(gtm_dir)
    holder["gts"] = new
    cluster.gts = new
    old.close()
    respawn_ms = (time.perf_counter() - t0) * 1000
    first = new.get_gts()
    listed = [i.gid for i in new.prepared_txns()]
    if first <= top or listed != [GTM_CRASH_GID]:
        raise AssertionError(f"respawned GTM: first {first} (card top "
                             f"{top}), prepared {listed}")
    q["gtm Q6 after the GTM's crash (coordinator, fused)"] = k1_query(
        "TPC-H Q6 after the GTM's SIGKILL and respawn", s, Q6, want_q6,
        one, card)
    s.execute("insert into gtm_probe values " + ",".join(
        f"({k}, 3)" for k in range(200, 264)))
    got = s.query("select count(*), sum(v) from gtm_probe")
    if got != [(64, 192)]:
        raise AssertionError(f"gtm_probe after the respawn: {got}")
    print(f"gtm (d): GTM pid {old_pid} SIGKILLed with '{GTM_CRASH_GID}' "
          f"prepared; respawned from {gtm_dir} as pid {new.pid} and "
          f"re-pointed in {respawn_ms:.3f} ms; its first timestamp "
          f"{first} is above the card's top commit stamp {top} (by "
          f"{(first - top) >> 20} ms of the clock); it lists {listed}; a "
          f"64-row write committed {got} [{card}]", flush=True)
    out.update(respawn_ms=respawn_ms, gtm_pid_after=new.pid)

    # (f) a GTM standby promoted on the card (tests/test_gtm_ha.py's)
    out["standby_failover"] = run_gtm_standby(cluster.device, one, card)
    q["gtm sum(v) after a GTM standby's promotion (small cluster, fused)"] \
        = out["standby_failover"].pop("query")
    out["queries"] = q
    out["wants"] = {"Q6": want_q6, "Q1": want_q1}
    return out


def run_gtm_standby(device, args, card: str) -> dict:
    """Phase 14 (f): a small cluster on the card whose in-process GTM
    feeds a standby over TCP (serve_feed / connect_feed); the GTM dies,
    the standby is promoted behind a GTSFrontend and the cluster is
    re-pointed there through NativeGTS: commits stamp above the old
    watermark, and a K1 read is exact."""
    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.gtm.client import NativeGTS
    from opentenbase_tpu_torch.gtm.server import GTSFrontend
    from opentenbase_tpu_torch.gtm.standby import (
        ReplicationLink,
        connect_feed,
        serve_feed,
    )

    c = Cluster(num_datanodes=2, shard_groups=32, device=device)
    link = ReplicationLink(c.gts)
    lsock, port, _t = serve_feed(link)
    fe = None
    try:
        sb, _rt = connect_feed("127.0.0.1", port)
        s = c.session()
        s.execute("create table gf (k bigint, v bigint) "
                  "distribute by shard(k)")
        s.execute("insert into gf values " + ",".join(
            f"({k}, {k % 10})" for k in range(HA_ROWS)))
        deadline = time.monotonic() + 30
        while sb.applied_lsn < link.sent_lsn:
            if time.monotonic() > deadline:
                raise RuntimeError("the GTM standby never caught up")
            time.sleep(0.01)
        old_wm = c.gts.clock._watermark
        lsock.close()  # the GTM dies with its feed
        t0 = time.perf_counter()
        fe = GTSFrontend(sb.promote()).start()
        c.gts = NativeGTS(fe.host, fe.port)
        ms = (time.perf_counter() - t0) * 1000
        s.execute("insert into gf values " + ",".join(
            f"({k}, 5)" for k in range(HA_ROWS, HA_ROWS + 64)))
        top = max(int(st["gf"].scan_view().xmin().max())
                  for st in c.stores.values())
        if top <= old_wm:
            raise AssertionError(f"stamp {top} not above the old GTM's "
                                 f"watermark {old_wm}")
        want = [(sum(k % 10 for k in range(HA_ROWS)) + 5 * 64,
                 HA_ROWS + 64)]
        r = k1_query("sum(v), count(*) after the GTM standby's promotion",
                     s, "select sum(v), count(*) from gf", want, args, card)
        print(f"gtm (f): the in-process GTM died; its standby (fed over "
              f"TCP, applied {sb.applied_lsn} events) promoted behind a "
              f"GTSFrontend and the cluster re-pointed through NativeGTS "
              f"in {ms:.3f} ms; the next commit stamped {top - old_wm} "
              f"above the old watermark [{card}]", flush=True)
        return {"failover_ms": ms, "query": r}
    finally:
        if fe is not None:
            fe.stop()
        lsock.close()
        c.close()


# phase 13: the rows of (a)'s dead-timeline write and (c)'s acknowledged
# commit, told apart from phase 12 (d)'s by their keys
DEAD_KEYS = range(1_000_000, 1_000_064)
ACKED_KEYS = range(2_000_000, 2_000_064)
# tests/test_ha.py's topology configuration, for (g)
HA_CONF = {"enable_fused_execution": "off", "synchronous_commit": "on",
           "failover_detect_ms": 1000, "failover_beats": 3,
           "fragment_retries": 1, "fragment_retry_backoff_ms": 5,
           "statement_timeout": 8000}
HA_ROWS = 4000  # (g)'s table: (a)-(f) carry SF10


def dn_rpc(port: int, msg: dict, timeout_s: float = 600.0) -> dict:
    """One RPC to a datanode process on a channel of its own."""
    from opentenbase_tpu_torch.ha import _endpoint_rpc

    return _endpoint_rpc("127.0.0.1", port, msg, timeout_s)


def wait_applied(label: str, applied, target: int) -> float:
    """Seconds until ``applied()`` reached ``target`` (raises past
    TOPOLOGY_CATCHUP_S)."""
    t0 = time.perf_counter()
    deadline = time.monotonic() + TOPOLOGY_CATCHUP_S
    while applied() < target:
        if time.monotonic() > deadline:
            raise RuntimeError(f"{label}: applied {applied()} short of "
                               f"{target}")
        time.sleep(0.01)
    return time.perf_counter() - t0


def sync_probe_rows(query) -> dict:
    """sync_probe's count and sum, and its rows of (a)'s dead-timeline
    write and of (c)'s acknowledged commit, through ``query``."""
    (n, v), = [tuple(r) for r in query(
        "select count(*), sum(v) from sync_probe")]
    (dead,), = [tuple(r) for r in query(
        f"select count(*) from sync_probe where k >= {DEAD_KEYS.start} "
        f"and k < {DEAD_KEYS.stop}")]
    (acked,), = [tuple(r) for r in query(
        f"select count(*) from sync_probe where k >= {ACKED_KEYS.start} "
        f"and k < {ACKED_KEYS.stop}")]
    return {"rows": n, "sum": v, "dead": dead, "acked": acked}


def run_failover(live: dict, standby, ports: list, d: str, wants: dict,
                 args, device, card: str) -> dict:
    """Phase 13 on phase 12's live topology (see the module docstring).
    ``live`` holds the coordinator ("cluster", "session") and its
    walsender ("sender"): (e) closes the ex-primary and drops all
    three (the sender holds the cluster), so the caller's teardown
    finds only what is still open and the ex-primary's memory is free
    before its rewind. The rewound ex-primary is closed here, whatever
    happens."""
    import torch

    from opentenbase_tpu_torch.ha import _probe_ping, failover_endpoints
    from opentenbase_tpu_torch.net.client import WireError, connect_tcp
    from opentenbase_tpu_torch.net.server import ClusterServer
    from opentenbase_tpu_torch.storage.replication import rejoin_standby

    cluster, s, sender = live["cluster"], live["session"], live["sender"]
    out: dict = {"queries": {}}
    rejoined = srv = None
    try:
        # (a) the replicas hold the coordinator's WAL end; the crash as
        # HATopology.crash_primary makes it (the walsender stopped, the
        # datanode pools closed; detached, so the write below commits on
        # the crashed process's own stores); then a write that never
        # streams
        wait_replicas(cluster, standby, card, "before the crash")
        sender.stop()
        for node in list(cluster.dn_channels):
            cluster.detach_datanode(node)
        before = sync_probe_rows(s.query)
        s.execute("set synchronous_commit = local")
        pos0 = cluster.persistence.wal.position
        s.execute("insert into sync_probe values " + ",".join(
            f"({k}, 7)" for k in DEAD_KEYS))
        ex_end = cluster.persistence.wal.position
        print(f"topology: failover (a): coordinator crashed (walsender "
              f"stopped, datanode pools closed); a 64-row commit under "
              f"synchronous_commit = local after it, WAL {pos0} -> "
              f"{ex_end} ({ex_end - pos0} bytes that never stream) "
              f"[{card}]", flush=True)

        # (b) failover by the port's own failover_endpoints, the RPC half
        # HATopology.failover drives
        res = failover_endpoints([("127.0.0.1", p) for p in ports], 1,
                                 standbys=[standby], ping_timeout_s=30.0,
                                 rpc_timeout_s=600.0)
        if not res["ok"] or sorted(res["candidates"]) != [0, 1]:
            raise AssertionError(f"failover_endpoints: {res}")
        new, resp = res["promoted"], res["resp"]
        other = 1 - new
        promote_ms, restart_ms = res["ms"]["promote"], res["ms"]["restart"]
        repoint_ms = res["ms"]["repoint"]
        if resp.get("generation") != 1 or not resp.get("wal_port") or (
                resp.get("gtm_nodes") != ["cn0", "dn0", "dn1", "gtm0"]):
            raise AssertionError(f"promote: {resp}")
        sql_port, wal_port = int(resp["port"]), int(resp["wal_port"])
        promote_lsn = int(resp["promote_lsn"])
        if promote_lsn != pos0:
            raise AssertionError(f"promote_lsn {promote_lsn}: the replicas "
                                 f"had applied {pos0}")
        rp = res["repointed"].get(other) or {}
        if not rp.get("ok") or rp.get("rewound"):
            raise AssertionError(f"repl_repoint: {rp}")
        if res["timeline"] != (1, promote_lsn):
            raise AssertionError(f"timeline {res['timeline']}, promote_lsn "
                                 f"{promote_lsn}")
        new_end = int(_probe_ping("127.0.0.1", sql_port, 30.0)["applied"])
        catch = {
            f"dn{other}": wait_applied(f"dn{other}", lambda: int(dn_rpc(
                ports[other], {"op": "ping"}, 30.0)["applied"]), new_end),
            "standby": wait_applied("standby", lambda: standby.applied,
                                    new_end)}
        if standby.cluster.node_generation != 1:
            raise AssertionError("the standby did not replay the "
                                 "ha_generation record")
        print(f"topology: failover (b) by ha.failover_endpoints: "
              f"datanodes applied {res['applied']}; "
              f"dn{new} promoted to generation 1 in {promote_ms:.3f} ms "
              f"(promote_lsn {promote_lsn}, torn tail "
              f"{resp.get('torn_bytes')} bytes, SQL port {sql_port}, "
              f"walsender {wal_port}); dn{other} fenced and re-pointed in "
              f"{repoint_ms:.3f} ms, the standby's stream restarted in "
              f"{restart_ms:.3f} ms after probe_timeline; caught up to the "
              f"new timeline's end {new_end}: " + "; ".join(
                  f"{k} {v:.3f} s" for k, v in catch.items())
              + f" [{card}]", flush=True)
        out.update(promote_ms=promote_ms, promote_lsn=promote_lsn,
                   torn_bytes=resp.get("torn_bytes"), repoint_ms=repoint_ms,
                   catchup_s=catch, promoted=new)

        # (c) the promoted node serves over the JSON wire
        conn = connect_tcp("127.0.0.1", sql_port, timeout=900)
        try:
            for name, sql in (("Q6", Q6), ("Q1", Q1)):
                ts = []
                for _ in range(1 + args.repeats):
                    t0 = time.perf_counter()
                    got = conn.query(sql)
                    ts.append((time.perf_counter() - t0) * 1000)
                    if got != wants[name]:
                        raise AssertionError(f"promoted {name}: {got} != "
                                             f"{wants[name]}")
                out[f"promoted {name} ms"] = {
                    "first": ts[0], "warm": statistics.median(ts[1:])}
                print(f"topology: failover (c): TPC-H {name} on the "
                      f"promoted dn{new} over the JSON wire exact, fused "
                      f"route on; first {ts[0]:.3f} ms incl. its upload, "
                      f"warm median {statistics.median(ts[1:]):.3f} ms over "
                      f"{args.repeats} [{card}]", flush=True)
            # phase 14 (e): the transaction prepared before the crash,
            # parked on the promoted node by its replay, decided there
            t0 = time.perf_counter()
            conn.execute(f"commit prepared '{GTM_CRASH_GID}'")
            cp_ms = (time.perf_counter() - t0) * 1000
            conn.execute("set synchronous_commit = remote_write")
            t0 = time.perf_counter()
            res = conn.execute("insert into sync_probe values " + ",".join(
                f"({k}, 9)" for k in ACKED_KEYS))
            commit_ms = (time.perf_counter() - t0) * 1000
            promoted_rows = sync_probe_rows(conn.query)
        finally:
            conn.close()
        want_rows = {"rows": before["rows"] + 64,
                     "sum": before["sum"] + 9 * 64, "dead": 0, "acked": 64}
        t0 = time.perf_counter()
        wait_applied("standby", lambda: standby.applied, res.wal_pos)
        reads = {"promoted": promoted_rows,
                 "re-pointed standby": sync_probe_rows(
                     standby.session().query),
                 f"dn{other} (replica read)": sync_probe_rows(
                     lambda q: dn_rpc(ports[other], {
                         "op": "query", "sql": q,
                         "min_lsn": res.wal_pos}, 60.0)["rows"])}
        readback_s = time.perf_counter() - t0
        for where, got in reads.items():
            if got != want_rows:
                raise AssertionError(f"sync_probe on {where}: {got}, want "
                                     f"{want_rows}")
        crash_rows = standby.session().query(
            "select count(*), sum(v) from gtm_probe where k >= "
            f"{GTM_CRASH_KEYS.start} and k < {GTM_CRASH_KEYS.stop}")
        if crash_rows != [(64, 128)]:
            raise AssertionError(f"'{GTM_CRASH_GID}' on the re-pointed "
                                 f"standby: {crash_rows}")
        print(f"gtm (e): COMMIT PREPARED '{GTM_CRASH_GID}' (prepared before "
              f"the GTM's and the coordinator's crash) over the JSON wire "
              f"to the promoted dn{new} {cp_ms:.3f} ms; its 64 rows read "
              f"back on the re-pointed standby {crash_rows}; the promoted "
              f"node's own in-process GTM lists {resp['gtm_nodes']} (the "
              f"re-registration is checked in (g)) [{card}]", flush=True)
        out["commit_prepared_after_failover_ms"] = cp_ms
        print(f"topology: failover (c): a 64-row commit on the promoted "
              f"node under synchronous_commit = remote_write {commit_ms:.3f} "
              f"ms (WAL {res.wal_pos}); read back exactly on the "
              f"re-pointed standby and on dn{other} in {readback_s:.3f} s; "
              f"(a)'s rows nowhere: {reads} [{card}]", flush=True)
        out["remote_write_ms"] = commit_ms

        # (d) the revived ex-primary is fenced
        for node, port in enumerate(ports):
            cluster.attach_datanode(node, "127.0.0.1", port, pool_size=2,
                                    rpc_timeout=900)
        srv = ClusterServer(cluster).start()
        stale = connect_tcp("127.0.0.1", srv.port, timeout=900)
        states = []
        try:
            stale.execute("set enable_fused_execution = off")
            for sql in ("select count(*) from sync_probe",
                        "insert into sync_probe values (5, 5)"):
                try:
                    stale.execute(sql)
                    states.append("served")
                except WireError as e:
                    states.append(e.sqlstate)
        finally:
            stale.close()
        try:
            s.execute("select count(*) from sync_probe")
            states.append("served")
        except Exception as e:
            states.append(getattr(e, "sqlstate", type(e).__name__))
        if states != ["72000"] * 3 or not cluster.ha_demoted:
            raise AssertionError(f"the ex-primary: {states}, demoted "
                                 f"{cluster.ha_demoted}")
        print(f"topology: failover (d): the revived ex-primary's read and "
              f"write refused with {states[:2]}, then every statement "
              f"({states[2]}; demoted, {cluster.ha_stats['fenced_refusals']}"
              f" refusals counted) [{card}]", flush=True)

        # (e) the ex-primary's rewind, on the card
        srv.stop()
        srv = None
        for node in list(cluster.dn_channels):
            cluster.detach_datanode(node)
        cluster.close()
        live.clear()
        del cluster, s, sender
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rejoined = rejoin_standby(os.path.join(d, "cn"), "127.0.0.1",
                                  wal_port, 2, device=device)
        rejoin_s = time.perf_counter() - t0
        end = int(_probe_ping("127.0.0.1", sql_port, 30.0)["applied"])
        catch_s = wait_applied("rewound ex-primary",
                               lambda: rejoined.applied, end)
        if rejoined.truncated_bytes != ex_end - promote_lsn:
            raise AssertionError(f"rewind truncated "
                                 f"{rejoined.truncated_bytes} bytes, the "
                                 f"dead timeline is {ex_end - promote_lsn}")
        got = sync_probe_rows(rejoined.session().query)
        if got != want_rows or rejoined.cluster.node_generation != 1:
            raise AssertionError(f"rewound ex-primary: {got}")
        print(f"topology: failover (e): the ex-primary rewound "
              f"{rejoined.truncated_bytes} bytes (its WAL end {ex_end} less "
              f"promote_lsn {promote_lsn}: (a)'s frame) and rejoined as a "
              f"standby on {rejoined.cluster.device}: rejoin "
              f"{rejoin_s:.3f} s (local replay {rejoined.replay_s:.3f} s), "
              f"caught up to {end} {catch_s:.3f} s later; sync_probe "
              f"{got} [{card}]", flush=True)
        out.update(rewound_bytes=rejoined.truncated_bytes, rejoin_s=rejoin_s,
                   replay_s=rejoined.replay_s, rejoin_catchup_s=catch_s)

        # (f) K1 on the healed topology
        for where, sb in (("re-pointed standby", standby),
                          ("rewound ex-primary", rejoined)):
            rs = sb.session()
            for name, sql in (("Q6", Q6), ("Q1", Q1)):
                out["queries"][f"failover {name} ({where}, fused)"] = (
                    k1_query(f"TPC-H {name} on the {where}", rs, sql,
                             wants[name], args, card))

        # (g) the failure detector on the card
        out["detector"] = run_ha_detector(os.path.join(d, "ha"), device,
                                          card)
        # phase 20 (d): a seeded chaos schedule on the card
        out["chaos"] = run_phase20_chaos(os.path.join(d, "chaos"), device,
                                         card)
        return out
    finally:
        if srv is not None:
            srv.stop()
        if rejoined is not None:
            rejoined.close()
        del rejoined
        gc.collect()


def run_ha_detector(d: str, device, card: str) -> dict:
    """Phase 13 (g): a small HATopology on the card with the reference
    test's configuration; the monitor promotes within its detection
    budget after crash_primary, and RoutingClient writes resume with
    every acknowledged row present."""
    import shutil

    import torch

    from opentenbase_tpu_torch.ha import HAMonitor, HATopology, RoutingClient

    shutil.rmtree(d, ignore_errors=True)
    topo = HATopology(d, num_datanodes=2, shard_groups=16,
                      conf_gucs=HA_CONF, device=device)
    mon = None
    rc = RoutingClient(topo)
    try:
        rc.execute("create table ha (k bigint, v bigint) "
                   "distribute by shard(k)")
        acked = []
        for lo in range(0, HA_ROWS, 500):
            rc.execute("insert into ha values " + ",".join(
                f"({k}, {k % 97})" for k in range(lo, lo + 500)))
            acked += range(lo, lo + 500)
        # every candidate's GTM loses dn1's registration and holds a
        # stale address for cn0: the promotion must register them again
        want_nodes = topo.dns[0].standby.cluster.gtm_registered_nodes()
        for dn in topo.dns:
            g = dn.standby.cluster.gts
            g.unregister_node("dn1")
            g.register_node("cn0", want_nodes["cn0"]["kind"], "10.0.0.9", 9)
        mon = HAMonitor(topo).start()
        t_crash = time.time()
        topo.crash_primary()
        resumed = None
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                rc.execute(f"insert into ha values ({HA_ROWS}, 0)")
                resumed = time.time()
                break
            except Exception:
                time.sleep(0.05)
        if resumed is None or mon.declared_dead_at is None:
            raise AssertionError(f"writes never resumed: {topo.events}")
        detect_ms = (mon.declared_dead_at - t_crash) * 1000
        budget = mon.detect_ms + mon.detect_ms / mon.beats + 600
        promoted = next(e for e in topo.events if e["kind"] == "promoted")
        promote_ms = (promoted["t"] - t_crash) * 1000
        keys = {r[0] for r in rc.query("select k from ha")}
        kinds = [e["kind"] for e in topo.events]
        nodes = topo.active_cluster.gtm_registered_nodes()
        if (detect_ms > budget or mon.promotions != 1
                or not set(acked) | {HA_ROWS} <= keys
                or topo.active_cluster.device != torch.device(device)
                or nodes != want_nodes):
            raise AssertionError(f"detector: {detect_ms:.1f} ms (budget "
                                 f"{budget:.1f}), promotions "
                                 f"{mon.promotions}, {len(keys)} keys, "
                                 f"{kinds}, GTM registry {nodes}")
        print(f"topology: failover (g): HATopology on "
              f"{topo.active_cluster.device}, {HA_ROWS} rows under "
              f"synchronous_commit = on; the monitor declared the primary "
              f"dead {detect_ms:.1f} ms after the crash (budget "
              f"{budget:.1f} ms), dn{topo.promoted_index} promoted "
              f"{promote_ms:.1f} ms after it, writes resumed "
              f"{(resumed - t_crash) * 1000:.1f} ms after it; every "
              f"acknowledged row present ({len(keys)}); events {kinds}; "
              f"the promoted node registered the topology with its GTM "
              f"again (dn1 restored, cn0's stale address replaced): "
              f"{sorted(nodes)} [{card}]", flush=True)
        return {"detect_ms": detect_ms, "budget_ms": budget,
                "promote_ms": promote_ms,
                "resume_ms": (resumed - t_crash) * 1000}
    finally:
        rc.close()
        if mon is not None:
            mon.stop()
        topo.stop()
        shutil.rmtree(d, ignore_errors=True)


# -- phase 20: fault injection ---------------------------------------------

# the channels each datanode pool holds open before phase 20 (b) arms its
# crash: the crashed attempt and its retry burn one each, for Q6 and for
# Q1 (spec), and a crashed process answers the fault-control ops only on
# a channel opened before the crash (its listener is closed)
P20_WARM_CHANNELS = 5
P20_FAULT_COLS = ("node, site, action, trigger_spec, arms, hits, fired, "
                  "armed")


def _expect_fault(name: str, fn) -> tuple:
    """(the FaultError ``fn`` raised, ms); an answer fails the phase."""
    from opentenbase_tpu_torch.fault import FaultError

    t0 = time.perf_counter()
    try:
        got = fn()
    except FaultError as e:
        return e, (time.perf_counter() - t0) * 1000
    raise AssertionError(f"{name}: answered {got[:2]} under an armed fault")


def run_phase20_fused(q3: dict, li: dict, args, card: str) -> dict:
    """Phase 20 (a), in phase 5c's SF10 cluster after phase 19 (a): with
    ``fault_injection`` on, ``fused/delta_tail_upload`` armed error once
    through pg_fault_inject, TPC-H RF1's lineitem volume COPYed in; Q6
    raises the injected error with no K1 launch and no host-route
    answer, Q6 again is exact on K1 (one launch) with the device cache's
    delta tail equal to the batch; then on the host route
    ``storage/delta_scan`` armed error once: the read fails, the rerun is
    exact. pg_stat_faults' rows printed."""
    import shutil
    import tempfile

    from opentenbase_tpu_torch import fault
    from opentenbase_tpu_torch.ops import scan_agg as sa

    t_phase = time.perf_counter()
    cluster = q3["cluster"]
    s = cluster.session()
    out: dict = {"reads": {}}
    os.makedirs(args.data_dir, exist_ok=True)
    d = tempfile.mkdtemp(prefix="p20_", dir=args.data_dir)
    try:
        rf1 = make_rf1({"orders": q3["tables"]["orders"],
                        "customer": q3["tables"]["customer"]},
                       args.q3_sf, args.seed + 20)
        # the 25th-32nd slots of a block: keys no earlier batch took
        rf1["lineitem"]["l_orderkey"] = rf1["lineitem"]["l_orderkey"] + 16
        _orders, ltbl = rf1_tbl(
            rf1, q3["tables"]["orders"]["o_comment"].vocab, args.seed + 21)
        path = os.path.join(d, "lineitem.tbl")
        n = write_tbl(path, ltbl)
        s.execute("set fault_injection = on")
        armed = s.query("select pg_fault_inject('fused/delta_tail_upload', "
                        "'error', 'once')")
        t0 = time.perf_counter()
        if s.execute(f"copy lineitem from '{path}' delimiter '|'"
                     ).rowcount != n:
            raise AssertionError("phase 20 (a): COPY lineitem row count")
        copy_ms = (time.perf_counter() - t0) * 1000
        li = _concat(li, {k: rf1["lineitem"][k] for k in li})
        want = expected_q6(li)
        fx = cluster.fused_executor()
        c0 = dict(fx.cache.stats)
        sa.scan_agg.launches = 0
        err, fail_ms = _expect_fault("phase 20 (a): Q6 under "
                                     "fused/delta_tail_upload",
                                     lambda: s.query(Q6))
        faulted_k1 = sa.scan_agg.launches
        faulted = {k: fx.cache.stats[k] - c0[k] for k in REFRESH_STATS}
        if faulted_k1 or s.last_route == "host" or any(faulted.values()):
            raise AssertionError(
                f"phase 20 (a): the faulted Q6 launched K1 {faulted_k1} "
                f"times on route {s.last_route}, refresh {faulted}")
        c1 = dict(fx.cache.stats)
        q6 = "TPC-H Q6 (spec) after the faulted refresh"
        out["reads"][q6] = r = p17_query(q6, s, Q6, want, card, scan_agg=1)
        refresh = {k: fx.cache.stats[k] - c1[k] for k in REFRESH_STATS}
        if refresh["full_uploads"] or refresh["delta_tail_rows"] != n:
            raise AssertionError(f"{q6}: refresh {refresh}, want a delta "
                                 f"tail of the batch's {n} rows")
        r["refresh"] = refresh
        print(f"fault: fused/delta_tail_upload armed error once "
              f"({armed}); RF1's lineitem volume, {n} rows, COPYed in "
              f"{copy_ms:.3f} ms; Q6 raised the injected error in "
              f"{fail_ms:.3f} ms ({err}), 0 K1 launches, no tail written; "
              f"Q6 again exact on K1 (1 launch) in {r['ms']:.3f} ms, the "
              f"refresh " + ", ".join(f"{k} {v}" for k, v in refresh.items())
              + f" [{card}]", flush=True)

        s.execute("set enable_fused_execution = off")
        s.query("select pg_fault_inject('storage/delta_scan', 'error', "
                "'once')")
        err, fail_ms = _expect_fault("phase 20 (a): Q6 under "
                                     "storage/delta_scan",
                                     lambda: s.query(Q6))
        q6h = "TPC-H Q6 (spec, host route) after the faulted delta scan"
        out["reads"][q6h] = rh = p17_query(q6h, s, Q6, want, card,
                                           scan_agg=0)
        s.execute("reset enable_fused_execution")
        rows = s.query(f"select {P20_FAULT_COLS} from pg_stat_faults "
                       "order by site")
        fired = {row[1]: row[6] for row in rows}
        if (fired.get("fused/delta_tail_upload") != 1
                or fired.get("storage/delta_scan") != 1
                or any(row[7] for row in rows)):
            raise AssertionError(f"pg_stat_faults: {rows}")
        cleared = s.query("select pg_fault_clear()")[0][0]
        print(f"fault: storage/delta_scan armed error once: the host "
              f"route's Q6 failed in {fail_ms:.3f} ms ({err}), the rerun "
              f"exact in {rh['ms']:.3f} ms (0 K1 launches); pg_stat_faults "
              f"{rows}; pg_fault_clear() cleared {cleared} [{card}]",
              flush=True)
        out.update(copy_ms=copy_ms, refresh=refresh, faults=rows,
                   refresh_ms=r["ms"], faulted_k1=faulted_k1)
    finally:
        fault.clear()
        s.execute("set fault_injection = off")
        shutil.rmtree(d, ignore_errors=True)
    print(f"time: phase 20 (a) {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return out


def run_phase20_crash(cluster, s, ans: dict, args, card: str) -> dict:
    """Phase 20 (b), in phase 12 after phase 19 (b), fused route off:
    each datanode pool holds P20_WARM_CHANNELS channels open, then
    pg_fault_inject('dn/exec_fragment', 'crash_node', 'node=1, once')
    reaches both processes; Q6 and Q1 (spec) answer exactly through the
    retry and the failover to the coordinator's stores; pg_stat_faults
    shows datanode 1's fired count; pg_fault_clear() revives it and Q6
    runs in both processes again."""
    from opentenbase_tpu_torch import fault
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    t_phase = time.perf_counter()
    out: dict = {"queries": {}}
    for pool in cluster.dn_channels.values():
        chans = [pool.acquire() for _ in range(P20_WARM_CHANNELS)]
        for ch in chans:
            pool.release(ch)
    s.execute("set fault_injection = on")
    s.execute("set fragment_retries = 1")
    s.execute("set fragment_retry_backoff_ms = 5")
    heal0 = dict(cluster.frag_heal_stats)
    try:
        _site, reached = s.query(
            "select pg_fault_inject('dn/exec_fragment', 'crash_node', "
            "'node=1, once')")[0]
        if reached != 2:
            raise AssertionError(f"pg_fault_inject reached {reached} "
                                 "datanode processes, want 2")
        for name, sql in (("Q6", Q6), ("Q1 (spec)", Q1_SPEC)):
            h0 = dict(cluster.frag_heal_stats)
            sa.scan_agg.launches = rp.radix_probe.launches = 0
            t0 = time.perf_counter()
            got = s.query(sql)
            ms = (time.perf_counter() - t0) * 1000
            launches = {"scan_agg": sa.scan_agg.launches,
                        "radix_probe": rp.radix_probe.launches}
            equal_to(name, ans[name])(got)
            heal = {k: cluster.frag_heal_stats[k] - h0[k] for k in h0}
            moved = [(i["node"], i.get("remote", False), i.get("failover"))
                     for i in s.last_executor.instrumentation]
            if heal != {"retries": 1, "failovers": 1} or (
                    1, False, "local") not in moved:
                raise AssertionError(f"{name} under the crash: {heal}, "
                                     f"fragments {moved}")
            # the failed-over fragment runs the host route on the
            # coordinator's stores: no kernel of this process launches
            if any(launches.values()):
                raise AssertionError(f"{name} under the crash: a kernel "
                                     f"launched in the coordinator: "
                                     f"{launches}")
            out["queries"][f"topology {name} through a datanode crash"] = {
                "route": "dn", "e2e": ms, "heal": heal,
                "launches": launches}
            print(f"fault: TPC-H {name} through the datanodes with dn1 "
                  f"crashed exact in {ms:.3f} ms: {heal['retries']} retry, "
                  f"{heal['failovers']} failover to the coordinator's "
                  f"stores (fragments (node, remote, failover) {moved}) "
                  f"[{card}]", flush=True)
        rows = s.query(f"select {P20_FAULT_COLS} from pg_stat_faults "
                       "where site = 'dn/exec_fragment' order by node")
        fired = {row[0]: row[6] for row in rows}
        if fired.get("dn1") != 1 or fired.get("dn0", 0) != 0:
            raise AssertionError(f"pg_stat_faults: {rows}")
        cleared = s.query("select pg_fault_clear()")[0][0]
        r = dn_query("TPC-H Q6 through the datanodes after pg_fault_clear",
                     s, Q6, equal_to("Q6", ans["Q6"]), args, card)
        out["queries"]["topology Q6 after pg_fault_clear (datanodes)"] = r
        heal = {k: cluster.frag_heal_stats[k] - heal0[k] for k in heal0}
        print(f"fault: dn/exec_fragment crash_node node=1 once reached "
              f"both processes; pg_stat_faults {rows}; pg_fault_clear() "
              f"cleared {cleared} and revived dn1: Q6 in both processes "
              f"again, first {r['first_ms']:.3f} ms; retries / failovers "
              f"in all {heal['retries']} / {heal['failovers']} [{card}]",
              flush=True)
        out.update(faults=rows, heal=heal, cleared=cleared)
    finally:
        fault.clear()
        for sql in ("reset fragment_retries",
                    "reset fragment_retry_backoff_ms",
                    "set fault_injection = off"):
            s.execute(sql)
    print(f"time: phase 20 (b) {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return out


def run_phase20_chaos(d: str, device, card: str) -> dict:
    """Phase 20 (d): the seeded chaos schedule of tests/test_ha.py (seed
    4242, 4 s, two datanodes, detect 900 ms over 3 beats) on an
    HATopology on the card: its verdict ``ok``, one promotion, the
    revived ex-primary's probe refused."""
    import shutil

    from opentenbase_tpu_torch import fault
    from opentenbase_tpu_torch.fault.schedule import (
        ChaosSchedule,
        run_schedule,
    )

    t0 = time.perf_counter()
    sched = ChaosSchedule.generate(4242, duration_s=4.0, num_datanodes=2)
    try:
        v = run_schedule(sched, d, detect_ms=900, beats=3, device=device)
    finally:
        fault.clear()
        fault.install_matrix(None)
        shutil.rmtree(d, ignore_errors=True)
    secs = time.perf_counter() - t0
    if (v["chaos_gate"] != "ok" or v["promotions"] != 1
            or v.get("fenced_probe") != "refused"):
        raise AssertionError(f"chaos schedule 4242: {v}")
    print(f"fault: chaos schedule 4242 (4 s, {len(sched.events)} events: "
          + "; ".join(v["events"]) + f") on an HATopology on {device}: "
          f"chaos_gate {v['chaos_gate']}, {v['promotions']} promotion, "
          f"acked writes {v['acked_writes']}, lost {v['lost_acked_writes']}"
          f", indeterminate {v['indeterminate_writes']}, reads "
          f"{v['reads_ok']}, detected {v.get('detect_latency_ms')} ms after "
          f"the crash (budget {v.get('detect_budget_ms')} ms), fenced probe "
          f"{v['fenced_probe']}, the ex-primary resynced "
          f"{v['resync']['rows']} rows; {secs:.1f} s [{card}]", flush=True)
    out = {k: v.get(k) for k in (
        "chaos_gate", "promotions", "acked_writes", "lost_acked_writes",
        "indeterminate_writes", "reads_ok", "detect_latency_ms",
        "detect_budget_ms", "fenced_probe")}
    out["s"] = secs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--rows", type=int, default=60_000_000)
    ap.add_argument("--ssb-rows", type=int, default=60_000_000)
    ap.add_argument("--q3-sf", type=float, default=10.0)
    ap.add_argument("--hits-rows", type=int, default=60_000_000)
    ap.add_argument("--sf100-rows", type=int, default=SF100_ROWS)
    ap.add_argument("--chunk-sf", type=float, default=30.0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--data-dir", default=os.path.join(
        ROOT, ".benchtmp", "chip_smoke"),
        help="phase 11's data directories (removed at the end)")
    args = ap.parse_args(argv)
    t_run = time.perf_counter()

    def done(label: str) -> None:
        """How far into the run each phase ended (one time limit covers
        the whole script)."""
        print(f"time: {label} done at {time.perf_counter() - t_run:.1f} s",
              flush=True)

    # bench.py's knobs for its SF100 leg, set before the port reads them
    # at import: the 151 M-row orders side must pass the fold gate, and
    # Q6's four resident columns (9.7 GB) must stay on K1's route
    os.environ.setdefault("OTB_DIMFOLD_MAX", "260000000")
    os.environ.setdefault("OTB_SCAN_HBM_BUDGET", "11000000000")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "opentenbase_tpu_torch")):
        print("chip_smoke: opentenbase_tpu_torch not found beside the "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from opentenbase_tpu_torch.ops import cuda_build
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch device {name}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    rate = hbm_rate(name)
    device = torch.device("cuda", 0)

    from opentenbase_tpu_torch.gtm.client import build_server

    t0 = time.perf_counter()
    # the GTM's server (g++) builds beside the kernels (nvcc)
    gtm_build = start_threads({"gts_server": build_server})
    libs = cuda_build.build(*cuda_build.SOURCES)
    sa._load()
    rp._load()
    print(f"build: {', '.join('csrc/' + k for k in libs)} in "
          f"{time.perf_counter() - t0:.3f} s (one nvcc each, in parallel)",
          flush=True)
    gtm_bin = gtm_build()["gts_server"]
    print(f"build: opentenbase_tpu_torch/gtm/native/gts_server.cpp (g++ "
          f"-O2, beside nvcc) -> {os.path.relpath(gtm_bin, ROOT)}, all "
          f"built {time.perf_counter() - t0:.3f} s after the first began",
          flush=True)
    for src in libs:
        report = ptxas_summary(cuda_build.ptxas_logs.get(src))
        print(f"build: csrc/{src}: {report}", flush=True)

    check_kernel_vs_plain(device, args.seed, card, args.rows)
    check_radix_vs_plain(device, args.seed, card, args.ssb_rows)
    done("build and kernel checks (phases 2-3)")
    main_run = run_main_path(args, device, card)
    rows = time_kernels(main_run, card, rate)
    topk = {"Q3 dense": run_q3_dense(main_run, args, card)}
    done("TPC-H Q6, Q1, dense Q3 (phases 4, 5c)")
    e2e_tpch, layers_tpch, trace_tpch, launches_tpch, k2_tpch = (
        main_run["e2e"], main_run["breakdown"], main_run["trace"],
        main_run["launches"], main_run["k2_launches"])
    del main_run  # free lineitem's planes before SSB loads (the cluster
    gc.collect()  # and its executors hold each other: a cycle)
    torch.cuda.empty_cache()
    ssb_run = run_ssb_path(args, device, card)
    grouped_run = run_ssb_grouped(ssb_run, args, card)
    radix_rows = time_radix(ssb_run, card, rate,
                            {**SSB_Q, **SSB_GROUPED_Q})
    # phase 8 (c): flight 1 again after a DELETE, in the same cluster,
    # after every earlier query and timing of its tables
    ssb_del = run_ssb_delete(ssb_run, args, card)
    radix_rows += time_radix(ssb_run, card, rate, ssb_del["queries"])
    # phase 17 (a, c): join_mode and EXPLAIN ANALYZE on SSB Q1.1
    p17_ssb = run_phase17_ssb(ssb_run, ssb_del["wants"]["Q1.1"], card)
    # phase 11 (b): SSB Q1.1 over the PostgreSQL wire, after the DELETE
    pgwire = run_pgwire(ssb_run, ssb_del.pop("wants")["Q1.1"], card)
    done("SSB (phases 5, 5b, 8c, 11b)")
    ssb_launches = {**ssb_run["launches"], **grouped_run["launches"],
                    **ssb_del["launches"]}
    del ssb_run["cluster"], ssb_run["session"]  # free SSB's planes
    gc.collect()
    torch.cuda.empty_cache()
    topk["Q3 spec"] = run_q3_spec(args, device, card)
    done("TPC-H SF10 spec Q3, Q1 (phases 5c, 5d)")
    # phase 9 (a-c, e): Q4, join rows, gseg and the zone window in Q3's
    # cluster, before phase 8 writes into it
    p10_answers = start_phase10_answers(topk["Q3 spec"]["phase8"]["tables"])
    phase9 = run_phase9(topk["Q3 spec"]["phase8"], args, card)
    topk.update(phase9["dag"])
    done("phase 9 a-c, e")
    # phase 10 (b): the host route in the same cluster, before phase 8
    host = run_phase10(topk["Q3 spec"]["phase8"], args, card, p10_answers)
    done("phase 10b")
    # phase 15: the expression library and the query sugar, in the same
    # cluster before phase 8 writes into it
    phase15 = run_phase15(topk["Q3 spec"]["phase8"], args, card)
    done("phase 15")
    radix_rows += phase9["radix_rows"]
    ssb_launches.update(phase9["k2_launches"])
    # phase 8 (a): TPC-H's refresh functions into Q3's tables, after
    # every earlier query of them; (b) bench.py's HTAP loop
    q3_state = topk["Q3 spec"].pop("phase8")
    refresh = run_refresh(q3_state, args, card)
    host.update(refresh.pop("txn_reads"))  # phase 10 (c)
    done("RF1, RF2 (phases 8a, 10c)")
    # phase 16: the DML and transaction statements, after RF2
    state16 = refresh.pop("state")
    phase16 = run_phase16(q3_state, state16, args, card)
    done("phase 16")
    # phase 17: the session statements and introspection, after phase 16
    phase17 = run_phase17(q3_state, state16, args, card)
    done("phase 17")
    # phase 18: partitioned tables, WITH RECURSIVE, PL/pgSQL and foreign
    # tables, after phase 17
    phase18 = run_phase18(q3_state, phase17, state16, args, card)
    done("phase 18")
    # phase 19 (a): workload management in the same cluster, after 18
    phase19 = run_phase19_wlm(q3_state, phase17["lineitem"], card)
    done("phase 19 (a)")
    # phase 20 (a): faults on the fused and host routes, after 19 (a)
    phase20 = run_phase20_fused(q3_state, phase17["lineitem"], args, card)
    del state16, phase17["rf1_orders"], phase17["lineitem"]
    done("phase 20 (a)")
    # phase 12 reuses phase 5c's arrays and numpy's answers at the end
    q3_tables, q3_answers = q3_state.pop("tables"), q3_state.pop("answers")
    del q3_state
    gc.collect()  # Q3's cluster, before the next cluster loads
    torch.cuda.empty_cache()
    htap = run_htap(args, device, card)
    done("HTAP loop (phase 8b)")
    gc.collect()
    torch.cuda.empty_cache()
    topk["ClickBench"] = run_clickbench(args, device, card)
    done("ClickBench (phases 5c, 5d)")
    gc.collect()  # hits' cluster, before the full hits loads
    torch.cuda.empty_cache()
    host.update(run_clickbench_full(args, device, card))  # phase 10 (a)
    done("ClickBench at 99 997 497 rows (phase 10a)")
    gc.collect()  # the full hits' cluster, before the SF100 tables load
    torch.cuda.empty_cache()
    sf100 = run_sf100(args, device, card)
    done("SF100 (phase 7)")
    gc.collect()  # SF100's tables, before phase 9d loads SF30's lineitem
    torch.cuda.empty_cache()
    chunked = run_chunked(args, device, card)
    chunk_sf_used = chunked.pop("sf")
    done("SF30 chunked scan (phase 9d)")
    gc.collect()
    torch.cuda.empty_cache()
    # phase 11 (a): the durable cluster over the JSON wire, recovered;
    # (c): otb_server as a process, SIGKILLed under otb_bench, recovered
    durable = run_durable(args, device, card)
    done("durable cluster and recovery (phase 11a)")
    crash = run_crash(args, device, card)
    done("otb_server crash and --recover (phase 11c)")
    # phase 12: phase 5c's arrays in the process topology (last: its
    # 4.4 GB of WAL a replica and three processes on the card touch
    # nothing after it)
    # phase 13: self-healing HA on phase 12's live topology
    # phase 14: the GTM on the same topology, between 12 and 13
    topology = run_topology(q3_tables, args, device, card, q3_answers,
                            done=done)
    del q3_tables, q3_answers
    done("self-healing HA (phase 13)")
    # K1's and K2's launches in every path's run, the new queries too
    path_launches = {
        "scan_agg": {**launches_tpch, **ssb_run["k1_launches"],
                     **grouped_run["k1_launches"]},
        "radix_probe": {**k2_tpch, **ssb_launches},
    }
    # phase 6's queries ran in phase 5c's clusters
    frag = {**topk["Q3 spec"].pop("fragment"),
            **topk["ClickBench"].pop("fragment"), **phase9["fragment"],
            **chunked}
    p19d = durable["phase19"]
    k1_rows = (topk["ClickBench"].pop("k1_rows") + refresh.pop("k1_rows")
               + sf100.pop("k1_rows") + phase16["k1_rows"]
               + phase17["k1_rows"] + phase18["k1_rows"] + p19d["k1_rows"])
    sf100_rows_n, windows = sf100.pop("rows"), sf100.pop("windows")
    frag.update(sf100)
    frag.update(host)
    for label in ("before RF1", "after RF1", "after RF2"):
        for q, r in refresh[label].items():
            (topk if "Q3" in q else frag)[q] = r
    frag.update(phase16["fragment"])
    topk.update(phase16["topk"])
    for q, r in {**durable["queries"], **topology["queries"],
                 **phase15, **phase16["reads"], **phase17["reads"],
                 **phase18["reads"], **phase19["reads"], **p19d["reads"],
                 **topology["parallel"]["queries"], **phase20["reads"],
                 **topology["phase20"]["queries"],
                 **p17_ssb, "topology EXPLAIN ANALYZE Q1 (spec)":
                 topology["explain"]}.items():
        for k, n in r["launches"].items():
            path_launches[k][q] = n
    path_launches["scan_agg"]["phase 19 (a): the two queued Q6s"] = (
        phase19["queue"]["k1"])
    path_launches["scan_agg"]["phase 20 (a): Q6 under the armed fault"] = (
        phase20["faulted_k1"])
    path_launches["scan_agg"]["phase 19 (c): matview populate"] = (
        p19d["populate"]["launches"])
    for mode, r in p19d["refresh"].items():
        path_launches["scan_agg"][f"phase 19 (c): REFRESH {mode}"] = (
            r["launches"])
    path_launches["radix_probe"]["pgwire SSB Q1.1"] = pgwire["launches"][
        "radix_probe"]
    path_launches["scan_agg"]["HTAP loop"] = htap["launches"]["scan_agg"]
    path_launches["radix_probe"]["HTAP loop"] = htap["launches"][
        "radix_probe"]
    for q, r in {**topk, **frag}.items():
        for k, n in r["launches"].items():
            path_launches[k][q] = n

    kernels = []
    for r in rows:
        kernels.append({
            "name": f"scan_agg ({r['query']} shape)",
            "route": "cuda",
            "source": "opentenbase_tpu_torch/csrc/scan_agg.cu",
            "replaces": "opentenbase_tpu/ops/pallas_scan.py:317",
            "launches": launches_tpch[r["query"]],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "gbps": r["bytes"] / r["ms"] / 1e6,
            "library_ms": None,
            "path_launches": path_launches["scan_agg"],
        })
    k1_src = {**frag, **phase17["reads"], **phase18["reads"],
              **{r["query"]: {"launches": {
                  "scan_agg": p19d["populate"]["launches"]}}
                 for r in p19d["k1_rows"]}}
    for r in k1_rows:
        kernels.append({
            "name": f"scan_agg ({r['query']} shape)",
            "route": "cuda",
            "source": "opentenbase_tpu_torch/csrc/scan_agg.cu",
            "replaces": "opentenbase_tpu/ops/pallas_scan.py:317",
            "launches": k1_src[r["query"]]["launches"]["scan_agg"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "gbps": r["bytes"] / r["ms"] / 1e6,
            "library_ms": None,
            "path_launches": path_launches["scan_agg"],
        })
    for r in radix_rows:
        kernels.append({
            "name": f"radix_probe ({r['query']} shape)",
            "route": "cuda",
            "source": "opentenbase_tpu_torch/csrc/radix_probe.cu",
            "replaces": "opentenbase_tpu/ops/pallas_join.py:85",
            "launches": ssb_launches[r["query"]],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "gbps": r["bytes"] / r["ms"] / 1e6,
            "library_ms": None,
            "path_launches": path_launches["radix_probe"],
        })
    # the JSON counts each trace's device event kinds; the trace lines
    # of the TPC-H queries name them
    late = {**topk, **frag}
    trace = {q: {**{k: v for k, v in tr.items()
                    if k not in ("events", "top")},
                 "event_kinds": len(tr["events"])}
             for q, tr in {**trace_tpch, **ssb_run["trace"],
                           **grouped_run["trace"],
                           **{q: r["trace"] for q, r in late.items()}}.items()}
    print(json.dumps({"kernels": kernels,
                      "e2e_ms": {**e2e_tpch, **ssb_run["e2e"],
                                 **grouped_run["e2e"], **ssb_del["e2e"],
                                 **{q: r["e2e"] for q, r in late.items()}},
                      "layers_ms": {**layers_tpch, **ssb_run["breakdown"],
                                    **grouped_run["breakdown"],
                                    **{q: r["layers"]
                                       for q, r in late.items()}},
                      "routes": {q: r["route"] for q, r in frag.items()},
                      "memory_gb": {q: [r["resident_gb"], r["peak_gb"]]
                                    for q, r in late.items()},
                      "trace": trace,
                      "rows": args.rows, "ssb_rows": args.ssb_rows,
                      "q3_sf": args.q3_sf, "hits_rows": args.hits_rows,
                      "sf100_rows": sf100_rows_n,
                      "sf100_q3_windows": windows,
                      "chunk_sf": chunk_sf_used,
                      "chunk_windows": {q: r["windows"]
                                        for q, r in chunked.items()},
                      "write_ms": {"RF1": refresh["RF1 ms"],
                                   "RF2": refresh["RF2 ms"],
                                   **phase16["writes"],
                                   **phase18["writes"]},
                      "phase18_iterations": {
                          q: r["iterations"]
                          for q, r in phase18["reads"].items()
                          if "iterations" in r},
                      "htap": {k: htap[k] for k in
                               ("rows_per_sec", "scans", "cache",
                                "rows_per_sec_fold", "folds")},
                      "phase17": {
                          "rates": phase17["rates"],
                          "explain_ms": {
                              q: {k: r[k] for k in r if k.endswith("_ms")}
                              for q, r in {**phase17["reads"], **p17_ssb,
                                           "topology Q1 (spec)":
                                           topology["explain"]}.items()
                              if q.startswith(("EXPLAIN", "topology"))}},
                      "durable": {
                          "recovery": durable["recovery"],
                          "wire_ms": {q: r["ms"] for q, r in
                                      durable["queries"].items()},
                          "pgwire_ms": pgwire["ms"],
                          "tpcb": {k: crash[k] for k in
                                   ("tps", "acked", "history", "restart_s",
                                    "fs")}},
                      "topology": {
                          "e2e_ms": {q: r["e2e"] for q, r in
                                     topology["queries"].items()},
                          "wire_bytes": {q: r["wire_bytes"] for q, r in
                                         topology["queries"].items()
                                         if "wire_bytes" in r},
                          "catchup_s": topology["catchup"]["s"],
                          "rf1": topology["rf1"], "sync_ms": topology["sync"],
                          "replica_read_ms": topology["replica_read_ms"],
                          "fs": topology["fs"]},
                      "gtm": topology["gtm"],
                      "failover": topology["failover"],
                      "faults": {
                          "fused": {k: phase20[k] for k in (
                              "copy_ms", "refresh_ms", "refresh")},
                          "crash": {k: topology["phase20"][k] for k in (
                              "heal", "cleared")}},
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

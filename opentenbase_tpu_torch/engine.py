"""Cluster and Session: the SQL entry point of the port (subset of the
reference's opentenbase_tpu/engine.py).

Statements: ``create table ... distribute by
roundrobin|shard(...)|hash(...)|modulo(...)|replication`` with NOT
NULL, PRIMARY KEY and DEFAULT; ``insert ... values|select`` with ``on
conflict`` and ``returning``, ``delete [using]`` and ``update [from]``
with ``returning``, each in an implicit transaction or inside ``begin
... commit|rollback`` with ``savepoint``, ``rollback to savepoint`` and
``release savepoint``; ``select ... for update|for share [nowait]`` and
``lock table``; ``truncate``; ``alter table ... add column|drop
column|distribute by|add partitions``; interval / range partitioned
tables (``partition by range (col) begin (v) step (s) partitions (n)``:
a catalog-only parent over real children ``parent$pK``, reads rewritten
into a UNION ALL of the children WHERE does not prune, INSERT and COPY
split by the boundaries, UPDATE / DELETE fanned out); ``with recursive``
(each self-referencing CTE materialized to its fixpoint in temporary
tables before analysis); ``create function ... language plpgsql`` (a
call runs its body at rewrite time, atomically); ``create foreign table
... server file`` (read from its source at scan time, fdw.py);
``vacuum``; ``create index`` (zone maps: the
columns register for the fragment program's block pruning);
``analyze`` (the planner's row and
distinct-value estimates); ``set`` / ``reset enable_fused_execution``;
``prepare transaction``, ``commit prepared`` and ``rollback prepared``;
``create`` / ``drop sequence`` with ``nextval``, ``currval`` and
``setval`` in INSERT VALUES rows and FROM-less SELECTs;
``select pg_resolve_indoubt([min_age_s])``;
and ``select`` through analyze -> optimize -> distribute -> the fused
executors (a single fragment through the scan-aggregate kernel or the
fragment program, joins through the fused DAG) and the coordinator
merge, or, where the fused executors decline as the reference's do,
the host executor (executor/dist.py). Anything else raises NotPorted.

Transactions run under snapshot isolation: a write parks its rows as
delta batches at PENDING_TS and records its deleted positions; commit
stamps every insert range's xmin and every deleted position's xmax at
one commit timestamp. UPDATE and DELETE take row locks keyed by stable
row ids and fail with SQLSTATE 40001 when a concurrent transaction
committed a change to a row first.

Datanode processes (``attach_datanode``, dn/server.py) follow the WAL
through a walsender and run the host route's fragments remotely
(executor/dist.py, ``min_lsn`` = the WAL end: read-your-writes). A
commit touching more than one node with a datanode process attached is
an implicit 2PC: every participant journals a vote carrying the write
set (``2pc_prepare``), the 'G' frame is tagged with the gid, and
``2pc_commit`` applies the journal ahead of the stream.
``synchronous_commit = on`` then waits until every reachable datanode
applied the commit's frame, ``remote_write`` until a majority of the
standbys acked it. PREPARE TRANSACTION parks the transaction under its
gid (``cluster._prepared``, the GTM's registry, a 'T' WAL record with
its writes, its delete targets reserved at RESERVED_TS) until COMMIT
or ROLLBACK PREPARED, from any session or after a recovery;
``clean_2pc`` (``start_clean2pc``) retires stale prepared transactions
and orphaned votes, ``resolve_indoubt`` (``start_indoubt_resolver``,
``pg_resolve_indoubt``) drives the GTM's registry and the datanodes'
votes to the WAL's decision.

Self-healing HA (ha.py, storage/replication.py): ``node_generation``
is the timeline's fencing generation, carried on every datanode RPC
(``hgen``). A datanode at a newer generation refuses a stale caller
(``ChannelFenced``); the session then demotes the cluster
(``ha_demoted``), and from then on every statement is refused with
SQLSTATE 72000, as is every statement while a ``serving_lease`` is not
valid. A cluster with a data directory reads
``<data_dir>/opentenbase.conf`` into ``conf_gucs`` (config.py), its
sessions' defaults.

Durability (``Cluster(..., data_dir=D)``, storage/persist.py): every
commit is one WAL 'G' frame, written inside the stamping fence and
made durable by the group flush before the statement returns
(``synchronous_commit`` ``local``; ``off`` skips the fsync wait); DDL
(CREATE TABLE with its constraints, CREATE INDEX, DROP TABLE, TRUNCATE,
ALTER TABLE, CREATE/DROP USER) and dictionary growth are 'D' records; a
VACUUM that removed rows and an ALTER TABLE ... DISTRIBUTE BY take a
checkpoint. With ``delta_compaction_naptime_ms`` in the conf file a
background job folds pending delta batches (storage/compaction.py).
``Cluster.recover(D, ...)`` restores the checkpoint and
replays the WAL tail. ``cluster._exec_lock`` is the wire servers'
statement lock (net/), ``cluster._fused_lock`` serializes the fused
executors' shared device state between concurrent readers.

Workload management (wlm/): ``create`` / ``alter`` / ``drop resource
group ... with (concurrency, memory_limit, queue_depth, priority)`` and
``alter role ... resource group``, logged as ``wlm_state`` records; an
autocommit resource-consuming statement is admitted, queued (its
statement-lock slot parked) or shed (53000, 53200; 57014 when its wait
outlives statement_timeout or wlm_queue_timeout) before any fragment is
dispatched, on either route (``Session._wlm_admit``). Materialized
views (matview/): ``create`` / ``refresh [concurrently]`` / ``drop
materialized view``, refreshed incrementally from the WAL's deltas
where the shape allows, a SELECT equal to a fresh one's definition
answered from it (``enable_matview_rewrite``); their rows change only
through REFRESH (42809), and a table or view they read is dropped only
with CASCADE (2BP01). Committed writes advance ``table_version``, the
rewrite's evidence of staleness. Logical replication
(storage/logical.py): ``create`` / ``drop publication`` and
``subscription`` (an apply worker pulling ``pg_logical_slot_changes``
and ``pg_logical_sync`` from the publisher's JSON server).

Snapshots and commit timestamps come from ``cluster.gts``, the GTM
(gtm/): an in-process ``GTSServer``, or with ``gts_backend="native"``
the C++ server as its own process behind ``NativeGTS``. Its hybrid
timestamps are wall-clock ms << 20 plus a logical counter (about 2^60.7
today), below the storage sentinels. Commit grants batch through
``GtsCommitBatcher``, and the cluster's stamping fence
(``commit_ts_begin_stamping`` / ``clamped_snapshot``) keeps a snapshot
off a commit timestamp whose stamps have not all landed, a GTS round
trip in flight included. The GTM holds the cluster's sequences (their
events are WAL 'D' records, so standbys replicate them) and its node
registry. ``cluster.stores[node][table]`` and ``cluster.gts.get_gts()``
keep the reference's names, so a loader that appends straight into the
stores (bench.py's ``_bulk_append``) works unchanged.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import itertools
import logging
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from opentenbase_tpu_torch import config as _config
from opentenbase_tpu_torch import fault as _fault
from opentenbase_tpu_torch import sysviews
from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.catalog import Catalog, TableMeta
from opentenbase_tpu_torch.catalog.distribution import (
    DistributionSpec,
    DistStrategy,
)
from opentenbase_tpu_torch.catalog.nodes import NodeDef, NodeManager, NodeRole
from opentenbase_tpu_torch.catalog.shardmap import ShardMap
from opentenbase_tpu_torch.device import resolve_device
from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.executor.dist import (
    DistExecutor,
    StatementTimeout,
    concat_batches,
)
from opentenbase_tpu_torch.executor.fused import (
    FusedExecutor,
    FusedUnsupported,
)
from opentenbase_tpu_torch.executor.fused_dag import DagUnsupported
from opentenbase_tpu_torch.executor.local import (
    LocalExecutor,
    np_expr_eval,
    predicate_rows,
)
from opentenbase_tpu_torch.fault import FAULT, FaultError
from opentenbase_tpu_torch.gtm.gts import (
    GTSAdvanceError,
    GTSServer,
    advance_limit_ms,
    stamp_lead_ms,
)
from opentenbase_tpu_torch.lmgr import (
    ROW_SHARE,
    ROW_UPDATE,
    TABLE_SHARED,
    DeadlockError,
    LockManager,
    LockNotAvailable,
    LockTimeout,
    table_lock_mode,
)
from opentenbase_tpu_torch.plan import analyze_statement
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan.distribute import distribute_statement
from opentenbase_tpu_torch.plan.optimize import (
    optimize_statement,
    prune_columns,
)
from opentenbase_tpu_torch.sql import ast as A
from opentenbase_tpu_torch.sql import parse
from opentenbase_tpu_torch.storage.column import Column, column_from_python
from opentenbase_tpu_torch.storage.persist import (
    ClusterPersistence,
    _type_to_str,
    apply_constraints,
    pow2_bucket,
)
from opentenbase_tpu_torch.storage.table import (
    INF_TS,
    PENDING_TS,
    RESERVED_TS,
    ColumnBatch,
    ShardStore,
)
from opentenbase_tpu_torch.utils.rwlock import RWStatementLock

log = logging.getLogger(__name__)


@dataclass
class Result:
    command: str
    rows: list[tuple] = field(default_factory=list)
    columns: list[str] = field(default_factory=list)
    rowcount: int = 0

    def __iter__(self):
        return iter(self.rows)

    @property
    def scalar(self):
        return self.rows[0][0] if self.rows else None


class SQLError(RuntimeError):
    """Statement error (a user mistake or a serialization failure, not a
    shape outside the port). ``sqlstate`` is the PG error code."""

    sqlstate = "XX000"

    def __init__(self, msg: str, sqlstate: Optional[str] = None):
        super().__init__(msg)
        if sqlstate is not None:
            self.sqlstate = sqlstate


# gathered partial rows from which the fused route's coordinator merge
# runs on the cluster's device instead of the CPU
MERGE_DEVICE_ROWS = 1 << 16


def merge_device(cluster, nrows: int) -> torch.device:
    """Where the fused route merges ``nrows`` partial rows. A merge of a
    row per shard or group runs on the CPU, as the reference's runs on
    the host's devices: a few operators over a few rows cost less there
    than their launches and round trips on the card. A merge of millions
    of partial groups (ClickBench's top 10 ships 10.6 M at 60 M rows)
    regroups and sorts them on the cluster's device, which is local."""
    if nrows >= MERGE_DEVICE_ROWS:
        return cluster.device
    return torch.device("cpu")


class GtsCommitBatcher:
    """Batches concurrent sessions' commit-timestamp grants into one
    ``commit_many`` call (gtm/gts.py): the first committer to arrive
    leads and grants for everyone queued behind it, so N concurrent
    commits pay one GTS lock round (in process) or one RPC (a GTM over
    the wire) instead of N. A lone commit leads at once and grants just
    itself. The fsync half of group commit is WAL.flush_to's."""

    def __init__(self, gts):
        self.gts = gts
        self._cv = threading.Condition(threading.Lock())
        self._waiting: list[int] = []
        self._results: dict[int, object] = {}
        self._leader_active = False
        # grants and the rounds that paid for them, rounds by batch size
        # (power-of-two buckets): pg_stat_wal's evidence
        self.grants = 0
        self.rounds = 0
        self.batch_hist: dict[int, int] = {}

    def stat_snapshot(self) -> dict:
        with self._cv:
            return {"grants": self.grants, "rounds": self.rounds,
                    "batch_hist": dict(self.batch_hist)}

    def _grant(self, gxids: list) -> dict:
        gts = self.gts
        many = getattr(gts, "commit_many", None)
        if many is not None and len(gxids) > 1:
            return many(gxids)
        # one failing grant fails only its own session, as without the
        # batcher: a grant the GTS already made durable for another
        # committer must reach it
        out: dict = {}
        for g in gxids:
            try:
                out[g] = gts.commit(g)
            except Exception as e:
                out[g] = e
        return out

    def commit(self, gxid: int) -> int:
        with self._cv:
            self._waiting.append(gxid)
            while self._leader_active:
                if gxid in self._results:
                    return self._take(gxid)
                self._cv.wait(timeout=5.0)
            self._leader_active = True
        try:
            while True:
                with self._cv:
                    batch, self._waiting = self._waiting, []
                if not batch:
                    break
                try:
                    tsmap = self._grant(batch)
                except Exception as e:
                    # every waiter gets the failure, each its own copy:
                    # sessions raising one shared instance at once would
                    # rewrite each other's traceback
                    import copy

                    tsmap = {g: copy.copy(e) for g in batch}
                with self._cv:
                    self.grants += len(batch)
                    self.rounds += 1
                    b = pow2_bucket(len(batch))
                    self.batch_hist[b] = self.batch_hist.get(b, 0) + 1
                    self._results.update(tsmap)
                    self._cv.notify_all()
                    if not self._waiting:
                        break
        finally:
            with self._cv:
                self._leader_active = False
                self._cv.notify_all()
        with self._cv:
            return self._take(gxid)

    def _take(self, gxid: int) -> int:
        """Caller holds ``_cv``."""
        r = self._results.pop(gxid)
        if isinstance(r, Exception):
            raise r
        return r


# ---------------------------------------------------------------------------
# Transaction
# ---------------------------------------------------------------------------


@dataclass
class _TableWrites:
    ins_ranges: list[tuple[int, int]] = field(default_factory=list)
    del_idx: list[int] = field(default_factory=list)


class Transaction:
    """A transaction's write sets: per node and table, the position
    ranges it appended (at PENDING_TS) and the positions it deletes
    (an UPDATE deletes the old row and appends the new one)."""

    def __init__(self, gxid: int, snapshot_ts: int):
        self.gxid = gxid
        self.snapshot_ts = snapshot_ts
        # node index -> table -> writes
        self.writes: dict[int, dict[str, _TableWrites]] = {}
        self.pinned: list[ShardStore] = []
        # set once its writes were undone: an abort runs at most once
        self.aborted = False
        # PREPARE TRANSACTION's gid, and when it was prepared (the
        # clean2pc staleness rule reads it)
        self.prepared_gid: Optional[str] = None
        self.prepared_at = 0.0
        # SAVEPOINT's (name, write-set mark) stack, newest last
        self.savepoints: list[tuple[str, dict]] = []

    def w(self, node: int, table: str) -> _TableWrites:
        return self.writes.setdefault(node, {}).setdefault(
            table, _TableWrites())

    def mark(self) -> dict:
        """Write-set positions now: a failed statement inside an explicit
        transaction rolls back to them (PG's implicit per-statement
        subtransaction; the reference's ``__stmt__`` savepoint)."""
        return {
            (node, table): (len(tw.ins_ranges), len(tw.del_idx))
            for node, tabs in self.writes.items()
            for table, tw in tabs.items()
        }

    def rollback_to(self, mark: dict, stores) -> None:
        for node, tabs in self.writes.items():
            for table, tw in tabs.items():
                n_ins, n_del = mark.get((node, table), (0, 0))
                for s, e in tw.ins_ranges[n_ins:]:
                    stores[node][table].truncate_range(s, e)
                del tw.ins_ranges[n_ins:]
                del tw.del_idx[n_del:]

    # -- savepoints (xact.c's subtransaction stack as write-set marks) ---
    def mark_savepoint(self, name: str) -> None:
        self.savepoints.append((name, self.mark()))

    def _find_savepoint(self, name: str) -> int:
        for i in range(len(self.savepoints) - 1, -1, -1):
            if self.savepoints[i][0] == name:
                return i
        raise SQLError(f'savepoint "{name}" does not exist')

    def rollback_to_savepoint(self, name: str, stores) -> None:
        """Undo the writes after the savepoint; the savepoint stays (PG),
        the later ones go."""
        i = self._find_savepoint(name)
        self.rollback_to(self.savepoints[i][1], stores)
        del self.savepoints[i + 1:]

    def release_savepoint(self, name: str) -> None:
        del self.savepoints[self._find_savepoint(name):]

    def touched_nodes(self) -> list[int]:
        """Nodes holding surviving writes: a node whose writes a
        ROLLBACK TO SAVEPOINT undid is no 2PC participant."""
        return [
            n for n, tabs in self.writes.items()
            if any(tw.ins_ranges or tw.del_idx for tw in tabs.values())
        ]

    def own_writes_view(self) -> dict[int, dict[str, tuple]]:
        return {
            n: {
                tb: (tw.ins_ranges, np.asarray(tw.del_idx, dtype=np.int64))
                for tb, tw in tabs.items()
            }
            for n, tabs in self.writes.items()
        }

    def pin(self, store: ShardStore) -> None:
        """Fence VACUUM out of ``store``: row positions are the write
        set's identifiers until commit or abort."""
        if store not in self.pinned:
            store.pin()
            self.pinned.append(store)

    def unpin_all(self) -> None:
        for s in self.pinned:
            s.unpin()
        self.pinned.clear()


def _assemble_assigned_column(d, v, nrows: int, ty, dictionary) -> Column:
    """One UPDATE SET result column: a scalar result broadcast to
    ``nrows``, dtype coerced, validity kept (shared by the numpy fast
    path and the compiled path, which must agree)."""
    d = np.asarray(d)
    d = np.broadcast_to(d, (nrows,)).copy() if d.ndim == 0 else d[:nrows]
    vv = None
    if v is not None:
        v = np.asarray(v)
        vv = np.broadcast_to(v, (nrows,)).copy() if v.ndim == 0 else v[:nrows]
    return Column(ty, d.astype(ty.np_dtype), vv, dictionary)


class Cluster:
    """One deployment: topology, catalog, per-datanode stores, the lock
    table, the device the fused fragments run on, and (with a
    ``data_dir``) the WAL and checkpoints."""

    def __init__(
        self,
        num_datanodes: int = 2,
        shard_groups: int = 256,
        data_dir: Optional[str] = None,
        device=None,
        gts_backend: str = "python",
    ):
        if gts_backend not in ("python", "native"):
            raise ValueError(f"gts_backend {gts_backend!r}: python or "
                             "native")
        self.device = resolve_device(device)
        # <data_dir>/opentenbase.conf, validated before anything opens:
        # the session defaults and the HA controller's budgets
        self.conf_gucs: dict = _config.load_conf(data_dir)
        self.nodes = NodeManager()
        self.nodes.create_node(NodeDef("cn0", NodeRole.COORDINATOR))
        self.nodes.create_node(NodeDef("gtm0", NodeRole.GTM))
        for i in range(num_datanodes):
            self.nodes.create_node(NodeDef(f"dn{i}", NodeRole.DATANODE))
        self.shardmap = ShardMap(shard_groups)
        self.shardmap.initialize(self.nodes.datanode_indices())
        self.catalog = Catalog(self.nodes, self.shardmap)
        # node index -> table name -> ShardStore
        self.stores: dict[int, dict[str, ShardStore]] = {
            i: {} for i in self.nodes.datanode_indices()
        }
        self.persistence: Optional[ClusterPersistence] = (
            ClusterPersistence(self, data_dir) if data_dir is not None
            else None
        )
        # the GTM: in process, or the C++ server as its own process with
        # its state under the data directory (a fresh temporary
        # directory without one, removed by close())
        self._gts_tmpdir: Optional[str] = None
        if gts_backend == "native":
            from opentenbase_tpu_torch.gtm.client import NativeGTS

            state = data_dir
            if state is None:
                state = self._gts_tmpdir = tempfile.mkdtemp(prefix="gts_")
            gts = NativeGTS.spawn(state)
        else:
            gts = GTSServer(os.path.join(data_dir, "gts.json")
                            if data_dir else None)
        # group commit's GTS leg (``gts`` re-points it)
        self.gts_batcher = GtsCommitBatcher(gts)
        self.gts = gts
        # commit timestamps whose xmin/xmax stamps are landing: a new
        # snapshot waits for them, or past a stall clamps below them, so
        # no reader sees half a transaction; ``_pending_floors`` covers
        # a commit still inside its GTS round trip (its timestamp is
        # strictly above the highest one known issued when it began)
        self._stamping_mu = threading.Lock()
        self._stamping_cond = threading.Condition(self._stamping_mu)
        self._stamping: set = set()
        self._pending_commits = 0
        self._pending_token = 0
        self._pending_floors: dict = {}
        self._issued_hwm = 0
        # explicitly PREPAREd transactions, parked by gid until COMMIT or
        # ROLLBACK PREPARED (twophase.c's state, registered in the GTM)
        self._prepared: dict[str, Transaction] = {}
        # announce the topology to the GTM (register_gtm.c)
        self._gtm_register_all()
        # the wire servers' statement lock: readers share it, autocommit
        # writers take it per table, everything else exclusively; a row
        # lock wait parks the waiter's slot (lmgr.py)
        self._exec_lock = RWStatementLock()
        self.locks = LockManager(self)
        # serializes the fused executors between concurrent readers:
        # the device cache, program caches and the DAG's retry state
        # are shared mutable state
        self._fused_lock = threading.RLock()
        self._session_ids = itertools.count(1)
        self._fused: Optional[FusedExecutor] = None
        # role -> SCRAM verifier (CREATE USER); no roles: trust mode
        self.users: dict[str, dict] = {}
        # view name -> (parsed body, its text); function name ->
        # plan.functions.SqlFunction (both expanded before analysis)
        self.views: dict[str, tuple] = {}
        self.functions: dict = {}
        # interval/range partitioning: parent name -> PartitionSpec (the
        # parent is a catalog-only shell, each partition a real table
        # named parent$pK)
        self.partitions: dict = {}
        # materialized views (matview/): name -> MatviewDef over a real
        # backing table (and an aux partial-state table for incremental
        # aggregates); each table's committed-write counter, the
        # rewrite's evidence of staleness (bump_table_versions)
        self.matviews: dict = {}
        self.table_version: dict[str, int] = {}
        # coordinator-only throwaway tables (a refresh's delta tables):
        # their fragments never ship to a datanode process
        self.local_tables: set = set()
        # logical replication (storage/logical.py): publication name ->
        # {"tables", "nodes"}; subscription name -> its apply worker;
        # publication -> the commit timestamp of the oldest frame its
        # consumer has not confirmed (VACUUM keeps dead rows from there)
        self.publications: dict[str, dict] = {}
        self.subscriptions: dict = {}
        self._slot_horizon_ts: dict[str, Optional[int]] = {}
        # workload management (wlm/): resource groups and the admission
        # controller every session consults before it dispatches
        from opentenbase_tpu_torch.wlm import WorkloadManager

        self.wlm = WorkloadManager()
        # (name, ts) of barriers read back from a WAL, carried into
        # each checkpoint: the reference's recovery reads them there
        self.barriers: list = []
        # sessions inside the commit path (commit_siblings' evidence)
        self._commit_active = 0
        self._commit_active_mu = threading.Lock()
        # True on a hot standby (storage/replication.py): reads only
        self.read_only = False
        # node index -> net.pool.ChannelPool of its datanode process
        self.dn_channels: dict = {}
        # commits whose write set was shipped to datanode processes
        # (pg_stat_dml), zeroed by pg_stat_reset() at stats_reset_at
        self.dml_stats: dict = {"shipped": 0, "stream_only": 0}
        self._dml_stats_mu = threading.Lock()
        # one statement at a time materializes system views (sysviews.py)
        self._sysview_lock = threading.RLock()
        # the in-doubt resolver's counters (pg_stat_2pc), bumped by the
        # admin function, the background resolver and failovers at once
        self.twophase_stats: dict = {
            "resolver_runs": 0, "indoubt_seen": 0, "resolved_commit": 0,
            "resolved_abort": 0, "awaiting_operator": 0,
            "unreachable_datanodes": 0,
        }
        self._2pc_stats_mu = threading.Lock()
        self.stats_reset_at = time.time()
        # the write path's ingest counters (pg_stat_wal)
        self.ingest_stats: dict = {
            "batches": 0, "rows": 0, "rewrites": 0, "rewrite_rows": 0,
            "compactions": 0, "batches_folded": 0,
        }
        self._ingest_stats_mu = threading.Lock()
        # implicit-2PC gids between their prepare and their decision:
        # clean_2pc's sweep leaves their votes alone
        self._open_gids: set = set()
        # self-healing HA: the timeline's fencing generation (bumped and
        # WAL-logged by every promotion); the WAL offset where this
        # timeline stopped being a byte prefix of its predecessor's (0
        # for an original primary), which a walsender hands rejoining
        # standbys as the rewind point; True once a newer generation
        # fenced this node out (every statement refused until it is
        # rejoined as a standby)
        self.node_generation = 0
        self.ha_promote_lsn = 0
        self.ha_demoted = False
        self.ha_stats: dict = {"promotions": 0, "fenced_refusals": 0}
        # the name this coordinator serves under (a promoted datanode
        # takes its own), and its serving lease (ha.ServingLease)
        self.coordinator_name = "cn0"
        self.serving_lease = None
        # remote read fragments retried and failed over to local stores
        self.frag_heal_stats: dict = {"retries": 0, "failovers": 0}
        # the background delta compaction job, where the conf asks for
        # one (storage/compaction.py)
        self._compaction_stop = None
        naptime = int(self.conf_gucs.get("delta_compaction_naptime_ms") or 0)
        if naptime > 0:
            from opentenbase_tpu_torch.storage.compaction import (
                start_compaction,
            )

            self._compaction_stop = start_compaction(
                self, interval_s=naptime / 1000.0)

    @classmethod
    def recover(
        cls,
        data_dir: str,
        num_datanodes: int = 2,
        shard_groups: int = 256,
        until_barrier: Optional[str] = None,
        device=None,
        gts_backend: str = "python",
    ) -> "Cluster":
        """Crash recovery: a cluster rebuilt from ``data_dir``'s
        checkpoint and WAL (the reference's format; recovery to a
        barrier is not ported), its GTM resumed from the state under
        ``data_dir``. Its device cache starts empty: the first query
        uploads."""
        c = cls(num_datanodes, shard_groups, data_dir, device=device,
                gts_backend=gts_backend)
        try:
            c.persistence.recover(until_barrier=until_barrier)
            # matview catalog fix-up: the replayed otb_matview_state rows
            # folded back into the defs, and each one's freshness decided
            # from the WAL tail past its refresh (matview/defs.py)
            if c.matviews:
                from opentenbase_tpu_torch.matview.defs import load_state

                load_state(c)
        except BaseException:
            c.close()
            raise
        # the apply workers of every subscription start again (the
        # logical-replication launcher); they retry until the publisher
        # answers
        for worker in c.subscriptions.values():
            worker.start()
        return c

    def close(self) -> None:
        """Stop the compaction job, close the datanode channels, make the
        WAL's tail durable and close it, and stop a native GTM process.
        Idempotent."""
        if self._compaction_stop is not None:
            self._compaction_stop()
            self._compaction_stop = None
        for worker in list(self.subscriptions.values()):
            worker.stop()
        for node in list(self.dn_channels):
            self.detach_datanode(node)
        if self.persistence is not None:
            self.persistence.wal.close()
        close_gts = getattr(self.gts, "close", None)
        if close_gts is not None:
            close_gts()
        if self._gts_tmpdir is not None:
            shutil.rmtree(self._gts_tmpdir, ignore_errors=True)
            self._gts_tmpdir = None

    @property
    def gts(self):
        """The GTM: a ``GTSServer`` in process, or a ``NativeGTS`` client
        of one over the wire. Assigning it re-points the cluster (a
        promoted standby's front end, a respawned GTM process)."""
        return self._gts

    @gts.setter
    def gts(self, gts) -> None:
        self._gts = gts
        self.gts_batcher.gts = gts
        # a timestamp the GTM has issued (gts_advance_to's floor)
        self._gts_floor = 0
        if (self.persistence is not None and isinstance(gts, GTSServer)
                and gts._on_replicate is None):
            # the GTM's sequence events ride the cluster WAL, so hot
            # standbys and datanode processes replicate sequence state
            # (a GTM over the wire: the sessions log them, _seq_logged)
            gts._on_replicate = self._seq_feed

    # -- the GTM's sequence events in the WAL ----------------------------
    def _seq_feed(self, event: str, payload: dict) -> None:
        """The in-process GTM's replication hook: its sequence events
        become 'D' records (not while recovery replays them)."""
        p = self.persistence
        if event.startswith("seq_") and p is not None and not p._in_recovery:
            p.log_ddl({"op": "seq_event", "event": event,
                       "payload": payload})

    def _seq_logged(self, event: str, payload: dict) -> None:
        """A sequence event the GTM applied over the wire: the same 'D'
        record the in-process GTM's hook writes (which it has already
        written where the GTM is in process)."""
        if not isinstance(self.gts, GTSServer):
            self._seq_feed(event, payload)

    def gts_advance_to(self, ts: int) -> None:
        """Move the GTM's clock past ``ts``: rows carried in from another
        cluster, or recovered, keep their commit timestamps and stay
        visible to the next snapshot. The hybrid clock runs ahead of
        wall time only by what it issued within a millisecond or a
        promotion's watermark jump, so a GTM over the wire (no op sets
        its clock) is waited out until its clock passes ``ts``. A stamp
        further ahead of wall time than ``advance_limit_ms()`` raises
        ``GTSAdvanceError`` on either backend, without waiting."""
        ts = int(ts)
        clock = getattr(self.gts, "clock", None)
        if ts <= (clock.current() if clock is not None else self._gts_floor):
            return  # below a timestamp this GTM already issued
        lead = stamp_lead_ms(ts)
        if lead > advance_limit_ms():
            raise GTSAdvanceError(
                f"timestamp {ts} lies {lead} ms ahead of the GTM's wall "
                f"clock (at most {advance_limit_ms()} ms)")
        if clock is not None:
            clock.advance(ts)
            return
        deadline = time.monotonic() + advance_limit_ms() / 1000.0
        while True:
            now = self.gts.get_gts()
            if now > ts:
                self._gts_floor = now
                return
            if time.monotonic() > deadline:
                raise GTSAdvanceError(
                    f"the GTM's clock ({now}) did not pass {ts} within "
                    f"{advance_limit_ms()} ms")
            time.sleep(min(((ts - now) >> 20) / 1000.0 + 0.001, 1.0))

    # -- datanode processes ----------------------------------------------
    def attach_datanode(
        self, node: int, host: str, port: int, pool_size: int = 4,
        rpc_timeout: float = 120.0,
    ) -> None:
        """Route ``node``'s fragments to a datanode process (dn/server.py)
        through a channel pool: CREATE NODE plus the pooler's
        registration."""
        from opentenbase_tpu_torch.net.pool import ChannelPool

        old = self.dn_channels.get(node)
        if old is not None:
            old.close()
        self.dn_channels[node] = ChannelPool(host, port, pool_size,
                                             rpc_timeout=rpc_timeout)

    def detach_datanode(self, node: int) -> None:
        pool = self.dn_channels.pop(node, None)
        if pool is not None:
            pool.close()

    def wait_standbys_applied(self, lsn: int,
                              timeout_s: float = 10.0) -> bool:
        """The remote_apply wait (``synchronous_commit = on``): until
        every reachable attached datanode reports ``applied`` >= lsn. A
        datanode that fails two probes in a row is skipped (a dead node
        must not wedge every commit), but at least one must confirm."""
        chans = dict(self.dn_channels)
        if not chans:
            return True
        deadline = time.monotonic() + timeout_s
        confirmed: set = set()
        fails: dict[int, int] = {}
        dead: set = set()
        while True:
            for n, ch in chans.items():
                if n in confirmed or n in dead:
                    continue
                try:
                    resp = ch.rpc({"op": "ping"}, timeout_s=2.0)
                    if resp.get("promoted") or (
                            int(resp.get("generation") or 0)
                            > self.node_generation):
                        # a standby that promoted away or follows a
                        # newer timeline applies a diverged WAL: its
                        # offset may pass ``lsn`` with our frame never
                        # replayed there. It can never confirm; the
                        # deadline fails the wait
                        fails.pop(n, None)
                        continue
                    if int(resp.get("applied") or 0) >= lsn:
                        confirmed.add(n)
                    fails.pop(n, None)
                except Exception:
                    fails[n] = fails.get(n, 0) + 1
                    if fails[n] >= 2:
                        dead.add(n)
            if len(confirmed) + len(dead) == len(chans):
                return bool(confirmed)
            if time.monotonic() >= deadline:
                return False  # a reachable standby never caught up
            time.sleep(0.005)

    def wait_standbys_acked(self, lsn: int,
                            timeout_s: float = 10.0) -> bool:
        """The remote_write wait (``synchronous_commit =
        remote_write``): until a majority of the standbys acked receipt
        of ``lsn`` over the replication ack channel (the walsenders'
        ack tables; no per-commit RPC). The standbys are the attached
        datanodes, else every connection of the walsenders."""
        p = self.persistence
        senders = list(p.wal_senders) if p is not None else []
        npeers = sum(len(s.peer_positions()) for s in senders)
        n = len(self.dn_channels) if self.dn_channels else npeers
        if n == 0:
            return True
        if not senders:
            return False  # no walsender: no ack can arrive
        quorum = n // 2 + 1
        deadline = time.monotonic() + timeout_s
        while True:
            # each peer address's best ack once across the senders
            best: dict = {}
            for sd in senders:
                for addr, a in sd.peer_acks():
                    if a > best.get(addr, -1):
                        best[addr] = a
            acks = sorted(best.values(), reverse=True)
            if len(acks) >= quorum and acks[quorum - 1] >= lsn:
                return True
            if time.monotonic() >= deadline:
                return False
            senders[0].wait_quorum_acked(
                lsn, quorum,
                deadline if len(senders) == 1
                else min(deadline, time.monotonic() + 0.05))

    # -- in-doubt 2PC repair (clean2pc.c and contrib/pg_clean) -----------
    def clean_2pc(self, max_age_s: float = 300.0) -> list[str]:
        """Retire stale in-doubt state. A parked PREPAREd transaction
        older than ``max_age_s`` is rolled back (no commit decision was
        ever logged, so abort is the safe side: pg_clean's rule); an
        implicit-2PC gid the GTM still lists with nothing behind it (its
        coordinator died between prepare and commit) is forgotten; and a
        datanode vote no open commit or registry entry knows was either
        decided (its phase-2 message lost: the decision is in the WAL,
        and the stream brings the rows) or never decided (presumed
        abort). Votes and transactions younger than ``max_age_s`` are
        left alone (a commit may be in flight). Returns the gids
        retired, a vote as ``dn<node>:<gid>``."""
        resolved = []
        now = time.time()
        prepared = self._prepared
        for gid, txn in list(prepared.items()):
            if now - txn.prepared_at < max_age_s:
                continue
            if prepared.pop(gid, None) is None:
                continue  # a session decided it meanwhile
            # rolled back through the session's path, so the WAL record
            # and the reservations are handled as ROLLBACK PREPARED does
            Session(self)._abort_txn(txn)
            if self.persistence is not None:
                self.persistence.log_rollback_prepared(gid)
            resolved.append(gid)
        try:
            registry = {i.gid: i for i in self.gts.prepared_txns() if i.gid}
        except Exception as e:
            log.warning("clean_2pc: the GTM's registry: %s", e)
            registry = {}
        for gid, info in registry.items():
            if (gid.startswith("__implicit_") and gid not in prepared
                    and gid not in self._open_gids):
                try:
                    self.gts.abort(info.gxid)
                    self.gts.forget(info.gxid)
                    resolved.append(gid)
                except Exception as e:
                    log.warning("clean_2pc: the GTM on %s: %s", gid, e)
        still_open = (set(prepared) | self._open_gids
                      | (set(registry) - set(resolved)))
        for n, ch in sorted(self.dn_channels.items()):
            try:
                resp = ch.rpc({"op": "2pc_list",
                               "hgen": self.node_generation})
                for e in resp.get("entries") or []:
                    gid = e["gid"]
                    if gid in still_open:
                        continue
                    age = e.get("age_s")
                    if age is not None and age < max_age_s:
                        continue
                    ch.rpc({"op": "2pc_abort", "gid": gid,
                            "hgen": self.node_generation})
                    resolved.append(f"dn{n}:{gid}")
            except Exception as e:
                log.warning("clean_2pc: datanode %d: %s", n, e)
        return resolved

    def start_clean2pc(self, interval_s: float = 60.0,
                       max_age_s: float = 300.0):
        """The background cleaner (clean2pc's postmaster child): runs
        ``clean_2pc`` every ``interval_s``. Returns a stop() callable."""
        return self._background(
            lambda: self.clean_2pc(max_age_s), interval_s, "clean_2pc")

    def resolve_indoubt(self, min_age_s: float = 0.0) -> list[tuple]:
        """Drive every in-doubt gid to a decision after a coordinator
        crash or a failover. The candidates are the GTM's prepared
        registry and the reachable datanodes' ``2pc_list`` journals; the
        verdict is this WAL's decision record (``gid_decision``):
        a commit replays phase 2, anything else is presumed abort. An
        explicitly PREPAREd transaction still parked here is touched only
        where a commit decision exists: it awaits its operator, it is
        not in doubt (``awaiting_operator``). ``min_age_s`` keeps the
        background resolver off a live commit between its datanode vote
        and its WAL record: an undecided vote younger than that, or
        without an age, is skipped, and so is a registry entry with no
        vote (``clean_2pc`` owns those); the admin function runs with 0.
        Returns [(gid, outcome)], each outcome ``committed``,
        ``aborted``, ``awaiting_operator``, or ``commit_retry`` /
        ``abort_retry`` where a datanode did not answer."""
        out: list[tuple] = []
        self._count_2pc("resolver_runs")
        explicit = set(self._prepared)
        gts_prepared: dict = {}
        try:
            for info in self.gts.prepared_txns():
                if info.gid:
                    gts_prepared[info.gid] = info
        except Exception as e:
            log.warning("resolve_indoubt: the GTM's registry: %s", e)
        chans = dict(self.dn_channels)
        votes: dict[str, list[int]] = {}
        vote_age: dict[str, float] = {}
        for n, ch in chans.items():
            try:
                resp = ch.rpc({"op": "2pc_list",
                               "hgen": self.node_generation})
            except Exception:
                self._count_2pc("unreachable_datanodes")
                continue  # a down datanode resolves on a later run
            for e in resp.get("entries") or []:
                votes.setdefault(e["gid"], []).append(n)
                age = e.get("age_s")
                if age is not None:
                    prev = vote_age.get(e["gid"])
                    vote_age[e["gid"]] = age if prev is None else min(
                        prev, age)
        p = self.persistence
        for gid in sorted(set(gts_prepared) | set(votes)):
            decision = p.gid_decision(gid) if p is not None else None
            if gid in explicit and decision is None:
                self._count_2pc("awaiting_operator")
                out.append((gid, "awaiting_operator"))
                continue
            if decision is None and min_age_s > 0:
                age = vote_age.get(gid)
                if gid in votes and (age is None or age < min_age_s):
                    continue
                if gid not in votes:
                    continue
            self._count_2pc("indoubt_seen")
            ok = True
            commit = decision is not None and decision[0] == "commit"
            for n in votes.get(gid, []):
                msg = {"op": "2pc_commit" if commit else "2pc_abort",
                       "gid": gid, "hgen": self.node_generation}
                if commit:
                    msg["commit_ts"] = decision[1]
                try:
                    chans[n].rpc(msg)
                except Exception:
                    ok = False
            outcome = ("committed" if commit else "aborted") if ok else (
                "commit_retry" if commit else "abort_retry")
            if ok:
                self._count_2pc("resolved_commit" if commit
                                else "resolved_abort")
            info = gts_prepared.get(gid)
            if info is not None and ok:
                try:
                    if not commit:
                        self.gts.abort(info.gxid)
                    self.gts.forget(info.gxid)
                except Exception as e:
                    log.warning("resolve_indoubt: the GTM on %s: %s", gid,
                                e)
            log.log(logging.WARNING if not ok else logging.INFO,
                    "in-doubt transaction %s %s (datanodes %s)", gid,
                    outcome, votes.get(gid, []))
            out.append((gid, outcome))
        return out

    def _count_2pc(self, stat: str) -> None:
        with self._2pc_stats_mu:
            self.twophase_stats[stat] += 1

    def start_indoubt_resolver(self, interval_s: float = 60.0,
                               min_age_s: float = 60.0):
        """The background in-doubt resolver (the clean2pc bgworker's
        shape): ``resolve_indoubt(min_age_s)`` every ``interval_s``.
        Returns a stop() callable."""
        return self._background(
            lambda: self.resolve_indoubt(min_age_s=min_age_s), interval_s,
            "resolve_indoubt")

    @staticmethod
    def _background(fn, interval_s: float, name: str):
        """A daemon thread running ``fn`` every ``interval_s`` until the
        returned stop() is called (a failed run is logged, and the next
        one comes on time)."""
        stop = threading.Event()

        def loop() -> None:
            while not stop.wait(interval_s):
                try:
                    fn()
                except Exception as e:
                    log.warning("%s: %s", name, e)

        th = threading.Thread(target=loop, daemon=True, name=name)
        th.start()

        def stopper() -> None:
            stop.set()
            th.join(timeout=5)

        return stopper

    # -- GTM node registration (recovery/register_gtm.c) -----------------
    def _gtm_register_all(self) -> None:
        """Register every catalog node with the GTM (each on its own: one
        failure must not skip the rest)."""
        for node in self.nodes.all_nodes():
            try:
                self.gts.register_node(
                    node.name, node.role.value,
                    getattr(node, "host", "") or "",
                    getattr(node, "port", 0) or 0,
                )
            except Exception as e:
                log.warning("GTM registration of %s: %s", node.name, e)

    def gtm_registered_nodes(self) -> dict:
        try:
            return self.gts.registered_nodes()
        except Exception as e:
            log.warning("GTM node registry: %s", e)
            return {}

    # -- the commit-stamp fence ------------------------------------------
    # A commit's xmin/xmax stamps land store by store, so a snapshot
    # taken mid-stamp must not straddle it. A new snapshot WAITS for
    # older stamp phases (a few memory writes and one WAL flush) rather
    # than clamping below them, which would break read-your-writes; a
    # stall past 10 s falls back to the clamp (consistent, merely stale).

    def commit_ts_begin_stamping(self, gxid: int,
                                 batched: bool = True) -> int:
        """A commit timestamp from the GTM, registered as stamping until
        ``stamping_done``. The GTS round trip runs outside the mutex; the
        pending count and its floor cover the window in which the
        timestamp exists at the GTM and not yet here. ``batched`` routes
        the grant through the group-commit batcher."""
        with self._stamping_mu:
            self._pending_commits += 1
            self._pending_token += 1
            token = self._pending_token
            self._pending_floors[token] = self._issued_hwm
        cts = None
        try:
            cts = (self.gts_batcher.commit(gxid) if batched
                   else self.gts.commit(gxid))
        finally:
            with self._stamping_mu:
                self._pending_commits -= 1
                self._pending_floors.pop(token, None)
                if cts is not None:
                    self._stamping.add(cts)
                    if cts > self._issued_hwm:
                        self._issued_hwm = cts
                self._stamping_cond.notify_all()
        return cts

    def stamping_done(self, cts: int) -> None:
        with self._stamping_mu:
            self._stamping.discard(cts)
            self._stamping_cond.notify_all()

    STAMP_STALL_S = 10.0

    def _fence_ts(self, ts: int) -> int:
        """Caller holds ``_stamping_mu``."""
        deadline = time.monotonic() + self.STAMP_STALL_S
        while self._pending_commits > 0 or (
                self._stamping and min(self._stamping) <= ts):
            left = deadline - time.monotonic()
            if left <= 0 or not self._stamping_cond.wait(timeout=left):
                break
        if self._stamping:
            ts = min(ts, min(self._stamping) - 1)
        if self._pending_floors:
            # a commit still inside its GTS round trip has no registered
            # timestamp; it will be strictly above its floor, so a clamp
            # to the floor keeps it (and all it stamps) invisible
            ts = min(ts, min(self._pending_floors.values()))
        return ts

    def clamp_ts(self, ts: int) -> int:
        with self._stamping_mu:
            return self._fence_ts(ts)

    def clamped_snapshot(self) -> int:
        """A read snapshot that no commit still stamping straddles. The
        GTS round trip runs outside the mutex: monotonicity makes the
        fence after it sound (every commit timestamp issued after the
        snapshot's is greater)."""
        ts = self.gts.snapshot_ts()
        with self._stamping_mu:
            return self._fence_ts(ts)

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def fused_executor(self) -> FusedExecutor:
        if self._fused is None:
            with self._fused_lock:
                if self._fused is None:
                    self._fused = FusedExecutor(
                        self.catalog, self.stores, self.device)
        return self._fused

    def drop_table_stores(self, name: str) -> None:
        """Forget a dropped table's stores and everything the fused
        executors hold for it: its device planes, and the programs and
        retry state keyed by store versions (a table created again
        under the name starts its versions over), and the WAL's count
        of its dictionary values already logged."""
        for tabs in self.stores.values():
            tabs.pop(name, None)
        if self.persistence is not None:
            self.persistence.forget_dicts(name)
        self.forget_device_table(name)

    def forget_device_table(self, name: str) -> None:
        """Free ``name``'s device planes and the fused executors' state
        keyed by its store versions: DDL that replaces or reshapes its
        stores (DROP, TRUNCATE, ALTER TABLE) starts their versions over
        or changes the columns a plane was built from."""
        if self._fused is not None:
            with self._fused_lock:
                self._fused.forget_table(name)

    def create_table_stores(self, meta: TableMeta) -> None:
        for n in meta.node_indices:
            self.stores[n][meta.name] = ShardStore(
                meta.schema, meta.dictionaries
            )

    def _refuse_pinned(self, name: str, what: str) -> None:
        """A rewrite renumbers every row position, and an open or
        prepared transaction holds positions into the old stores (PG's
        AccessExclusiveLock would wait; the reference refuses)."""
        meta = self.catalog.get(name)
        for node in meta.node_indices:
            store = self.stores.get(node, {}).get(name)
            if store is not None and store._pins > 0:
                raise SQLError(
                    f'cannot {what} "{name}": open or prepared '
                    "transactions still reference it")

    def truncate_table(self, name: str) -> None:
        """TRUNCATE: fresh empty stores (the dictionaries stay), and the
        old planes freed."""
        meta = self.catalog.get(name)
        self.create_table_stores(meta)
        self.forget_device_table(name)
        self.bump_table_versions({name})

    # -- ALTER TABLE (tablecmds.c, redistrib.c), shared with WAL redo ----
    def _alter_targets(self, name: str) -> list[str]:
        """The tables holding ``name``'s rows: a partitioned parent's
        children, else the table itself."""
        spec = self.partitions.get(name)
        return spec.children() if spec is not None else [name]

    def alter_add_column(self, name: str, col: str, ty) -> None:
        """A new column, NULL in every existing row (of every partition,
        for a partitioned parent)."""
        from opentenbase_tpu_torch.storage.column import Dictionary

        metas = [self.catalog.get(name)] + [
            self.catalog.get(ch) for ch in self._alter_targets(name)
            if ch != name]
        for meta in metas:
            if col in meta.schema:
                raise SQLError(f'column "{col}" already exists')
        for meta in metas:
            meta.schema[col] = ty
            if ty.id == t.TypeId.TEXT and col not in meta.dictionaries:
                meta.dictionaries[col] = Dictionary()
        for target in self._alter_targets(name):
            for node in self.catalog.get(target).node_indices:
                store = self.stores.get(node, {}).get(target)
                if store is not None:
                    store.add_column(col, ty)
            self.forget_device_table(target)

    def alter_drop_column(self, name: str, col: str) -> None:
        meta = self.catalog.get(name)
        if col in meta.dist.key_columns:
            raise SQLError(f'cannot drop distribution key "{col}"')
        spec = self.partitions.get(name)
        if spec is not None and col == spec.column:
            raise SQLError(f'cannot drop partition key "{col}"')
        if col not in meta.schema:
            raise SQLError(f'column "{col}" does not exist')
        for target in dict.fromkeys([name, *self._alter_targets(name)]):
            tm = self.catalog.get(target)
            tm.schema.pop(col, None)
            tm.dictionaries.pop(col, None)
            tm.not_null.discard(col)
            tm.defaults.pop(col, None)
            if tm.primary_key == col:
                tm.primary_key = None
            # a TEXT column added again under the name starts a fresh
            # dictionary: its WAL watermark restarts at zero with it
            if self.persistence is not None:
                self.persistence._dict_synced.pop(f"{target}.{col}", None)
            for node in tm.node_indices:
                store = self.stores.get(node, {}).get(target)
                if store is not None:
                    store.drop_column(col)
            self.forget_device_table(target)

    def redistribute_table(self, name: str, dist: DistributionSpec) -> int:
        """ALTER TABLE ... DISTRIBUTE BY: every live row rewritten through
        the new locator into fresh stores (dead versions are dropped, as
        a PG table rewrite drops them); a partitioned parent rewrites
        each partition. Returns the rows written."""
        from opentenbase_tpu_torch.catalog.locator import Locator

        targets = self._alter_targets(name)
        for target in targets:
            self._refuse_pinned(target, "redistribute")
        snapshot = self.gts.snapshot_ts()
        commit_ts = self.gts.get_gts()
        moved = 0
        for target in targets:
            meta = self.catalog.get(target)
            src_nodes = (meta.node_indices[:1] if meta.dist.is_replicated
                         else meta.node_indices)
            batches = []
            for node in src_nodes:
                store = self.stores.get(node, {}).get(target)
                if store is None or store.nrows == 0:
                    continue
                idx = store.live_index(snapshot)
                if len(idx):
                    batches.append(store.take_batch(idx))
            meta.dist = dist
            meta.locator = Locator(
                dist, meta.node_indices,
                self.shardmap if dist.strategy == DistStrategy.SHARD
                else None,
                key_types={k: meta.schema[k] for k in dist.key_columns})
            self.create_table_stores(meta)
            for batch in batches:
                if dist.is_replicated:
                    for node in meta.node_indices:
                        self.stores[node][target].append_batch(
                            batch, commit_ts)
                    moved += batch.nrows
                    continue
                routes = meta.locator.route_insert(
                    {k: batch.columns[k] for k in dist.key_columns},
                    batch.nrows)
                for node in np.unique(routes):
                    sub = batch.take(np.nonzero(routes == node)[0])
                    self.stores[int(node)][target].append_batch(
                        sub, commit_ts)
                    moved += sub.nrows
            self.forget_device_table(target)
        if name in self.partitions:  # the parent shell keeps matching
            self.catalog.get(name).dist = dist
        return moved

    def extend_partitions(self, name: str, count: int) -> None:
        """ALTER TABLE ... ADD PARTITIONS (count): ``count`` more
        children past the last boundary, sharing the parent's
        dictionaries. The existing children keep their stores."""
        from opentenbase_tpu_torch.plan.partition import PartitionSpec

        spec = self.partitions.get(name)
        if spec is None:
            raise SQLError(f'"{name}" is not a partitioned table')
        parent = self.catalog.get(name)
        clause = dict(spec.spec)
        clause["partitions"] = spec.nparts + count
        new_spec = PartitionSpec.build(name, clause, spec.key_type)
        for i in range(spec.nparts, new_spec.nparts):
            child = new_spec.child(i)
            meta = self.catalog.create_table(child, parent.schema,
                                             parent.dist)
            meta.dictionaries = parent.dictionaries
            self.create_table_stores(meta)
            self.forget_device_table(child)
        self.partitions[name] = new_spec

    def bump_table_versions(self, tables) -> None:
        """Advance the committed-write counter of every named table, the
        matview rewrite's evidence of staleness: from commit stamping,
        WAL redo and content-replacing DDL. A write to a partition
        child bumps its parent too (a matview over a partitioned table
        tracks the parent's name)."""
        tables = set(tables)
        for parent, spec in self.partitions.items():
            if parent not in tables and not tables.isdisjoint(
                    spec.children()):
                tables.add(parent)
        for tb in tables:
            self.table_version[tb] = self.table_version.get(tb, 0) + 1

    def compact_deltas(self) -> int:
        """Fold every store's pending delta batches into its base arrays
        (positions kept, so the device cache stays valid): the
        compaction job's verb. Returns the batches folded."""
        from opentenbase_tpu_torch.storage.compaction import compact_cluster

        return compact_cluster(self)

    def session(self) -> "Session":
        return Session(self)


class Session:
    def __init__(self, cluster: Cluster, user: str = "otb"):
        self.cluster = cluster
        self.session_id = next(cluster._session_ids)
        self.txn: Optional[Transaction] = None
        # the effective user (SET session_authorization / role)
        self.user = user
        # whether the last SELECT's device output came from the fused DAG
        # (else from K1's route), the reference's attribute
        self._fused_via_dag = False
        # session settings (SET / RESET): the registry's defaults,
        # overlaid with the cluster's conf file (config.py)
        self.gucs: dict = {**_config.defaults(), **cluster.conf_gucs}
        # PREPARE name AS ...: the per-session statement templates and
        # each one's parameter count
        self.prepared_statements: dict[str, A.Statement] = {}
        self._prepared_nparams: dict[str, int] = {}
        # the last fused statement's compile / device / host_merge ms
        # and its device-cache attribution (EXPLAIN ANALYZE reads them)
        self._fused_phases: dict = {}
        # the system views the running statement materialized
        self._sysviews: frozenset = frozenset()
        # the last SELECT's route ("fused" or "host") and, on the host
        # route, its DistExecutor (instrumentation, motions, join modes)
        self.last_route: Optional[str] = None
        self.last_executor: Optional[DistExecutor] = None
        # why the fused executors declined the last SELECT, in order
        self.last_declines: list[str] = []
        # the WAL offset just past this session's last commit frame
        self.last_commit_lsn = 0
        # the last commit's implicit 2PC: gid, participants, prepare and
        # commit ms (None where the last commit took none)
        self.last_2pc: Optional[dict] = None
        # the running statement's statement_timeout cutoff (monotonic)
        self._stmt_deadline: Optional[float] = None
        # the last value nextval or setval gave each sequence here
        self._seq_currval: dict[str, int] = {}
        # PL/pgSQL call nesting (``_pl_call``)
        self._pl_depth = 0
        # lines a rewrite stage hands EXPLAIN (the recursive-CTE shape),
        # and the stand-in table names it prints under their CTE names
        self._explain_prelude: list[str] = []
        self._explain_rename: dict[str, str] = {}
        # the last statement's recursive CTEs: name -> iterations of its
        # recursive term (the last one yielded no row)
        self.recursive_iterations: dict[str, int] = {}
        # workload management (wlm/): the admission ticket of the
        # statement in flight; "queued" while it waits in a queue; the
        # text pg_stat_wlm_queue shows for it
        self._wlm_ticket = None
        self.state = "idle"
        self.last_query = ""
        # True while the matview machinery runs its own statements
        # (populate, refresh): no serving-path rewrite (a refresh reads
        # the base tables, never the view) and no write guard
        self._matview_internal = False

    def close(self) -> None:
        """Backend exit: a workload-management slot still held goes
        back now. Idempotent."""
        ticket = self._wlm_ticket
        if ticket is not None:
            self._wlm_ticket = None
            ticket.release()
        self.state = "closed"

    def execute(self, sql: str) -> Result:
        self.last_query = sql
        results = [self._execute_one(s) for s in parse(sql)]
        return results[-1] if results else Result("EMPTY")

    def query(self, sql: str) -> list[tuple]:
        return self.execute(sql).rows

    # the reference's FROM-less admin functions: the port runs those
    # whose subsystem it has, and refuses each other one by name with
    # the ROADMAP item that brings its subsystem
    _ADMIN_FUNCS = frozenset({
        "pg_resolve_indoubt", "pg_unlock_execute", "pg_unlock_check_deadlock",
        "pg_unlock_check_dependency", "pg_current_wal_lsn", "pg_stat_reset",
        "pg_publication_tables", "pg_logical_slot_changes", "pg_logical_sync",
        "pg_fault_inject", "pg_fault_clear",
    })
    # those that change nothing: the wire servers run them as reads
    _READONLY_ADMIN_FUNCS = frozenset({"pg_sleep"})
    _ADMIN_REFUSED = {
        "pg_clean_execute": "A.9", "pg_audit_add_fga_policy": "A.10",
        "pg_audit_drop_fga_policy": "A.10", "pg_basebackup": "A.8",
        "pg_rebalance_wait": "A.8", "pg_add_coordinator": "A.9",
        "pg_remove_coordinator": "A.9", "pg_coordinators": "A.9",
        "pg_replica_status": "A.9", "pg_stat_statements_reset": "A.7",
        "pg_export_traces": "A.7", "pg_cluster_logs": "A.7",
    }
    _SEQ_FUNCS = ("nextval", "currval", "setval")

    # what a hot standby runs (the reference's _READONLY_OK, of the
    # statements the port takes)
    _READONLY_OK = (A.Select, A.ExplainStmt, A.ShowStmt, A.SetStmt,
                    A.BeginStmt, A.CommitStmt, A.RollbackStmt,
                    # session-local; EXECUTE's bound statement re-enters
                    # _execute_one and is gated on its own class there
                    A.PrepareStmt, A.ExecuteStmt, A.DeallocateStmt,
                    A.SavepointStmt, A.RollbackToSavepoint,
                    A.ReleaseSavepoint)

    def _is_readonly_stmt(self, stmt: A.Statement) -> bool:
        """What a hot standby runs: reads, session statements, and COPY
        TO (a read in a write-shaped statement class)."""
        if isinstance(stmt, self._READONLY_OK):
            return True
        return isinstance(stmt, A.CopyStmt) and stmt.direction == "to"

    def _execute_one(self, stmt: A.Statement) -> Result:
        """One statement, under its statement_timeout deadline (a nested
        statement, a PL/pgSQL body's or a recursive CTE's, keeps its
        caller's), with its self-referencing CTEs materialized first
        into temporary tables that are dropped after it."""
        top = self._stmt_deadline is None
        if top:
            timeout_ms = self.gucs["statement_timeout"]
            self._stmt_deadline = (time.monotonic() + timeout_ms / 1000.0
                                   if timeout_ms > 0 else None)
        try:
            rec = self._materialize_recursive_ctes(stmt)
            if rec is None:
                return self._execute_one_inner(stmt)
            stmt, temps = rec
            try:
                return self._execute_one_inner(stmt)
            finally:
                self._drop_temps(temps)
                # a failure before EXPLAIN read the prelude must not
                # leak it into the session's next EXPLAIN
                self._explain_prelude = []
                self._explain_rename = {}
        except StatementTimeout as e:
            raise SQLError(str(e), "57014") from None
        finally:
            if top:
                self._stmt_deadline = None

    def _execute_one_inner(self, stmt: A.Statement) -> Result:
        c = self.cluster
        if c.ha_demoted:
            # a fenced ex-primary: a newer generation was promoted, and
            # a read served here could be arbitrarily stale
            c.ha_stats["fenced_refusals"] += 1
            raise SQLError(
                "node is fenced: a newer generation "
                f"({c.node_generation}+) was promoted; demoted ex-primary "
                "must resync (rejoin_standby) before serving", "72000")
        lease = c.serving_lease
        if lease is not None and not lease.valid():
            # no datanode-quorum contact within the lease: a partitioned
            # or fenced coordinator must not serve, even a read that
            # would send no datanode an RPC
            c.ha_stats["fenced_refusals"] += 1
            raise SQLError(
                "node's serving lease is not valid: no datanode-quorum "
                f"contact within lease_ttl_ms ({lease.ttl_ms}ms) — "
                "self-demoted until the lease renews", "72000")
        if self.cluster.read_only and not self._is_readonly_stmt(stmt):
            raise SQLError(f"cannot execute {type(stmt).__name__} in a "
                           "read-only (hot standby) cluster", "25006")
        fn = {
            A.CreateTable: self._x_createtable,
            A.Insert: self._x_insert,
            A.Update: self._x_update,
            A.Delete: self._x_delete,
            A.Select: self._x_select,
            A.BeginStmt: self._x_beginstmt,
            A.CommitStmt: self._x_commitstmt,
            A.RollbackStmt: self._x_rollbackstmt,
            A.VacuumStmt: self._x_vacuumstmt,
            A.CreateIndex: self._x_createindex,
            A.SetStmt: self._x_setstmt,
            A.AnalyzeStmt: self._x_analyzestmt,
            A.DropTable: self._x_droptable,
            A.CreateUser: self._x_createuser,
            A.DropUser: self._x_dropuser,
            A.PrepareTransaction: self._x_preparetransaction,
            A.CommitPrepared: self._x_commitprepared,
            A.RollbackPrepared: self._x_rollbackprepared,
            A.CreateSequence: self._x_createsequence,
            A.DropSequence: self._x_dropsequence,
            A.CreateView: self._x_createview,
            A.DropView: self._x_dropview,
            A.CreateTableAs: self._x_createtableas,
            A.CreateFunction: self._x_createfunction,
            A.DropFunction: self._x_dropfunction,
            A.SavepointStmt: self._x_savepointstmt,
            A.RollbackToSavepoint: self._x_rollbacktosavepoint,
            A.ReleaseSavepoint: self._x_releasesavepoint,
            A.TruncateTable: self._x_truncatetable,
            A.AlterTable: self._x_altertable,
            A.LockTable: self._x_locktable,
            A.ShowStmt: self._x_showstmt,
            A.PrepareStmt: self._x_preparestmt,
            A.ExecuteStmt: self._x_executestmt,
            A.DeallocateStmt: self._x_deallocatestmt,
            A.ExplainStmt: self._x_explainstmt,
            A.CopyStmt: self._x_copystmt,
            A.CreateForeignTable: self._x_createforeigntable,
            A.CreateMatview: self._x_creatematview,
            A.RefreshMatview: self._x_refreshmatview,
            A.DropMatview: self._x_dropmatview,
            A.CreatePublication: self._x_createpublication,
            A.DropPublication: self._x_droppublication,
            A.CreateSubscription: self._x_createsubscription,
            A.DropSubscription: self._x_dropsubscription,
            A.CreateResourceGroup: self._x_createresourcegroup,
            A.DropResourceGroup: self._x_dropresourcegroup,
            A.AlterRoleResourceGroup: self._x_alterroleresourcegroup,
        }.get(type(stmt))
        if fn is None:
            raise NotPorted(f"statement {type(stmt).__name__}")
        ticket = None
        try:
            if not self._matview_internal:
                self._matview_write_guard(stmt)
                stmt = self._maybe_matview_rewrite(stmt)
            if isinstance(stmt, A.Select) and self._admin_call(stmt):
                # admission first: pg_sleep and the other admin calls
                # are statements a resource group gates
                ticket = self._wlm_admit(stmt)
                admin = self._maybe_admin_function(stmt)
                if admin is not None:
                    return admin
            if isinstance(stmt, A.ExplainStmt):
                stmt = dataclasses.replace(
                    stmt, query=self._rewrite(stmt.query, explain=True))
            else:
                stmt = self._rewrite(stmt)
                if isinstance(stmt, Result):  # a partition fan-out ran
                    return stmt
            # workload management: admitted, queued or shed before any
            # fragment is dispatched, on either route; the ticket goes
            # back on every exit path
            if ticket is None:
                ticket = self._wlm_admit(stmt)
            txn = self.txn
            if txn is None or not isinstance(
                stmt, (A.Insert, A.Update, A.Delete, A.CopyStmt)
            ):
                return fn(stmt)
            # a failed statement inside an explicit transaction leaves
            # no partial writes for COMMIT to persist
            mark = txn.mark()
            try:
                return fn(stmt)
            except Exception:
                if self.txn is txn:
                    txn.rollback_to(mark, self.cluster.stores)
                raise
        except DeadlockError as e:
            # the victim's whole transaction dies, or its locks keep the
            # cycle standing
            if self.txn is not None:
                self._abort_txn(self.txn)
                self.txn = None
            self.cluster.locks.release_all(self.session_id)
            raise SQLError(str(e), "40P01")
        except (LockTimeout, LockNotAvailable) as e:
            raise SQLError(str(e)) from None
        finally:
            if ticket is not None:
                self._wlm_ticket = None
                ticket.release()

    # -- workload management (wlm/) ---------------------------------------
    # matview population and refresh run their defining query, and are
    # admitted like any read (charged by that query's plan)
    _WLM_GATED = (
        A.Select, A.Insert, A.Update, A.Delete, A.CopyStmt,
        A.RefreshMatview, A.CreateMatview,
    )

    @staticmethod
    def _admin_call(stmt: A.Select) -> bool:
        """A FROM-less SELECT of one function call (an admin function,
        pg_sleep, a sequence call)."""
        return (stmt.from_clause is None and len(stmt.items) == 1
                and isinstance(stmt.items[0].expr, A.FuncCall))

    def _wlm_group_name(self) -> str:
        """The session's resource group: the ``resource_group`` setting,
        else its role's binding (ALTER ROLE ... RESOURCE GROUP), else
        default_group."""
        gname = self.gucs.get("resource_group") or ""
        if gname:
            return str(gname)
        return self.cluster.wlm.group_for_role(self.user)

    def _wlm_admit(self, stmt: A.Statement):
        """Admission control before any fragment is dispatched, for an
        autocommit resource-consuming statement: one inside an explicit
        transaction holds locks, and parking it could deadlock against
        the statement it waits on; a nested statement rides its
        caller's ticket; a SELECT of system views only stays reachable
        from a saturated group. A statement that must queue parks its
        statement-lock slot (and a writer's table mutexes) for the wait,
        which is bounded by what is left of statement_timeout, else by
        wlm_queue_timeout. Returns the ticket (the caller releases it)
        or None."""
        if self._wlm_ticket is not None or self.txn is not None:
            return None
        if not isinstance(stmt, self._WLM_GATED):
            return None
        if isinstance(stmt, A.Select):
            from opentenbase_tpu_torch.plan.astwalk import relation_names

            try:
                refs = relation_names(stmt)
            except Exception:
                refs = set()
            if refs and refs <= _SYSTEM_VIEWS:
                return None
        mgr = self.cluster.wlm
        gname = self._wlm_group_name()
        group = mgr.groups.get(gname)
        if group is None:
            raise SQLError(f'resource group "{gname}" does not exist',
                           "42704")
        est = 0
        if group.memory_limit > 0:
            from opentenbase_tpu_torch.wlm.estimate import (
                estimate_statement_memory,
            )

            est_stmt = stmt
            if isinstance(stmt, A.RefreshMatview):
                d = self.cluster.matviews.get(stmt.name)
                if d is not None:
                    est_stmt = d.query
            est = estimate_statement_memory(
                est_stmt, self.cluster.catalog,
                work_mem=self.gucs.get("work_mem", 0))
        timeout_ms = 0
        if group.limited():
            if self._stmt_deadline is not None:
                timeout_ms = max(int(
                    (self._stmt_deadline - time.monotonic()) * 1000), 1)
            else:
                timeout_ms = int(self.gucs.get("wlm_queue_timeout") or 0)
        ticket = mgr.try_admit(gname, est)
        if ticket is None:
            from opentenbase_tpu_torch.utils.rwlock import parked

            prev_state, self.state = self.state, "queued"
            try:
                with parked(self.cluster._exec_lock):
                    ticket = mgr.admit(gname, est, timeout_ms,
                                       session_id=self.session_id,
                                       query=self.last_query)
            finally:
                self.state = prev_state
        self._wlm_ticket = ticket
        return ticket

    # -- materialized views (matview/) ------------------------------------
    def _matview_write_guard(self, stmt: A.Statement) -> None:
        """A matview's rows, its aux table's and the refresh-state
        catalog's change only through REFRESH: any other write or DDL
        against them fails with 42809 (wrong_object_type)."""
        c = self.cluster
        names: list = []
        if isinstance(stmt, (A.Insert, A.Update, A.Delete)):
            names = [stmt.table]
        elif isinstance(stmt, A.CopyStmt) and stmt.direction == "from":
            names = [stmt.table]
        elif isinstance(stmt, (A.TruncateTable, A.DropTable)):
            names = list(stmt.names)
        elif isinstance(stmt, A.AlterTable):
            names = [stmt.table]
        if not names:
            return
        from opentenbase_tpu_torch.matview.defs import STATE_TABLE

        for name in names:
            if name == STATE_TABLE and c.catalog.has(STATE_TABLE):
                raise SQLError(
                    f'"{STATE_TABLE}" is the materialized-view '
                    "refresh-state catalog", "42809")
        if not c.matviews:
            return
        aux_owners = {d.aux_table: nm for nm, d in c.matviews.items()}
        for name in names:
            if name in c.matviews:
                if isinstance(stmt, A.DropTable):
                    raise SQLError(
                        f'"{name}" is a materialized view — use '
                        "DROP MATERIALIZED VIEW", "42809")
                raise SQLError(
                    f'cannot change materialized view "{name}"', "42809")
            if name in aux_owners:
                raise SQLError(
                    f'"{name}" is the auxiliary state table of '
                    f'materialized view "{aux_owners[name]}"', "42809")

    def _maybe_matview_rewrite(self, stmt: A.Statement) -> A.Statement:
        """The serving path (``enable_matview_rewrite``): a SELECT equal
        to a fresh matview's defining query scans the matview instead.
        Never inside a transaction block (its snapshot may predate the
        last refresh, and its own writes are not in the view). EXPLAIN
        shows the rewrite as a prelude line over the scan; only EXPLAIN
        ANALYZE, which serves rows, counts as a hit."""
        c = self.cluster
        if not c.matviews or not self.gucs.get("enable_matview_rewrite",
                                               True):
            return stmt
        if self.txn is not None:
            return stmt
        sel = stmt.query if isinstance(stmt, A.ExplainStmt) else stmt
        if not isinstance(sel, A.Select):
            return stmt
        from opentenbase_tpu_torch.matview.rewrite import try_rewrite

        hit = try_rewrite(c, sel)
        if hit is None:
            return stmt
        name, new_sel = hit
        d = c.matviews[name]
        if isinstance(stmt, A.ExplainStmt):
            if stmt.analyze:
                d.stats["rewrites"] = d.stats.get("rewrites", 0) + 1
            self._explain_prelude.append(
                f'Matview rewrite: query served from "{name}" '
                f"(lsn {d.last_refresh_lsn})")
            stmt.query = new_sel
            return stmt
        d.stats["rewrites"] = d.stats.get("rewrites", 0) + 1
        return new_sel

    def _dependent_matviews(self, relname: str) -> list[str]:
        """Matviews whose defining queries read ``relname``, views
        included (the pg_depend edge DROP honors)."""
        from opentenbase_tpu_torch.plan.astwalk import relation_names

        return sorted(
            nm for nm, d in self.cluster.matviews.items()
            if nm != relname and (relname in d.base_tables
                                  or relname in relation_names(d.query)))

    def _drop_dependents(self, relname: str) -> None:
        """CASCADE: every view and matview depending on ``relname``,
        dependents first."""
        for v in self._dependent_views(relname):
            if v in self.cluster.views:
                self._drop_dependents(v)
                self._x_dropview(A.DropView(v, if_exists=True))
        for m in self._dependent_matviews(relname):
            if m in self.cluster.matviews:
                self._x_dropmatview(
                    A.DropMatview(m, if_exists=True, cascade=True))

    def _matview_dist(self, options: dict, schema: dict) -> DistributionSpec:
        """A matview's distribution: WITH (distribute = ...), else
        ROUNDROBIN (derived rows have no natural key)."""
        strat = (options.get("distribute") or "").lower()
        if not strat:
            return DistributionSpec(DistStrategy.ROUNDROBIN)
        keys = list(options.get("distribute_keys") or [])
        for k in keys:
            if k not in schema:
                raise SQLError(f'distribution key "{k}" is not an output '
                               "column of the materialized view")
        return self._dist_spec_named(strat, keys)

    def _x_creatematview(self, stmt: A.CreateMatview) -> Result:
        """CREATE MATERIALIZED VIEW: the backing table of the query's
        output columns, an aux partial-state table for an incremental
        aggregate, both populated (with the otb_matview_state row) in
        one transaction read at one pinned snapshot."""
        from opentenbase_tpu_torch.matview import defs as _mv
        from opentenbase_tpu_torch.matview.refresh import (
            PinnedSnapshot,
            apply_refresh,
            build_partials_select,
        )

        c = self.cluster
        name = stmt.name
        self._reserved_relation(name)
        if self.txn is not None:
            raise SQLError("CREATE MATERIALIZED VIEW cannot run inside a "
                           "transaction block", "25001")
        if name in c.matviews:
            if stmt.if_not_exists:
                return Result("CREATE MATERIALIZED VIEW")
            raise SQLError(f'materialized view "{name}" already exists',
                           "42P07")
        if c.catalog.has(name) or name in c.views or name in c.partitions:
            if stmt.if_not_exists:
                return Result("CREATE MATERIALIZED VIEW")
            raise SQLError(f'relation "{name}" already exists', "42P07")
        _mv.ensure_state_table(self)
        p = c.persistence
        lsn0 = p.wal.position if p is not None else 0
        # one read snapshot pinned next to the lsn0 capture, and the
        # versions with them: a base commit during the populate leaves
        # the matview stale (matview/refresh.py PinnedSnapshot)
        pin = PinnedSnapshot(self)
        refresh_ts = pin.snapshot_ts
        versions0 = dict(c.table_version)
        prev_internal = self._matview_internal
        self._matview_internal = True
        try:
            batch = self._run_select(stmt.query)
            schema: dict = {}
            for colname, col in batch.columns.items():
                if colname in schema or not colname:
                    raise SQLError("CREATE MATERIALIZED VIEW needs "
                                   "unique, named output columns")
                schema[colname] = col.type
            if not schema:
                raise SQLError(
                    "CREATE MATERIALIZED VIEW needs at least one column")
            dist = self._matview_dist(stmt.options, schema)
            meta = c.catalog.create_table(name, schema, dist)
            c.create_table_stores(meta)
            d = _mv.register(c, name, stmt.text, stmt.options)
            aux_rows = None
            if d.wants_incremental() and d.shape.kind == "agg":
                aux_batch = self._run_select(build_partials_select(d.shape))
                aux_schema = {cn: cb.type
                              for cn, cb in aux_batch.columns.items()}
                aux_meta = c.catalog.create_table(
                    d.aux_table, aux_schema,
                    DistributionSpec(DistStrategy.ROUNDROBIN))
                c.create_table_stores(aux_meta)
                d.aux_schema = {cn: _type_to_str(ty)
                                for cn, ty in aux_schema.items()}
                aux_rows = {cn: cb.to_python() for cn, cb in zip(
                    aux_meta.schema, aux_batch.columns.values())}
            pin.release()  # the reads are done; the apply commits alone
            self._log_ddl({
                "op": "create_matview", "name": name, "text": stmt.text,
                "options": dict(stmt.options),
                "schema": {k: _type_to_str(v) for k, v in schema.items()},
                "strategy": dist.strategy.value,
                "key_columns": list(dist.key_columns),
                "aux_schema": d.aux_schema,
            })
            d.last_refresh_lsn = lsn0
            d.last_refresh_ts = refresh_ts
            mv_rows = {cn: cb.to_python() for cn, cb in zip(
                meta.schema, batch.columns.values())}
            try:
                apply_refresh(
                    self, d, meta,
                    {"deletes": [], "mv_rows": mv_rows,
                     "aux_rows": aux_rows, "row_deletes": []},
                    _mv.state_row(d))
            except Exception:
                # the populate failed: the half-made matview goes
                c.matviews.pop(name, None)
                for tb in (name, d.aux_table):
                    if c.catalog.has(tb):
                        c.catalog.drop_table(tb)
                        c.drop_table_stores(tb)
                self._log_ddl({"op": "drop_matview", "name": name})
                raise
        finally:
            pin.release()
            self._matview_internal = prev_internal
        d.base_versions = {tb: versions0.get(tb, 0) for tb in d.base_tables}
        return Result("CREATE MATERIALIZED VIEW", rowcount=batch.nrows)

    def _x_refreshmatview(self, stmt: A.RefreshMatview) -> Result:
        d = self.cluster.matviews.get(stmt.name)
        if d is None:
            raise SQLError(
                f'materialized view "{stmt.name}" does not exist', "42P01")
        if self.txn is not None:
            raise SQLError("REFRESH MATERIALIZED VIEW cannot run inside a "
                           "transaction block", "25001")
        from opentenbase_tpu_torch.matview.refresh import refresh_matview

        info = refresh_matview(self, d, concurrently=stmt.concurrently)
        return Result("REFRESH MATERIALIZED VIEW", rowcount=info["deltas"])

    def _x_dropmatview(self, stmt: A.DropMatview) -> Result:
        from opentenbase_tpu_torch.matview.defs import STATE_TABLE

        c = self.cluster
        d = c.matviews.get(stmt.name)
        if d is None:
            if stmt.if_exists:
                return Result("DROP MATERIALIZED VIEW")
            raise SQLError(
                f'materialized view "{stmt.name}" does not exist', "42P01")
        if self.txn is not None:
            raise SQLError("DROP MATERIALIZED VIEW cannot run inside a "
                           "transaction block", "25001")
        deps = self._dependent_views(stmt.name)
        mv_deps = self._dependent_matviews(stmt.name)
        if (deps or mv_deps) and not stmt.cascade:
            what = ", ".join(sorted(deps + mv_deps))
            raise SQLError(
                f'cannot drop materialized view "{stmt.name}": other '
                f"objects ({what}) depend on it", "2BP01")
        if stmt.cascade:
            self._drop_dependents(stmt.name)
        c.matviews.pop(stmt.name, None)
        for tb in (stmt.name, d.aux_table):
            if c.catalog.has(tb):
                c.catalog.drop_table(tb)
                c.drop_table_stores(tb)
        if c.catalog.has(STATE_TABLE):
            prev_internal = self._matview_internal
            self._matview_internal = True
            try:
                self._execute_one(A.Delete(
                    table=STATE_TABLE,
                    where=A.BinOp("=", A.ColumnRef("mv", None),
                                  A.Literal(stmt.name))))
            finally:
                self._matview_internal = prev_internal
        self._log_ddl({"op": "drop_matview", "name": stmt.name})
        return Result("DROP MATERIALIZED VIEW")

    # -- logical replication (publicationcmds.c, subscriptioncmds.c) -------
    def _x_createpublication(self, stmt: A.CreatePublication) -> Result:
        c = self.cluster
        if stmt.name in c.publications:
            raise SQLError(f'publication "{stmt.name}" already exists')
        if stmt.tables is not None:
            for tb in stmt.tables:
                if not c.catalog.has(tb):
                    raise SQLError(f'table "{tb}" does not exist')
        nodes = None
        if stmt.nodes is not None:
            nodes = [c.nodes.get(n).mesh_index for n in stmt.nodes]
        pub = {"tables": stmt.tables, "nodes": nodes}
        c.publications[stmt.name] = pub
        # a slot with no confirmed position keeps every dead row from
        # now on out of VACUUM's reach
        c._slot_horizon_ts[stmt.name] = c.gts.snapshot_ts()
        self._log_ddl({"op": "create_publication", "name": stmt.name,
                       **pub})
        return Result("CREATE PUBLICATION")

    def _x_droppublication(self, stmt: A.DropPublication) -> Result:
        c = self.cluster
        if stmt.name not in c.publications:
            raise SQLError(f'publication "{stmt.name}" does not exist')
        del c.publications[stmt.name]
        c._slot_horizon_ts.pop(stmt.name, None)
        self._log_ddl({"op": "drop_publication", "name": stmt.name})
        return Result("DROP PUBLICATION")

    def _x_createsubscription(self, stmt: A.CreateSubscription) -> Result:
        """CREATE SUBSCRIPTION: an apply worker pulling the publisher's
        decoded frames over the JSON wire. With copy_data = off the
        slot is created now, at the publisher's current WAL position,
        so nothing committed after this statement is skipped."""
        from opentenbase_tpu_torch.storage.logical import (
            SubscriptionWorker,
            apply_frame,
            ensure_state_table,
        )

        c = self.cluster
        if stmt.name in c.subscriptions:
            raise SQLError(f'subscription "{stmt.name}" already exists')
        worker = SubscriptionWorker(c, stmt.name, stmt.conninfo,
                                    stmt.publication)
        if not stmt.copy_data:
            worker.synced = True
            try:
                client = worker._connect()
                try:
                    worker.lsn = int(client.query(
                        "select pg_current_wal_lsn()")[0][0])
                finally:
                    client.close()
            except Exception as e:
                raise SQLError(
                    f"could not connect to the publisher: {e}") from None
            ensure_state_table(self)
            apply_frame(self, {"changes": []},
                        slot_state=(stmt.name, worker.lsn, True))
        c.subscriptions[stmt.name] = worker
        self._log_ddl({"op": "create_subscription", "name": stmt.name,
                       "conninfo": stmt.conninfo,
                       "publication": stmt.publication,
                       "copy_data": stmt.copy_data})
        worker.start()
        return Result("CREATE SUBSCRIPTION")

    def _x_dropsubscription(self, stmt: A.DropSubscription) -> Result:
        worker = self.cluster.subscriptions.pop(stmt.name, None)
        if worker is None:
            raise SQLError(f'subscription "{stmt.name}" does not exist')
        # no join: under a wire server this statement holds the
        # statement lock the worker may wait on; it sees the stop flag
        # under that lock and applies nothing more
        worker.stop(join=False)
        self._log_ddl({"op": "drop_subscription", "name": stmt.name})
        return Result("DROP SUBSCRIPTION")

    # -- DDL: workload management (wlm/) -----------------------------------
    @staticmethod
    def _wlm_config_sqlerror(e) -> SQLError:
        """A WlmConfigError as the class a client library expects: 42704
        undefined_object, 42710 duplicate_object, else 22023."""
        msg = str(e)
        if "does not exist" in msg:
            state = "42704"
        elif "already exists" in msg:
            state = "42710"
        else:
            state = "22023"
        return SQLError(msg, state)

    def _log_wlm_state(self) -> None:
        """Resource-group DDL is logged as the whole configuration, so
        its replay is idempotent against checkpoints."""
        self._log_ddl({"op": "wlm_state",
                       "payload": self.cluster.wlm.dump_state()})

    def _x_createresourcegroup(self, stmt: A.CreateResourceGroup) -> Result:
        from opentenbase_tpu_torch.wlm import WlmConfigError

        mgr = self.cluster.wlm
        try:
            if stmt.alter:
                mgr.alter_group(stmt.name, stmt.options)
            else:
                mgr.create_group(stmt.name, stmt.options)
        except WlmConfigError as e:
            raise self._wlm_config_sqlerror(e) from None
        self._log_wlm_state()
        return Result("ALTER RESOURCE GROUP" if stmt.alter
                      else "CREATE RESOURCE GROUP")

    def _x_dropresourcegroup(self, stmt: A.DropResourceGroup) -> Result:
        from opentenbase_tpu_torch.wlm import WlmConfigError

        try:
            dropped = self.cluster.wlm.drop_group(
                stmt.name, if_exists=stmt.if_exists)
        except WlmConfigError as e:
            raise self._wlm_config_sqlerror(e) from None
        if dropped:
            self._log_wlm_state()
        return Result("DROP RESOURCE GROUP")

    def _x_alterroleresourcegroup(
            self, stmt: A.AlterRoleResourceGroup) -> Result:
        from opentenbase_tpu_torch.wlm import WlmConfigError

        try:
            self.cluster.wlm.bind_role(stmt.role, stmt.group)
        except WlmConfigError as e:
            raise self._wlm_config_sqlerror(e) from None
        self._log_wlm_state()
        return Result("ALTER ROLE")

    def _rewrite(self, stmt: A.Statement, explain: bool = False):
        """The rewrite passes before a statement runs, in the
        reference's order: sequences bound, SQL functions inlined and
        PL/pgSQL calls evaluated (under ``explain``, planned as NULL
        placeholders), WITH and views (a CTE name shadows a view), then
        partitioned parents expanded over their children. Returns the
        statement, or the Result of an UPDATE / DELETE a partitioned
        parent fanned out over its children. Under ``explain`` only a
        SELECT is expanded over partitions: EXPLAIN runs no write."""
        stmt = self._expand_sequences(stmt)
        stmt = self._expand_views(self._expand_functions(stmt, explain))
        if explain and not isinstance(stmt, A.Select):
            return stmt
        return self._expand_partitions(stmt)

    # -- transactions ---------------------------------------------------
    def _new_txn(self) -> Transaction:
        """A transaction registered at the GTM, its snapshot the begin
        timestamp behind the stamping fence."""
        info = self.cluster.gts.begin()
        return Transaction(info.gxid, self.cluster.clamp_ts(info.start_ts))

    def _begin_implicit(self) -> tuple[Transaction, bool]:
        if self.txn is not None:
            return self.txn, False
        return self._new_txn(), True

    def _snapshot(self) -> int:
        if self.txn is not None:
            return self.txn.snapshot_ts
        return self.cluster.clamped_snapshot()

    def _x_beginstmt(self, stmt: A.BeginStmt) -> Result:
        if self.txn is not None:
            raise SQLError("there is already a transaction in progress")
        self.txn = self._new_txn()
        return Result("BEGIN")

    def _x_commitstmt(self, stmt: A.CommitStmt) -> Result:
        if self.txn is None:
            raise SQLError("there is no transaction in progress")
        txn, self.txn = self.txn, None
        try:
            self._commit_txn(txn)
        except SQLError:
            raise  # serialization failure: _commit_txn already aborted
        except FaultError:
            # an injected fault is the coordinator dying at its site: no
            # cleanup runs, so the in-doubt state (the votes, the GTM's
            # prepared entry, maybe a durable commit record) is left for
            # pg_resolve_indoubt as a crash would leave it. Aborting
            # after the commit record would drop committed rows
            raise
        except Exception:
            self._abort_txn(txn)
            raise
        return Result("COMMIT")

    def _x_rollbackstmt(self, stmt: A.RollbackStmt) -> Result:
        if self.txn is None:
            raise SQLError("there is no transaction in progress")
        self._abort_txn(self.txn)
        self.txn = None
        return Result("ROLLBACK")

    # -- savepoints ----------------------------------------------------------
    def _txn_block(self, what: str) -> Transaction:
        if self.txn is None:
            raise SQLError(f"{what} can only be used in transaction blocks")
        return self.txn

    def _x_savepointstmt(self, stmt: A.SavepointStmt) -> Result:
        self._txn_block("SAVEPOINT").mark_savepoint(stmt.name)
        return Result("SAVEPOINT")

    def _x_rollbacktosavepoint(self, stmt: A.RollbackToSavepoint) -> Result:
        self._txn_block("ROLLBACK TO SAVEPOINT").rollback_to_savepoint(
            stmt.name, self.cluster.stores)
        return Result("ROLLBACK")

    def _x_releasesavepoint(self, stmt: A.ReleaseSavepoint) -> Result:
        self._txn_block("RELEASE SAVEPOINT").release_savepoint(stmt.name)
        return Result("RELEASE")

    # -- explicit two-phase commit ----------------------------------------
    def _x_preparetransaction(self, stmt: A.PrepareTransaction) -> Result:
        """PREPARE TRANSACTION: the open transaction becomes a commit vote
        parked under its gid until COMMIT or ROLLBACK PREPARED, from any
        session (or after a crash: the 'T' record holds its writes)."""
        if self.txn is None:
            raise SQLError("there is no transaction in progress")
        txn = self.txn
        c = self.cluster
        if stmt.gid in c._prepared:
            self._abort_txn(txn)
            self.txn = None
            raise SQLError(f'transaction identifier "{stmt.gid}" is '
                           "already in use")
        try:
            self._check_write_conflicts(txn)
        except SQLError:
            self.txn = None
            raise
        nodes = txn.touched_nodes()
        # the datanodes vote first: a refusal leaves the coordinator as
        # it was (no parked transaction, no WAL record, the locks held),
        # so a plain ROLLBACK remains possible
        try:
            self._dn_2pc("2pc_prepare", stmt.gid, nodes, gxid=txn.gxid,
                         participants=list(nodes))
        except Exception:
            self._abort_txn(txn)
            self.txn = None
            raise
        txn.prepared_gid = stmt.gid
        c.gts.prepare(txn.gxid, stmt.gid, tuple(nodes))
        # a successful PREPARE is a commit vote that no later writer may
        # invalidate: its delete targets are reserved (xmax RESERVED_TS),
        # so COMMIT PREPARED never fails a serialization check
        for node, tabs in txn.writes.items():
            for table, tw in tabs.items():
                if tw.del_idx:
                    c.stores[node][table].stamp_xmax(
                        np.asarray(tw.del_idx, dtype=np.int64), RESERVED_TS)
        txn.prepared_at = time.time()
        # the session's row locks hand over to the reservations: the
        # deciding session may be another one, or a recovery
        c.locks.release_all(self.session_id)
        c._prepared[stmt.gid] = txn
        if c.persistence is not None:
            c.persistence.log_prepare(txn, c.stores)
        self.txn = None
        return Result("PREPARE TRANSACTION")

    def _x_commitprepared(self, stmt: A.CommitPrepared) -> Result:
        c = self.cluster
        txn = c._prepared.pop(stmt.gid, None)
        if txn is None:
            raise SQLError(f'prepared transaction "{stmt.gid}" does not '
                           "exist")
        # no conflict check: PREPARE reserved the delete targets
        commit_ts = c.commit_ts_begin_stamping(txn.gxid)
        try:
            self._stamp_commit(txn, commit_ts, wal_log=False)
            if c.persistence is not None:
                # inside the fence, as a 'G' frame is: no snapshot sees
                # the commit before its decision is logged
                c.persistence.log_commit_prepared(stmt.gid, commit_ts)
        finally:
            c.stamping_done(commit_ts)
        txn.unpin_all()
        c.gts.forget(txn.gxid)
        if c.persistence is not None:
            self.last_commit_lsn = max(self.last_commit_lsn,
                                       c.persistence.wal.position)
        try:
            self._dn_2pc("2pc_commit", stmt.gid, txn.touched_nodes(),
                         commit_ts=commit_ts)
        except Exception as e:
            # the decision is durable; clean_2pc retires the votes
            log.warning("COMMIT PREPARED %s, phase 2: %s", stmt.gid, e)
        return Result("COMMIT PREPARED")

    def _x_rollbackprepared(self, stmt: A.RollbackPrepared) -> Result:
        c = self.cluster
        txn = c._prepared.pop(stmt.gid, None)
        if txn is None:
            raise SQLError(f'prepared transaction "{stmt.gid}" does not '
                           "exist")
        self._abort_txn(txn)
        if c.persistence is not None:
            c.persistence.log_rollback_prepared(stmt.gid)
        try:
            self._dn_2pc("2pc_abort", stmt.gid, txn.touched_nodes())
        except Exception as e:
            log.warning("ROLLBACK PREPARED %s, phase 2: %s", stmt.gid, e)
        return Result("ROLLBACK PREPARED")

    # -- admin functions -------------------------------------------------
    def _maybe_admin_function(self, stmt: A.Select) -> Optional[Result]:
        """A FROM-less SELECT of one admin function: the in-doubt
        resolver, the deadlock breaker (pg_unlock_*), the WAL position,
        pg_sleep and pg_stat_reset run; the reference's others are
        refused by name. The state-changing ones are refused on a hot
        standby, whose 2PC state WAL replay owns."""
        if stmt.from_clause is not None or len(stmt.items) != 1:
            return None
        e = stmt.items[0].expr
        if not isinstance(e, A.FuncCall):
            return None
        item = self._ADMIN_REFUSED.get(e.name)
        if item is not None:
            raise NotPorted(f"admin function {e.name}() (ROADMAP {item})")
        if e.name in self._READONLY_ADMIN_FUNCS:
            return self._pg_sleep(e)
        if e.name not in self._ADMIN_FUNCS:
            return None
        c = self.cluster
        if c.read_only and e.name in ("pg_unlock_execute",
                                      "pg_resolve_indoubt"):
            raise SQLError(f"cannot execute {e.name}() in a read-only "
                           "(hot standby) cluster", "25006")
        if e.name == "pg_resolve_indoubt":
            age = float(self._const_arg(e.args[0])) if e.args else 0.0
            rows = c.resolve_indoubt(min_age_s=age)
            return Result("SELECT", rows, ["gid", "outcome"], len(rows))
        if e.name in ("pg_fault_inject", "pg_fault_clear"):
            return self._fault_function(e)
        if e.name == "pg_stat_reset":
            # the counters the port keeps (pg_stat_dml's)
            with c._dml_stats_mu:
                for k in c.dml_stats:
                    c.dml_stats[k] = 0
            c.stats_reset_at = time.time()
            return Result("SELECT", [("",)], ["pg_stat_reset"], 1)
        if e.name == "pg_current_wal_lsn":
            p = c.persistence
            pos = p.wal.position if p is not None else 0
            return Result("SELECT", [(int(pos),)], ["lsn"], 1)
        if e.name in ("pg_publication_tables", "pg_logical_slot_changes",
                      "pg_logical_sync"):
            return self._logical_function(e)
        if e.name == "pg_unlock_execute":
            gxids = c.locks.execute_unlock()
            return Result("SELECT", [(g,) for g in gxids],
                          ["cancelled_gxid"], len(gxids))
        if e.name == "pg_unlock_check_deadlock":
            rows = c.locks.check_deadlock()
            return Result("SELECT", rows, ["cycle", "gxid_path"], len(rows))
        rows = c.locks.check_dependency()  # pg_unlock_check_dependency
        return Result("SELECT", rows, ["waiter_gxid", "holder_gxid",
                                       "node_index", "relation"], len(rows))

    def _fault_function(self, e: A.FuncCall) -> Result:
        """pg_fault_inject(site, action[, spec]) arms a failpoint
        (fault/) on a session with fault_injection = on; pg_fault_clear
        ([site]) disarms, gated by nothing (an operator can always
        disarm). The registry is per process, so both are forwarded to
        every attached datanode process (best effort: an unreachable
        datanode is often the point)."""
        chans = list(self.cluster.dn_channels.values())
        if e.name == "pg_fault_clear":
            site = str(self._const_arg(e.args[0])) if e.args else None
            n = _fault.clear(site)
            for ch in chans:
                try:
                    n += int(ch.rpc({"op": "fault_clear",
                                     "site": site}).get("cleared", 0))
                except Exception:
                    pass
            return Result("SELECT", [(n,)], ["cleared"], 1)
        if not self.gucs.get("fault_injection"):
            raise SQLError("pg_fault_inject() requires fault_injection = on",
                           "55000")
        if len(e.args) not in (2, 3):
            raise SQLError("pg_fault_inject(site, action[, spec])")
        site = str(self._const_arg(e.args[0]))
        action = str(self._const_arg(e.args[1]))
        spec = str(self._const_arg(e.args[2])) if len(e.args) == 3 else ""
        try:
            _fault.inject(site, action, spec)
        except ValueError as ve:
            raise SQLError(str(ve)) from None
        forwarded = 0
        for ch in chans:
            try:
                ch.rpc({"op": "fault_arm", "site": site, "action": action,
                        "spec": spec})
                forwarded += 1
            except Exception:
                pass
        return Result("SELECT", [(site, forwarded)],
                      ["site", "datanodes_armed"], 1)

    def _published_tables(self, pub: dict) -> list[str]:
        if pub["tables"] is not None:
            return list(pub["tables"])
        return [nm for nm in self.cluster.catalog.table_names()
                if nm not in _SYSTEM_VIEWS and not nm.startswith("otb_")]

    def _logical_function(self, e: A.FuncCall) -> Result:
        """The publisher's side of logical replication, called by the
        subscriber over the wire: a publication's tables; its decoded
        commit frames from a slot offset (pgoutput's role), with a
        trailing fast-forward row past activity on other tables; and
        the initial sync, every published live row with the WAL offset
        the copy is consistent with, in one statement."""
        import json

        from opentenbase_tpu_torch.storage.logical import decode_changes

        c = self.cluster
        sig = {"pg_publication_tables": "pg_publication_tables(publication)",
               "pg_logical_slot_changes":
                   "pg_logical_slot_changes(publication, lsn)",
               "pg_logical_sync": "pg_logical_sync(publication)"}[e.name]
        nargs = 2 if e.name == "pg_logical_slot_changes" else 1
        if len(e.args) != nargs:
            raise SQLError(sig)
        pubname = str(self._const_arg(e.args[0]))
        pub = c.publications.get(pubname)
        if pub is None:
            raise SQLError(f'publication "{pubname}" does not exist')

        def _default(o):
            item = getattr(o, "item", None)
            return item() if item is not None else str(o)

        if e.name == "pg_publication_tables":
            tables = self._published_tables(pub)
            return Result("SELECT", [(tb,) for tb in tables],
                          ["tablename"], len(tables))
        if e.name == "pg_logical_slot_changes":
            lsn = int(self._const_arg(e.args[1]))
            try:
                next_off, frames = decode_changes(c, pub, lsn)
            except ValueError as ve:
                raise SQLError(str(ve)) from None
            # the poll's lsn is the consumer's confirmed position; the
            # first frame past it is the oldest dead row decode may
            # still need (the vacuum horizon)
            c._slot_horizon_ts[pubname] = (
                frames[0]["commit_ts"] if frames else None)
            rows = [(int(fr["next_off"]), json.dumps(
                {"commit_ts": fr["commit_ts"], "changes": fr["changes"]},
                default=_default)) for fr in frames]
            if next_off > lsn and (not rows or rows[-1][0] < next_off):
                rows.append((int(next_off), ""))
            return Result("SELECT", rows, ["next_lsn", "frame"], len(rows))
        p = c.persistence
        out = [("", str(int(p.wal.position if p else 0)))]
        snap = self._snapshot()
        for tb in self._published_tables(pub):
            if not c.catalog.has(tb):
                continue
            meta = c.catalog.get(tb)
            # the publication's scope, as streaming decode keeps it
            if meta.dist.is_replicated:
                src_nodes = [min(meta.node_indices)]
            elif pub["nodes"] is not None:
                src_nodes = [n for n in meta.node_indices
                             if n in pub["nodes"]]
            else:
                src_nodes = meta.node_indices
            for node in src_nodes:
                store = c.stores.get(node, {}).get(tb)
                if store is None or store.nrows == 0:
                    continue
                idx = store.live_index(snap)
                if not len(idx):
                    continue
                data = store.take_batch(idx).to_pydict()
                for r in range(len(idx)):
                    out.append((tb, json.dumps(
                        {col: data[col][r] for col in data},
                        default=_default)))
        return Result("SELECT", out, ["tablename", "payload"], len(out))

    def _pg_sleep(self, e: A.FuncCall) -> Result:
        """pg_sleep(seconds), in short slices so the statement's
        statement_timeout still cancels it (SQLSTATE 57014)."""
        secs = float(self._const_arg(e.args[0])) if e.args else 0.0
        end = time.monotonic() + max(secs, 0.0)
        while True:
            now = time.monotonic()
            if now >= end:
                break
            if self._stmt_deadline is not None and now >= self._stmt_deadline:
                raise SQLError("canceling statement due to statement "
                               "timeout", "57014")
            time.sleep(min(0.02, end - now))
        return Result("SELECT", [("",)], ["pg_sleep"], 1)

    @staticmethod
    def _const_arg(e: A.Expr):
        if isinstance(e, A.Literal):
            return e.value
        if (isinstance(e, A.UnaryOp) and e.op == "-"
                and isinstance(e.operand, A.Literal)
                and isinstance(e.operand.value, (int, float))
                and not isinstance(e.operand.value, bool)):
            return -e.operand.value
        raise SQLError("EXECUTE arguments must be constants")

    # -- PREPARE / EXECUTE / DEALLOCATE (prepare.c) -----------------------
    def _x_preparestmt(self, stmt: A.PrepareStmt) -> Result:
        if stmt.name in self.prepared_statements:
            raise SQLError(
                f'prepared statement "{stmt.name}" already exists')
        if isinstance(stmt.statement, (A.PrepareStmt, A.ExecuteStmt)):
            raise SQLError("cannot prepare a PREPARE/EXECUTE statement")
        self.prepared_statements[stmt.name] = stmt.statement
        # the arity is the template's: counted once, not on every EXECUTE
        self._prepared_nparams[stmt.name] = _count_params(stmt.statement)
        return Result("PREPARE")

    def _x_executestmt(self, stmt: A.ExecuteStmt) -> Result:
        """EXECUTE name(args): the template with its $n bound to the
        constant arguments, run as a statement of its own. A VALUES-only
        INSERT binds copy-on-write (the prepared-insert burst path: no
        rewrite below its root mutates it); anything else binds a fresh
        clone, since later rewrites mutate trees in place."""
        tmpl = self.prepared_statements.get(stmt.name)
        if tmpl is None:
            raise SQLError(
                f'prepared statement "{stmt.name}" does not exist')
        values = [self._const_arg(a) for a in stmt.args]
        nparams = self._prepared_nparams[stmt.name]
        if len(values) != nparams:
            raise SQLError(
                "wrong number of parameters for prepared statement "
                f'"{stmt.name}": expected {nparams}, got {len(values)}')
        if isinstance(tmpl, A.Insert) and tmpl.query is None:
            bound = _subst_params(tmpl, values)
            if bound is tmpl:
                bound = dataclasses.replace(tmpl)
        else:
            bound = _subst_params(_clone_ast(tmpl), values)
        return self._execute_one(bound)

    def _x_deallocatestmt(self, stmt: A.DeallocateStmt) -> Result:
        if stmt.name is None:
            self.prepared_statements.clear()
            self._prepared_nparams.clear()
        elif self.prepared_statements.pop(stmt.name, None) is None:
            raise SQLError(
                f'prepared statement "{stmt.name}" does not exist')
        else:
            self._prepared_nparams.pop(stmt.name, None)
        return Result("DEALLOCATE")

    # -- sequences (nextval, currval and setval as SQL) --------------------
    def _x_createsequence(self, stmt: A.CreateSequence) -> Result:
        try:
            self.cluster.gts.create_sequence(stmt.name, stmt.start,
                                             stmt.increment)
        except ValueError:
            if not stmt.if_not_exists:
                raise SQLError(f'sequence "{stmt.name}" already exists')
        else:
            self.cluster._seq_logged("seq_create", {
                "name": stmt.name, "start": stmt.start,
                "increment": stmt.increment, "min": 1, "max": 2**62,
                "cycle": False})
        return Result("CREATE SEQUENCE")

    def _x_dropsequence(self, stmt: A.DropSequence) -> Result:
        self.cluster.gts.drop_sequence(stmt.name)
        self.cluster._seq_logged("seq_drop", {"name": stmt.name})
        return Result("DROP SEQUENCE")

    def _seq_increment(self, name: str) -> int:
        """The sequence's increment where the GTM is in process; over the
        wire (no op reads it) 1, as the reference assumes."""
        seqs = getattr(self.cluster.gts, "_seqs", None)
        if isinstance(seqs, dict) and name in seqs:
            return int(seqs[name].increment)
        return 1

    @staticmethod
    def _seq_walk(e, visit) -> None:
        """``visit`` every expression node under ``e``; literals are
        leaves (the bulk VALUES path)."""
        if isinstance(e, A.Literal):
            return
        visit(e)
        if dataclasses.is_dataclass(e) and not isinstance(e, type):
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                for x in v if isinstance(v, (list, tuple)) else (v,):
                    if isinstance(x, A.Expr):
                        Session._seq_walk(x, visit)

    @staticmethod
    def _seq_positions(stmt):
        """The expressions a sequence function may stand in: INSERT
        VALUES rows and a FROM-less SELECT's items."""
        if isinstance(stmt, A.Insert) and stmt.values:
            return [v for row in stmt.values for v in row]
        if isinstance(stmt, A.Select) and stmt.from_clause is None:
            return [it.expr for it in stmt.items]
        return []

    def _expand_sequences(self, stmt: A.Statement):
        """Bind each sequence function call to a value from the GTM, per
        occurrence (each VALUES row its own nextval, the volatile
        semantics of sequence.c); each sequence's values of the
        statement come in ONE GTM round trip (get_rangemax). Elsewhere
        the analyzer refuses the functions."""
        exprs = self._seq_positions(stmt)
        if not exprs:
            return stmt
        counts: dict[str, int] = {}
        found = []

        def visit(e) -> None:
            if isinstance(e, A.FuncCall) and e.name in self._SEQ_FUNCS:
                found.append(e)
                if (e.name == "nextval" and e.args
                        and isinstance(e.args[0], A.Literal)):
                    name = str(e.args[0].value)
                    counts[name] = counts.get(name, 0) + 1

        for e in exprs:
            self._seq_walk(e, visit)
        if not found:
            return stmt
        c = self.cluster
        gts = c.gts
        reserved: dict = {}
        for name, n in counts.items():
            if c.read_only:
                raise SQLError("cannot execute nextval() in a read-only "
                               "(hot standby) cluster", "25006")
            try:
                first, last = gts.nextval(name, n)
            except KeyError:
                raise SQLError(f'sequence "{name}" does not exist') \
                    from None
            inc = self._seq_increment(name)
            c._seq_logged("seq_next", {"name": name, "next": last + inc})
            reserved[name] = iter(range(first, last + inc, inc))

        def bind(e):
            if isinstance(e, A.FuncCall) and e.name in self._SEQ_FUNCS:
                if not e.args or not isinstance(e.args[0], A.Literal):
                    raise SQLError(f"{e.name} requires a sequence name")
                name = str(e.args[0].value)
                if e.name == "nextval":
                    v = next(reserved[name])
                    self._seq_currval[name] = v
                elif e.name == "currval":
                    if name not in self._seq_currval:
                        raise SQLError(
                            f'currval of sequence "{name}" is not yet '
                            "defined in this session")
                    v = self._seq_currval[name]
                else:
                    # PG's setval: v becomes last_value, so the next
                    # nextval returns v + increment
                    if len(e.args) < 2:
                        raise SQLError("setval(sequence, value)")
                    if c.read_only:
                        raise SQLError(
                            "cannot execute setval() in a read-only "
                            "(hot standby) cluster", "25006")
                    v = int(self._const_arg(e.args[1]))
                    nxt = v + self._seq_increment(name)
                    try:
                        gts.setval(name, nxt)
                    except KeyError:
                        raise SQLError(
                            f'sequence "{name}" does not exist') from None
                    c._seq_logged("seq_set", {"name": name, "value": nxt})
                    self._seq_currval[name] = v
                return A.Literal(v)
            if dataclasses.is_dataclass(e) and not isinstance(e, type):
                changes = {}
                for f in dataclasses.fields(e):
                    val = getattr(e, f.name)
                    if isinstance(val, A.Expr):
                        nv = bind(val)
                        if nv is not val:
                            changes[f.name] = nv
                    elif isinstance(val, (list, tuple)):
                        out = [bind(x) if isinstance(x, A.Expr) else x
                               for x in val]
                        if any(a is not b for a, b in zip(out, val)):
                            changes[f.name] = type(val)(out)
                if changes:
                    return dataclasses.replace(e, **changes)
            return e

        if isinstance(stmt, A.Insert):
            return dataclasses.replace(
                stmt, values=[[bind(v) for v in row] for row in stmt.values])
        return dataclasses.replace(stmt, items=[
            A.SelectItem(bind(it.expr), it.alias) for it in stmt.items])

    def _lock_opts(self) -> dict:
        return {"lock_timeout_ms": self.gucs["lock_timeout"],
                "deadlock_timeout_ms": self.gucs["deadlock_timeout"]}

    def _acquire_row_locks(
        self, txn: Transaction, table: str, node: int, idx, mode: str,
        nowait: bool = False,
    ) -> None:
        """Row locks on store positions ``idx``, keyed by the stable row
        ids (VACUUM is fenced out by the store pin, taken BEFORE the
        wait). Then the lock targets are checked again for a committed
        concurrent change: the wait may have ended because a conflicting
        writer committed (PG's heap_lock_tuple HeapTupleUpdated)."""
        if len(idx) == 0:
            return
        store = self.cluster.stores[node][table]
        keys = [(node, table, int(rid))
                for rid in store.peek_row_id_at(np.asarray(idx))]
        newly_pinned = store not in txn.pinned
        txn.pin(store)
        try:
            self.cluster.locks.acquire(self.session_id, txn.gxid, keys,
                                       mode, nowait=nowait,
                                       **self._lock_opts())
        except Exception:
            if newly_pinned:
                store.unpin()
                txn.pinned.remove(store)
            raise
        if (store.peek_xmax_at(idx) != INF_TS).any():
            raise SQLError(
                "could not serialize access due to concurrent update",
                "40001",
            )

    def _check_write_conflicts(self, txn: Transaction) -> None:
        """First committer wins: a row this transaction deletes that
        another already stamped would be changed twice."""
        for node, tabs in txn.writes.items():
            for table, tw in tabs.items():
                if not tw.del_idx:
                    continue
                store = self.cluster.stores[node][table]
                idx = np.asarray(tw.del_idx, dtype=np.int64)
                if (store.peek_xmax_at(idx) != INF_TS).any():
                    self._abort_txn(txn)
                    raise SQLError(
                        "could not serialize access due to concurrent "
                        "update", "40001",
                    )

    def _commit_txn(self, txn: Transaction) -> None:
        c = self.cluster
        with c._commit_active_mu:
            c._commit_active += 1
        try:
            self._commit_txn_inner(txn)
        finally:
            with c._commit_active_mu:
                c._commit_active -= 1

    def _commit_txn_inner(self, txn: Transaction) -> None:
        """Stamp and log the commit. Over more than one node, an implicit
        2PC around it: the GTM registers the prepare before the
        irrevocable stamp, and where a datanode process takes part the
        participants journal the shipped write set first (a failed vote
        aborts), the frame carries the gid, and phase 2 applies the
        journals (a lost phase-2 message is safe: the decision is in
        the WAL and the stream brings the rows). Then the
        ``synchronous_commit`` rung's standby wait."""
        self._check_write_conflicts(txn)
        c = self.cluster
        self.last_2pc = None
        nodes = txn.touched_nodes()
        gid = frame = None
        implicit_gid = None
        if len(nodes) > 1:
            implicit_gid = f"__implicit_{txn.gxid}"
            c._open_gids.add(implicit_gid)
        if implicit_gid is not None and any(n in c.dn_channels
                                            for n in nodes):
            from opentenbase_tpu_torch.plan import serde

            gid = implicit_gid
            frame = self._txn_write_frame(txn)
            extra = {"writes": serde.frame_to_wire(*frame)}
            with c._dml_stats_mu:
                c.dml_stats["shipped"] += 1
            t0 = time.perf_counter()
            try:
                self._dn_2pc("2pc_prepare", gid, nodes, gxid=txn.gxid,
                             participants=list(nodes), **extra)
            except Exception:
                c._open_gids.discard(gid)
                self._abort_txn(txn)
                raise
            self.last_2pc = {"gid": gid, "nodes": list(nodes),
                             "prepare_ms": (time.perf_counter() - t0) * 1e3}
        commit_lsn = None
        cts = None
        try:
            if implicit_gid is not None:
                try:
                    c.gts.prepare(txn.gxid, implicit_gid, tuple(nodes))
                except Exception:
                    self._abort_txn(txn)
                    if gid is not None:
                        try:
                            self._dn_2pc("2pc_abort", gid, nodes)
                        except Exception:
                            pass  # clean_2pc sweeps the vote
                    raise
                # failpoint: the coordinator dying between the prepare
                # and the commit record. Outside every abort handler:
                # the state it leaves (the votes, the GTM's prepared
                # entry, no commit record) is a crash at this instant,
                # which pg_resolve_indoubt drives to abort
                FAULT("coord/2pc_after_prepare", gid=implicit_gid)
            if nodes:
                cts = c.commit_ts_begin_stamping(
                    txn.gxid, batched=bool(self.gucs["enable_group_commit"]))
                try:
                    try:
                        commit_lsn = self._stamp_commit(txn, cts, gid=gid,
                                                        frame=frame)
                    except Exception:
                        self._abort_txn(txn, failed_commit_ts=cts)
                        if gid is not None:
                            try:
                                self._dn_2pc("2pc_abort", gid, nodes)
                            except Exception:
                                pass  # clean_2pc sweeps the vote
                        raise
                finally:
                    c.stamping_done(cts)
            if implicit_gid is not None:
                # failpoint: the coordinator dying after the durable
                # commit record, before phase 2 (the resolver drives it
                # to commit: the decision is in the WAL)
                FAULT("coord/2pc_before_phase2", gid=implicit_gid)
            try:
                c.gts.forget(txn.gxid)
            except Exception as e:
                log.warning("GTM forget of gxid %d: %s", txn.gxid, e)
            if commit_lsn is not None:
                self.last_commit_lsn = max(self.last_commit_lsn, commit_lsn)
            if gid is not None:
                t0 = time.perf_counter()
                try:
                    self._dn_2pc("2pc_commit", gid, nodes, commit_ts=cts)
                except Exception as e:
                    log.warning("2PC phase 2 of %s: %s", gid, e)
                self.last_2pc["commit_ms"] = (
                    (time.perf_counter() - t0) * 1e3)
        finally:
            if implicit_gid is not None:
                c._open_gids.discard(implicit_gid)
        txn.unpin_all()
        c.locks.release_all(self.session_id)
        mode = self.gucs["synchronous_commit"]
        if commit_lsn is None or mode not in ("on", "remote_write"):
            return
        has_standbys = bool(c.dn_channels) or (
            mode == "remote_write" and c.persistence is not None
            and any(sd.peer_positions()
                    for sd in c.persistence.wal_senders))
        if not has_standbys:
            return
        ok = (c.wait_standbys_applied(commit_lsn) if mode == "on"
              else c.wait_standbys_acked(commit_lsn))
        if not ok:
            # committed locally, the replication guarantee unmet: the
            # outcome is indeterminate to the client
            raise SQLError(
                f"synchronous commit ({mode}): no standby "
                + ("quorum acked" if mode == "remote_write"
                   else "confirmed apply of")
                + f" WAL position {commit_lsn}; the transaction is "
                "committed locally but unreplicated; outcome "
                "indeterminate, verify before re-issuing", "08006")

    def _txn_write_frame(self, txn: Transaction):
        """The transaction's writes as a commit-group frame for the
        datanodes' 2PC journals, with each touched dictionary's delta
        above the WAL-synced watermark (a datanode missing earlier
        values defers to the stream)."""
        from opentenbase_tpu_torch.storage.persist import (
            encode_commit_group,
        )

        writes = [(node, table, tw.ins_ranges, tw.del_idx)
                  for node, tabs in txn.writes.items()
                  for table, tw in tabs.items()]
        p = self.cluster.persistence
        return encode_commit_group(
            writes, self.cluster.stores, catalog=self.cluster.catalog,
            dict_synced=p._dict_synced if p is not None else {})

    def _ha_demote(self, exc) -> None:
        """A datanode at a newer generation fenced this node out: every
        further statement is refused with 72000 until the node is
        rejoined as a standby (rejoin_standby)."""
        c = self.cluster
        c.ha_stats["fenced_refusals"] += 1
        if not c.ha_demoted:
            c.ha_demoted = True
            log.error("node fenced by a newer generation (ours %d, the "
                      "peer's %s): demoting; this ex-primary must resync "
                      "before serving again", c.node_generation,
                      getattr(exc, "peer_generation", None))

    def _dn_2pc(self, op: str, gid: str, nodes, **extra) -> list[int]:
        """A 2PC message to every participating datanode process, in
        parallel, carrying our fencing generation. Returns the nodes
        that acknowledged; any failure raises: SQLSTATE 72000 after a
        demotion where a datanode fenced us, else 08006."""
        from opentenbase_tpu_torch.net.pool import ChannelFenced

        chans = self.cluster.dn_channels
        targets = [(n, chans[n]) for n in nodes if n in chans]
        results: dict = {}
        errors: list = []
        hgen = self.cluster.node_generation

        def send(n, ch):
            try:
                results[n] = ch.rpc({"op": op, "gid": gid, "hgen": hgen,
                                     **extra})
            except Exception as e:  # a channel failure is a failed vote
                errors.append((n, e))

        ths = [threading.Thread(target=send, args=tg) for tg in targets]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        for n, e in errors:
            if isinstance(e, ChannelFenced):
                # never 08006: a retry would be the split-brain write
                self._ha_demote(e)
                raise SQLError(f"datanode {n} fenced {op} for {gid!r}: "
                               f"{e}", "72000")
        if errors:
            n, e = errors[0]
            raise SQLError(f"datanode {n} failed {op} for {gid!r}: {e}",
                           "08006")
        return sorted(results)

    def _stamp_commit(self, txn: Transaction, commit_ts: int,
                      gid=None, frame=None,
                      wal_log: bool = True) -> Optional[int]:
        """Every insert range's xmin and every deleted position's xmax at
        one commit timestamp, store by store, then (with a data
        directory) the commit's one WAL 'G' frame, durable by the
        session's ``synchronous_commit`` (tagged with ``gid`` and built
        from ``frame`` when the write set was shipped). All of it runs
        inside the stamping fence, so no snapshot sees the commit before
        its frame is logged; a WAL failure raises, and the caller rolls
        the stamps back. ``wal_log`` False: an explicitly PREPAREd
        transaction, whose writes the 'T' record holds and whose
        decision is the 'C' record. Returns the WAL offset just past
        the frame (None without one)."""
        for node, tabs in txn.writes.items():
            for table, tw in tabs.items():
                store = self.cluster.stores[node][table]
                for s, e in tw.ins_ranges:
                    store.stamp_xmin(s, e, commit_ts)
                if tw.del_idx:
                    store.stamp_xmax(
                        np.asarray(tw.del_idx, dtype=np.int64), commit_ts)
        # the committed-write counters (the matview rewrite's staleness)
        self.cluster.bump_table_versions(
            {tb for tabs in txn.writes.values() for tb in tabs})
        p = self.cluster.persistence if wal_log else None
        if p is not None:
            with self.cluster._commit_active_mu:
                active = self.cluster._commit_active
            return p.log_commit_group(
                [(node, table, tw.ins_ranges, tw.del_idx)
                 for node, tabs in txn.writes.items()
                 for table, tw in tabs.items()],
                self.cluster.stores, commit_ts, gid=gid, frame=frame,
                sync_mode=self.gucs["synchronous_commit"],
                commit_delay_us=self.gucs["commit_delay_us"],
                commit_siblings=self.gucs["commit_siblings"],
                group_commit=self.gucs["enable_group_commit"],
                commit_active=active,
            )
        return None

    def _abort_txn(
        self, txn: Transaction, failed_commit_ts: Optional[int] = None
    ) -> None:
        if txn.aborted:
            return
        txn.aborted = True
        for node, tabs in txn.writes.items():
            for table, tw in tabs.items():
                store = self.cluster.stores[node][table]
                for s, e in tw.ins_ranges:
                    store.truncate_range(s, e)
                if tw.del_idx:
                    # undo only OUR xmax stamps: a PREPARE's reservation
                    # or a half-applied commit's; rows another
                    # transaction deleted stay deleted
                    idx = np.asarray(tw.del_idx, dtype=np.int64)
                    cur = store.peek_xmax_at(idx)
                    mine = cur == RESERVED_TS
                    if failed_commit_ts is not None:
                        mine |= cur == failed_commit_ts
                    if mine.any():
                        store.unstamp_xmax(idx[mine])
        txn.unpin_all()
        try:
            self.cluster.gts.abort(txn.gxid)
            self.cluster.gts.forget(txn.gxid)
        except Exception as e:
            log.warning("GTM abort of gxid %d: %s", txn.gxid, e)
        self.cluster.locks.release_all(self.session_id)

    def _finish(self, txn: Transaction, implicit: bool, fn):
        """Run the write ``fn`` inside ``txn``: an implicit transaction
        commits after it and aborts on its failure; an explicit one
        stays open on the session."""
        try:
            out = fn()
        except Exception:
            if implicit:
                self._abort_txn(txn)
            raise
        if implicit:
            self._commit_txn(txn)
        else:
            self.txn = txn
        return out

    # -- DDL ---------------------------------------------------------------
    def _x_createtable(self, stmt: A.CreateTable) -> Result:
        cat = self.cluster.catalog
        if stmt.to_group is not None:
            raise NotPorted("CREATE TABLE ... TO GROUP")
        self._reserved_relation(stmt.name)
        if cat.has(stmt.name):
            if stmt.if_not_exists:
                return Result("CREATE TABLE")
            raise SQLError(f'relation "{stmt.name}" already exists')
        schema: dict[str, t.SqlType] = {}
        for cd in stmt.columns:
            schema[cd.name] = t.type_from_name(cd.type_name, cd.type_args)
        dist = self._dist_spec(stmt)
        constraints = self._column_constraints(stmt, schema)
        if stmt.partition_by is not None:
            return self._create_partitioned(stmt, schema, dist, constraints)
        self._create_table(stmt.name, schema, dist, constraints)
        return Result("CREATE TABLE")

    def _create_partitioned(self, stmt: A.CreateTable, schema,
                            dist: DistributionSpec,
                            constraints: dict) -> Result:
        """Interval / range partitioning (gram.y:4172): the parent a
        catalog-only shell, each partition a real table sharing the
        parent's dictionaries (one logical table: encoded rows route
        freely between them). Its 'D' records: the parent's first (the
        children's replay reads its spec), then each child's."""
        from opentenbase_tpu_torch.plan.partition import (
            PartitionError,
            PartitionSpec,
        )

        clause = stmt.partition_by
        col = clause.get("column")
        if col not in schema:
            raise SQLError(f'partition column "{col}" does not exist')
        pk = constraints.get("primary_key")
        if pk is not None and pk != col:
            # per-child uniqueness is whole only where equal keys always
            # land in one child (PG: the key must hold the partition key)
            raise SQLError("PRIMARY KEY on a partitioned table must be the "
                           "partition column")
        try:
            spec = PartitionSpec.build(stmt.name, clause, schema[col])
        except PartitionError as e:
            raise SQLError(str(e)) from None
        cat = self.cluster.catalog
        parent = cat.create_table(stmt.name, schema, dist)  # the shell
        apply_constraints(parent, constraints)
        self.cluster.partitions[stmt.name] = spec
        self._log_ddl({
            "op": "create_parent", "name": stmt.name,
            "schema": {k: _type_to_str(v) for k, v in schema.items()},
            "strategy": dist.strategy.value,
            "key_columns": list(dist.key_columns),
            "partition": spec.spec,
            "constraints": constraints,
        })
        for child in spec.children():
            self._create_table(child, schema, dist, constraints,
                               dictionaries=parent.dictionaries)
        return Result("CREATE TABLE")

    def _x_createforeigntable(self, stmt: A.CreateForeignTable) -> Result:
        """CREATE FOREIGN TABLE ... SERVER file OPTIONS (...)
        (src/backend/foreign, contrib/file_fdw): a replicated catalog
        entry on one node and no stores; its scan reads the source
        (fdw.py) on the host route."""
        cat = self.cluster.catalog
        self._reserved_relation(stmt.name)
        if cat.has(stmt.name):
            raise SQLError(f'relation "{stmt.name}" already exists')
        schema: dict[str, t.SqlType] = {}
        for cd in stmt.columns:
            schema[cd.name] = t.type_from_name(cd.type_name, cd.type_args)
        meta = cat.create_table(stmt.name, schema,
                                DistributionSpec(DistStrategy.REPLICATED))
        meta.node_indices = meta.node_indices[:1]  # the scan's one node
        meta.foreign = dict(stmt.options)
        meta.foreign["server"] = stmt.server
        self._log_ddl({
            "op": "create_foreign_table", "name": stmt.name,
            "schema": {k: str(v) for k, v in schema.items()},
            "server": stmt.server, "options": dict(stmt.options),
        })
        return Result("CREATE FOREIGN TABLE")

    def _column_constraints(self, stmt: A.CreateTable, schema) -> dict:
        """NOT NULL, PRIMARY KEY (which implies NOT NULL: a NULL key
        would be stored as 0 and collide with a real 0) and DEFAULT
        constants, each default checked against its column type now."""
        from opentenbase_tpu_torch.storage.column import Dictionary

        not_null, defaults, pk = [], {}, None
        for cd in stmt.columns:
            if cd.not_null:
                not_null.append(cd.name)
            if cd.primary_key:
                pk = cd.name
                if cd.name not in not_null:
                    not_null.append(cd.name)
            if cd.default is not None:
                try:
                    v = self._const_arg(cd.default)
                except SQLError:
                    raise SQLError(f'default for column "{cd.name}" must '
                                   "be a constant") from None
                ty = schema[cd.name]
                try:
                    column_from_python(
                        [v], ty,
                        Dictionary() if ty.id == t.TypeId.TEXT else None)
                except (ValueError, TypeError):
                    raise SQLError(f'default for column "{cd.name}" is not '
                                   f"valid for type {ty}") from None
                defaults[cd.name] = v
        return {"not_null": not_null, "defaults": defaults,
                "primary_key": pk}

    def _create_table(self, name: str, schema: dict,
                      dist: DistributionSpec,
                      constraints: Optional[dict] = None,
                      dictionaries: Optional[dict] = None) -> TableMeta:
        """A new table's catalog entry, its constraints, its stores, and
        its 'D' record; ``dictionaries``: a partition's, its parent's."""
        constraints = constraints or {"not_null": [], "defaults": {},
                                      "primary_key": None}
        meta = self.cluster.catalog.create_table(name, schema, dist)
        if dictionaries is not None:
            meta.dictionaries = dictionaries
        apply_constraints(meta, constraints)
        self.cluster.create_table_stores(meta)
        self._log_ddl({
            "op": "create_table", "name": name,
            "schema": {k: _type_to_str(v) for k, v in schema.items()},
            "strategy": meta.dist.strategy.value,
            "key_columns": list(meta.dist.key_columns),
            "group": meta.dist.group,
            "constraints": constraints,
        })
        return meta

    def _log_ddl(self, op: dict) -> None:
        if self.cluster.persistence is not None:
            self.cluster.persistence.log_ddl(op)

    def _x_droptable(self, stmt: A.DropTable) -> Result:
        """DROP TABLE [IF EXISTS] [CASCADE]: refused while a view depends
        on the table, unless CASCADE drops those views first. The table's
        stores and device residency go with it."""
        cat = self.cluster.catalog
        for name in stmt.names:
            if name in self.cluster.views:
                raise SQLError(f'"{name}" is a view (use DROP VIEW)')
            deps = self._dependent_views(name)
            mv_deps = self._dependent_matviews(name)
            if (deps or mv_deps) and stmt.cascade:
                self._drop_dependents(name)
                deps = self._dependent_views(name)
                mv_deps = self._dependent_matviews(name)
            if deps:
                raise SQLError(
                    f'cannot drop table "{name}": view(s) '
                    f"{', '.join(sorted(deps))} depend on it", "2BP01")
            if mv_deps:
                raise SQLError(
                    f'cannot drop table "{name}": materialized '
                    f"view(s) {', '.join(mv_deps)} depend on it", "2BP01")
            if not cat.has(name):
                if stmt.if_exists:
                    continue
                raise SQLError(f'relation "{name}" does not exist')
            cat.drop_table(name)
            self.cluster.drop_table_stores(name)
            self._log_ddl({"op": "drop_table", "name": name})
        return Result("DROP TABLE")

    def _x_createuser(self, stmt: A.CreateUser) -> Result:
        """CREATE/ALTER USER ... PASSWORD: a SCRAM-SHA-256 verifier in
        ``cluster.users``, never the password (net/auth.py)."""
        from opentenbase_tpu_torch.net.auth import build_verifier

        users = self.cluster.users
        if not stmt.alter and stmt.name in users:
            raise SQLError(f'role "{stmt.name}" already exists')
        if stmt.alter and stmt.name not in users:
            raise SQLError(f'role "{stmt.name}" does not exist')
        verifier = build_verifier(stmt.password)
        users[stmt.name] = verifier
        self._log_ddl({"op": "create_user", "name": stmt.name,
                       "verifier": verifier})
        return Result("ALTER ROLE" if stmt.alter else "CREATE ROLE")

    def _x_dropuser(self, stmt: A.DropUser) -> Result:
        if stmt.name not in self.cluster.users:
            if stmt.if_exists:
                return Result("DROP ROLE")
            raise SQLError(f'role "{stmt.name}" does not exist')
        del self.cluster.users[stmt.name]
        self._log_ddl({"op": "drop_user", "name": stmt.name})
        # a dangling binding would block DROP RESOURCE GROUP for ever
        if stmt.name in self.cluster.wlm.role_bindings:
            self.cluster.wlm.bind_role(stmt.name, None)
            self._log_wlm_state()
        return Result("DROP ROLE")

    def _x_createindex(self, stmt: A.CreateIndex) -> Result:
        """A columnar engine's index: zone maps (block min and max, as
        BRIN keeps them). CREATE INDEX registers the columns for pruning
        and builds every shard's summaries now (the reference's, without
        its persistence log)."""
        meta = self._table_meta(stmt.table)
        for col in stmt.columns:  # validate everything before mutating
            if col not in meta.schema:
                raise SQLError(f'column "{col}" of relation '
                               f'"{stmt.table}" does not exist')
        for col in stmt.columns:
            meta.zone_cols.add(col)
            for n in meta.node_indices:
                store = self.cluster.stores.get(n, {}).get(stmt.table)
                if store is not None:
                    store.zone_map(col)
        self._log_ddl({"op": "create_index", "name": stmt.name,
                       "table": stmt.table, "columns": list(stmt.columns)})
        return Result("CREATE INDEX")

    @classmethod
    def _dist_spec(cls, stmt: A.CreateTable) -> DistributionSpec:
        """The named strategy, else the reference's default: SHARD on the
        primary key, else on the first column."""
        if stmt.distribute_strategy:
            return cls._dist_spec_named(stmt.distribute_strategy,
                                        stmt.distribute_keys)
        key = next((cd.name for cd in stmt.columns if cd.primary_key),
                   stmt.columns[0].name)
        return DistributionSpec(DistStrategy.SHARD, (key,))

    @staticmethod
    def _dist_spec_named(strategy: str, keys) -> DistributionSpec:
        """The one strategy name -> DistributionSpec mapper (CREATE TABLE
        and ALTER TABLE ... DISTRIBUTE BY)."""
        s = (strategy or "").lower()
        if s in ("replication", "replicated"):
            return DistributionSpec(DistStrategy.REPLICATED)
        if s == "roundrobin":
            return DistributionSpec(DistStrategy.ROUNDROBIN)
        if s in ("shard", "hash", "modulo"):
            if not keys:
                raise SQLError(f"{s} distribution requires a key column")
            strat = {"shard": DistStrategy.SHARD, "hash": DistStrategy.HASH,
                     "modulo": DistStrategy.MODULO}[s]
            return DistributionSpec(strat, tuple(keys))
        raise SQLError(f"unknown distribution strategy {strategy!r}")

    # -- TRUNCATE, ALTER TABLE, LOCK TABLE ------------------------------------
    def _x_truncatetable(self, stmt: A.TruncateTable) -> Result:
        """Every named table gets fresh empty stores, and its 'D' record.
        Refused while a transaction holds positions in the table."""
        for name in stmt.names:
            self._table_meta(name)
            self.cluster._refuse_pinned(name, "truncate")
        for name in stmt.names:
            self.cluster.truncate_table(name)
            self._log_ddl({"op": "truncate", "name": name})
        return Result("TRUNCATE TABLE")

    def _x_altertable(self, stmt: A.AlterTable) -> Result:
        """ADD COLUMN, DROP COLUMN and DISTRIBUTE BY, each with its 'D'
        record (a redistribution then takes a checkpoint: its stores were
        rewritten whole) and ADD PARTITIONS. A partition is altered
        through its parent only."""
        c = self.cluster
        meta = self._table_meta(stmt.table)
        child_of = {ch: p for p, ps in c.partitions.items()
                    for ch in ps.children()}
        if stmt.table in child_of:
            raise SQLError(
                f'cannot alter "{stmt.table}": it is a partition of '
                f'"{child_of[stmt.table]}" (alter the parent)')
        if stmt.action == "add_column":
            cd = stmt.column
            ty = t.type_from_name(cd.type_name, cd.type_args)
            c.alter_add_column(stmt.table, cd.name, ty)
            self._log_ddl({"op": "add_column", "name": stmt.table,
                           "column": cd.name, "type": _type_to_str(ty)})
            return Result("ALTER TABLE")
        if stmt.action == "drop_column":
            c.alter_drop_column(stmt.table, stmt.column_name)
            self._log_ddl({"op": "drop_column", "name": stmt.table,
                           "column": stmt.column_name})
            return Result("ALTER TABLE")
        if stmt.action == "distribute":
            for k in stmt.keys:
                if k not in meta.schema:
                    raise SQLError(f'distribution key "{k}" is not a column')
            dist = self._dist_spec_named(stmt.strategy, stmt.keys)
            n = c.redistribute_table(stmt.table, dist)
            if c.persistence is not None:
                c.persistence.log_ddl({
                    "op": "redistribute", "name": stmt.table,
                    "strategy": dist.strategy.value,
                    "key_columns": list(dist.key_columns)})
                c.persistence.checkpoint()
            return Result("ALTER TABLE", rowcount=n)
        if stmt.action == "add_partitions":
            c.extend_partitions(stmt.table, stmt.count)
            self._log_ddl({"op": "add_partitions", "name": stmt.table,
                           "count": stmt.count})
            return Result("ALTER TABLE")
        raise SQLError(f"unsupported ALTER TABLE action {stmt.action}")

    def _x_locktable(self, stmt: A.LockTable) -> Result:
        """LOCK TABLE (lockcmds.c): a table lock in the mode's class on
        every node holding the table, to the end of the transaction."""
        if self.txn is None:
            raise SQLError("LOCK TABLE can only be used in transaction "
                           "blocks")
        if not self.cluster.catalog.has(stmt.table):
            raise SQLError(f'table "{stmt.table}" does not exist')
        meta = self.cluster.catalog.get(stmt.table)
        self.cluster.locks.acquire(
            self.session_id, self.txn.gxid,
            [(node, tb) for tb in self._lock_table_names(stmt.table)
             for node in meta.node_indices],
            table_lock_mode(stmt.mode), nowait=stmt.nowait,
            **self._lock_opts())
        return Result("LOCK TABLE")

    def _x_vacuumstmt(self, stmt: A.VacuumStmt) -> Result:
        """Reclaim rows deleted before the newest timestamp, store by
        store; a store a transaction pins is skipped (its positions are
        that transaction's identifiers). Row positions are rewritten, so
        the device cache rebuilds the table on its next read, and a
        checkpoint is taken (redo starts from the renumbered rows)."""
        c = self.cluster
        oldest = c.gts.snapshot_ts()
        # a logical slot's horizon: dead rows newer than its oldest
        # unconfirmed frame are still decode's old tuples
        for ts in c._slot_horizon_ts.values():
            if ts is not None:
                oldest = min(oldest, ts - 1)
        cat = c.catalog
        names = [stmt.table] if stmt.table else cat.table_names()
        removed = 0
        for name in names:
            if not cat.has(name):
                raise SQLError(f'relation "{name}" does not exist')
            # an incremental matview resolves deleted rows against their
            # dead versions: those newer than its last refresh stay
            t_oldest = oldest
            for d in c.matviews.values():
                if (d.wants_incremental() and name in d.base_tables
                        and d.last_refresh_ts):
                    t_oldest = min(t_oldest, d.last_refresh_ts)
            for n in cat.get(name).node_indices:
                store = c.stores[n].get(name)
                if store is not None and hasattr(store, "vacuum"):
                    removed += store.vacuum(t_oldest)
        if removed and self.cluster.persistence is not None:
            self.cluster.persistence.checkpoint()
        return Result("VACUUM", rowcount=removed)

    # -- views, WITH, CREATE TABLE AS and SQL functions ------------------------
    # -- WITH RECURSIVE (parse_cte.c's checkWellFormedRecursion,
    # nodeRecursiveUnion.c) ----------------------------------------------
    def _materialize_recursive_ctes(self, stmt: A.Statement):
        """Self-referencing CTEs evaluated to their fixpoint into
        temporary tables before analysis (nodeRecursiveUnion.c's working
        and intermediate tables, table-backed so every later stage sees
        a plain relation): (the statement over those tables, the tables
        to drop after it), or None where no CTE recurses. A plain
        EXPLAIN executes nothing: it plans over empty stand-ins and
        prints the Recursive Union's shape."""
        sel = None
        if isinstance(stmt, A.Select):
            sel = stmt
        elif isinstance(stmt, A.ExplainStmt) and isinstance(
                stmt.query, A.Select):
            sel = stmt.query
        elif isinstance(stmt, A.CreateTableAs):
            sel = stmt.query
        elif isinstance(stmt, A.Insert) and stmt.query is not None:
            sel = stmt.query
        if sel is None or not sel.ctes_recursive or not sel.ctes:
            return None
        from opentenbase_tpu_torch.plan.astwalk import (
            relation_names,
            rename_relations,
        )

        if not any(name in relation_names(body)
                   for name, _a, body in sel.ctes):
            return None  # RECURSIVE written, nothing recursive: plain
        self.recursive_iterations = {}
        if isinstance(stmt, A.ExplainStmt) and not stmt.analyze:
            return self._explain_recursive_shape(stmt, sel)
        if self.cluster.read_only:
            raise SQLError("recursive queries are not supported on a "
                           "read-only (hot standby) cluster")
        temps: list[str] = []
        rename: dict[str, str] = {}
        kept = []
        try:
            for name, aliases, body in sel.ctes:
                if rename:
                    rename_relations(body, rename)
                if name not in relation_names(body):
                    kept.append((name, aliases, body))
                    continue
                rename[name] = self._recursive_union(
                    name, aliases, body, temps, kept)
            sel.ctes = kept
            if rename:
                rename_relations(sel, rename)
        except Exception:
            self._drop_temps(temps)
            raise
        return stmt, temps

    def _drop_temps(self, temps: list) -> None:
        for name in reversed(temps):
            if name.startswith("__recshape_"):
                # EXPLAIN's stand-ins went straight into the catalog and
                # never reached the WAL: no DROP record either
                if self.cluster.catalog.has(name):
                    self.cluster.catalog.drop_table(name)
                self.cluster.drop_table_stores(name)
                continue
            try:
                self.execute(f"drop table if exists {name}")
            except SQLError:
                pass

    @staticmethod
    def _recursive_parts(name: str, body: A.Select):
        """(the union operator, the non-recursive term, the recursive
        term) of a recursive CTE's body, with the reference's errors."""
        import copy

        from opentenbase_tpu_torch.plan.astwalk import relation_names

        if not body.set_ops:
            raise SQLError(
                f'recursive query "{name}" must have the form '
                "non-recursive-term UNION [ALL] recursive-term")
        op, rec_term = body.set_ops[-1]
        if op not in ("union", "union all"):
            raise SQLError(f'recursive query "{name}" must use UNION [ALL]')
        base = copy.copy(body)
        base.set_ops = body.set_ops[:-1]
        if name in relation_names(base):
            raise SQLError(
                f'recursive reference to query "{name}" must not appear '
                "within its non-recursive term")
        return op, base, rec_term

    def _explain_recursive_shape(self, stmt: A.ExplainStmt, sel):
        """Plain EXPLAIN of WITH RECURSIVE, executing nothing: each
        recursive CTE's non-recursive term is analyzed for its output
        columns, an empty catalog-only stand-in (no WAL) takes the place
        of the self-reference, and both terms' plans lead the report
        under the Recursive Union line (obs/explain.py)."""
        import copy
        import uuid

        from opentenbase_tpu_torch.obs.explain import recursive_union_lines
        from opentenbase_tpu_torch.plan.astwalk import (
            relation_names,
            rename_relations,
        )
        from opentenbase_tpu_torch.plan.views import expand_ctes

        cat = self.cluster.catalog
        temps: list[str] = []
        rename: dict[str, str] = {}
        kept = []
        prelude: list[str] = []

        def plan_lines(splan) -> list[str]:
            return distribute_statement(optimize_statement(splan, cat),
                                        cat).explain().splitlines()

        try:
            for name, aliases, body in sel.ctes:
                if rename:
                    rename_relations(body, rename)
                if name not in relation_names(body):
                    kept.append((name, aliases, body))
                    continue
                if not body.set_ops:
                    self._recursive_parts(name, body)  # raises
                if kept:
                    body.ctes = [copy.deepcopy(sib) for sib in kept] + list(
                        body.ctes)
                expand_ctes(body)
                op, base, rec_term = self._recursive_parts(name, body)
                base_splan = analyze_statement(base, cat)
                out_schema = base_splan.root.schema
                cols = [oc.name for oc in out_schema]
                if aliases and len(aliases) == len(cols):
                    cols = list(aliases)
                shape = f"__recshape_{uuid.uuid4().hex[:10]}_{name}"
                meta = cat.create_table(
                    shape, {c: oc.type for c, oc in zip(cols, out_schema)},
                    DistributionSpec(DistStrategy.REPLICATED))
                self.cluster.create_table_stores(meta)
                temps.append(shape)
                rename[name] = shape
                rec2 = copy.deepcopy(rec_term)
                rename_relations(rec2, {name: shape, **rename})
                prelude += recursive_union_lines(
                    name, op, plan_lines(base_splan),
                    plan_lines(analyze_statement(rec2, cat)))
            sel.ctes = kept
            if rename:
                rename_relations(sel, rename)
        except Exception:
            self._drop_temps(temps)
            raise
        self._explain_prelude = prelude
        self._explain_rename = {shape: name for name, shape in rename.items()}
        return stmt, temps

    def _recursive_union(self, name: str, aliases: list, body: A.Select,
                         temps: list, siblings: list = ()) -> str:
        """One recursive CTE materialized: the non-recursive term into a
        table, then the recursive term run over the previous
        iteration's rows (the working table) until it yields none, each
        iteration's rows appended (UNION: less every row already
        there). Returns the table holding the CTE's rows; every table it
        made is in ``temps``."""
        import copy
        import uuid

        from opentenbase_tpu_torch.plan.astwalk import rename_relations
        from opentenbase_tpu_torch.plan.views import expand_ctes
        from opentenbase_tpu_torch.sql.deparse import (
            DeparseError,
            deparse_select,
        )

        if not body.set_ops:
            self._recursive_parts(name, body)  # raises
        if body.order_by or body.limit is not None or (
                body.offset is not None):
            raise SQLError("ORDER BY/LIMIT in a recursive query is not "
                           "supported")
        if siblings:
            # the plain sibling CTEs of the same WITH list are in scope
            # in this body: fresh copies inlined, so the deparsed CREATE
            # TABLE AS still resolves them
            body.ctes = [copy.deepcopy(sib) for sib in siblings] + list(
                body.ctes)
        expand_ctes(body)  # an inner WITH does not survive deparsing
        op, base, rec_term = self._recursive_parts(name, body)
        dedup = op == "union"
        # unique across the cluster: sessions share one catalog
        full = f"__rec_{uuid.uuid4().hex[:10]}_{name}"

        def push_aliases(q: A.Select, cols: list) -> bool:
            """``q``'s items renamed to ``cols`` where its shape allows
            (CREATE TABLE AS needs unique, named output columns)."""
            if not cols or len(q.items) != len(cols) or any(
                    isinstance(it.expr, A.Star) for it in q.items):
                return False
            q.items = [A.SelectItem(it.expr, c)
                       for it, c in zip(q.items, cols)]
            return True

        def ctas(tbl: str, q: A.Select, cols: list) -> list:
            """CREATE TABLE AS, its output renamed to ``cols`` where
            given; returns the table's column names."""
            try:
                sql = deparse_select(q)
            except DeparseError as e:
                raise SQLError(f'recursive query "{name}": {e}') from None
            self.execute(f"create table {tbl} as {sql}")
            temps.append(tbl)
            got = list(self.cluster.catalog.get(tbl).schema)
            if not cols or got == cols:
                return got
            if len(got) != len(cols):
                raise SQLError(f'recursive query "{name}" column arity '
                               f"mismatch: {len(got)} vs {len(cols)}")
            if any(not g.replace("_", "").isalnum() for g in got):
                raise SQLError(f'recursive query "{name}": alias unnamed '
                               "output columns in the CTE column list")
            proj = ", ".join(f"{g} as {c}" for g, c in zip(got, cols))
            self.execute(f"create table {tbl}r as select {proj} from {tbl}")
            temps.append(f"{tbl}r")
            self.execute(f"drop table {tbl}")
            temps.remove(tbl)
            return cols

        want = list(aliases)
        if push_aliases(base, want):
            want = []
        if dedup:
            base = A.Select(items=[A.SelectItem(A.Star(), None)],
                            from_clause=A.SubqueryRef(base, "__rb"),
                            distinct=True)
        cols = ctas(full, base, want)
        if f"{full}r" in temps:
            full = f"{full}r"
        work = f"{full}_w"
        self.execute(f"create table {work} as select * from {full}")
        temps.append(work)
        limit = int(os.environ.get("OTB_MAX_RECURSION", "200"))
        for it in range(1, limit + 1):
            rec = copy.deepcopy(rec_term)
            refs = rename_relations(rec, {name: work})
            if it == 1 and refs != 1:
                raise SQLError(
                    f'recursive reference to query "{name}" must appear '
                    "exactly once in the recursive term")
            delta = f"{full}_d{it}"
            want = list(cols)
            if push_aliases(rec, want):
                want = []
            if dedup:
                rec = A.Select(items=[A.SelectItem(A.Star(), None)],
                               from_clause=A.SubqueryRef(rec, "__rd"))
                rec.set_ops = [("except", A.Select(
                    items=[A.SelectItem(A.Star(), None)],
                    from_clause=A.RelRef(full, None)))]
            ctas(delta, rec, want)
            if f"{delta}r" in temps:
                delta = f"{delta}r"
            n = self.query(f"select count(*) from {delta}")[0][0]
            self.execute(f"drop table {work}")
            temps.remove(work)
            work = delta
            self.recursive_iterations[name] = it
            if n == 0:
                return full
            self.execute(f"insert into {full} select * from {delta}")
        raise SQLError(f'recursion limit ({limit}) exceeded in query '
                       f'"{name}" — set OTB_MAX_RECURSION to raise it')

    # -- SQL and PL/pgSQL functions ----------------------------------------
    def _expand_functions(self, stmt: A.Statement, explain: bool = False):
        """SQL-function calls inlined before analysis (the planner's
        inline_function), and PL/pgSQL calls with constant arguments run
        (``_pl_call``) and replaced by their results; under ``explain``
        a PL/pgSQL call plans as a NULL placeholder and runs nothing."""
        funcs = self.cluster.functions
        if not funcs or isinstance(stmt, (A.CreateFunction,
                                          A.DropFunction)):
            return stmt
        from opentenbase_tpu_torch.plan.functions import (
            FunctionError,
            expand_calls,
        )
        from opentenbase_tpu_torch.plan.plpgsql import PlpgsqlError

        def pl_eval(fn, vals):
            return None if explain else self._pl_call(fn, vals)

        try:
            return expand_calls(stmt, funcs, pl_eval=pl_eval)
        except (FunctionError, PlpgsqlError) as e:
            raise SQLError(str(e)) from None

    def _pl_call(self, fn, vals):
        """One PL/pgSQL call (pl_exec.c): at most 8 deep, and atomic: the
        body's statements commit or roll back as one, under a ``__pl__``
        savepoint of the caller's transaction, or of one opened for the
        call where none is."""
        from opentenbase_tpu_torch.plan.functions import FunctionError

        depth = self._pl_depth
        if depth >= 8:
            raise FunctionError(
                "plpgsql call nesting exceeds the recursion limit")
        started = self.txn is None
        if started:
            self.execute("begin")
        txn = self.txn
        txn.mark_savepoint("__pl__")
        self._pl_depth = depth + 1
        try:
            out = fn.execute(self, vals)
        except Exception:
            if self.txn is txn:
                txn.rollback_to_savepoint("__pl__", self.cluster.stores)
                del txn.savepoints[txn._find_savepoint("__pl__"):]
                if started:
                    self.execute("rollback")
            raise
        finally:
            self._pl_depth = depth
        if self.txn is txn:
            del txn.savepoints[txn._find_savepoint("__pl__"):]
            if started:
                self.execute("commit")
        return out

    # -- partitioned tables (plan/partition.py) ----------------------------
    def _expand_partitions(self, stmt: A.Statement):
        """Partitioned parents expanded over their children: a read of
        a parent becomes a UNION ALL of the children WHERE's bare
        literals do not prune (FROM, joins, set operations and
        subqueries, a DML's WHERE subqueries included); UPDATE and
        DELETE of a parent fan out over the surviving children in one
        transaction (``_fanout_dml``, which returns its Result); TRUNCATE
        and DROP of a parent name its children (DROP of a child alone
        is refused)."""
        parts = self.cluster.partitions
        if not parts:
            return stmt
        from opentenbase_tpu_torch.plan.partition import (
            _rewrite_expr_subqueries,
            rewrite_select,
        )

        if isinstance(stmt, A.Select):
            return rewrite_select(stmt, parts)
        if isinstance(stmt, (A.CreateTableAs, A.CreateMatview)) or (
                isinstance(stmt, A.Insert) and stmt.query is not None):
            rewrite_select(stmt.query, parts)
            return stmt
        if isinstance(stmt, (A.Update, A.Delete)):
            if stmt.where is not None:
                _rewrite_expr_subqueries(stmt.where, parts)
            if stmt.table not in parts:
                return stmt
            if isinstance(stmt, A.Update):
                pcol = parts[stmt.table].column
                if any(c == pcol for c, _e in stmt.assignments):
                    raise SQLError(
                        "updating the partition key (moving rows between "
                        "partitions) is not supported")
            return self._fanout_dml(stmt, parts[stmt.table])
        if isinstance(stmt, (A.TruncateTable, A.DropTable)):
            child_of = {ch: p for p, ps in parts.items()
                        for ch in ps.children()}
            drop = isinstance(stmt, A.DropTable)
            names: list[str] = []
            for n in stmt.names:
                if drop and n in child_of:
                    raise SQLError(
                        f'cannot drop "{n}": it is a partition of '
                        f'"{child_of[n]}" (drop the parent instead)')
                if n not in parts:
                    names.append(n)
                    continue
                if drop:
                    deps = self._dependent_views(n)
                    if deps and stmt.cascade:
                        self._drop_dependent_views(n)
                        deps = self._dependent_views(n)
                    if deps:
                        raise SQLError(
                            f'cannot drop table "{n}": view(s) '
                            f"{', '.join(sorted(deps))} depend on it",
                            "2BP01")
                names.extend(parts[n].children())
                if drop:
                    parts.pop(n)
                    self.cluster.catalog.drop_table(n)
                    self._log_ddl({"op": "drop_parent", "name": n})
            return dataclasses.replace(stmt, names=names)
        return stmt

    def _fanout_dml(self, stmt, spec) -> Result:
        """UPDATE / DELETE of a partitioned parent: the statement run on
        each child its WHERE does not prune, in one transaction (one
        statement inside an explicit one: no child's writes survive a
        failure)."""
        keep = spec.prune(stmt.where, {spec.parent})
        txn, implicit = self._begin_implicit()
        self.txn = txn
        if not implicit:
            txn.mark_savepoint("__stmt__")
        total = 0
        tag = "UPDATE" if isinstance(stmt, A.Update) else "DELETE"
        try:
            for i in keep:
                child = dataclasses.replace(stmt, table=spec.child(i))
                total += self._execute_one(child).rowcount
        except Exception:
            if implicit:
                self._abort_txn(txn)
                self.txn = None
            else:
                txn.rollback_to_savepoint("__stmt__", self.cluster.stores)
                del txn.savepoints[txn._find_savepoint("__stmt__"):]
            raise
        if implicit:
            self.txn = None
            self._commit_txn(txn)
        else:
            del txn.savepoints[txn._find_savepoint("__stmt__"):]
        return Result(tag, rowcount=total)

    def _partition_and_append(self, spec, full: ColumnBatch,
                              txn: Transaction) -> int:
        """A parent's rows split by the partition boundaries, each slice
        routed into its child by the child's locator."""
        from opentenbase_tpu_torch.plan.partition import PartitionError

        key = full.columns[spec.column]
        try:
            pidx = spec.route(key.data, key.validity)
        except PartitionError as e:
            raise SQLError(str(e)) from None
        n = 0
        for i in np.unique(pidx):
            child = self.cluster.catalog.get(spec.child(int(i)))
            n += self._route_and_append(
                child, full.take(np.nonzero(pidx == i)[0]), txn)
        return n

    def _lock_table_names(self, name: str) -> list[str]:
        """A table lock's keys: a partitioned parent covers its children
        (PG locks partitions through the parent)."""
        spec = self.cluster.partitions.get(name)
        return [name, *spec.children()] if spec is not None else [name]

    def _expand_ctes_stmt(self, stmt: A.Statement):
        """WITH clauses expanded (statement-scoped views): before view
        expansion, so a CTE name shadows a same-named view, and again
        after it, for view bodies that carry WITH."""
        from opentenbase_tpu_torch.plan.astwalk import walk_expr_subqueries
        from opentenbase_tpu_torch.plan.views import (
            ViewRecursionError,
            expand_ctes,
        )

        try:
            if isinstance(stmt, A.Select):
                expand_ctes(stmt)
            elif isinstance(stmt, (A.CreateTableAs, A.CreateMatview)):
                expand_ctes(stmt.query)
            elif isinstance(stmt, (A.Update, A.Delete, A.Insert)):
                if isinstance(stmt, A.Insert) and stmt.query is not None:
                    expand_ctes(stmt.query)
                exprs = []
                if getattr(stmt, "where", None) is not None:
                    exprs.append(stmt.where)
                for _c, e in getattr(stmt, "assignments", ()):
                    exprs.append(e)
                for row in getattr(stmt, "values", ()):
                    exprs.extend(row)
                for e in exprs:
                    walk_expr_subqueries(e, expand_ctes)
        except ViewRecursionError as e:
            raise SQLError(str(e)) from None
        return stmt

    def _expand_views(self, stmt: A.Statement):
        """View references replaced by their bodies (the rewriter), and
        writes into a view refused."""
        stmt = self._expand_ctes_stmt(stmt)
        views = self.cluster.views
        if not views:
            return stmt
        from opentenbase_tpu_torch.plan.views import (
            ViewRecursionError,
            _expr_subqueries,
            rewrite_views,
        )

        try:
            if isinstance(stmt, A.Select):
                rewrite_views(stmt, views)
            elif isinstance(stmt, A.Insert):
                if stmt.table in views:
                    raise SQLError(
                        f'cannot insert into view "{stmt.table}"')
                if stmt.query is not None:
                    rewrite_views(stmt.query, views)
            elif isinstance(stmt, (A.Update, A.Delete)):
                if stmt.table in views:
                    verb = ("update" if isinstance(stmt, A.Update)
                            else "delete from")
                    raise SQLError(f'cannot {verb} view "{stmt.table}"')
                if stmt.where is not None:
                    _expr_subqueries(stmt.where, views, 0)
            elif isinstance(stmt, (A.CreateTableAs, A.CreateMatview)):
                rewrite_views(stmt.query, views)
        except ViewRecursionError as e:
            raise SQLError(str(e)) from None
        # view bodies may themselves carry WITH clauses
        return self._expand_ctes_stmt(stmt)

    @contextlib.contextmanager
    def _system_views(self, sel: Optional[A.Select]):
        """The system views ``sel`` reads, each materialized as a
        replicated table from its provider for the statement and dropped
        after it (the reference's ``_refresh_system_views``, which keeps
        them). One statement at a time fills them (the cluster's
        ``_sysview_lock``); their fragments run on the coordinator, on
        the host route (``_sysviews``)."""
        from opentenbase_tpu_torch.plan.astwalk import relation_names

        names = set() if sel is None else (
            (relation_names(sel) & _SYSTEM_VIEWS) - self._sysviews)
        if not names:
            yield
            return
        for name in sorted(names):
            item = sysviews.NOT_PORTED.get(name)
            if item is not None:
                raise NotPorted(f"system view {name} (ROADMAP {item})")
        c = self.cluster
        cat = c.catalog
        with c._sysview_lock:
            prev = self._sysviews
            self._sysviews = prev | names
            try:
                for name in sorted(names):
                    schema, provider = sysviews.SYSTEM_VIEWS[name]
                    if cat.has(name):  # one a reference checkpoint kept
                        self._drop_system_view(name)
                    meta = cat.create_table(
                        name, dict(schema),
                        DistributionSpec(DistStrategy.REPLICATED))
                    rows = provider(c)
                    batch = ColumnBatch.from_pydict(
                        {col: [r[i] for r in rows]
                         for i, col in enumerate(meta.schema)},
                        meta.schema, meta.dictionaries)
                    for n in meta.node_indices:
                        store = ShardStore(meta.schema, meta.dictionaries)
                        store.append_batch(batch, 1)
                        c.stores[n][name] = store
                yield
            finally:
                self._sysviews = prev
                for name in names:
                    self._drop_system_view(name)

    def _drop_system_view(self, name: str) -> None:
        c = self.cluster
        if c.catalog.has(name):
            c.catalog.drop_table(name)
        for tabs in c.stores.values():
            tabs.pop(name, None)

    def _reserved_relation(self, name: str) -> None:
        if name in _SYSTEM_VIEWS:
            raise SQLError(
                f'relation name "{name}" is reserved for a system view')

    def _x_createview(self, stmt: A.CreateView) -> Result:
        """CREATE [OR REPLACE] VIEW: the body must analyze now (view.c
        checks the definition at CREATE time); its text is what the WAL
        and checkpoints keep."""
        import copy

        from opentenbase_tpu_torch.plan.views import rewrite_views

        c = self.cluster
        self._reserved_relation(stmt.name)
        if c.catalog.has(stmt.name):
            raise SQLError(f'"{stmt.name}" already exists as a table')
        if stmt.name in c.views and not stmt.replace:
            raise SQLError(f'view "{stmt.name}" already exists')
        probe = rewrite_views(copy.deepcopy(stmt.query), c.views)
        probe = self._expand_partitions(
            self._expand_views(self._expand_functions(probe)))
        with self._system_views(probe):
            prune_columns(analyze_statement(probe, c.catalog))
        c.views[stmt.name] = (stmt.query, stmt.text)
        self._log_ddl({"op": "create_view", "name": stmt.name,
                       "text": stmt.text})
        return Result("CREATE VIEW")

    def _dependent_views(self, relname: str) -> list[str]:
        """Views whose definitions reference ``relname`` (pg_depend)."""
        from opentenbase_tpu_torch.plan.astwalk import relation_names

        return [vname for vname, (q, _text) in self.cluster.views.items()
                if vname != relname and relname in relation_names(q)]

    def _drop_dependent_views(self, relname: str) -> None:
        """CASCADE: every view depending on ``relname``, dependents
        first."""
        for v in self._dependent_views(relname):
            if v in self.cluster.views:
                self._drop_dependent_views(v)
                self._x_dropview(A.DropView(v, if_exists=True))

    def _x_dropview(self, stmt: A.DropView) -> Result:
        c = self.cluster
        if stmt.name not in c.views:
            if stmt.if_exists:
                return Result("DROP VIEW")
            raise SQLError(f'view "{stmt.name}" does not exist')
        deps = self._dependent_views(stmt.name)
        if deps:
            raise SQLError(
                f'cannot drop view "{stmt.name}": view(s) '
                f"{', '.join(sorted(deps))} depend on it", "2BP01")
        del c.views[stmt.name]
        self._log_ddl({"op": "drop_view", "name": stmt.name})
        return Result("DROP VIEW")

    def _x_createtableas(self, stmt: A.CreateTableAs) -> Result:
        """CREATE TABLE ... AS SELECT: a round-robin table of the query's
        output columns, its rows re-encoded through the new table's
        dictionaries and appended in one transaction."""
        c = self.cluster
        self._reserved_relation(stmt.name)
        if c.catalog.has(stmt.name) or stmt.name in c.views:
            if stmt.if_not_exists:
                return Result("CREATE TABLE")
            raise SQLError(f'relation "{stmt.name}" already exists')
        batch = self._run_select(stmt.query)
        schema: dict[str, t.SqlType] = {}
        for name, col in batch.columns.items():
            if name in schema or not name:
                raise SQLError(
                    "CREATE TABLE AS needs unique, named output columns")
            schema[name] = col.type
        if not schema:
            raise SQLError("CREATE TABLE AS needs at least one column")
        meta = self._create_table(
            stmt.name, schema, DistributionSpec(DistStrategy.ROUNDROBIN))
        full = ColumnBatch.from_pydict(
            {name: col.to_python() for name, col in batch.columns.items()},
            meta.schema, meta.dictionaries)
        txn, implicit = self._begin_implicit()
        n = self._finish(txn, implicit, lambda: self._locked_append(
            meta, full, txn))
        return Result("CREATE TABLE AS", rowcount=n)

    def _x_createfunction(self, stmt: A.CreateFunction) -> Result:
        """CREATE [OR REPLACE] FUNCTION ... LANGUAGE SQL | plpgsql (a SQL
        body inlines at each call, a PL/pgSQL one runs per call)."""
        from opentenbase_tpu_torch.plan.functions import (
            FunctionError,
            SqlFunction,
        )

        funcs = self.cluster.functions
        if not stmt.replace and stmt.name in funcs:
            raise SQLError(f'function "{stmt.name}" already exists')
        if (stmt.name in self._SEQ_FUNCS or stmt.name in self._ADMIN_FUNCS
                or stmt.name in self._READONLY_ADMIN_FUNCS
                or stmt.name in self._ADMIN_REFUSED):
            raise SQLError(f'"{stmt.name}" is a reserved function name')
        from opentenbase_tpu_torch.plan.plpgsql import (
            PlpgsqlError,
            PlpgsqlFunction,
        )

        cls = PlpgsqlFunction if stmt.language == "plpgsql" else SqlFunction
        try:
            fn = cls.create(stmt.name, stmt.args, stmt.rettype, stmt.body)
        except (FunctionError, PlpgsqlError) as e:
            raise SQLError(str(e)) from None
        funcs[stmt.name] = fn
        self._log_ddl({
            "op": "create_function", "name": stmt.name,
            "args": list(map(list, stmt.args)), "rettype": stmt.rettype,
            "body": stmt.body, "language": stmt.language,
        })
        return Result("CREATE FUNCTION")

    def _x_dropfunction(self, stmt: A.DropFunction) -> Result:
        if stmt.name not in self.cluster.functions:
            if stmt.if_exists:
                return Result("DROP FUNCTION")
            raise SQLError(f'function "{stmt.name}" does not exist')
        del self.cluster.functions[stmt.name]
        self._log_ddl({"op": "drop_function", "name": stmt.name})
        return Result("DROP FUNCTION")

    # -- INSERT ------------------------------------------------------------
    # the literal Python types the bulk path takes per column type
    _LITERAL_OK = {
        t.TypeId.BOOL: (bool,),
        t.TypeId.INT4: (int,),
        t.TypeId.INT8: (int,),
        t.TypeId.FLOAT4: (int, float),
        t.TypeId.FLOAT8: (int, float),
        t.TypeId.DECIMAL: (int, float),
        t.TypeId.DATE: (str,),
        t.TypeId.TIMESTAMP: (str,),
        t.TypeId.TEXT: (str,),
    }

    def _table_meta(self, name: str) -> TableMeta:
        cat = self.cluster.catalog
        if not cat.has(name):
            raise SQLError(f'relation "{name}" does not exist')
        return cat.get(name)

    def _bulk_insert_batch(self, stmt: A.Insert):
        """VALUES rows of plain literals as per-column arrays, with no
        plan (the reference's bulk-insert rewrite, engine.py
        _bulk_insert_batch): (meta, the batch in table order), or None
        where the general pipeline answers (an expression, a cast, a
        literal of another type, a bad name or arity: that pipeline
        alone defines the semantics and the errors), and where
        ``enable_bulk_insert_rewrite`` is off."""
        if not self.gucs.get("enable_bulk_insert_rewrite", True):
            return None
        if stmt.query is not None or not stmt.values:
            return None
        cat = self.cluster.catalog
        if not cat.has(stmt.table):
            return None
        meta = cat.get(stmt.table)
        if meta.foreign is not None:
            return None  # refused on the general path
        columns = list(stmt.columns) if stmt.columns else list(meta.schema)
        arity = len(stmt.values[0])
        if not stmt.columns and arity < len(columns) and all(
                len(row) == arity for row in stmt.values):
            columns = columns[:arity]  # PG: short VALUES fill leading cols
        if len(set(columns)) != len(columns) or any(
                c not in meta.schema for c in columns) or any(
                len(row) != len(columns) for row in stmt.values):
            return None
        cols: dict[str, Column] = {}
        for j, name in enumerate(columns):
            ty = meta.schema[name]
            ok = self._LITERAL_OK.get(ty.id)
            if ok is None:
                return None
            vals = []
            for row in stmt.values:
                v = row[j]
                if type(v) is not A.Literal:
                    return None
                pv = v.value
                if pv is not None and (
                        not isinstance(pv, ok)
                        or (isinstance(pv, bool)
                            and ty.id is not t.TypeId.BOOL)):
                    return None
                vals.append(pv)
            try:
                cols[name] = column_from_python(
                    vals, ty, meta.dictionaries.get(name))
            except (ValueError, TypeError, OverflowError):
                return None  # an unparseable date, an overflowing int
        src = ColumnBatch(cols, len(stmt.values))
        with self.cluster._ingest_stats_mu:
            st = self.cluster.ingest_stats
            st["rewrites"] += 1
            st["rewrite_rows"] += src.nrows
        return meta, self._complete_insert_batch(meta, columns, src)

    def _complete_insert_batch(self, meta: TableMeta, columns,
                               src: ColumnBatch) -> ColumnBatch:
        """``src`` (the given ``columns``, in order) in table column
        order; an absent column takes its DEFAULT, else NULL."""
        given = dict(zip(columns, src.columns.values()))
        out: dict[str, Column] = {}
        for name, ty in meta.schema.items():
            col = given.get(name)
            out[name] = (
                Column(ty, col.data, col.validity, col.dictionary)
                if col is not None else column_from_python(
                    [meta.defaults.get(name)] * src.nrows, ty,
                    meta.dictionaries.get(name)))
        return ColumnBatch(out, src.nrows)

    def _x_insert(self, stmt: A.Insert) -> Result:
        """INSERT ... VALUES | SELECT [ON CONFLICT ...] [RETURNING ...].
        VALUES of plain literals build per-column arrays directly
        (``_bulk_insert_batch``); anything else runs its source through
        the one dispatch point, cast and encoded into the table's types
        and dictionaries by the analyzer's projection. The batch takes
        its defaults, routes by the table's locator, must pass NOT NULL
        and the primary key, and parks as delta batches at PENDING_TS;
        the commit stamps them."""
        fast = self._bulk_insert_batch(stmt)
        if fast is not None:
            meta, full = fast
        with contextlib.ExitStack() as stack:
            if fast is None:
                stack.enter_context(self._system_views(stmt.query))
                splan = analyze_statement(stmt, self.cluster.catalog)
                iplan = splan.root
                meta = self._table_meta(iplan.table)
                self._refuse_foreign(meta)
            ret = (self._validate_returning(meta, stmt.returning)
                   if stmt.returning else None)
            if fast is None:
                src = self._run_statement_plan(optimize_statement(
                    L.StatementPlan(iplan.source, splan.subplans),
                    self.cluster.catalog))
                full = self._complete_insert_batch(meta, iplan.columns, src)
        txn, implicit = self._begin_implicit()
        # the rows the statement inserts, and an upsert's new images
        affected: list[ColumnBatch] = [full]

        spec = self.cluster.partitions.get(meta.name)

        def write() -> int:
            self._lock_table_shared(meta, txn)
            if spec is not None:
                if stmt.on_conflict is not None:
                    raise SQLError("ON CONFLICT on partitioned tables is "
                                   "not supported")
                return self._partition_and_append(spec, full, txn)
            n_upd = 0
            if stmt.on_conflict is not None:
                affected[0], n_upd, upd = self._apply_on_conflict(
                    meta, stmt.on_conflict, full, txn)
                affected.extend(upd)
            return self._route_and_append(meta, affected[0], txn) + n_upd

        n = self._finish(txn, implicit, write)
        if ret is not None:
            return self._returning_result(
                "INSERT", ret, self._concat_affected(meta, affected), n)
        return Result("INSERT", rowcount=n)

    def _lock_table_shared(self, meta: TableMeta, txn: Transaction) -> None:
        """INSERT's table lock: coexists with other writers, waits for a
        LOCK TABLE ... EXCLUSIVE (of a partitioned parent's child too)."""
        self.cluster.locks.acquire(
            self.session_id, txn.gxid,
            [(node, tb) for tb in self._lock_table_names(meta.name)
             for node in meta.node_indices],
            TABLE_SHARED, **self._lock_opts())

    def _locked_append(self, meta: TableMeta, batch: ColumnBatch,
                       txn: Transaction) -> int:
        """``_route_and_append`` under INSERT's table lock, through the
        partition split for a partitioned parent."""
        self._lock_table_shared(meta, txn)
        spec = self.cluster.partitions.get(meta.name)
        if spec is not None:
            return self._partition_and_append(spec, batch, txn)
        return self._route_and_append(meta, batch, txn)

    def _route_and_append(
        self, meta: TableMeta, batch: ColumnBatch, txn: Transaction
    ) -> int:
        """Append ``batch`` where the locator puts each row (every
        replica of a replicated table), as pending delta batches, after
        the NOT NULL and primary key checks."""
        if batch.nrows == 0:
            return 0
        self._check_not_null(meta, batch)
        if meta.dist.is_replicated:
            self._check_unique_pk(meta, meta.node_indices[0], batch, txn)
            for node in meta.node_indices:
                self._append_one(meta, node, batch, txn)
            return batch.nrows
        key_cols = {k: batch.columns[k] for k in meta.dist.key_columns}
        routes = meta.locator.route_insert(key_cols, batch.nrows)
        for node in np.unique(routes):
            sub = batch.take(np.nonzero(routes == node)[0])
            self._check_unique_pk(meta, int(node), sub, txn)
            self._append_one(meta, int(node), sub, txn)
        return batch.nrows

    def _append_one(self, meta, node: int, batch: ColumnBatch,
                    txn: Transaction) -> None:
        store = self.cluster.stores[node][meta.name]
        txn.pin(store)
        s, e = store.append_delta(batch, PENDING_TS)
        txn.w(node, meta.name).ins_ranges.append((s, e))
        with self.cluster._ingest_stats_mu:
            st = self.cluster.ingest_stats
            st["batches"] += 1
            st["rows"] += batch.nrows

    # -- constraints -------------------------------------------------------
    @staticmethod
    def _check_not_null(meta: TableMeta, batch: ColumnBatch) -> None:
        for col in meta.not_null:
            c = batch.columns.get(col)
            if c is not None and c.validity is not None and not bool(
                    np.all(c.validity)):
                raise SQLError(f'null value in column "{col}" violates '
                               "not-null constraint")

    @staticmethod
    def _pk_colocated(meta: TableMeta, pk: str) -> bool:
        """Equal keys always land on one node: the one rule of primary
        key enforcement and of the ON CONFLICT arbiter (a cross-node
        unique index is refused in the reference too)."""
        return meta.dist.is_replicated or tuple(
            meta.dist.key_columns) == (pk,)

    def _live_keys(self, store: ShardStore, txn: Transaction, node: int,
                   table: str, pk: str):
        """(the store's key column, the mask of its rows no commit or
        this transaction deleted: other writers' pending rows count)."""
        v = store.scan_view()
        live = v.xmax() == INF_TS
        tw = txn.writes.get(node, {}).get(table)
        if tw is not None and tw.del_idx:
            live[np.asarray(tw.del_idx, dtype=np.int64)] = False
        return v.col(pk), live

    def _check_unique_pk(self, meta: TableMeta, node: int,
                         batch: ColumnBatch, txn: Transaction) -> None:
        pk = meta.primary_key
        if pk is None or not self._pk_colocated(meta, pk):
            return
        vals = np.asarray(batch.columns[pk].data)
        dup = len(np.unique(vals)) != len(vals)
        store = self.cluster.stores[node].get(meta.name)
        if not dup and store is not None and store.nrows:
            keycol, live = self._live_keys(store, txn, node, meta.name, pk)
            dup = bool(np.isin(vals, keycol[live]).any())
        if dup:
            raise SQLError(f'duplicate key value violates primary key "{pk}"')

    # -- ON CONFLICT ---------------------------------------------------------
    def _apply_on_conflict(self, meta: TableMeta, oc, full: ColumnBatch,
                           txn: Transaction):
        """INSERT ... ON CONFLICT over the primary key arbiter
        (nodeModifyTable.c's ExecOnConflictUpdate): a conflicting
        proposed row is dropped (DO NOTHING) or becomes an update of the
        existing row (DO UPDATE, ``excluded.col`` naming the proposed
        values). Returns (the rows still to insert, rows updated, their
        new images)."""
        target, action, sets = oc
        pk = meta.primary_key
        if pk is None or not self._pk_colocated(meta, pk) or (
                target is not None and target != pk):
            if action == "nothing" and target is None:
                return full, 0, []  # no arbiter: a plain insert (PG)
            raise SQLError("there is no unique or exclusion constraint "
                           "matching the ON CONFLICT specification")
        vals = np.asarray(full.columns[pk].data)
        pv = full.columns[pk].validity
        notnull = (np.ones(len(vals), dtype=bool) if pv is None
                   else np.asarray(pv))
        nn_vals = vals[notnull]
        if action == "update" and len(np.unique(nn_vals)) != len(nn_vals):
            raise SQLError("ON CONFLICT DO UPDATE command cannot affect "
                           "row a second time")
        conflict = np.zeros(len(vals), dtype=bool)
        n_updated = 0
        newbs: list[ColumnBatch] = []
        for node in meta.node_indices:
            store = self.cluster.stores[node].get(meta.name)
            if store is None or store.nrows == 0:
                continue
            keycol, live = self._live_keys(store, txn, node, meta.name, pk)
            # a NULL key conflicts with nothing: the NOT NULL check
            # refuses it on the insert path
            hit = np.isin(vals, keycol[live]) & notnull
            if action == "update" and hit.any():
                pos_live = np.nonzero(live)[0]
                idx = pos_live[np.isin(keycol[pos_live], vals[hit])]
                old = store.take_batch(idx)
                prop = {k: i for i, k in enumerate(vals.tolist())}
                align = np.asarray(
                    [prop[k] for k in np.asarray(
                        old.columns[pk].data).tolist()], dtype=np.int64)
                self._acquire_row_locks(txn, meta.name, node, idx,
                                        ROW_UPDATE)
                txn.pin(store)
                txn.w(node, meta.name).del_idx.extend(idx.tolist())
                newbs.append(self._upsert_new_batch(meta, old, full, align,
                                                    sets))
                n_updated += len(idx)
                if meta.dist.is_replicated:
                    # one replica's images; the insert fans them out
                    newbs = newbs[:1]
                    n_updated = len(idx)
            conflict |= hit
        for nb in newbs:
            self._route_and_append(meta, nb, txn)
        keep = full.take(np.nonzero(~conflict)[0])
        if action == "nothing" and keep.nrows:
            # duplicates within the statement: the first proposed row
            # inserts, the later ones conflict with it (NULL keys never)
            kv = np.asarray(keep.columns[pk].data)
            kvalid = keep.columns[pk].validity
            seen: set = set()
            sel = []
            for i in range(keep.nrows):
                if kvalid is not None and not kvalid[i]:
                    sel.append(i)
                elif kv[i] not in seen:
                    seen.add(kv[i])
                    sel.append(i)
            if len(sel) != keep.nrows:
                keep = keep.take(np.asarray(sel, dtype=np.int64))
        return keep, n_updated, newbs

    def _upsert_new_batch(self, meta: TableMeta, old: ColumnBatch,
                          full: ColumnBatch, align: np.ndarray,
                          sets) -> ColumnBatch:
        """DO UPDATE's row images: the existing rows with each SET item
        applied, ``excluded.col`` (the proposed row), a bare column (the
        existing row) or a constant."""
        out = dict(old.columns)
        n = old.nrows
        for col, expr in sets:
            if col not in meta.schema:
                raise SQLError(f'column "{col}" does not exist')
            ty = meta.schema[col]
            if isinstance(expr, A.ColumnRef) and expr.table == "excluded":
                if expr.name not in full.columns:
                    raise SQLError(
                        f'column "excluded.{expr.name}" does not exist')
                src = full.columns[expr.name]
                out[col] = Column(
                    ty, np.asarray(src.data)[align],
                    None if src.validity is None
                    else np.asarray(src.validity)[align], src.dictionary)
            elif isinstance(expr, A.ColumnRef) and expr.table in (
                    None, meta.name):
                if expr.name not in old.columns:
                    raise SQLError(f'column "{expr.name}" does not exist')
                src = old.columns[expr.name]
                out[col] = Column(ty, src.data, src.validity,
                                  src.dictionary)
            elif isinstance(expr, A.Literal):
                out[col] = column_from_python(
                    [expr.value] * n, ty, meta.dictionaries.get(col))
            else:
                raise SQLError("ON CONFLICT DO UPDATE supports excluded.col, "
                               "column, and constant assignments")
        return ColumnBatch(out, n)

    # -- RETURNING -----------------------------------------------------------
    @staticmethod
    def _validate_returning(meta: TableMeta, items):
        """The RETURNING list as (column names, labels), checked before
        the statement writes, so a bad list writes nothing. Column
        references and ``*``, as the reference takes."""
        names: list[str] = []
        labels: list[str] = []
        for item in items:
            e = item.expr
            qual = getattr(e, "table", None)
            if qual is not None and qual != meta.name:
                raise SQLError(f'invalid reference to table "{qual}" in '
                               "RETURNING")
            if isinstance(e, A.Star):
                names.extend(meta.schema)
                labels.extend(meta.schema)
            elif isinstance(e, A.ColumnRef):
                if e.name not in meta.schema:
                    raise SQLError(f'column "{e.name}" does not exist')
                names.append(e.name)
                labels.append(item.alias or e.name)
            else:
                raise SQLError("RETURNING supports column references and *")
        return names, labels

    @staticmethod
    def _concat_affected(meta: TableMeta, batches) -> ColumnBatch:
        if not batches:
            return ColumnBatch({
                n: column_from_python([], ty, meta.dictionaries.get(n))
                for n, ty in meta.schema.items()}, 0)
        return batches[0] if len(batches) == 1 else concat_batches(batches)

    @staticmethod
    def _returning_result(verb: str, resolved, batch: ColumnBatch,
                          rowcount: int) -> Result:
        names, labels = resolved
        cols = [batch.columns[n].to_python() for n in names]
        return Result(verb, list(zip(*cols)) if cols else [], labels,
                      rowcount)

    # -- UPDATE / DELETE -------------------------------------------------
    @staticmethod
    def _fold_dml_alias(stmt) -> None:
        """A target alias: qualified references to it rewrite to the
        table name, so the plain analyzer resolves them."""
        alias = getattr(stmt, "alias", None)
        if not alias or alias == stmt.table:
            return

        def walk(e):
            if isinstance(e, (A.ColumnRef, A.Star)) and e.table == alias:
                return dataclasses.replace(e, table=stmt.table)
            if dataclasses.is_dataclass(e) and not isinstance(e, type):
                ch = {}
                for f in dataclasses.fields(e):
                    v = getattr(e, f.name)
                    if isinstance(v, A.Expr):
                        nv = walk(v)
                        if nv is not v:
                            ch[f.name] = nv
                    elif isinstance(v, (list, tuple)):
                        nv = [walk(x) if isinstance(x, A.Expr) else x
                              for x in v]
                        if any(a is not b for a, b in zip(nv, v)):
                            ch[f.name] = type(v)(nv)
                if ch:
                    try:
                        return dataclasses.replace(e, **ch)
                    except TypeError:
                        for k, v in ch.items():
                            setattr(e, k, v)
            return e

        if stmt.where is not None:
            stmt.where = walk(stmt.where)
        for i, (c, e) in enumerate(getattr(stmt, "assignments", []) or []):
            stmt.assignments[i] = (c, walk(e))
        for i, item in enumerate(stmt.returning or []):
            ne = walk(item.expr)
            if ne is not item.expr:
                stmt.returning[i] = dataclasses.replace(item, expr=ne)

    def _dml_plan(self, stmt):
        """(the analyzed statement plan, the table's meta, the resolved
        RETURNING list or None)."""
        self._fold_dml_alias(stmt)
        self._table_meta(stmt.table)
        splan = analyze_statement(stmt, self.cluster.catalog)
        meta = self.cluster.catalog.get(splan.root.table)
        self._refuse_foreign(meta)
        ret = (self._validate_returning(meta, stmt.returning)
               if stmt.returning else None)
        return splan, meta, ret

    @staticmethod
    def _refuse_foreign(meta: TableMeta) -> None:
        if meta.foreign is not None:
            raise SQLError(f'cannot change foreign table "{meta.name}"')

    def _subquery_values(self, splan: L.StatementPlan) -> list:
        """Each scalar subquery's value (the InitPlans), run through the
        one dispatch point: (value or None, type)."""
        vals = []
        for sp in splan.subplans:
            b = self._run_statement_plan(optimize_statement(
                L.StatementPlan(sp, []), self.cluster.catalog))
            ty = sp.schema[0].type
            if b.nrows > 1:
                raise SQLError("more than one row returned by a subquery "
                               "used as an expression")
            if b.nrows == 0:
                vals.append((None, ty))
            else:
                col = next(iter(b.columns.values()))
                vals.append((col.data[0] if col.valid_mask[0] else None, ty))
        return vals

    def _target_rows(self, txn, meta, node, predicate, subq=None,
                     mode: str = ROW_UPDATE,
                     nowait: bool = False) -> np.ndarray:
        """This node's rows the statement changes (or locks), locked."""
        idx = predicate_rows(
            self.cluster.catalog, self.cluster.stores[node][meta.name],
            meta.name, predicate, txn.snapshot_ts,
            txn.own_writes_view().get(node, {}).get(meta.name),
            self.cluster.device, subquery_values=subq,
            fold=not self._delta_scan(),
        )
        if len(idx):
            self._acquire_row_locks(txn, meta.name, node, idx, mode,
                                    nowait=nowait)
        return idx

    def _x_delete(self, stmt: A.Delete) -> Result:
        if stmt.from_table is not None:
            return self._dml_from(stmt, update=False)
        splan, meta, ret = self._dml_plan(stmt)
        txn, implicit = self._begin_implicit()
        old: list[ColumnBatch] = []  # RETURNING's rows, one copy each

        def write():
            subq = self._subquery_values(splan)
            total = 0
            for node in meta.node_indices:
                idx = self._target_rows(txn, meta, node,
                                        splan.root.predicate, subq)
                if not len(idx):
                    continue
                store = self.cluster.stores[node][meta.name]
                if ret is not None and (not meta.dist.is_replicated
                                        or not old):
                    old.append(store.take_batch(idx))
                txn.pin(store)
                txn.w(node, meta.name).del_idx.extend(idx.tolist())
                total += len(idx)
            if meta.dist.is_replicated and meta.node_indices:
                total //= len(meta.node_indices)
            return total

        n = self._finish(txn, implicit, write)
        if ret is not None:
            return self._returning_result(
                "DELETE", ret, self._concat_affected(meta, old), n)
        return Result("DELETE", rowcount=n)

    def _x_update(self, stmt: A.Update) -> Result:
        """Each changed row is deleted and its new image appended, routed
        by the locator: a row whose distribution key changes moves to
        its new node."""
        if stmt.from_table is not None:
            return self._dml_from(stmt, update=True)
        splan, meta, ret = self._dml_plan(stmt)
        assigned = dict(splan.root.assignments)
        txn, implicit = self._begin_implicit()
        new_batches: list[ColumnBatch] = []

        def write():
            subq = self._subquery_values(splan)
            total = 0
            for node in meta.node_indices:
                idx = self._target_rows(txn, meta, node,
                                        splan.root.predicate, subq)
                if not len(idx):
                    continue
                store = self.cluster.stores[node][meta.name]
                new_batches.append(self._apply_assignments(
                    meta, store.take_batch(idx), assigned, subq))
                txn.pin(store)
                txn.w(node, meta.name).del_idx.extend(idx.tolist())
                total += len(idx)
                if meta.dist.is_replicated:
                    # one copy's new image; the append fans out again
                    del new_batches[1:]
            for nb in new_batches:
                self._route_and_append(meta, nb, txn)
            if meta.dist.is_replicated and meta.node_indices:
                total //= len(meta.node_indices)
            return total

        n = self._finish(txn, implicit, write)
        if ret is not None:
            return self._returning_result(
                "UPDATE", ret, self._concat_affected(meta, new_batches), n)
        return Result("UPDATE", rowcount=n)

    def _dml_from(self, stmt, update: bool) -> Result:
        """UPDATE ... FROM / DELETE ... USING: the target joined with ONE
        source table, and the matched target rows updated or deleted
        (the reference plans it as a join feeding ModifyTable). Per
        target node an ordinary executor join on the cluster's device:
        the target's live rows, only the columns the statement reads and
        their positions (``__pos``), against the source gathered once
        through the one dispatch point, so SET and WHERE take any
        expression over both sides. An equality conjunct pairing the two
        sides is the join key and is required. A target row matched
        more than once changes once (its first match)."""
        from opentenbase_tpu_torch.plan import texpr as TE
        from opentenbase_tpu_torch.plan.analyze import (
            Analyzer,
            ExprContext,
            Scope,
            ScopeCol,
            _bool_type,
            _cast,
            _common_input_type,
            _split_and,
        )
        from opentenbase_tpu_torch.plan.distribute import RemoteSource

        meta = self._table_meta(stmt.table)
        self._refuse_foreign(meta)
        src_name, src_alias = stmt.from_table
        smeta = self._table_meta(src_name)
        if stmt.where is None:
            raise SQLError("UPDATE ... FROM / DELETE ... USING require a "
                           "WHERE join condition")
        ret = (self._validate_returning(meta, stmt.returning)
               if stmt.returning else None)
        tq = stmt.alias or stmt.table
        sq = src_alias or src_name

        def dictid(table, col, ty):
            return f"{table}.{col}" if ty.id == t.TypeId.TEXT else None

        tcols = list(meta.schema.items())
        scols = list(smeta.schema.items())
        nt = len(tcols)
        an = Analyzer(self.cluster.catalog)
        ctx = ExprContext(Scope(
            [ScopeCol(tq, c, ty, dictid(stmt.table, c, ty))
             for c, ty in tcols]
            + [ScopeCol(sq, c, ty, dictid(src_name, c, ty))
               for c, ty in scols]), an)

        def cols_of(te) -> set:
            out = set()

            def walk(e):
                if isinstance(e, TE.Col):
                    out.add(e.index)
                for ch in e.children():
                    walk(ch)

            walk(te)
            return out

        def side(te) -> str:
            cols = cols_of(te)
            if not cols:
                return "none"
            if min(cols) >= nt:
                return "s"
            return "t" if max(cols) < nt else "mixed"

        lkeys: list = []
        rkeys: list = []
        residual = None
        for conj in _split_and(stmt.where):
            te = _bool_type(an.expr(conj, ctx))
            pair = None
            if isinstance(te, TE.BinE) and te.op == "=":
                sides = (side(te.left), side(te.right))
                if sides == ("t", "s"):
                    pair = (te.left, te.right)
                elif sides == ("s", "t"):
                    pair = (te.right, te.left)
            if pair is None:
                residual = (te if residual is None
                            else TE.BinE("and", residual, te, t.BOOL))
                continue
            lk, rk = pair
            if lk.type != rk.type:
                ct = _common_input_type(lk.type, rk.type, "=")
                lk, rk = _cast(lk, ct), _cast(rk, ct)
            lkeys.append(lk)
            rkeys.append(rk)
        if an.subplans:
            raise SQLError("subqueries are not supported in UPDATE ... FROM "
                           "/ DELETE ... USING conditions")
        if not lkeys:
            raise SQLError("UPDATE ... FROM / DELETE ... USING need an "
                           "equality condition joining the two tables")
        sets = []
        if update:
            for col, e_ast in dict(stmt.assignments).items():
                if col not in meta.schema:
                    raise SQLError(f'column "{col}" does not exist')
                sets.append((col, _cast(an.expr(e_ast, ctx),
                                        meta.schema[col])))
            if an.subplans:
                raise SQLError("subqueries are not supported in UPDATE ... "
                               "FROM SET expressions")
        # the target's columns the statement reads: the join side gathers
        # only these (the reference gathers every column)
        exprs = [*lkeys, *(e for _c, e in sets)]
        if residual is not None:
            exprs.append(residual)
        used = sorted({i for e in exprs for i in cols_of(e) if i < nt})
        nu = len(used)
        tpos = {i: j for j, i in enumerate(used)}
        # analysis positions are [target][source]; the join's output is
        # [used target columns][__pos][source], its right child [source]
        to_out = (lambda i: tpos[i] if i < nt else i - nt + nu + 1)
        lkeys = [_rewrite_cols(k, to_out) for k in lkeys]
        rkeys = [_rewrite_cols(k, lambda i: i - nt) for k in rkeys]
        t_schema = tuple(
            L.OutCol(tcols[i][0], tcols[i][1],
                     dictid(stmt.table, *tcols[i])) for i in used
        ) + (L.OutCol("__pos", t.INT8),)
        s_schema = tuple(L.OutCol(c, ty, dictid(src_name, c, ty))
                         for c, ty in scols)
        plan: L.LogicalPlan = L.Join(
            RemoteSource(0, t_schema), RemoteSource(1, s_schema), "inner",
            tuple(lkeys), tuple(rkeys), None, t_schema + s_schema)
        if residual is not None:
            plan = L.Filter(plan, _rewrite_cols(residual, to_out),
                            plan.schema)
        plan = L.Project(
            plan,
            (TE.Col(nu, t.INT8, "__pos"),
             *(_rewrite_cols(e, to_out) for _c, e in sets)),
            (L.OutCol("__pos", t.INT8),
             *(L.OutCol(f"__set_{col}", meta.schema[col],
                        dictid(stmt.table, col, meta.schema[col]))
               for col, _e in sets)))
        src_batch = self._run_select(parse(f"select * from {src_name}")[0])
        replicated = meta.dist.is_replicated
        txn, implicit = self._begin_implicit()
        # UPDATE's new images, or DELETE's old rows for RETURNING
        affected: list[ColumnBatch] = []

        def write():
            total = 0
            for node in meta.node_indices:
                store = self.cluster.stores[node][stmt.table]
                view = store.scan_view(fold=not self._delta_scan())
                store.note_delta_read(view.delta_rows())
                n0 = view.nrows
                snap = np.int64(txn.snapshot_ts)
                live = (view.xmin() <= snap) & (snap < view.xmax())
                ow = txn.own_writes_view().get(node, {}).get(stmt.table)
                if ow is not None:
                    for s0, e0 in ow[0]:
                        live[s0:min(e0, n0)] = True
                    if len(ow[1]):
                        live[ow[1]] = False
                pos = np.nonzero(live)[0]
                if not len(pos):
                    continue
                cols = {c: Column(ty, view.col_at(c, pos),
                                  view.validity_at(c, pos),
                                  meta.dictionaries.get(c))
                        for c, ty in (tcols[i] for i in used)}
                cols["__pos"] = Column(t.INT8, pos.astype(np.int64))
                out = LocalExecutor(
                    self.cluster.catalog,
                    {0: ColumnBatch(cols, len(pos)), 1: src_batch},
                    device=self.cluster.device).run_plan(plan)
                if out.nrows == 0:
                    continue
                opos = np.asarray(out.columns["__pos"].data, dtype=np.int64)
                # one change per target row: its first match
                sel = np.sort(np.unique(opos, return_index=True)[1])
                opos = opos[sel]
                self._acquire_row_locks(txn, stmt.table, node, opos,
                                        ROW_UPDATE)
                txn.pin(store)
                txn.w(node, stmt.table).del_idx.extend(opos.tolist())
                total += len(opos)
                if update:
                    old = store.take_batch(opos)
                    newc = dict(old.columns)
                    outcols = list(out.columns.values())
                    for i, (col, _e) in enumerate(sets):
                        c = outcols[1 + i]
                        newc[col] = Column(
                            meta.schema[col], np.asarray(c.data)[sel],
                            None if c.validity is None
                            else np.asarray(c.validity)[sel],
                            meta.dictionaries.get(col))
                    affected.append(ColumnBatch(newc, len(opos)))
                    if replicated:
                        # one copy's images; the append fans them out
                        del affected[1:]
                elif ret is not None and (not replicated or not affected):
                    affected.append(store.take_batch(opos))
            if update:
                for nb in affected:
                    self._route_and_append(meta, nb, txn)
            if replicated and meta.node_indices:
                total //= len(meta.node_indices)
            return total

        n = self._finish(txn, implicit, write)
        verb = "UPDATE" if update else "DELETE"
        if ret is not None:
            return self._returning_result(
                verb, ret, self._concat_affected(meta, affected), n)
        return Result(verb, rowcount=n)

    def _apply_assignments(self, meta: TableMeta, old: ColumnBatch,
                           assigned, subq=None) -> ColumnBatch:
        """The SET expressions over the changed rows: in numpy where
        every one is simple (``np_expr_eval``), else all through the
        port's ExprCompiler over CPU tensors (the coordinator's
        ``_bind``), which alone defines the semantics. A TEXT result is
        encoded into the column's dictionary (a new value grows it)."""
        oldcols = list(old.columns.values())
        out = dict(old.columns)

        def getcol(idx):
            col = oldcols[idx]
            if col.type.is_text or col.type.id == t.TypeId.DECIMAL:
                return None
            return (np.asarray(col.data),
                    None if col.validity is None
                    else np.asarray(col.validity))

        fast = {}
        for name, expr in assigned.items():
            ty = meta.schema[name]
            r = (None if ty.is_text or ty.id == t.TypeId.DECIMAL
                 else np_expr_eval(expr, getcol))
            if r is None:
                fast = None
                break
            fast[name] = r
        if fast is None:
            schema = tuple(
                L.OutCol(name, ty, f"{meta.name}.{name}"
                         if ty.id == t.TypeId.TEXT else None)
                for name, ty in meta.schema.items()
            )
            ex = LocalExecutor(self.cluster.catalog, {}, device="cpu",
                               subquery_values=subq)
            names = list(assigned)
            fns, params = ex._bind(
                [assigned[n] for n in names], schema,
                want_dids=[f"{meta.name}.{n}" for n in names])
            env = [(torch.from_numpy(np.ascontiguousarray(c.data)),
                    None if c.validity is None else torch.from_numpy(
                        np.ascontiguousarray(c.validity)))
                   for c in oldcols]
            fast = {}
            for n, fn in zip(names, fns):
                d, v = fn(env, params)
                fast[n] = (d.numpy(), None if v is None else v.numpy())
        for name, (d, v) in fast.items():
            out[name] = _assemble_assigned_column(
                d, v, old.nrows, meta.schema[name],
                meta.dictionaries.get(name))
        return ColumnBatch(out, old.nrows)

    # -- EXPLAIN [ANALYZE] ------------------------------------------------------
    def _x_explainstmt(self, stmt: A.ExplainStmt) -> Result:
        """EXPLAIN: the distributed plan's text. ANALYZE runs that one
        plan through the read path's dispatch and reports what answered.
        On the fused route: the compile / device / host_merge ms
        (``_try_fused_locked``), the DAG's join modes, the delta-resident
        rows this statement's refresh tail-uploaded, and under VERBOSE
        the DAG's ms. On the host route: every fragment's operator tree
        with rows, loops and ms (a scan's delta-resident rows; a
        datanode process's fragment reports no operators), then each
        (fragment, node)'s rows and ms. Left out: the plan cache's line
        (ROADMAP A.9), the Resources footer (A.7), the node-group lines
        (A.8)."""
        from opentenbase_tpu_torch.obs.explain import unrename_lines

        inner = stmt.query
        cat = self.cluster.catalog
        prelude, self._explain_prelude = self._explain_prelude, []
        unrename, self._explain_rename = self._explain_rename, {}
        with self._system_views(inner if isinstance(inner, A.Select)
                                else None):
            splan = optimize_statement(analyze_statement(inner, cat), cat)
            dplan = distribute_statement(splan, cat)
            lines = prelude + dplan.explain().splitlines()
            if stmt.analyze:
                lines += self._explain_analyze(dplan, stmt.verbose)
        rows = [(line,) for line in unrename_lines(lines, unrename)]
        return Result("EXPLAIN", rows, ["QUERY PLAN"], len(rows))

    def _explain_analyze(self, dplan, verbose: bool) -> list[str]:
        from opentenbase_tpu_torch.obs.explain import (
            analyze_report,
            fragment_summary,
        )

        snapshot = self._snapshot()
        self._fused_phases = {}
        t0 = time.perf_counter()
        out = self._execute_dplan(dplan, snapshot, instrument=True)
        total_ms = (time.perf_counter() - t0) * 1000.0
        lines = [""]
        if self.last_route == "fused":
            ph = self._fused_phases
            lines.append(
                f"Fused device execution: compile={ph['compile_ms']:.3f} ms "
                f"device={ph['device_ms']:.3f} ms "
                f"host_merge={ph['host_ms']:.3f} ms")
            if ph.get("join_modes"):
                lines.append(f"Fused join modes: {ph['join_modes']}")
            if ph.get("delta_tail_rows"):
                lines.append(f"Fused delta plane: {ph['delta_tail_rows']} "
                             "delta-resident rows tail-uploaded")
            if verbose:
                frag_ms = ph.get("frag_ms") or {}
                lines += [f"  device fragment {k}: {frag_ms[k]:.3f} ms"
                          for k in sorted(frag_ms, key=str)]
        else:
            ex = self.last_executor
            lines += analyze_report(dplan, ex, verbose=verbose)
            lines.append("")
            lines += fragment_summary(ex)
        lines.append(f"Total: rows={out.nrows} time={total_ms:.3f} ms")
        return lines

    # -- COPY -------------------------------------------------------------------
    def _x_copystmt(self, stmt: A.CopyStmt) -> Result:
        """COPY table [(columns)] TO / FROM 'file' [DELIMITER 'c']
        [HEADER]: CSV, ``\\N`` written for NULL, ``\\N`` and the empty
        field read as NULL, each value parsed as the reference parses it
        (DECIMAL through float, then scaled; extra fields past the
        columns, as a dbgen line's trailing '|' gives, ignored). TO reads
        through the read path (a hot standby serves it); FROM routes by
        the locator and appends as INSERT does, inside the session's
        transaction where one is open."""
        meta = self._table_meta(stmt.table)
        if meta.foreign is not None and stmt.direction == "from":
            raise SQLError(f'cannot change foreign table "{meta.name}"')
        columns = stmt.columns or list(meta.schema)
        delim = stmt.options.get("delimiter", ",")
        if stmt.direction == "to":
            from opentenbase_tpu_torch.plan.partition import rewrite_select

            batch = self._run_select(rewrite_select(A.Select(
                items=[A.SelectItem(A.ColumnRef(c, None)) for c in columns],
                from_clause=A.RelRef(stmt.table, None)),
                self.cluster.partitions))
            with open(stmt.target, "w", newline="") as f:
                w = csv.writer(f, delimiter=delim)
                if stmt.options.get("header"):
                    w.writerow(columns)
                w.writerows(
                    ["\\N" if v is None else v for v in row]
                    for row in batch.to_rows())
            return Result("COPY", rowcount=batch.nrows)
        with open(stmt.target, newline="") as f:
            rows = list(csv.reader(f, delimiter=delim))
        if stmt.options.get("header") and rows:
            rows = rows[1:]
        # a column at a time: each field list parsed by one map
        fields = list(zip(*rows)) if rows else [()] * len(columns)
        data = {c: _copy_values(fields[i], meta.schema[c])
                for i, c in enumerate(columns)}
        batch = ColumnBatch.from_pydict(
            data, {c: meta.schema[c] for c in columns}, meta.dictionaries)
        full = self._complete_insert_batch(meta, tuple(columns), batch)
        txn, implicit = self._begin_implicit()
        n = self._finish(txn, implicit,
                         lambda: self._locked_append(meta, full, txn))
        return Result("COPY", rowcount=n)

    # -- SET / SHOW / ANALYZE --------------------------------------------------
    def _x_setstmt(self, stmt: A.SetStmt) -> Result:
        """SET / RESET of a setting the port acts on (config.py's GUCS),
        parsed and validated as the reference's config.py does; RESET
        restores the conf file's value, else the registry's default.
        ``session_authorization`` and ``role`` change the session's
        user (RESET: the login user). A setting whose subsystem is not
        ported raises ``NotPorted`` naming its ROADMAP item."""
        name = stmt.name
        if name in _config.NOT_ACTED_ON:
            raise NotPorted(
                f"SET {name} (ROADMAP {_config.NOT_ACTED_ON[name]})")
        v = stmt.value
        if v is None:  # RESET, SET ... TO DEFAULT
            if name in self.cluster.conf_gucs:
                v = self.cluster.conf_gucs[name]
            else:
                entry = _config.GUCS.get(name)
                if entry is None and "." not in name:
                    raise SQLError("unrecognized configuration parameter "
                                   f'"{name}"')
                v = entry[1] if entry is not None else None
        if isinstance(v, str):  # the reference's spelling normalization
            low = v.lower()
            if low in ("true", "on", "yes", "1"):
                v = True
            elif low in ("false", "off", "no", "0"):
                v = False
            elif low.lstrip("-").isdigit():
                v = int(low)
        if v is not None:
            try:
                v = _config.validate(name, v)
            except _config.GucError as e:
                raise SQLError(str(e)) from None
        if name in ("session_authorization", "role"):
            # the raw spelling is the identity (role "on" stays "on")
            if stmt.value is not None:
                if not hasattr(self, "_login_user"):
                    self._login_user = self.user
                self.user = str(stmt.value)
            else:
                self.user = getattr(self, "_login_user", self.user)
        if v is None:
            self.gucs.pop(name, None)
        else:
            self.gucs[name] = v
        return Result("SET")

    def _x_showstmt(self, stmt: A.ShowStmt) -> Result:
        """SHOW name (its value as set, None where unset) and SHOW ALL
        (every setting of the session, as text, sorted by name)."""
        if stmt.name == "all":
            rows = sorted((k, str(v)) for k, v in self.gucs.items())
            return Result("SHOW", rows, ["name", "setting"], len(rows))
        if stmt.name in _config.NOT_ACTED_ON:
            raise NotPorted(f"SHOW {stmt.name} "
                            f"(ROADMAP {_config.NOT_ACTED_ON[stmt.name]})")
        return Result("SHOW", [(self.gucs.get(stmt.name),)], [stmt.name], 1)

    def _x_analyzestmt(self, stmt: A.AnalyzeStmt) -> Result:
        """The planner's statistics (the reference's ANALYZE): live rows
        and per-column distinct-value estimates from a bounded sample of
        every table (or the one named), which join ordering and the
        broadcast-or-redistribute choice read (plan/costs.py)."""
        snap = self.cluster.gts.snapshot_ts()
        cat = self.cluster.catalog
        names = [stmt.table] if stmt.table else cat.table_names()
        sample_max = 100_000
        for name in names:
            meta = self._table_meta(name)
            rows = 0
            samples: dict[str, list] = {c: [] for c in meta.schema}
            nodes = (meta.node_indices[:1] if meta.dist.is_replicated
                     else meta.node_indices)
            for n in nodes:
                store = self.cluster.stores[n].get(name)
                if store is None:
                    continue
                sv = store.scan_view()
                idx = np.nonzero((sv.xmin() <= snap) & (snap < sv.xmax()))[0]
                rows += len(idx)
                if len(idx) > sample_max:
                    idx = idx[:: max(len(idx) // sample_max, 1)][:sample_max]
                for c in meta.schema:
                    samples[c].append(sv.col(c)[idx])
            ndv: dict[str, int] = {}
            for c, parts in samples.items():
                if not parts:
                    ndv[c] = 0
                    continue
                arr = np.concatenate(parts)
                u = len(np.unique(arr))
                if rows > len(arr) and u > 0.9 * len(arr):
                    # nearly unique in the sample: extrapolate to the
                    # table (PG's proportional n_distinct)
                    u = int(u * rows / max(len(arr), 1))
                ndv[c] = max(u, 1)
            meta.stats = {"rows": rows, "ndv": ndv}
        return Result("ANALYZE")

    # -- SELECT ----------------------------------------------------------------
    def _x_select(self, stmt: A.Select) -> Result:
        if stmt.for_update is not None:
            return self._select_for_update(stmt)
        batch = self._run_select(stmt)
        return Result(
            "SELECT", batch.to_rows(), batch.column_names(), batch.nrows
        )

    def _select_for_update(self, stmt: A.Select) -> Result:
        """SELECT ... FOR UPDATE / FOR SHARE [NOWAIT]: the rows WHERE
        picks are locked on every node holding them, then the query runs
        at the transaction's snapshot. An implicit transaction releases
        the locks at the statement's end, an explicit one at COMMIT or
        ROLLBACK."""
        c = self.cluster
        if c.read_only:
            raise SQLError("cannot execute SELECT FOR UPDATE in a read-only "
                           "(hot standby) cluster", "25006")
        fc = stmt.from_clause
        if (not isinstance(fc, A.RelRef) or stmt.group_by or stmt.distinct
                or stmt.set_ops or not c.catalog.has(fc.name)
                or fc.name in _SYSTEM_VIEWS):
            raise SQLError("FOR UPDATE is only allowed on a single base "
                           "table without DISTINCT/GROUP BY/set operations")
        meta = c.catalog.get(fc.name)
        mode = ROW_UPDATE if stmt.for_update == "update" else ROW_SHARE
        txn, implicit = self._begin_implicit()
        prev = self.txn
        try:
            splan = analyze_statement(
                A.Delete(table=fc.name, where=stmt.where), c.catalog)
            subq = self._subquery_values(splan)
            for node in meta.node_indices:
                self._target_rows(txn, meta, node, splan.root.predicate,
                                  subq, mode=mode, nowait=stmt.lock_nowait)
                if meta.dist.is_replicated:
                    break  # one copy's locks stand for the row
            self.txn = txn
            batch = self._run_select(stmt)
        except Exception:
            self.txn = prev
            if implicit:
                self._abort_txn(txn)
            raise
        if implicit:
            self.txn = None
            self._commit_txn(txn)
        return Result("SELECT", batch.to_rows(), batch.column_names(),
                      batch.nrows)

    def _run_select(self, stmt: A.Select) -> ColumnBatch:
        """A (rewritten) SELECT planned and run at the session's
        snapshot."""
        catalog = self.cluster.catalog
        with self._system_views(stmt):
            return self._run_statement_plan(optimize_statement(
                analyze_statement(stmt, catalog), catalog))

    def _run_statement_plan(self, splan: L.StatementPlan) -> ColumnBatch:
        dplan = distribute_statement(splan, self.cluster.catalog)
        return self._execute_dplan(dplan, self._snapshot())

    def _delta_scan(self) -> bool:
        """``enable_delta_scan``: scans read pending deltas in place (on)
        or fold them first (off, the fold-on-read baseline)."""
        return self.gucs.get("enable_delta_scan", True) is not False

    def _execute_dplan(self, dplan, snapshot,
                       instrument: bool = False) -> ColumnBatch:
        """The one dispatch point for a planned statement (the
        reference's ``_execute_dplan``), shared by the read path and
        EXPLAIN ANALYZE: the fused executors, else the host executor
        over the cluster's stores on the cluster's device, with the
        transaction's own writes laid over its scans, and each node with
        a datanode process running its fragments there. ``instrument``:
        the host route records every operator (``last_executor``)."""
        self.last_executor = None
        if (self._stmt_deadline is not None
                and time.monotonic() >= self._stmt_deadline):
            raise StatementTimeout(
                "canceling statement due to statement timeout")
        out = self._try_fused(dplan, snapshot)
        if out is not None:
            self.last_route = "fused"
            return out
        self.last_route = "host"
        p = self.cluster.persistence
        ex = DistExecutor(
            self.cluster.catalog, self.cluster.stores, snapshot,
            own_writes=self.txn.own_writes_view() if self.txn else None,
            device=self.cluster.device,
            dn_channels=self.cluster.dn_channels,
            # read-your-writes: a datanode replays up to the WAL end
            # before it runs a fragment
            min_lsn=max(p.wal.position if p is not None else 0,
                        self.last_commit_lsn),
            deadline=self._stmt_deadline,
            fragment_retries=self.gucs["fragment_retries"],
            retry_backoff_ms=self.gucs["fragment_retry_backoff_ms"],
            node_generation=self.cluster.node_generation,
            delta_scan=self._delta_scan(),
            instrument_ops=instrument,
            local_only_tables=(self._sysviews | self._foreign_tables()
                               | self.cluster.local_tables),
            parallel_workers=self.gucs.get("dn_parallel_workers", 4),
            wlm_ticket=self._wlm_ticket,
        )
        self.last_executor = ex
        from opentenbase_tpu_torch.net.pool import ChannelFenced

        try:
            return ex.run(dplan)
        except ChannelFenced as cf:
            # a datanode at a newer generation refused a fragment: this
            # node is the fenced ex-primary. The executor neither
            # retried nor failed over (our stores are the stale copy)
            self._ha_demote(cf)
            raise SQLError(f"fragment refused by fenced datanode: {cf}",
                           "72000") from cf
        finally:
            hs = self.cluster.frag_heal_stats
            with self.cluster._dml_stats_mu:
                hs["retries"] += ex.retry_stats["retries"]
                hs["failovers"] += ex.retry_stats["failovers"]

    def _foreign_tables(self) -> frozenset:
        """The foreign tables, whose fragments run on the coordinator
        where datanode processes are attached: a process would encode a
        source's TEXT into its own dictionaries, whose codes the
        coordinator cannot decode (the reference's datanode path fails
        so, ROADMAP C)."""
        if not self.cluster.dn_channels:
            return frozenset()
        cat = self.cluster.catalog
        return frozenset(n for n in cat.table_names()
                         if cat.get(n).foreign is not None)

    def _try_fused(self, dplan, snapshot) -> Optional[ColumnBatch]:
        """The fused route (the reference's ``_try_fused_inner``), or
        None where the reference's declines: the setting is off, a
        writing transaction is open (the device cache holds no own-write
        overlay), the plan has no fragments or has subplans, the DAG
        declines (``DagUnsupported``) or the fragment program does
        (``FusedUnsupported``); and where the statement reads a system
        view (its rows live for the statement alone, and a read of the
        device cache's counters must not move them). Any other exception
        — a kernel that does not build or launch, a NotPorted, a fault
        in the fused path — propagates: it never gives way to the host
        route.

        Route order, as the reference's: a Limit(Sort(...)) plan tries
        the DAG first, which may rank on the device and ship k rows; a
        single fragment tries K1's route and the fragment program; what
        neither took, and every other plan, goes to the DAG."""
        self.last_declines = []
        if self.gucs.get("enable_fused_execution", True) is False:
            self.last_declines.append("enable_fused_execution is off")
            return None
        if self.txn is not None and self.txn.writes:
            self.last_declines.append("a writing transaction is open")
            return None
        if not dplan.fragments or dplan.subplans:
            self.last_declines.append("no fragments" if not dplan.fragments
                                      else "scalar subqueries")
            return None
        if self._sysviews:
            self.last_declines.append("a system view is read")
            return None
        with self.cluster._fused_lock:
            return self._try_fused_locked(dplan, snapshot)

    def _try_fused_locked(self, dplan, snapshot) -> Optional[ColumnBatch]:
        """``_try_fused`` past its gates, with the statement's phases:
        ``compile_ms`` the time spent building the kernels
        (ops/cuda_build.py; 0 once built), ``device_ms`` the device
        path's time (CUDA events on the card, less the build), and
        ``host_ms`` the coordinator's merge; with the rows this
        statement's refresh tail-uploaded from delta batches, and the
        DAG's last join modes and ms. Caller holds ``_fused_lock``."""
        from opentenbase_tpu_torch.ops import cuda_build

        fx = self.cluster.fused_executor()
        # the session's settings, on the executors they steer
        fx.join_mode = str(self.gucs.get("join_mode", "auto"))
        fx.device_memory_limit = int(
            self.gucs.get("device_memory_limit", 0) or 0)
        fx.enable_pallas_join = self.gucs.get("enable_pallas_join")
        fx.cache.legacy_fold = not self._delta_scan()
        use_pallas = self.gucs.get("enable_pallas_scan") is not False
        has_topk = isinstance(dplan.root, L.Limit) and isinstance(
            dplan.root.child, L.Sort)
        out, final_idx = None, 0
        self._fused_via_dag = False
        tail0 = int(fx.cache.stats["delta_tail_rows"])
        build0 = cuda_build.build_ms
        timer = _DeviceTimer(fx.device)
        try:
            if has_topk:
                try:
                    final_idx, out = fx.dag_output(dplan, snapshot)
                    self._fused_via_dag = True
                except DagUnsupported as e:
                    self.last_declines.append(f"DagUnsupported: {e}")
            if out is None and len(dplan.fragments) == 1:
                out = fx.fragment_output(dplan.fragments[0], snapshot,
                                         use_pallas=use_pallas)
            if out is None and not has_topk:
                final_idx, out = fx.dag_output(dplan, snapshot)
                self._fused_via_dag = True
        except (DagUnsupported, FusedUnsupported) as e:
            self.last_declines.append(f"{type(e).__name__}: {e}")
            return None
        if out is None:
            return None
        timer.stop()
        t0 = time.perf_counter()
        batch = LocalExecutor(
            self.cluster.catalog, {final_idx: out},
            device=merge_device(self.cluster, out.nrows)).run_plan(dplan.root)
        host_ms = (time.perf_counter() - t0) * 1000.0
        compile_ms = cuda_build.build_ms - build0
        phases = {"compile_ms": compile_ms,
                  "device_ms": max(timer.ms() - compile_ms, 0.0),
                  "host_ms": host_ms}
        fx.last_phases = dict(phases)
        for k, v in phases.items():
            fx.phase_totals[k] = fx.phase_totals.get(k, 0.0) + v
        # as the reference's: the DAG's last run, whichever route this
        # statement took
        dag = fx._dag
        if dag is not None and dag.last_frag_ms:
            phases["frag_ms"] = dict(dag.last_frag_ms)
        if dag is not None and dag.last_join_modes:
            phases["join_modes"] = ",".join(dag.last_join_modes)
        tail = int(fx.cache.stats["delta_tail_rows"]) - tail0
        if tail > 0:
            phases["delta_tail_rows"] = tail
        self._fused_phases = phases
        return batch


class _DeviceTimer:
    """Elapsed ms from construction to ``stop()``: CUDA events on a CUDA
    device (the device's own clock), else the host's."""

    def __init__(self, device: torch.device):
        self._cuda = torch.device(device).type == "cuda"
        if self._cuda:
            self._ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            self._ev[0].record()
        self._t0 = time.perf_counter()
        self._ms: Optional[float] = None

    def stop(self) -> None:
        if self._cuda:
            self._ev[1].record()
        else:
            self._ms = (time.perf_counter() - self._t0) * 1000.0

    def ms(self) -> float:
        if self._ms is None:
            self._ev[1].synchronize()
            self._ms = float(self._ev[0].elapsed_time(self._ev[1]))
        return self._ms


# the reference's system views (engine.py _SYSTEM_VIEWS): reserved names
# for CREATE TABLE, CREATE VIEW and CREATE TABLE AS; the ported ones are
# materialized for the statement that reads them (sysviews.py)
_SYSTEM_VIEWS = sysviews.ALL_NAMES


def _rewrite_cols(te, fn):
    """``te`` with every column reference's index ``i`` made ``fn(i)``."""
    from opentenbase_tpu_torch.plan import texpr as TE

    if isinstance(te, TE.Col):
        ni = fn(te.index)
        return te if ni == te.index else dataclasses.replace(te, index=ni)
    if dataclasses.is_dataclass(te) and not isinstance(te, type):
        ch = {}
        for f in dataclasses.fields(te):
            v = getattr(te, f.name)
            if isinstance(v, TE.TExpr):
                nv = _rewrite_cols(v, fn)
                if nv is not v:
                    ch[f.name] = nv
            elif isinstance(v, tuple) and any(
                    isinstance(x, TE.TExpr) for x in v):
                ch[f.name] = tuple(
                    _rewrite_cols(x, fn) if isinstance(x, TE.TExpr) else x
                    for x in v)
        if ch:
            return dataclasses.replace(te, **ch)
    return te


def _copy_values(fields, ty) -> list:
    """One column of COPY FROM's fields as Python values, as the
    reference parses them: ``\\N`` and '' are NULL; integers by int(),
    FLOAT and DECIMAL by float() (DECIMAL scales afterwards), BOOL true
    for t / true / 1; TEXT and the rest as written."""
    if ty.is_numeric and ty.id != t.TypeId.DECIMAL and ty.id not in (
            t.TypeId.FLOAT4, t.TypeId.FLOAT8):
        conv = int
    elif ty.is_numeric:
        conv = float
    elif ty.id == t.TypeId.BOOL:
        def conv(v):
            return v.lower() in ("t", "true", "1")
    else:
        conv = None
    if "\\N" not in fields and "" not in fields:
        return list(fields) if conv is None else list(map(conv, fields))
    if conv is None:
        return [None if v == "\\N" or v == "" else v for v in fields]
    return [None if v == "\\N" or v == "" else conv(v) for v in fields]


_AST_FIELDS: dict = {}


def _clone_ast(node):
    """A full clone of a statement tree (dataclass nodes, lists, tuples;
    scalar leaves shared, the engine never mutates them): deepcopy's
    result without its memo and reduce machinery."""
    if isinstance(node, list):
        return [_clone_ast(x) for x in node]
    if isinstance(node, tuple):
        return tuple(_clone_ast(x) for x in node)
    cls = type(node)
    fields = _AST_FIELDS.get(cls)
    if fields is None:
        fields = (tuple(f.name for f in dataclasses.fields(node))
                  if dataclasses.is_dataclass(node)
                  and not isinstance(node, type) else False)
        _AST_FIELDS[cls] = fields
    if fields is False:
        return node
    out = cls.__new__(cls)
    for name in fields:  # object.__setattr__: frozen dataclasses too
        object.__setattr__(out, name, _clone_ast(getattr(node, name)))
    return out


def _count_params(node) -> int:
    """The highest $n in a statement tree (its parameter count)."""
    if isinstance(node, A.Param):
        return node.index
    mx = 0
    if isinstance(node, (list, tuple)):
        for x in node:
            mx = max(mx, _count_params(x))
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            mx = max(mx, _count_params(getattr(node, f.name)))
    return mx


def _subst_params(node, values):
    """Replace $n Param nodes with literal argument values throughout a
    (copied) statement tree: the Bind step of the extended protocol
    (net/pgwire.py)."""
    if isinstance(node, A.Param):
        if not 1 <= node.index <= len(values):
            raise SQLError(f"there is no parameter ${node.index}")
        return A.Literal(values[node.index - 1])
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = _subst_field(v, values)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(node, **changes) if changes else node
    return node


def _subst_field(v, values):
    if isinstance(v, (list, tuple)):
        out = [_subst_field(x, values) for x in v]
        if any(a is not b for a, b in zip(out, v)):
            return type(v)(out)
        return v
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _subst_params(v, values)
    return v

"""The coordinator's distributed loop (the reference's
opentenbase_tpu/executor/dist.py).

Fragments run one after another, each on every node of its placement:
in process, through a ``LocalExecutor`` over that node's shard stores
with the transaction's own writes on that node laid over its scans; or,
for a node with a datanode process (``dn_channels``, dn/server.py), as a
serialized plan (plan/serde.py) over a pooled channel, the remote nodes
of a fragment fanned out in threads. The motion under each fragment
moves host batches between them:

- gather       -> the producers' outputs concatenated at the coordinator
- broadcast    -> every consumer node gets the concatenation
- redistribute -> each producer's rows hash-split among the consumers

When every producer and every consumer of a redistribute or broadcast
has a datanode process, the data plane goes datanode to datanode (the
peer exchange, squeue.c's analog): the coordinator ships the address
book with the producer fragment and sees row counts only.

A fragment runs remotely on node n only when the transaction wrote none
of the tables it scans on n (uncommitted rows exist only in the
coordinator's stores); ``min_lsn`` is the WAL offset the datanode must
have replayed first (read-your-writes). A ``deadline`` (monotonic) cuts
a remote call at the socket and sends ``cancel_fragment``.

Self-healing reads: a remote fragment whose channel fails is retried
``fragment_retries`` times with doubling backoff (from
``retry_backoff_ms``), then runs on the coordinator's own stores, which
hold the authoritative copy the datanode replicates. Every dispatched
fragment is a read (writes reach the datanodes by 2PC and the WAL), so
a rerun never applies anything twice; a fragment on the peer exchange
is not retried (its parts are consumed once). A fenced refusal
(``ChannelFenced``: a datanode at a newer fencing generation than
``node_generation``) never enters this ladder: our stores are then the
stale copy. ``retry_stats`` counts retries and failovers, and a
fragment's instrumentation its ``retries`` and ``failover: "local"``.

Every in-process executor runs on the cluster's device; a fragment's
output comes back to the host in one transfer per node
(``LocalExecutor.to_host``), the motions work on host ``ColumnBatch``es,
as the reference's do, and the consumer uploads its input. Scalar
subqueries (InitPlans) run first, in registration order, sharing one
value list. ``parallel_workers`` (the ``dn_parallel_workers`` setting)
rides every remote fragment as ``parallel``: a datanode process splits
a qualifying partial aggregate's base scan over that many row-block
workers (executor/local.py ``run_fragment_parallel``). ``wlm_ticket``
is the statement's admission ticket (wlm/): the bytes of the result's
live rows are noted on it (``pg_stat_wlm.peak_result_bytes``). Each
remote attempt passes the ``exec/fragment`` failpoint first. Not
ported: tracing, and the replica coordinator's guard on a failover (the port has no peer coordinators: its local stores are
always the primary's).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Optional

import numpy as np

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.catalog import Catalog
from opentenbase_tpu_torch.device import resolve_device
from opentenbase_tpu_torch.executor.local import LocalExecutor
from opentenbase_tpu_torch.fault import FAULT
from opentenbase_tpu_torch.plan.distribute import (
    COORDINATOR,
    DistributedPlan,
    Fragment,
    RemoteSource,
)
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import ColumnBatch
from opentenbase_tpu_torch.utils.hashing import combine_hashes, hash32_np

log = logging.getLogger(__name__)


class StatementTimeout(RuntimeError):
    """The statement's deadline passed mid-execution (SQLSTATE 57014):
    between fragment dispatches, or a remote call cut at its socket
    deadline."""

    sqlstate = "57014"


class ExchangeRef:
    """Stands in for a motioned batch that never visited the
    coordinator: the producer datanodes pushed their partitions straight
    to the consumers' exchange stores (dn/server.py ``exch_put``)."""

    __slots__ = ("xid", "producers", "schema")

    def __init__(self, xid: str, producers, schema):
        self.xid = xid
        self.producers = list(producers)
        self.schema = schema


def _scan_tables(plan) -> set:
    """The base tables a plan fragment reads."""
    out: set = set()
    stack = [plan]
    while stack:
        node = stack.pop()
        tb = getattr(node, "table", None)
        if isinstance(tb, str):
            out.add(tb)
        stack.extend(node.children())
    return out


def _jsonable(v):
    """A subquery value as JSON takes it (numpy scalars to Python)."""
    return v.item() if hasattr(v, "item") else v


class StaleTopology(RuntimeError):
    """A fragment targets a node index the cluster does not have."""

    sqlstate = "72001"


def _remote_source_ids(plan) -> set:
    """The producer fragments a plan consumes: a fragment's inputs are
    restricted to these."""
    out: set = set()
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, RemoteSource):
            out.add(node.fragment)
        stack.extend(node.children())
    return out


def _batch_bytes(batch: ColumnBatch) -> int:
    """Payload bytes of a motioned batch (data and validity)."""
    total = 0
    for col in batch.columns.values():
        total += col.data.nbytes
        if col.validity is not None:
            total += col.validity.nbytes
    return total


def concat_batches(batches: list) -> ColumnBatch:
    """The batches' rows one after another, column by column: a column
    takes a validity mask where any part has one."""
    batches = [b for b in batches if b is not None]
    if not batches:
        raise ValueError("no batches to concatenate")
    if len(batches) == 1:
        return batches[0]
    names = list(batches[0].columns.keys())
    cols: dict[str, Column] = {}
    for i, name in enumerate(names):
        parts = [list(b.columns.values())[i] for b in batches]
        data = np.concatenate([p.data for p in parts])
        validity = None
        if any(p.validity is not None for p in parts):
            validity = np.concatenate([
                np.ones(len(p.data), np.bool_) if p.validity is None
                else p.validity for p in parts])
        cols[name] = Column(parts[0].type, data, validity,
                            parts[0].dictionary)
    return ColumnBatch(cols, sum(b.nrows for b in batches))


def partition_batch(batch: ColumnBatch, hash_positions,
                    ndest: int) -> list[np.ndarray]:
    """Row-index arrays per destination slot: the one redistribute
    routing formula."""
    if batch.nrows == 0:
        return [np.empty(0, np.int64) for _ in range(ndest)]
    h = hash_batch_columns(batch, list(hash_positions))
    route = (h % np.uint32(ndest)).astype(np.int64)
    return [np.nonzero(route == di)[0] for di in range(ndest)]


def hash_batch_columns(batch: ColumnBatch, positions: list) -> np.ndarray:
    """uint32 placement hash over key columns, the locator's formula
    (utils/hashing.py): a TEXT value hashes its string, a NULL as 0."""
    cols = list(batch.columns.values())
    hashes = []
    for p in positions:
        col = cols[p]
        data = col.data
        if col.type.id == t.TypeId.TEXT and col.dictionary is not None:
            n_vals = len(col.dictionary)
            codes = np.clip(data, 0, max(n_vals - 1, 0))
            data = (col.dictionary.hash_array()[codes] if n_vals
                    else np.zeros(len(data), np.uint32))
            h = hash32_np(data.astype(np.int64))
        else:
            h = hash32_np(data)
        if col.validity is not None:
            h = np.where(col.validity, h, np.uint32(0))
        hashes.append(h)
    return combine_hashes(hashes, np)


def _slice(batch: ColumnBatch, s: int, e: int) -> ColumnBatch:
    """Rows [s, e) of a batch, as views (no copy)."""
    return ColumnBatch({
        k: Column(c.type, c.data[s:e],
                  None if c.validity is None else c.validity[s:e],
                  c.dictionary)
        for k, c in batch.columns.items()}, e - s)


class DistExecutor:
    """Runs a DistributedPlan over per-node shard stores on ``device``
    and over the datanode processes of ``dn_channels``.

    After ``run``: ``instrumentation`` holds one record per (fragment,
    node): rows, ms, bytes uploaded, join modes; a remote one is marked
    ``remote`` and carries the datanode's own ms (``dn_ms``) and the
    bytes its call put on the wire (``wire_bytes``); ``motion_stats``
    per fragment its kind, rows, bytes and ms (``peer`` for the peer
    exchange, whose bytes are the producers' pushes); ``coordinator_ms``
    the coordinator's plan; ``h2d_bytes`` every byte the in-process
    executors uploaded."""

    def __init__(
        self,
        catalog: Catalog,
        node_stores: dict,  # node index -> {table -> ShardStore}
        snapshot_ts: Optional[int] = None,
        own_writes: Optional[dict] = None,  # node -> table -> writes
        device=None,
        dn_channels: Optional[dict] = None,  # node -> net.pool.ChannelPool
        min_lsn: int = 0,
        deadline: Optional[float] = None,  # time.monotonic() cutoff
        fragment_retries: int = 2,  # extra remote attempts a fragment
        retry_backoff_ms: float = 25.0,  # base backoff, doubling a try
        node_generation: int = 0,  # fencing generation on every call
        delta_scan: bool = True,  # enable_delta_scan (off: fold on read)
        instrument_ops: bool = False,  # per-operator EXPLAIN ANALYZE
        local_only_tables=(),  # coordinator-only tables (system views)
        parallel_workers: int = 1,  # row-block workers a remote fragment
        wlm_ticket=None,  # wlm.AdmissionTicket held for this statement
    ):
        self.catalog = catalog
        self.node_stores = node_stores
        self.snapshot_ts = snapshot_ts
        self.own_writes = own_writes or {}
        self.device = resolve_device(device)
        self.dn_channels = dn_channels or {}
        self.min_lsn = int(min_lsn)
        self.deadline = deadline
        self.instrumentation: list[dict] = []
        self.motion_stats: dict = {}
        self.coordinator_ms = 0.0
        self.h2d_bytes = 0
        self.join_modes: list[str] = []
        self.fragment_retries = max(int(fragment_retries or 0), 0)
        self.retry_backoff_ms = float(retry_backoff_ms or 0.0)
        self.node_generation = int(node_generation or 0)
        self.retry_stats = {"retries": 0, "failovers": 0, "cancels": 0}
        self._stats_mu = threading.Lock()
        self.delta_scan = bool(delta_scan)
        # with ``instrument_ops``: one record per in-process (fragment,
        # node) and the coordinator's plan, {fragment, node, subplan,
        # ops} (the operator records of LocalExecutor.op_records); a
        # datanode process sends none back
        self.instrument_ops = instrument_ops
        self.op_instrumentation: list[dict] = []
        # tables the coordinator materializes (the system views): no
        # datanode process holds them, so their fragments run here
        self.local_only_tables = frozenset(local_only_tables)
        self.parallel_workers = max(int(parallel_workers or 1), 1)
        self.wlm_ticket = wlm_ticket

    def _stores(self, node: int) -> dict:
        if node == COORDINATOR:
            return {}
        if node not in self.node_stores:
            raise StaleTopology(
                f"plan targets datanode index {node}, which the cluster "
                "does not have")
        return self.node_stores[node]

    def run(self, dplan: DistributedPlan) -> ColumnBatch:
        self.instrumentation = []
        self.op_instrumentation = []
        self.motion_stats = {}
        self.coordinator_ms = 0.0
        self.h2d_bytes = 0
        self.join_modes = []
        # InitPlans in registration order, sharing the value list: the
        # analyzer registers a nested scalar subquery before its parent,
        # so every reference points at an evaluated lower index
        n = len(dplan.subplans)
        subquery_values: list = [None] * n
        for i in range(n):
            b = self._run_one(dplan.subplans[i], subquery_values,
                              tag=f"sub{i}")
            col = next(iter(b.columns.values()), None)
            ty = col.type if col is not None else t.INT8
            if b.nrows > 1:
                raise RuntimeError("more than one row returned by a "
                                   "subquery used as an expression")
            if b.nrows == 0 or col is None or not col.valid_mask[0]:
                subquery_values[i] = (None, ty)
            else:
                subquery_values[i] = (col.data[0], ty)
        out = self._run_one(dplan, subquery_values)
        if self.wlm_ticket is not None:
            try:
                # the host columns of the live rows: no device padding
                self.wlm_ticket.note_bytes(
                    sum(c.data.nbytes for c in out.columns.values()))
            except Exception as e:  # statistics never fail a query
                log.warning("wlm result-bytes accounting failed: %r", e)
        return out

    def _check_deadline(self) -> None:
        if self.deadline is not None and time.monotonic() >= self.deadline:
            raise StatementTimeout(
                "canceling statement due to statement timeout")

    def _can_remote(self, node: int, frag_tables: set) -> bool:
        """The transaction wrote none of the fragment's tables on
        ``node``: its rows there are all in the datanode's replica."""
        if node not in self.dn_channels or (
                frag_tables & self.local_only_tables):
            return False
        touched = self.own_writes.get(node)
        return not touched or not (frag_tables & set(touched))

    def _run_one(self, dplan: DistributedPlan, subquery_values,
                 tag=None) -> ColumnBatch:
        # fragment -> consumer node -> its input batch (or an
        # ExchangeRef where the data went datanode to datanode)
        motioned: dict[int, dict] = {}
        frag_schemas = {f.index: f.root.schema for f in dplan.fragments}
        qxid = uuid.uuid4().hex[:16]
        for frag in dplan.fragments:
            self._check_deadline()
            sources = _remote_source_ids(frag.root)
            frag_tables = _scan_tables(frag.root)
            remote = [n for n in frag.nodes
                      if self._can_remote(n, frag_tables)]
            local = [n for n in frag.nodes if n not in remote]
            peer_xid = None
            if (frag.motion in ("redistribute", "broadcast")
                    and frag.dest_nodes and not local
                    and all(n in self.dn_channels for n in frag.dest_nodes)):
                peer_xid = f"{qxid}:{frag.index}"
            fkey = frag.index if tag is None else f"{tag}:{frag.index}"
            outs: dict[int, ColumnBatch] = {}
            slots: dict[int, list] = {}  # node -> rows a destination
            pushed: list = []  # bytes the producers pushed to peers
            errors: list = []

            def run_remote(node):
                from opentenbase_tpu_torch.net.pool import (
                    ChannelError,
                    ChannelFenced,
                )

                t0 = time.perf_counter()
                retries = 0
                # a fragment on the peer exchange runs once: its parts
                # are consumed by the first attempt
                retryable = peer_xid is None and not any(
                    isinstance(per_node.get(node), ExchangeRef)
                    for j, per_node in motioned.items() if j in sources)
                try:
                    while True:
                        try:
                            # coordinator-side failpoint: fails this
                            # attempt as a dead channel would, with no
                            # datanode process in the loop
                            act = FAULT("exec/fragment", node=node,
                                        fragment=frag.index)
                            if act == "crash_node":
                                raise ChannelError(
                                    "injected coordinator-side channel "
                                    "failure")
                            rows, batch, resp = self._exec_remote(
                                frag, node, motioned, subquery_values,
                                frag_schemas, sources, peer_xid)
                            break
                        except ChannelFenced:
                            raise  # the session demotes; no ladder
                        except ChannelError as ce:
                            if not retryable:
                                raise
                            self._check_deadline()
                            if retries >= self.fragment_retries:
                                # our stores are the authoritative copy
                                # the datanode was replicating
                                log.warning(
                                    "remote fragment %s on dn%d failed "
                                    "over to local stores after %d "
                                    "retries: %s", frag.index, node,
                                    retries, ce)
                                batch, ex, _counts = (
                                    self._exec_local_fragment(
                                        frag, node, motioned,
                                        subquery_values, sources))
                                with self._stats_mu:
                                    self.retry_stats["failovers"] += 1
                                outs[node] = batch
                                self.instrumentation.append({
                                    "fragment": fkey, "node": node,
                                    "rows": batch.nrows,
                                    "ms": (time.perf_counter() - t0)
                                    * 1000.0,
                                    "remote": False, "retries": retries,
                                    "failover": "local",
                                    "h2d_bytes": ex.h2d_bytes})
                                return
                            retries += 1
                            with self._stats_mu:
                                self.retry_stats["retries"] += 1
                            log.warning("retrying remote fragment %s on "
                                        "dn%d (attempt %d): %s",
                                        frag.index, node, retries + 1, ce)
                            delay = (self.retry_backoff_ms
                                     * (2 ** (retries - 1)) / 1000.0)
                            if delay > 0:
                                time.sleep(min(delay, 2.0))
                    if batch is not None:
                        outs[node] = batch
                    pushed.append(int(resp.get("bytes_out", 0)))
                    instr = {
                        "fragment": fkey, "node": node, "rows": rows,
                        "ms": (time.perf_counter() - t0) * 1000.0,
                        "remote": True,
                        "dn_ms": float(resp.get("ms", 0.0)),
                        "wire_bytes": sum(resp.get("_wire", (0, 0))),
                        "h2d_bytes": int(resp.get("h2d_bytes", 0)),
                    }
                    if retries:
                        instr["retries"] = retries
                    self.instrumentation.append(instr)
                except Exception as e:
                    errors.append(e)

            threads = [threading.Thread(target=run_remote, args=(n,))
                       for n in remote]
            for th in threads:
                th.start()
            try:
                for node in local:
                    t0 = time.perf_counter()
                    batch, ex, counts = self._exec_local_fragment(
                        frag, node, motioned, subquery_values, sources)
                    outs[node] = batch
                    if counts is not None:
                        slots[node] = counts
                    instr = {
                        "fragment": fkey,
                        "node": node,
                        "rows": batch.nrows,
                        "ms": (time.perf_counter() - t0) * 1000.0,
                        "h2d_bytes": ex.h2d_bytes,
                    }
                    if ex.join_modes:
                        instr["join_modes"] = list(ex.join_modes)
                    if ex.zone_total_blocks:
                        instr["pruned_blocks"] = ex.zone_pruned_blocks
                        instr["total_blocks"] = ex.zone_total_blocks
                    self.instrumentation.append(instr)
                    if self.instrument_ops:
                        self.op_instrumentation.append({
                            "fragment": frag.index, "node": node,
                            "subplan": tag, "ops": ex.op_records})
            finally:
                for th in threads:
                    th.join()
            if errors:
                raise errors[0]
            key = frag.index if tag is None else (tag, frag.index)
            if peer_xid is not None:
                ref = ExchangeRef(peer_xid, list(frag.nodes),
                                  frag.root.schema)
                motioned[frag.index] = {n: ref for n in frag.dest_nodes}
                self.motion_stats[key] = {
                    "kind": frag.motion,
                    "rows": sum(i["rows"] for i in self.instrumentation
                                if i["fragment"] == fkey),
                    "bytes": sum(pushed), "ms": None, "peer": True}
                continue
            t_m0 = time.perf_counter()
            moved = self._apply_motion(frag, outs, slots)
            ms = (time.perf_counter() - t_m0) * 1000.0
            motioned[frag.index] = moved
            rows = nbytes = 0
            seen: set[int] = set()
            for b in moved.values():
                if id(b) in seen:  # a broadcast shares one batch
                    continue
                seen.add(id(b))
                rows += b.nrows
                nbytes += _batch_bytes(b)
            if frag.motion == "broadcast":
                rows *= max(len(moved), 1)
                nbytes *= max(len(moved), 1)
            self.motion_stats[key] = {"kind": frag.motion, "rows": rows,
                                      "bytes": nbytes, "ms": ms}
        t0 = time.perf_counter()
        ex = LocalExecutor(
            self.catalog,
            {j: per_node[COORDINATOR] for j, per_node in motioned.items()
             if COORDINATOR in per_node},
            snapshot_ts=self.snapshot_ts,
            subquery_values=subquery_values,
            device=self.device,
            instrument=self.instrument_ops,
        )
        out = ex.run_plan(dplan.root)
        self.coordinator_ms += (time.perf_counter() - t0) * 1000.0
        self._note(ex)
        if self.instrument_ops:
            self.op_instrumentation.append({
                "fragment": COORDINATOR, "node": COORDINATOR,
                "subplan": tag, "ops": ex.op_records})
        return out

    def _note(self, ex: LocalExecutor) -> None:
        self.h2d_bytes += ex.h2d_bytes
        self.join_modes += ex.join_modes

    def _exec_local_fragment(self, frag: Fragment, node: int, motioned,
                             subquery_values, sources):
        """Run one fragment against ``node``'s stores: (batch, executor,
        rows a destination slot or None). Under a redistribute the rows
        come back grouped by destination, their slots computed on the
        device (``LocalExecutor.run_plan_partitioned``), except for a
        float key, which ``partition_batch`` routes on the host."""
        ex = LocalExecutor(
            self.catalog,
            {j: self._resolve_input(per_node[node], node)
             for j, per_node in motioned.items()
             if node in per_node and j in sources},
            stores=self._stores(node),
            snapshot_ts=self.snapshot_ts,
            subquery_values=subquery_values,
            own_writes=self.own_writes.get(node),
            device=self.device,
            instrument=self.instrument_ops,
            fold_on_read=not self.delta_scan,
        )
        out, counts = None, None
        if frag.motion == "redistribute":
            out = ex.run_plan_partitioned(frag.root, frag.hash_positions,
                                          len(frag.dest_nodes))
        if out is None:
            batch = ex.run_plan(frag.root)
        else:
            batch, counts = out
        self._note(ex)
        return batch, ex, counts

    def _resolve_input(self, val, node: int) -> ColumnBatch:
        """An in-process consumer of a peer-exchanged input pulls the
        parts from the node's datanode exchange store."""
        from opentenbase_tpu_torch.plan import serde

        if not isinstance(val, ExchangeRef):
            return val
        resp = self.dn_channels[node].rpc({
            "op": "exch_take", "xid": val.xid, "dest": node,
            "producers": val.producers})
        return concat_batches([serde.batch_from_wire(p, self.catalog)
                               for p in resp["parts"]])

    def _exec_remote(self, frag: Fragment, node: int, motioned,
                     subquery_values, frag_schemas, sources, peer_xid):
        """Ship the fragment to ``node``'s datanode process: (rows, batch,
        response). With ``peer_xid`` the datanode partitions its output
        and pushes it to the consumers itself; only a row count comes
        back (batch None)."""
        from opentenbase_tpu_torch.net.pool import ChannelError
        from opentenbase_tpu_torch.plan import serde

        inputs, exchanges = {}, {}
        for j, per_node in motioned.items():
            if node not in per_node or j not in sources:
                continue
            v = per_node[node]
            if isinstance(v, ExchangeRef):
                exchanges[str(j)] = {"xid": v.xid, "producers": v.producers}
            else:
                inputs[str(j)] = serde.batch_to_wire(v, frag_schemas[j])
        msg = {
            "op": "exec_fragment",
            "plan": serde.dumps_plan(frag.root),
            "node": node,
            "snapshot_ts": self.snapshot_ts,
            "inputs": inputs,
            "subquery_values": [
                [_jsonable(v), [ty.id.value, ty.precision, ty.scale]]
                for v, ty in subquery_values],
            "min_lsn": self.min_lsn,
            "hgen": self.node_generation,
        }
        if not self.delta_scan:
            # fold on read on the datanode processes too (absent = on)
            msg["delta_scan"] = False
        if self.parallel_workers > 1:
            msg["parallel"] = self.parallel_workers
        if exchanges:
            msg["exchanges"] = exchanges
        if peer_xid is not None:
            msg["motion"] = {
                "xid": peer_xid,
                "kind": frag.motion,
                "hash_positions": list(frag.hash_positions),
                "from": node,
                "dest": [[n, self.dn_channels[n].host,
                          self.dn_channels[n].port]
                         for n in frag.dest_nodes],
            }
        pool = self.dn_channels[node]
        timeout_s = None
        if self.deadline is not None:
            # the deadline may only tighten the channel's own
            timeout_s = min(max(self.deadline - time.monotonic(), 0.05),
                            pool.rpc_timeout)
            msg["cancel_token"] = f"{peer_xid or uuid.uuid4().hex}:{node}"
        try:
            resp = pool.rpc(msg, timeout_s=timeout_s)
        except ChannelError as e:
            if timeout_s is not None and isinstance(e.__cause__,
                                                    TimeoutError):
                # cut at the deadline: tell the datanode to stop the
                # abandoned fragment (best effort, on a fresh channel)
                try:
                    pool.rpc({"op": "cancel_fragment",
                              "token": msg["cancel_token"]}, timeout_s=2.0)
                    with self._stats_mu:
                        self.retry_stats["cancels"] += 1
                except Exception:
                    pass
                raise StatementTimeout(
                    "canceling statement due to statement timeout "
                    f"(fragment {frag.index} on datanode {node})") from e
            raise
        if peer_xid is not None:
            return int(resp.get("rows", 0)), None, resp
        batch = serde.batch_from_wire(resp["batch"], self.catalog)
        return batch.nrows, batch, resp

    def _apply_motion(self, frag: Fragment, outs: dict[int, ColumnBatch],
                      slots: Optional[dict] = None) -> dict:
        """Each consumer node's input (the coordinator's under a
        gather). ``slots``: per producer node, its rows a destination
        where they come grouped by destination already."""
        ordered = [outs[n] for n in frag.nodes]
        if frag.motion == "gather":
            return {COORDINATOR: concat_batches(ordered)}
        if frag.motion == "broadcast":
            merged = concat_batches(ordered)
            return {n: merged for n in frag.dest_nodes}
        if frag.motion == "redistribute":
            dest = list(frag.dest_nodes)
            shards: dict[int, list] = {n: [] for n in dest}
            for node, b in zip(frag.nodes, ordered):
                if b.nrows == 0:
                    continue
                counts = (slots or {}).get(node)
                if counts is None:
                    parts = partition_batch(b, frag.hash_positions,
                                            len(dest))
                    for di, n in enumerate(dest):
                        shards[n].append(b.take(parts[di]))
                    continue
                start = 0
                for n, c in zip(dest, counts):
                    shards[n].append(_slice(b, start, start + c))
                    start += c
            empty = ordered[0].take(np.empty(0, dtype=np.int64))
            return {n: concat_batches(shards[n] or [empty]) for n in dest}
        raise ValueError(f"unknown motion {frag.motion}")

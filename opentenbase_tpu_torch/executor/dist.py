"""The coordinator's distributed loop, in process (the reference's
opentenbase_tpu/executor/dist.py, its local branch).

Fragments run one after another, each on every node of its placement
through a ``LocalExecutor`` over that node's shard stores, with the
transaction's own writes on that node laid over its scans; the motion
under each fragment moves host batches between them:

- gather       -> the producers' outputs concatenated at the coordinator
- broadcast    -> every consumer node gets the concatenation
- redistribute -> each producer's rows hash-split among the consumers

The coordinator's plan then runs over what reached it. Every executor
runs on the cluster's device; a fragment's output comes back to the host
in one transfer per node (``LocalExecutor.to_host``), the motions work on
host ``ColumnBatch``es, as the reference's do, and the consumer uploads
its input. Scalar subqueries (InitPlans) run first, in registration
order, sharing one value list.

Not ported, because the port has no datanode processes: DN channels,
peer exchange, fragment retries and failover, statement deadlines and
WLM tickets. The nodes of a fragment run one after another on the one
device (the reference runs local fragments on threads).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.catalog import Catalog
from opentenbase_tpu_torch.device import resolve_device
from opentenbase_tpu_torch.executor.local import LocalExecutor
from opentenbase_tpu_torch.plan.distribute import (
    COORDINATOR,
    DistributedPlan,
    Fragment,
    RemoteSource,
)
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import ColumnBatch
from opentenbase_tpu_torch.utils.hashing import combine_hashes, hash32_np


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
    """Runs a DistributedPlan over per-node shard stores on ``device``.

    After ``run``: ``instrumentation`` holds one record per (fragment,
    node) — rows, ms, bytes uploaded, join modes; ``motion_stats`` per
    fragment its kind, rows, bytes and ms; ``coordinator_ms`` the
    coordinator's plan; ``h2d_bytes`` every byte the executors
    uploaded."""

    def __init__(
        self,
        catalog: Catalog,
        node_stores: dict,  # node index -> {table -> ShardStore}
        snapshot_ts: Optional[int] = None,
        own_writes: Optional[dict] = None,  # node -> table -> writes
        device=None,
    ):
        self.catalog = catalog
        self.node_stores = node_stores
        self.snapshot_ts = snapshot_ts
        self.own_writes = own_writes or {}
        self.device = resolve_device(device)
        self.instrumentation: list[dict] = []
        self.motion_stats: dict = {}
        self.coordinator_ms = 0.0
        self.h2d_bytes = 0
        self.join_modes: list[str] = []

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
        return self._run_one(dplan, subquery_values)

    def _run_one(self, dplan: DistributedPlan, subquery_values,
                 tag=None) -> ColumnBatch:
        # fragment -> consumer node -> its input batch
        motioned: dict[int, dict[int, ColumnBatch]] = {}
        for frag in dplan.fragments:
            sources = _remote_source_ids(frag.root)
            outs: dict[int, ColumnBatch] = {}
            slots: dict[int, list] = {}  # node -> rows a destination
            for node in frag.nodes:
                t0 = time.perf_counter()
                batch, ex, counts = self._exec_local_fragment(
                    frag, node, motioned, subquery_values, sources)
                outs[node] = batch
                if counts is not None:
                    slots[node] = counts
                instr = {
                    "fragment": frag.index if tag is None
                    else f"{tag}:{frag.index}",
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
            key = frag.index if tag is None else (tag, frag.index)
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
        )
        out = ex.run_plan(dplan.root)
        self.coordinator_ms += (time.perf_counter() - t0) * 1000.0
        self._note(ex)
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
            {j: per_node[node] for j, per_node in motioned.items()
             if node in per_node and j in sources},
            stores=self._stores(node),
            snapshot_ts=self.snapshot_ts,
            subquery_values=subquery_values,
            own_writes=self.own_writes.get(node),
            device=self.device,
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

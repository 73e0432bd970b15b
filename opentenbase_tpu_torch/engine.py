"""Cluster and Session: the SQL entry point of the port (subset of the
reference's opentenbase_tpu/engine.py).

Statements: ``create table ... distribute by
roundrobin|shard(...)|replication``, ``insert ... values`` of literals,
and ``select`` through analyze -> optimize -> distribute -> the device
(a single fragment through the scan-aggregate kernel or the fragment
program, joins through the fused DAG) -> the coordinator merge.
Anything else raises NotPorted.

Commit timestamps come from ``cluster.gts``, a monotone in-process
counter in place of the reference's GTS: a write commits at the next
timestamp, a read takes the last one as its snapshot.
``cluster.stores[node][table]`` and ``cluster.gts.get_gts()`` keep the
reference's names, so a loader that appends straight into the stores
(bench.py's ``_bulk_append``) works unchanged.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.catalog import Catalog, TableMeta
from opentenbase_tpu_torch.catalog.distribution import (
    DistributionSpec,
    DistStrategy,
)
from opentenbase_tpu_torch.catalog.nodes import NodeDef, NodeManager, NodeRole
from opentenbase_tpu_torch.catalog.shardmap import ShardMap
from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.executor.fused import FusedExecutor
from opentenbase_tpu_torch.executor.fused_dag import DagUnsupported
from opentenbase_tpu_torch.executor.local import LocalExecutor
from opentenbase_tpu_torch.plan import analyze_statement
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan.distribute import distribute_statement
from opentenbase_tpu_torch.plan.optimize import optimize_statement
from opentenbase_tpu_torch.sql import ast as A
from opentenbase_tpu_torch.sql import parse
from opentenbase_tpu_torch.storage.column import Column, column_from_python
from opentenbase_tpu_torch.storage.table import ColumnBatch, ShardStore


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
    """Statement error (a user mistake, not a shape outside the port)."""


def resolve_device(device) -> torch.device:
    """``None`` means the first CUDA device, and no CUDA is an error: the
    port never falls back to the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: opentenbase_tpu_torch runs on the GPU "
                "(pass device='cpu' to run the plain PyTorch versions)"
            )
        return torch.device("cuda", 0)
    return torch.device(device)


class CommitClock:
    """Monotone in-process commit-timestamp source (takes the place of
    the reference's GTS service): a write commits at ``get_gts()``, a
    read's snapshot is ``snapshot_ts()`` and sees every commit so far."""

    def __init__(self):
        self._ts = 0
        self._mu = threading.Lock()

    def get_gts(self) -> int:
        """A fresh commit timestamp, greater than every earlier one."""
        with self._mu:
            self._ts += 1
            return self._ts

    def snapshot_ts(self) -> int:
        with self._mu:
            return self._ts

    def advance_to(self, ts: int) -> None:
        """Move the clock to at least ``ts`` (rows carried in from another
        cluster keep their commit timestamps)."""
        with self._mu:
            self._ts = max(self._ts, int(ts))


class Cluster:
    """One deployment: topology, catalog, per-datanode stores, and the
    device the fused fragments run on."""

    def __init__(
        self,
        num_datanodes: int = 2,
        shard_groups: int = 256,
        device=None,
    ):
        self.device = resolve_device(device)
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
        self.gts = CommitClock()
        self._fused: Optional[FusedExecutor] = None

    def fused_executor(self) -> FusedExecutor:
        if self._fused is None:
            self._fused = FusedExecutor(self.catalog, self.stores, self.device)
        return self._fused

    def create_table_stores(self, meta: TableMeta) -> None:
        for n in meta.node_indices:
            self.stores[n][meta.name] = ShardStore(
                meta.schema, meta.dictionaries
            )

    def session(self) -> "Session":
        return Session(self)


class Session:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        # whether the last SELECT's device output came from the fused DAG
        # (else from K1's route), the reference's attribute
        self._fused_via_dag = False

    def execute(self, sql: str) -> Result:
        results = [self._execute_one(s) for s in parse(sql)]
        return results[-1] if results else Result("EMPTY")

    def query(self, sql: str) -> list[tuple]:
        return self.execute(sql).rows

    def _execute_one(self, stmt: A.Statement) -> Result:
        fn = {
            A.CreateTable: self._x_createtable,
            A.Insert: self._x_insert,
            A.Select: self._x_select,
        }.get(type(stmt))
        if fn is None:
            raise NotPorted(f"statement {type(stmt).__name__}")
        return fn(stmt)

    # -- DDL ---------------------------------------------------------------
    def _x_createtable(self, stmt: A.CreateTable) -> Result:
        cat = self.cluster.catalog
        if stmt.partition_by is not None:
            raise NotPorted("partitioned table")
        if stmt.to_group is not None:
            raise NotPorted("CREATE TABLE ... TO GROUP")
        for cd in stmt.columns:
            if cd.not_null or cd.primary_key or cd.default is not None:
                raise NotPorted("column constraints and defaults")
        if cat.has(stmt.name):
            if stmt.if_not_exists:
                return Result("CREATE TABLE")
            raise SQLError(f'relation "{stmt.name}" already exists')
        schema: dict[str, t.SqlType] = {}
        for cd in stmt.columns:
            schema[cd.name] = t.type_from_name(cd.type_name, cd.type_args)
        meta = cat.create_table(stmt.name, schema, self._dist_spec(stmt))
        self.cluster.create_table_stores(meta)
        return Result("CREATE TABLE")

    @staticmethod
    def _dist_spec(stmt: A.CreateTable) -> DistributionSpec:
        s = (stmt.distribute_strategy or "").lower()
        if s in ("replication", "replicated"):
            return DistributionSpec(DistStrategy.REPLICATED)
        if s == "roundrobin":
            return DistributionSpec(DistStrategy.ROUNDROBIN)
        if s == "shard":
            if not stmt.distribute_keys:
                raise SQLError("shard distribution requires a key column")
            return DistributionSpec(
                DistStrategy.SHARD, tuple(stmt.distribute_keys)
            )
        if not s:
            # the reference's default: SHARD on the first column
            return DistributionSpec(
                DistStrategy.SHARD, (stmt.columns[0].name,)
            )
        raise NotPorted(f"distribute by {s}")

    # -- INSERT ... VALUES ---------------------------------------------------
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

    def _x_insert(self, stmt: A.Insert) -> Result:
        """VALUES rows of plain literals build per-column arrays directly
        (the reference's bulk-insert rewrite, engine.py
        _bulk_insert_batch), route by the table's locator, and commit at
        one fresh timestamp."""
        if stmt.query is not None or not stmt.values:
            raise NotPorted("INSERT ... SELECT")
        if stmt.returning or stmt.on_conflict is not None:
            raise NotPorted("INSERT ... RETURNING / ON CONFLICT")
        cat = self.cluster.catalog
        if not cat.has(stmt.table):
            raise SQLError(f'relation "{stmt.table}" does not exist')
        meta = cat.get(stmt.table)
        columns = list(stmt.columns) if stmt.columns else list(meta.schema)
        arity = len(stmt.values[0])
        if not stmt.columns and arity < len(columns):
            columns = columns[:arity]  # PG: short VALUES fill leading cols
        if len(set(columns)) != len(columns):
            raise SQLError("column specified more than once")
        for c in columns:
            if c not in meta.schema:
                raise SQLError(f'column "{c}" of "{meta.name}" does not exist')
        for row in stmt.values:
            if len(row) != len(columns):
                raise SQLError("VALUES lists must all be the same length")
        cols: dict[str, Column] = {}
        for j, name in enumerate(columns):
            ty = meta.schema[name]
            ok = self._LITERAL_OK.get(ty.id)
            if ok is None:
                raise NotPorted(f"insert into a {ty.id.value} column")
            vals = []
            for row in stmt.values:
                v = row[j]
                if type(v) is not A.Literal or (
                    v.value is not None and (
                        not isinstance(v.value, ok)
                        or (isinstance(v.value, bool)
                            and ty.id is not t.TypeId.BOOL)
                    )
                ):
                    raise NotPorted("INSERT values other than plain literals")
                vals.append(v.value)
            cols[name] = column_from_python(
                vals, ty, meta.dictionaries.get(name))
        n = len(stmt.values)
        for name, ty in meta.schema.items():  # absent columns are NULL
            if name not in cols:
                cols[name] = column_from_python(
                    [None] * n, ty, meta.dictionaries.get(name)
                )
        batch = ColumnBatch({k: cols[k] for k in meta.schema}, n)
        ts = self.cluster.gts.get_gts()
        if meta.dist.is_replicated:  # every replica holds every row
            for node in meta.node_indices:
                self.cluster.stores[node][meta.name].append_batch(batch, ts)
            return Result("INSERT", rowcount=n)
        key_cols = {k: batch.columns[k] for k in meta.dist.key_columns}
        routes = meta.locator.route_insert(key_cols, n)
        for node in np.unique(routes):
            sub = batch.take(np.nonzero(routes == node)[0])
            self.cluster.stores[int(node)][meta.name].append_batch(sub, ts)
        return Result("INSERT", rowcount=n)

    # -- SELECT ----------------------------------------------------------------
    def _x_select(self, stmt: A.Select) -> Result:
        if stmt.for_update is not None:
            raise NotPorted("SELECT ... FOR UPDATE")
        catalog = self.cluster.catalog
        splan = optimize_statement(analyze_statement(stmt, catalog), catalog)
        dplan = distribute_statement(splan, catalog)
        if dplan.subplans:
            raise NotPorted("scalar subqueries")
        snapshot = self.cluster.gts.snapshot_ts()
        fx = self.cluster.fused_executor()
        # the reference's route order (engine.py _try_fused_inner): a
        # Limit(Sort(...)) coordinator plan tries the fused DAG first,
        # which may rank on the device and ship k rows; a single fragment
        # tries K1's route; what neither took, and every other plan, goes
        # to the DAG. A DagUnsupported of the first try is the reference's
        # "DAG returns None"; any other NotPorted is a gap of the port
        # and propagates.
        has_topk = isinstance(dplan.root, L.Limit) and isinstance(
            dplan.root.child, L.Sort)
        out, final_idx, declined = None, 0, None
        self._fused_via_dag = False
        if has_topk:
            try:
                final_idx, out = fx.dag_output(dplan, snapshot)
                self._fused_via_dag = True
            except DagUnsupported as e:
                declined = e
        if out is None and len(dplan.fragments) == 1:
            out = fx.fragment_output(dplan.fragments[0], snapshot)
        if out is None:
            if declined is not None:
                # the reference's host executor answers: not ported
                raise declined
            final_idx, out = fx.dag_output(dplan, snapshot)
            self._fused_via_dag = True
        batch = LocalExecutor(catalog, {final_idx: out}).run_plan(dplan.root)
        return Result(
            "SELECT", batch.to_rows(), batch.column_names(), batch.nrows
        )

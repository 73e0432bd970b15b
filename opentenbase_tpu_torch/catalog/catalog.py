"""System catalog: table metadata + distribution.

Coordinator-side metadata only (the reference's CNs likewise hold only
catalogs, no user data — README.md:11-14). One TableMeta row is the moral
equivalent of pg_class + pgxc_class (+ the dictionary store, which the
reference does not need since it ships raw strings).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.distribution import DistributionSpec, DistStrategy
from opentenbase_tpu_torch.catalog.locator import Locator
from opentenbase_tpu_torch.catalog.nodes import NodeManager
from opentenbase_tpu_torch.catalog.shardmap import ShardMap
from opentenbase_tpu_torch.storage.column import Dictionary


@dataclass
class TableMeta:
    name: str
    schema: dict[str, t.SqlType]  # ordered: insertion order = column order
    dist: DistributionSpec
    node_indices: list[int]
    dictionaries: dict[str, Dictionary] = field(default_factory=dict)
    locator: Locator | None = None
    next_rowid: int = 0  # hidden unique row id sequence (ctid analog)
    # optimizer statistics (pg_class.reltuples / pg_statistic analog),
    # populated by ANALYZE: {"rows": int, "ndv": {col: int}}
    stats: dict = field(default_factory=dict)
    # columns with zone maps (CREATE INDEX builds BRIN-style block
    # min/max summaries; scans prune blocks against them)
    zone_cols: set = field(default_factory=set)
    # foreign-table spec (server + options) — scans materialize via
    # fdw.foreign_store instead of shard stores (src/backend/foreign)
    foreign: dict | None = None
    # column constraints (CREATE TABLE): NOT NULL columns, DEFAULT
    # constants, the PRIMARY KEY column (unique where duplicates are
    # colocated; it implies NOT NULL)
    not_null: set = field(default_factory=set)
    defaults: dict = field(default_factory=dict)
    primary_key: str | None = None

    @property
    def column_names(self) -> list[str]:
        return list(self.schema.keys())

    def column_type(self, name: str) -> t.SqlType:
        if name not in self.schema:
            raise KeyError(f'column "{name}" of relation "{self.name}" does not exist')
        return self.schema[name]


class Catalog:
    def __init__(self, nodes: NodeManager, shardmap: ShardMap):
        self.nodes = nodes
        self.shardmap = shardmap
        self._tables: dict[str, TableMeta] = {}
        # Session-wide dictionary for expression-produced TEXT values
        # (CASE/COALESCE literals etc.) — dict_id "__lit__" (ops/expr.py).
        self.literals = Dictionary()

    def dictionary(self, dict_id: str) -> Dictionary:
        """Resolve a column dict_id ("table.col" or the literal-pool
        "__lit__") to its Dictionary — the one shared implementation for
        every executor path."""
        if dict_id == "__lit__":
            return self.literals
        table, _, col = dict_id.partition(".")
        return self.get(table).dictionaries[col]

    def create_table(
        self,
        name: str,
        schema: dict[str, t.SqlType],
        dist: DistributionSpec,
    ) -> TableMeta:
        if name in self._tables:
            raise ValueError(f'relation "{name}" already exists')
        for key in dist.key_columns:
            if key not in schema:
                raise ValueError(f'distribution key "{key}" is not a column of "{name}"')
        node_indices = self.nodes.datanode_indices(dist.group)
        if not node_indices:
            raise ValueError("no datanodes available")
        dictionaries = {
            col: Dictionary() for col, ty in schema.items() if ty.id == t.TypeId.TEXT
        }
        shardmap = self.shardmap if dist.strategy == DistStrategy.SHARD else None
        meta = TableMeta(
            name=name,
            schema=dict(schema),
            dist=dist,
            node_indices=node_indices,
            dictionaries=dictionaries,
            locator=Locator(
                dist,
                node_indices,
                shardmap,
                key_types={k: schema[k] for k in dist.key_columns},
            ),
        )
        self._tables[name] = meta
        return meta

    def drop_table(self, name: str) -> TableMeta:
        if name not in self._tables:
            raise ValueError(f'relation "{name}" does not exist')
        return self._tables.pop(name)

    def get(self, name: str) -> TableMeta:
        if name not in self._tables:
            raise ValueError(f'relation "{name}" does not exist')
        return self._tables[name]

    def has(self, name: str) -> bool:
        return name in self._tables

    def table_names(self) -> list[str]:
        return list(self._tables.keys())

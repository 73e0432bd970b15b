"""Locator: maps rows and queries to datanodes.

Equivalent of src/backend/pgxc/locator/locator.c in the reference
(createLocator :1164, locate_shard_insert :1786, locate_hash_select :2072,
GetRelationNodes :2406, GetRelationNodesByQuals :2511). Routing is
vectorized: a whole batch of rows is routed with one hash + gather, host-side
via numpy here and device-side with the same formula during redistribution
(parallel/collectives.py).
"""

from __future__ import annotations

import itertools

import numpy as np

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.distribution import DistStrategy, DistributionSpec
from opentenbase_tpu_torch.catalog.shardmap import ShardMap
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.utils.hashing import combine_hashes, hash32_np, hash_strings


class Locator:
    """Routing for one table, bound to its distribution spec + node set."""

    def __init__(
        self,
        spec: DistributionSpec,
        node_indices: list[int],
        shardmap: ShardMap | None = None,
        key_types: dict[str, t.SqlType] | None = None,
    ):
        self.spec = spec
        self.node_indices = list(node_indices)
        self.shardmap = shardmap
        # SQL type of each distribution-key column: constants in quals must
        # be converted to the same physical representation route_insert
        # hashes, or pruning would pick a different node than the insert.
        self.key_types = key_types or {}
        self._rr_counter = itertools.count()  # round-robin cursor

    # ------------------------------------------------------------------
    # Insert routing: batch of rows -> per-row datanode mesh index
    # (locate_shard_insert / locate_hash_insert equivalents)
    # ------------------------------------------------------------------
    def route_insert(self, key_columns: dict[str, Column], nrows: int) -> np.ndarray:
        s = self.spec.strategy
        if s == DistStrategy.REPLICATED:
            raise ValueError("replicated tables route to ALL nodes, not per-row")
        if s == DistStrategy.ROUNDROBIN:
            start = next(self._rr_counter)
            nodes = np.asarray(self.node_indices, dtype=np.int32)
            return nodes[(start + np.arange(nrows)) % len(nodes)]
        if s == DistStrategy.RANGE:
            key = key_columns[self.spec.key_columns[0]]
            bounds = np.asarray(self.spec.range_bounds)
            slot = np.searchsorted(bounds, key.data, side="right")
            return np.asarray(self.node_indices, dtype=np.int32)[slot]
        h = self.key_hash(key_columns)
        if s == DistStrategy.SHARD:
            assert self.shardmap is not None
            return self.shardmap.route_hash(h)
        nodes = np.asarray(self.node_indices, dtype=np.int32)
        if s == DistStrategy.MODULO:
            key = key_columns[self.spec.key_columns[0]]
            return nodes[(key.data.astype(np.int64) % len(nodes)).astype(np.int32)]
        # HASH: direct hash onto the node list
        return nodes[h % np.uint32(len(nodes))]

    def key_hash(self, key_columns: dict[str, Column]) -> np.ndarray:
        """uint32 hash of the distribution key for each row."""
        hashes = []
        for name in self.spec.key_columns:
            col = key_columns[name]
            if col.type.id == t.TypeId.TEXT and col.dictionary is not None:
                hashes.append(col.dictionary.hash_array()[col.data])
            else:
                hashes.append(hash32_np(col.data))
        return combine_hashes(hashes, np)

    # ------------------------------------------------------------------
    # Select routing: which nodes can hold matching rows?
    # (GetRelationNodes / GetRelationNodesByQuals equivalents)
    # ------------------------------------------------------------------
    def nodes_for_read(self) -> list[int]:
        if self.spec.is_replicated:
            # read-any: prefer the first node (preferred-node logic)
            return [self.node_indices[0]]
        return list(self.node_indices)

    def nodes_for_write(self) -> list[int]:
        return list(self.node_indices)

    def _eq_hash(self, values: dict[str, object]):
        """(placement hash, first physical key) for a fully-pinned key
        set, or None. THE one constant→physical→hash sequence — node
        pruning and the shard barrier's membership proof must agree or
        a statement could 'prove' it misses a moving shard while
        routing to it."""
        if not all(k in values for k in self.spec.key_columns):
            return None
        hashes = []
        first_phys = None
        for name in self.spec.key_columns:
            ty = self.key_types.get(name)
            try:
                phys, is_str = _physical_key(values[name], ty)
            except (TypeError, ValueError):
                return None
            if first_phys is None:
                first_phys = phys
            if is_str:
                hashes.append(hash_strings([phys]))
            else:
                hashes.append(hash32_np(phys))
        return combine_hashes(hashes, np), first_phys

    def shard_id_by_key_equal(self, values: dict[str, object]):
        """The single shard group a fully-pinned key routes to (SHARD
        strategy only), or None. Lets the shard barrier prove a
        statement touches no in-move shard (shardbarrier.c's check is
        the same shard-id membership test)."""
        if self.spec.strategy != DistStrategy.SHARD:
            return None
        hp = self._eq_hash(values)
        if hp is None:
            return None
        assert self.shardmap is not None
        return int(self.shardmap.shard_ids(hp[0])[0])

    def prune_by_key_equal(self, values: dict[str, object]) -> list[int] | None:
        """If the quals pin every distribution-key column to a constant,
        return the single owning node ([n]); else None (all nodes). This is
        the fast-query-shipping pruning step (GetRelationNodesByQuals,
        locator.c:2511). Constants are converted to each key column's
        *physical* representation before hashing so the result always
        matches route_insert."""
        s = self.spec.strategy
        if s in (DistStrategy.REPLICATED, DistStrategy.ROUNDROBIN):
            return None
        hp = self._eq_hash(values)
        if hp is None:
            return None
        h, first_phys = hp
        if s == DistStrategy.SHARD:
            assert self.shardmap is not None
            return [int(self.shardmap.route_hash(h)[0])]
        if s == DistStrategy.MODULO:
            if first_phys is None or isinstance(first_phys, str):
                return None
            key = int(first_phys[0])
            return [self.node_indices[key % len(self.node_indices)]]
        if s == DistStrategy.RANGE:
            key = first_phys if isinstance(first_phys, str) else first_phys[0]
            bounds = np.asarray(self.spec.range_bounds)
            slot = int(np.searchsorted(bounds, key, side="right"))
            return [self.node_indices[slot]]
        return [self.node_indices[int(h[0]) % len(self.node_indices)]]


def _physical_key(v: object, ty: t.SqlType | None) -> tuple[object, bool]:
    """Convert a qual constant to the physical value route_insert hashes.
    Returns (value, is_string). Raises if the constant cannot be converted
    losslessly (caller then falls back to scanning all nodes)."""
    if ty is None:
        # Untyped fallback: python-type driven (legacy behavior).
        if isinstance(v, str):
            return v, True
        if isinstance(v, bool):
            return np.asarray([v], dtype=np.bool_), False
        if isinstance(v, int):
            return np.asarray([v], dtype=np.int64), False
        if isinstance(v, float):
            return np.asarray([v], dtype=np.float32), False
        raise TypeError(f"cannot prune on {type(v)}")
    tid = ty.id
    if tid == t.TypeId.TEXT:
        if not isinstance(v, str):
            raise TypeError("text key requires str constant")
        return v, True
    if tid == t.TypeId.DECIMAL:
        scaled = round(float(v) * ty.decimal_factor)
        return np.asarray([scaled], dtype=np.int64), False
    if tid == t.TypeId.DATE:
        days = np.datetime64(v, "D").astype("int64")
        return np.asarray([days], dtype=np.int32), False
    if tid == t.TypeId.TIMESTAMP:
        us = np.datetime64(v, "us").astype("int64")
        return np.asarray([us], dtype=np.int64), False
    if tid == t.TypeId.BOOL:
        return np.asarray([bool(v)], dtype=np.bool_), False
    if tid in (t.TypeId.INT4, t.TypeId.INT8):
        if isinstance(v, float) and not v.is_integer():
            raise ValueError("non-integral constant for integer key")
        return np.asarray([int(v)], dtype=np.int64), False
    # FLOAT4/FLOAT8
    return np.asarray([float(v)], dtype=np.float32), False

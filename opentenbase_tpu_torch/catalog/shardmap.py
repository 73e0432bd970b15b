"""Shard map: 4096 shard groups -> datanode mapping.

Equivalent of src/backend/pgxc/shard/shardmap.c in the reference (shard
group count src/include/pgxc/shardmap.h:27-28, EvaluateShardId
shardmap.c:2104, MOVE DATA rebalancing PgxcMoveData_*). The map is a dense
int32 array so routing a whole batch is one vectorized gather; the same
array is pushed to device for device-side batch routing during
redistribution.
"""

from __future__ import annotations

import numpy as np

from opentenbase_tpu_torch.utils.hashing import hash32_np

SHARD_GROUPS = 4096


class ShardMap:
    """shard id -> datanode mesh index, plus per-shard row statistics."""

    def __init__(self, num_shards: int = SHARD_GROUPS):
        self.num_shards = num_shards
        self.map = np.full(num_shards, -1, dtype=np.int32)
        self.row_stats = np.zeros(num_shards, dtype=np.int64)
        self.version = 0

    def initialize(self, node_indices: list[int]) -> None:
        """Round-robin shard groups over member datanodes (SyncShardMapList
        equivalent after CREATE SHARDING GROUP)."""
        if not node_indices:
            raise ValueError("cannot initialize shard map with no datanodes")
        nodes = np.asarray(node_indices, dtype=np.int32)
        self.map = nodes[np.arange(self.num_shards) % len(nodes)]
        self.version += 1

    # -- routing --------------------------------------------------------
    def shard_ids(self, key_hash: np.ndarray) -> np.ndarray:
        """hash values -> shard ids (EvaluateShardId, shardmap.c:2104)."""
        return (key_hash % np.uint32(self.num_shards)).astype(np.int32)

    def nodes_for_shards(self, shard_ids: np.ndarray) -> np.ndarray:
        return self.map[shard_ids]

    def route_hash(self, key_hash: np.ndarray) -> np.ndarray:
        return self.nodes_for_shards(self.shard_ids(key_hash))

    # -- rebalancing (MOVE DATA equivalent) ------------------------------
    def shards_on_node(self, node_index: int) -> np.ndarray:
        return np.nonzero(self.map == node_index)[0]

    def move_shard(self, shard_id: int, to_node: int) -> int:
        """Repoint one shard group; returns the previous owner. The actual
        data movement is driven by the rebalancer (rebalance/), which
        copies rows then calls this to flip ownership. In-memory only:
        durability is the caller's job — the rebalancer's flip journal
        record carries the post-flip map, so recovery and standbys
        rebuild it (WAL redo lands in ``apply_replayed_map``)."""
        prev = int(self.map[shard_id])
        self.map[shard_id] = to_node
        self.version += 1
        return prev

    def apply_replayed_map(self, map_list) -> None:
        """WAL-redo entry for a durable shard-map mutation ('shardmap' /
        'rebalance_flip' D-records): install the logged map and advance
        ``version`` so standbys invalidate routing caches exactly like
        the primary did at flip time."""
        self.map = np.asarray(map_list, dtype=np.int32)
        self.version += 1

    def add_node_rebalance_plan(self, new_node: int, node_indices: list[int]) -> list[int]:
        """Pick shard groups to hand to a new datanode so groups are level.
        Returns shard ids to move (caller moves data, then move_shard)."""
        all_nodes = list(node_indices) + [new_node]
        target = self.num_shards // len(all_nodes)
        moves: list[int] = []
        counts = {n: len(self.shards_on_node(n)) for n in node_indices}
        donors = sorted(counts, key=counts.get, reverse=True)
        for donor in donors:
            if len(moves) >= target:
                break
            for sid in self.shards_on_node(donor):
                if len(moves) >= target or counts[donor] <= target:
                    break
                moves.append(int(sid))
                counts[donor] -= 1
        return moves

    # -- stats ----------------------------------------------------------
    def record_rows(self, shard_ids: np.ndarray) -> None:
        np.add.at(self.row_stats, shard_ids, 1)

    def bytes_per_shard(self, avg_row_bytes: float) -> np.ndarray:
        """Per-shard byte weights from ``row_stats`` — the rebalance
        planner's load signal (balance bytes, not shard counts). Shards
        with no recorded rows weigh one row so an empty cluster still
        levels by count."""
        rows = self.row_stats.astype(np.float64)
        rows = np.maximum(rows, 1.0)
        return rows * max(float(avg_row_bytes), 1.0)

    def node_bytes(self, avg_row_bytes: float) -> dict[int, float]:
        """Total byte weight per owning datanode (pg_stat_rebalance's
        balance verdict + the planner's donor ordering)."""
        w = self.bytes_per_shard(avg_row_bytes)
        out: dict[int, float] = {}
        for n in np.unique(self.map):
            if int(n) >= 0:
                out[int(n)] = float(w[self.map == n].sum())
        return out


def shard_hash_for_column(data: np.ndarray) -> np.ndarray:
    """Hash a physical key column (int32/int64 representation) to uint32.
    TEXT columns must be pre-mapped to their dictionary *string* hashes so
    equal strings hash equally across tables (see Dictionary.hash_array)."""
    return hash32_np(data)

"""Distribution strategies (locator types).

Mirrors src/include/pgxc/locator.h:20-33 of the reference:

    LOCATOR_TYPE_REPLICATED 'R'   -> REPLICATED
    LOCATOR_TYPE_HASH       'H'   -> HASH
    LOCATOR_TYPE_MODULO     'M'   -> MODULO
    LOCATOR_TYPE_RROBIN     'N'   -> ROUNDROBIN
    LOCATOR_TYPE_SHARD      'S'   -> SHARD   (hash -> 4096 shard groups -> node)
    LOCATOR_TYPE_RANGE      'G'   -> RANGE

SHARD is the OpenTenBase-native strategy (rebalancable via the shard map);
HASH/MODULO hash directly onto the node list (legacy XC). RANGE partitions
on sorted boundaries.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class DistStrategy(enum.Enum):
    REPLICATED = "replicated"
    HASH = "hash"
    MODULO = "modulo"
    ROUNDROBIN = "roundrobin"
    SHARD = "shard"
    RANGE = "range"


@dataclass
class DistributionSpec:
    """How one table's rows map to datanodes (a pgxc_class row)."""

    strategy: DistStrategy
    key_columns: tuple[str, ...] = ()
    # Secondary (cold/hot) time key for dual-group routing, SHARD only.
    secondary_key: str | None = None
    group: str | None = None  # node group name; None = all datanodes
    # RANGE only: sorted upper bounds, len == len(nodes)-1.
    range_bounds: tuple = ()

    def __post_init__(self):
        needs_key = self.strategy in (
            DistStrategy.HASH,
            DistStrategy.MODULO,
            DistStrategy.SHARD,
            DistStrategy.RANGE,
        )
        if needs_key and not self.key_columns:
            raise ValueError(f"{self.strategy.value} distribution requires a key column")

    @property
    def is_replicated(self) -> bool:
        return self.strategy == DistStrategy.REPLICATED

    def describe(self) -> str:
        if self.strategy == DistStrategy.REPLICATED:
            return "DISTRIBUTE BY REPLICATION"
        if self.strategy == DistStrategy.ROUNDROBIN:
            return "DISTRIBUTE BY ROUNDROBIN"
        keys = ", ".join(self.key_columns)
        return f"DISTRIBUTE BY {self.strategy.value.upper()}({keys})"

from opentenbase_tpu_torch.catalog.nodes import NodeManager, NodeDef, NodeRole, NodeGroup
from opentenbase_tpu_torch.catalog.shardmap import ShardMap, SHARD_GROUPS
from opentenbase_tpu_torch.catalog.distribution import DistStrategy, DistributionSpec
from opentenbase_tpu_torch.catalog.catalog import Catalog, TableMeta

__all__ = [
    "NodeManager",
    "NodeDef",
    "NodeRole",
    "NodeGroup",
    "ShardMap",
    "SHARD_GROUPS",
    "DistStrategy",
    "DistributionSpec",
    "Catalog",
    "TableMeta",
]

from opentenbase_tpu_torch.storage.column import Column, Dictionary
from opentenbase_tpu_torch.storage.table import ColumnBatch, ShardStore

__all__ = ["Column", "Dictionary", "ColumnBatch", "ShardStore"]

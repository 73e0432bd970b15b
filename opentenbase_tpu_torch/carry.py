"""Carry a table's stored state into a port cluster: the database's
counterpart of carrying weights across.

The rows go in unchanged — column data, validity and the per-row commit
timestamps — so a port cluster answers over exactly the state another
deployment holds (the parity tests read the arrays out of a reference
cluster's stores and hand them over as numpy arrays).
"""

from __future__ import annotations

import numpy as np

from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import (
    INF_TS,
    PENDING_TS,
    RESERVED_TS,
    ColumnBatch,
)


def load_table(cluster, table: str, per_node_columns: dict,
               per_node_xmin: dict, per_node_xmax: dict,
               dictionaries: dict | None = None) -> int:
    """Append each datanode's rows to ``cluster.stores[node][table]``.

    ``per_node_columns``: node -> column name -> ``(data, validity)``
    numpy arrays (validity None = no NULLs), every column of the table;
    a TEXT column's data are codes into the source's dictionary, whose
    values (in code order) ``dictionaries[column]`` holds: the codes are
    re-encoded into the table's own dictionary. ``per_node_xmin`` /
    ``per_node_xmax``: node -> int64 commit timestamps per row (xmax
    INF_TS for a live row). The cluster's clock moves past every carried
    commit timestamp, so a later read sees what the source saw. Returns
    the rows loaded."""
    meta = cluster.catalog.get(table)
    # source code -> this table's code, per TEXT column
    xlate = {}
    for name, ty in meta.schema.items():
        if ty.is_text:
            if dictionaries is None or name not in dictionaries:
                raise ValueError(f"TEXT column {name} needs its dictionary")
            vals = list(dictionaries[name])
            xlate[name] = (meta.dictionaries[name].encode(vals) if vals
                           else np.zeros(1, dtype=np.int32))
    total = 0
    top = 0
    for node, cols in per_node_columns.items():
        if node not in meta.node_indices:
            raise ValueError(f"node {node} holds no shard of {table!r}")
        missing = set(meta.schema) - set(cols)
        if missing:
            raise ValueError(f"missing columns {sorted(missing)}")
        xmin = np.asarray(per_node_xmin[node], dtype=np.int64)
        xmax = np.asarray(per_node_xmax[node], dtype=np.int64)
        n = len(xmin)
        if len(xmax) != n:
            raise ValueError("xmin and xmax differ in length")
        batch = ColumnBatch(
            {
                name: Column(
                    ty, _data(cols[name], xlate.get(name)),
                    None if cols[name][1] is None
                    else np.asarray(cols[name][1], dtype=np.bool_),
                )
                for name, ty in meta.schema.items()
            },
            n,
        )
        for name, c in batch.columns.items():
            if len(c) != n:
                raise ValueError(f"column {name} has {len(c)} rows, not {n}")
        store = cluster.stores[node][table]
        start, _ = store.append_batch(batch, PENDING_TS)
        # stamp each run of equal xmin, then each distinct finite xmax
        bounds = np.flatnonzero(np.diff(xmin)) + 1
        for s, e in zip(np.r_[0, bounds], np.r_[bounds, n]):
            if e > s:
                store.stamp_xmin(start + int(s), start + int(e), int(xmin[s]))
        for ts in np.unique(xmax[xmax != INF_TS]):
            store.stamp_xmax(start + np.flatnonzero(xmax == ts), int(ts))
        stamps = np.concatenate([xmin, xmax])
        committed = stamps[stamps < RESERVED_TS]
        if committed.size:
            top = max(top, int(committed.max()))
        total += n
    cluster.gts_advance_to(top)
    return total


def load_partitioned(cluster, parent: str, schema: dict, strategy: str,
                     key_columns, clause: dict, per_child: dict,
                     dictionaries: dict | None = None) -> int:
    """A partitioned table carried across: the parent's catalog shell
    and ``PartitionSpec`` from its partition ``clause`` (the source's
    ``PartitionSpec.spec``: column, begin, step, step unit and count),
    its partitions (each sharing the parent's dictionaries, distributed
    by ``strategy`` ("shard", "hash", ...) over ``key_columns``), then
    each partition's rows.

    ``schema``: column -> type name as the WAL writes it ("int8",
    "text", "decimal(15,2)", ...), in column order. ``per_child``:
    partition name (``parent$pK``) -> ``(per_node_columns,
    per_node_xmin, per_node_xmax)`` as ``load_table`` takes them, with
    ``dictionaries`` the source's shared TEXT dictionaries. Returns the
    rows loaded."""
    from opentenbase_tpu_torch.catalog.distribution import (
        DistributionSpec,
        DistStrategy,
    )
    from opentenbase_tpu_torch.plan.partition import PartitionSpec
    from opentenbase_tpu_torch.storage.persist import _type_from_str

    types = {c: _type_from_str(ty) for c, ty in schema.items()}
    dist = DistributionSpec(DistStrategy(strategy), tuple(key_columns))
    spec = PartitionSpec.build(parent, dict(clause), types[clause["column"]])
    shell = cluster.catalog.create_table(parent, dict(types), dist)
    cluster.partitions[parent] = spec
    for child in spec.children():
        meta = cluster.catalog.create_table(child, dict(types), dist)
        meta.dictionaries = shell.dictionaries
        cluster.create_table_stores(meta)
    total = 0
    for child, (cols, xmin, xmax) in per_child.items():
        if child not in spec.children():
            raise ValueError(f"{child!r} is no partition of {parent!r}")
        total += load_table(cluster, child, cols, xmin, xmax, dictionaries)
    return total


def foreign_table(cluster, name: str, schema: dict, server: str,
                  options: dict) -> None:
    """A foreign table carried across: its catalog entry on one node,
    its ``server`` and ``options`` (``filename``, ``format``, ...); its
    rows stay in the source, which its scans read. ``schema`` as
    ``load_partitioned`` takes it."""
    from opentenbase_tpu_torch.catalog.distribution import (
        DistributionSpec,
        DistStrategy,
    )
    from opentenbase_tpu_torch.storage.persist import _type_from_str

    meta = cluster.catalog.create_table(
        name, {c: _type_from_str(ty) for c, ty in schema.items()},
        DistributionSpec(DistStrategy.REPLICATED))
    meta.node_indices = meta.node_indices[:1]
    meta.foreign = {**options, "server": server}


def _data(col, xl):
    """A column's data, TEXT codes re-encoded through ``xl`` (a NULL
    slot keeps code 0)."""
    data = np.asarray(col[0])
    if xl is None:
        return data
    out = xl[np.clip(data, 0, len(xl) - 1)].astype(np.int32)
    if col[1] is not None:
        out[~np.asarray(col[1], dtype=np.bool_)] = 0
    return out

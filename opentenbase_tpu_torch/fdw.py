"""Foreign data wrappers — the FDW plugin boundary (src/backend/foreign,
contrib/file_fdw).

A foreign table has no shard stores; its scan materializes rows from an
external source at query time. The built-in ``file`` server reads
CSV/TSV (file_fdw's surface):

    CREATE FOREIGN TABLE ft (a bigint, b text)
        SERVER file OPTIONS (filename '/path.csv', format 'csv',
                             header 'true');

The loaded batch is cached per (file mtime, size) — re-reading only when
the file changes, like file_fdw's per-scan re-parse but amortized for
repeated analytics.
"""

from __future__ import annotations

import csv
import os

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.storage.table import ColumnBatch, ShardStore


class FdwError(RuntimeError):
    pass


def foreign_store(meta) -> ShardStore:
    """Materialize (with caching) a ShardStore view of the foreign
    source described by ``meta.foreign``."""
    spec = meta.foreign
    if spec is None:
        raise FdwError(f'"{meta.name}" is not a foreign table')
    if spec.get("server", "file") != "file":
        raise FdwError(f"unknown foreign server {spec.get('server')!r}")
    path = spec.get("filename")
    if not path:
        raise FdwError("file server requires a filename option")
    try:
        st = os.stat(path)
    except OSError as e:
        raise FdwError(f"cannot read {path}: {e}") from e
    key = (st.st_mtime_ns, st.st_size)
    cached = getattr(meta, "_fdw_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    delim = spec.get("delimiter") or (
        "\t" if spec.get("format") == "tsv" else ","
    )
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=delim))
    if str(spec.get("header", "")).lower() in ("true", "t", "1") and rows:
        rows = rows[1:]
    columns = list(meta.schema)
    data: dict[str, list] = {c: [] for c in columns}
    types = [meta.schema[c] for c in columns]
    for row in rows:
        if len(row) != len(columns):
            raise FdwError(
                f"{path}: expected {len(columns)} fields, got {len(row)}"
            )
        for c, ty, v in zip(columns, types, row):
            data[c].append(_parse_value(ty, v))
    batch = ColumnBatch.from_pydict(
        data, dict(meta.schema), meta.dictionaries
    )
    store = ShardStore(meta.schema, meta.dictionaries)
    store.append_batch(batch, 1)  # visible to every snapshot
    meta._fdw_cache = (key, store)
    return store


def _parse_value(ty: t.SqlType, v: str):
    """CSV text -> python value, matching COPY FROM's conversions."""
    if v == "\\N" or v == "":
        return None
    if ty.id == t.TypeId.DECIMAL:
        return float(v)
    if ty.id == t.TypeId.BOOL:
        return v.lower() in ("t", "true", "1")
    if ty.is_numeric:
        if ty.id in (t.TypeId.FLOAT4, t.TypeId.FLOAT8):
            return float(v)
        return int(v)
    return v

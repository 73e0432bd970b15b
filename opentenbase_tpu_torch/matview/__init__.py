"""Materialized views with incremental maintenance (the reference's
opentenbase_tpu/matview, with its imports rewritten to the port's
modules).

OpenTenBase ships recompute-only materialized views
(src/backend/commands/matview.c, REFRESH MATERIALIZED VIEW
[CONCURRENTLY]); this subsystem goes further: the cluster WAL's 'G'
frames already carry every committed transaction's row-level changes
(storage/logical.py decodes them for logical replication), and for a
supported shape class — single-table filter/project and GROUP BY with
sum/count/avg/min/max — REFRESH consumes exactly that delta stream and
applies per-group updates instead of re-scanning the fact table
(DBToaster-style delta maintenance; Napa-style continuously fresh
pre-aggregation).

- ``defs``    — MatviewDef catalog entries, shape classification,
  fingerprints, the durable refresh-state table, recovery fixup.
- ``refresh`` — the refresh engine: full recompute and incremental
  delta apply, both transactional (one WAL commit frame carries the
  new contents AND the refresh-state row, so a crash can never
  separate them — the replication-origin trick of storage/logical).
- ``rewrite`` — the serving path: a query that exactly matches a
  fresh matview's defining query is answered from the matview
  (``enable_matview_rewrite`` GUC), visible in EXPLAIN.
"""

from opentenbase_tpu_torch.matview.defs import (  # noqa: F401
    MatviewDef,
    STATE_TABLE,
    classify,
    fingerprint,
    is_fresh,
    load_state,
    register,
)

"""Matview catalog entries, shape classification, and durable state
(the reference's opentenbase_tpu/matview/defs.py).

A materialized view is a real distributed table (storage/table +
catalog/locator) plus a ``MatviewDef`` describing its defining query.
The def carries everything maintenance and serving need:

- **shape**: the incremental-maintenance classification. Supported:
  single-table filter/project, and GROUP BY over one table where every
  output is either a grouped key expression or a bare
  sum/count/avg/min/max call. Joins, DISTINCT, windows, subqueries,
  set ops and HAVING transparently degrade to full recompute.
- **fingerprint**: the canonical (deparsed) text of the defining query,
  matched against incoming queries by the planner rewrite.
- **refresh state**: ``last_refresh_lsn`` / counters live in the
  replicated ``otb_matview_state`` table and are replaced INSIDE each
  refresh transaction, so the WAL position and the applied contents
  commit in one frame (a crash can never separate them — the same
  contract logical replication's slot state rides on).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from opentenbase_tpu_torch.sql import ast as A

STATE_TABLE = "otb_matview_state"

AGG_FUNCS = {"sum", "count", "avg", "min", "max"}

# functions whose result depends on session/time state: a defining query
# containing one can never be served from a snapshot, so it gets no
# fingerprint (and no rewrite)
_VOLATILE_FUNCS = {
    "nextval", "currval", "setval", "random", "now",
    "current_timestamp", "current_date", "pg_sleep",
}


@dataclass
class AggSpec:
    """One aggregate output column of an agg-shaped matview."""

    col: str               # output column name in the matview
    func: str              # sum | count | avg | min | max
    arg: Optional[A.Expr]  # None for count(*)
    star: bool = False


@dataclass
class Shape:
    """Incremental-maintenance classification of a defining query."""

    kind: str                       # "agg" | "project"
    table: str                      # the single base table
    where: Optional[A.Expr]
    group_exprs: list = field(default_factory=list)
    key_cols: list = field(default_factory=list)   # matview column names
    aggs: list = field(default_factory=list)       # list[AggSpec]

    @property
    def has_minmax(self) -> bool:
        return any(a.func in ("min", "max") for a in self.aggs)


@dataclass
class MatviewDef:
    name: str
    query: A.Select                 # defining query AST (template)
    text: str                       # verbatim body source
    options: dict = field(default_factory=dict)
    incremental: bool = True        # WITH (incremental = on|off)
    shape: Optional[Shape] = None   # None = full recompute only
    fingerprint: Optional[str] = None
    base_tables: set = field(default_factory=set)
    aux_schema: Optional[dict] = None  # aux table schema (type strings)
    # refresh state (mirrors the otb_matview_state row)
    last_refresh_lsn: int = 0
    last_refresh_ts: int = 0        # refresh snapshot (vacuum horizon)
    base_versions: Optional[dict] = None  # None = stale / unknown
    stats: dict = field(default_factory=lambda: {
        "incremental_refreshes": 0,
        "full_refreshes": 0,
        "deltas_applied": 0,
        "rewrites": 0,
        "last_refresh_ms": 0.0,
        "last_mode": "",
    })

    @property
    def aux_table(self) -> str:
        return f"{self.name}$aux"

    def wants_incremental(self) -> bool:
        return self.incremental and self.shape is not None


# ---------------------------------------------------------------------------
# fingerprints (the rewrite's match key)
# ---------------------------------------------------------------------------


def _has_volatile(sel: A.Select) -> bool:
    stack = [sel]
    while stack:
        x = stack.pop()
        if x is None:
            # a None FIELD only ends this branch of the walk, never
            # the whole search (returning here made the check miss
            # volatile calls behind any earlier-popped empty field)
            continue
        if isinstance(x, A.FuncCall) and x.name.lower() in _VOLATILE_FUNCS:
            return True
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(
                getattr(x, f.name) for f in dataclasses.fields(x)
            )
    return False


def fingerprint(sel: A.Select) -> Optional[str]:
    """Canonical text of a SELECT for exact-match rewriting, or None
    when the query can't be served from stored rows: an ORDER BY would
    be lost by a table scan, and volatile functions must re-evaluate."""
    if not isinstance(sel, A.Select):
        return None
    if sel.order_by or sel.for_update or sel.values_rows:
        return None
    if _has_volatile(sel):
        return None
    from opentenbase_tpu_torch.sql.deparse import DeparseError, deparse_select

    try:
        return deparse_select(sel)
    except DeparseError:
        return None


# ---------------------------------------------------------------------------
# shape classification
# ---------------------------------------------------------------------------


def _expr_has_subquery(e) -> bool:
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, (A.Select, A.ScalarSubquery, A.InSubquery,
                          A.ExistsSubquery, A.WindowCall)):
            return True
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(
                getattr(x, f.name) for f in dataclasses.fields(x)
            )
    return False


def _contains_agg(e) -> bool:
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, A.FuncCall) and x.name.lower() in AGG_FUNCS:
            return True
        if isinstance(x, (A.Select,)):
            continue
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(
                getattr(x, f.name) for f in dataclasses.fields(x)
            )
    return False


def classify(
    query: A.Select, cluster, out_cols: list[str]
) -> Optional[Shape]:
    """Classify a defining query for incremental maintenance.
    ``out_cols`` are the matview's output column names (one per select
    item, in order). Returns None for unsupported shapes — the caller
    degrades to full recompute, never errors."""
    sel = query
    if (
        sel.set_ops or sel.ctes or sel.distinct
        or sel.distinct_on is not None or sel.grouping_sets is not None
        or sel.having is not None or sel.order_by
        or sel.limit is not None or sel.offset is not None
        or sel.values_rows or sel.for_update
    ):
        return None
    fc = sel.from_clause
    if not isinstance(fc, A.RelRef):
        return None
    if fc.alias is not None:
        return None  # keep the delta-query rename trivially safe
    table = fc.name
    if not cluster.catalog.has(table):
        return None  # view / partition parent / missing: recompute only
    if table in cluster.partitions or table in cluster.views:
        return None
    meta = cluster.catalog.get(table)
    if getattr(meta, "foreign", None) is not None:
        return None  # no WAL deltas for foreign tables
    if sel.where is not None and _expr_has_subquery(sel.where):
        return None
    if len(out_cols) != len(sel.items):
        return None
    for item in sel.items:
        if isinstance(item.expr, A.Star):
            return None
        if _expr_has_subquery(item.expr):
            return None

    if not sel.group_by:
        # filter/project: no aggregates anywhere
        if any(_contains_agg(it.expr) for it in sel.items):
            return None  # scalar aggregate without GROUP BY
        return Shape("project", table, sel.where)

    # agg shape: every item is a grouped key expr or a bare agg call
    key_exprs = list(sel.group_by)
    key_cols: list[str] = []
    covered = [False] * len(key_exprs)
    aggs: list[AggSpec] = []
    for item, col in zip(sel.items, out_cols):
        e = item.expr
        if isinstance(e, A.FuncCall) and e.name.lower() in AGG_FUNCS:
            if e.distinct:
                return None
            if e.star:
                if e.name.lower() != "count":
                    return None
                aggs.append(AggSpec(col, "count", None, star=True))
                continue
            if len(e.args) != 1 or _contains_agg(e.args[0]):
                return None
            aggs.append(AggSpec(col, e.name.lower(), e.args[0]))
            continue
        matched = False
        for j, k in enumerate(key_exprs):
            if not covered[j] and _expr_eq(e, k):
                covered[j] = True
                key_cols.append(col)
                matched = True
                break
        if not matched:
            return None  # an output that is neither key nor bare agg
    if not all(covered):
        return None  # a grouping key not selected: groups unmatchable
    return Shape("agg", table, sel.where, key_exprs, key_cols, aggs)


def _expr_eq(a, b) -> bool:
    """Structural equality between a select item and a grouping key,
    lenient about a missing table qualifier (t.a matches a)."""
    if isinstance(a, A.ColumnRef) and isinstance(b, A.ColumnRef):
        return a.name == b.name and (
            a.table == b.table or a.table is None or b.table is None
        )
    return a == b


# ---------------------------------------------------------------------------
# registration (shared by DDL, WAL redo, and checkpoint restore)
# ---------------------------------------------------------------------------


def register(
    cluster, name: str, text: str, options: dict,
    aux_schema: Optional[dict] = None,
) -> MatviewDef:
    """Build and register the MatviewDef for an existing (or about to
    be created) backing table. Idempotent on name."""
    from opentenbase_tpu_torch.plan.astwalk import relation_names
    from opentenbase_tpu_torch.sql.parser import Parser

    query = Parser(text).parse_select()
    d = MatviewDef(
        name=name,
        query=query,
        text=text,
        options=dict(options or {}),
        incremental=bool((options or {}).get("incremental", True)),
        aux_schema=dict(aux_schema) if aux_schema else None,
    )
    d.fingerprint = fingerprint(query)
    # base tables: every real relation the (view-expanded) query reads —
    # the freshness check must cover all of them
    probe = copy.deepcopy(query)
    try:
        from opentenbase_tpu_torch.plan.views import expand_ctes, rewrite_views

        expand_ctes(probe)
        rewrite_views(probe, cluster.views)
    except Exception:
        pass
    d.base_tables = {
        r for r in relation_names(probe)
        if cluster.catalog.has(r) or r in cluster.partitions
    }
    out_cols = None
    if cluster.catalog.has(name):
        out_cols = list(cluster.catalog.get(name).schema)
    if out_cols is not None:
        d.shape = classify(query, cluster, out_cols)
    cluster.matviews[name] = d
    return d


# ---------------------------------------------------------------------------
# freshness (serving-path staleness check)
# ---------------------------------------------------------------------------


def is_fresh(cluster, d: MatviewDef) -> bool:
    """True when no base table has committed a write since the last
    refresh — the condition under which the rewrite may serve the
    matview's rows as the query's answer."""
    if d.base_versions is None:
        return False
    expected = {
        tb: cluster.table_version.get(tb, 0) for tb in d.base_tables
    }
    return expected == d.base_versions


def snapshot_versions(cluster, d: MatviewDef) -> dict:
    return {tb: cluster.table_version.get(tb, 0) for tb in d.base_tables}


# ---------------------------------------------------------------------------
# durable refresh state (otb_matview_state)
# ---------------------------------------------------------------------------

STATE_SCHEMA_SQL = (
    f"create table {STATE_TABLE} (mv text, lsn bigint, ts bigint, "
    "incr bigint, fullr bigint, deltas bigint) "
    "distribute by replication"
)


def ensure_state_table(session) -> None:
    if not session.cluster.catalog.has(STATE_TABLE):
        session.execute(STATE_SCHEMA_SQL)


def state_row(d: MatviewDef) -> dict:
    return {
        "mv": d.name,
        "lsn": int(d.last_refresh_lsn),
        "ts": int(d.last_refresh_ts),
        "incr": int(d.stats.get("incremental_refreshes", 0)),
        "fullr": int(d.stats.get("full_refreshes", 0)),
        "deltas": int(d.stats.get("deltas_applied", 0)),
    }


def load_state(cluster) -> None:
    """Recovery fixup: fold the replayed otb_matview_state rows back
    into the in-memory defs, then decide freshness by scanning the WAL
    tail for base-table commits after each matview's refresh LSN."""
    rows = _read_state_rows(cluster)
    for name, d in cluster.matviews.items():
        st = rows.get(name)
        if st is not None:
            lsn, ts, incr, fullr, deltas = st
            d.last_refresh_lsn = int(lsn or 0)
            d.last_refresh_ts = int(ts or 0)
            d.stats["incremental_refreshes"] = int(incr or 0)
            d.stats["full_refreshes"] = int(fullr or 0)
            d.stats["deltas_applied"] = int(deltas or 0)
        # probe set includes partition children: WAL frames carry the
        # child table names while the def tracks the parent
        probe = set(d.base_tables)
        for tb in d.base_tables:
            spec = cluster.partitions.get(tb)
            if spec is not None:
                probe.update(spec.children())
        if _wal_touches_after(cluster, probe, d.last_refresh_lsn):
            d.base_versions = None  # stale until the next refresh
        else:
            d.base_versions = snapshot_versions(cluster, d)


def _read_state_rows(cluster) -> dict:
    """Direct store read of the state table (one replicated copy) —
    runs during recovery, before any session exists."""
    out: dict = {}
    if not cluster.catalog.has(STATE_TABLE):
        return out
    meta = cluster.catalog.get(STATE_TABLE)
    snap = cluster.gts.snapshot_ts()
    for node in meta.node_indices:
        store = cluster.stores.get(node, {}).get(STATE_TABLE)
        if store is None or store.nrows == 0:
            continue
        idx = store.live_index(snap)
        if not len(idx):
            continue
        data = store.take_batch(idx).to_pydict()
        for r in range(len(idx)):
            out[data["mv"][r]] = (
                data["lsn"][r], data["ts"][r], data["incr"][r],
                data["fullr"][r], data["deltas"][r],
            )
        break  # replicated: one copy is the truth
    return out


# content-changing DDL ops that leave no 'G' frames: both the delta
# decoder and the recovery staleness probe must treat them as writes
CONTENT_DDL_OPS = (
    "truncate", "redistribute", "add_column", "drop_column",
    "drop_table",
)


def _wal_touches_after(cluster, tables: set, lsn: int) -> bool:
    """Header-only WAL scan: does any committed 'G' frame — or a
    content-changing 'D' record (TRUNCATE/ALTER/redistribute leave no
    row frames) — after ``lsn`` touch one of ``tables``? (The
    staleness probe recovery runs.)"""
    p = cluster.persistence
    if p is None or not tables:
        return False
    from opentenbase_tpu_torch.storage.persist import WAL

    for tag, header, _a, _off in WAL.read_records(
        p.wal.path, start=int(lsn), decode_arrays=False
    ):
        if tag == "D":
            if header.get("name") in tables and (
                header.get("op") in CONTENT_DDL_OPS
            ):
                return True
            continue
        if tag == "C":
            # 2PC commit decision whose 'T' writes may predate this
            # window: conservatively stale (a refresh re-syncs)
            return True
        if tag in ("G", "T"):
            for wm in header.get("writes", ()):
                if wm.get("table") in tables:
                    return True
    return False

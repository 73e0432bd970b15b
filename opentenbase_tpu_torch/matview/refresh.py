"""Matview refresh engine: full recompute and incremental delta apply
(the reference's opentenbase_tpu/matview/refresh.py).

Both paths end in ONE transaction that carries the content change AND
the replacement of the matview's ``otb_matview_state`` row, so the WAL
commit frame is atomic: after a crash, recovery either replays both or
neither — ``last_refresh_lsn`` can never disagree with the stored rows
(the slot-state-in-apply-transaction contract of storage/logical.py).

Incremental maintenance (the delta path):

1. ``decode_table_deltas`` turns the WAL's 'G' frames after
   ``last_refresh_lsn`` into the base table's row-level inserts and
   deletes (deletes resolve their old tuples from the store's dead
   versions, exactly as logical decoding does).
2. The deltas land in throwaway replicated tables and the *partials
   query* — the defining query rewritten to produce per-group
   count(*)/sum/non-null-count partial states — runs over them through
   the ordinary (vectorized, on-device) host executor: Q(Δ), the
   classic delta-query formulation.
3. Dirty groups merge arithmetically against the matview's auxiliary
   state table (count/sum/avg are exact under addition with non-null
   counts deciding NULL transitions); min/max — which are not
   invertible under deletion — fall back to a per-dirty-group
   recompute against the base table, restricted to exactly the dirty
   group keys.
4. The apply transaction deletes the dirty groups and inserts their
   new rows (matview + aux + state), routed and WAL-framed like any
   other write.

Filter/project matviews skip the aux machinery: Q(Δins) rows append,
Q(Δdel) rows retract one-for-one (multiset semantics, the same
old-tuple matching the logical-replication apply worker uses).

The compute phase passes the ``matview/refresh`` failpoint (fault/).
"""

from __future__ import annotations

import contextlib
import copy
import logging
import time
import uuid
from typing import Optional

from opentenbase_tpu_torch.catalog.distribution import DistributionSpec, DistStrategy
from opentenbase_tpu_torch.fault import FAULT
from opentenbase_tpu_torch.matview.defs import (
    STATE_TABLE,
    MatviewDef,
    snapshot_versions,
    state_row,
)
from opentenbase_tpu_torch.sql import ast as A

log = logging.getLogger(__name__)

_CHUNK = 200  # dirty groups per DELETE statement


def _lit(v) -> A.Literal:
    item = getattr(v, "item", None)
    return A.Literal(item() if item is not None else v)


def _or_all(preds):
    out = None
    for p in preds:
        out = p if out is None else A.BinOp("or", out, p)
    return out


def _and_all(preds):
    out = None
    for p in preds:
        out = p if out is None else A.BinOp("and", out, p)
    return out


def _col_eq(ref: A.Expr, v) -> A.Expr:
    if v is None:
        return A.IsNull(ref)
    return A.BinOp("=", ref, _lit(v))


def key_predicate(refs: list[A.Expr], keys) -> Optional[A.Expr]:
    """Predicate selecting exactly the given key tuples. ``refs`` are
    the expressions producing each key part (column refs for the
    matview/aux side, the grouping expressions for the base side).
    NULL keys compare with IS NULL (SQL groups NULLs together)."""
    keys = list(keys)
    if not keys:
        return None
    if len(refs) == 1:
        ref = refs[0]
        nonnull = sorted(
            {k[0] for k in keys if k[0] is not None}, key=repr
        )
        preds = []
        if nonnull:
            preds.append(
                A.InList(
                    copy.deepcopy(ref),
                    tuple(_lit(v) for v in nonnull),
                )
            )
        if any(k[0] is None for k in keys):
            preds.append(A.IsNull(copy.deepcopy(ref)))
        return _or_all(preds)
    return _or_all(
        _and_all(
            _col_eq(copy.deepcopy(r), v) for r, v in zip(refs, key)
        )
        for key in keys
    )


# ---------------------------------------------------------------------------
# query builders
# ---------------------------------------------------------------------------


def build_partials_select(shape, table: Optional[str] = None,
                          extra_pred: Optional[A.Expr] = None) -> A.Select:
    """The partial-aggregate state query for an agg-shaped matview:
    group keys (g0..gK), count(*) as cnt, and per sum/avg aggregate its
    running sum and non-null count (a{i}_sum / a{i}_nn). Runs over the
    base table, a delta table, or a dirty-group restriction of either."""
    items = [
        A.SelectItem(copy.deepcopy(k), f"g{j}")
        for j, k in enumerate(shape.group_exprs)
    ]
    items.append(
        A.SelectItem(A.FuncCall("count", (), star=True), "cnt")
    )
    for i, a in enumerate(shape.aggs):
        if a.func in ("sum", "avg"):
            items.append(A.SelectItem(
                A.FuncCall("sum", (copy.deepcopy(a.arg),)), f"a{i}_sum"
            ))
            items.append(A.SelectItem(
                A.FuncCall("count", (copy.deepcopy(a.arg),)), f"a{i}_nn"
            ))
        elif a.func == "count" and not a.star:
            items.append(A.SelectItem(
                A.FuncCall("count", (copy.deepcopy(a.arg),)), f"a{i}_nn"
            ))
    where = copy.deepcopy(shape.where)
    if extra_pred is not None:
        where = extra_pred if where is None else A.BinOp(
            "and", where, extra_pred
        )
    return A.Select(
        items=items,
        from_clause=A.RelRef(table or shape.table, None),
        where=where,
        group_by=[copy.deepcopy(k) for k in shape.group_exprs],
    )


def _run_host(session, sel: A.Select):
    """Run an internal refresh query on the HOST executor. The delta
    tables are uuid-named throwaways and the dirty-group predicates
    change every refresh, so on the fused route each refresh would
    upload planes and build programs keyed by names and literals it
    never sees again. Full recomputes (a stable plan over the real base
    table) still take the fused route: K1 on a single fragment."""
    saved = session.gucs.get("enable_fused_execution", True)
    session.gucs["enable_fused_execution"] = False
    try:
        return session._run_select(sel)
    finally:
        session.gucs["enable_fused_execution"] = saved


def _defining_select(d: MatviewDef, table: Optional[str] = None,
                     extra_pred: Optional[A.Expr] = None) -> A.Select:
    sel = copy.deepcopy(d.query)
    if table is not None and d.shape is not None:
        from opentenbase_tpu_torch.plan.astwalk import rename_relations

        rename_relations(sel, {d.shape.table: table})
    if extra_pred is not None:
        sel.where = extra_pred if sel.where is None else A.BinOp(
            "and", sel.where, extra_pred
        )
    return sel


# ---------------------------------------------------------------------------
# temp delta tables
# ---------------------------------------------------------------------------


def _make_delta_table(session, base_meta, rows: list[dict]) -> str:
    """Materialize decoded delta rows as a throwaway replicated table
    (xmin=1: visible at any snapshot, never WAL-logged) so the delta
    queries run through the ordinary executor. It is coordinator-only
    (``Cluster.local_tables``): no datanode process holds it."""
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    c = session.cluster
    name = f"__mvdelta_{uuid.uuid4().hex[:10]}"
    meta = c.catalog.create_table(
        name, dict(base_meta.schema),
        DistributionSpec(DistStrategy.REPLICATED),
    )
    c.create_table_stores(meta)
    c.local_tables.add(name)
    if rows:
        data = {
            col: [r.get(col) for r in rows] for col in meta.schema
        }
        batch = ColumnBatch.from_pydict(
            data, meta.schema, meta.dictionaries
        )
        for n in meta.node_indices:
            c.stores[n][name].append_batch(batch, 1)
    return name


def _drop_delta_table(session, name: str) -> None:
    """Drop a delta table: its stores, and the device planes and fused
    state keyed by it (``Cluster.drop_table_stores``)."""
    c = session.cluster
    try:
        c.catalog.drop_table(name)
    except Exception:
        pass
    c.drop_table_stores(name)
    c.local_tables.discard(name)


# ---------------------------------------------------------------------------
# the refresh entry point
# ---------------------------------------------------------------------------


class PinnedSnapshot:
    """The refresh-snapshot protocol, shared by CREATE MATERIALIZED VIEW
    and REFRESH: ONE read snapshot pinned adjacent to the caller's lsn0
    capture. A base commit landing after lsn0 must be invisible to the
    compute-phase reads — a commit the reads absorbed but lsn0 predates
    would be decoded from WAL by the next incremental refresh and
    applied AGAIN. ``release()`` is idempotent: callers drop the pin the
    moment their reads finish (the apply runs its own transaction) and
    still guard exception paths with a ``finally``. Both entry points
    reject transaction blocks (25001) before pinning, so the pin is
    always a fresh implicit txn and release returns ``session.txn`` to
    None; a session already holding a transaction is refused here too
    rather than silently losing it."""

    def __init__(self, session):
        if session.txn is not None:
            from opentenbase_tpu_torch.engine import SQLError

            raise SQLError(
                "matview population cannot pin a snapshot inside a "
                "transaction block",
                "25001",
            )
        self._session = session
        self.txn, _ = session._begin_implicit()
        self.snapshot_ts = self.txn.snapshot_ts
        session.txn = self.txn
        self._pinned = True

    def release(self) -> None:
        if self._pinned:
            self._pinned = False
            self._session.txn = None
            self._session._abort_txn(self.txn)


def refresh_matview(session, d: MatviewDef, concurrently: bool = False) -> dict:
    """Refresh one matview. Plain REFRESH computes and applies while
    holding whatever statement slot the session owns (the wire server
    classes it exclusive — readers wait, as OpenTenBase's
    AccessExclusive refresh does); CONCURRENTLY parks the slot for the
    expensive compute phase and re-acquires it only for the short apply
    transaction, so concurrent readers overlap the recompute and flip
    atomically (MVCC) to the new contents. A refresh that wanted the
    delta path and could not take it says why in a warning."""
    from opentenbase_tpu_torch.utils.rwlock import parked

    c = session.cluster
    t0 = time.perf_counter()
    meta = c.catalog.get(d.name)
    durable = c.persistence is not None
    lsn0 = c.persistence.wal.position if durable else 0
    # under a parked CONCURRENTLY compute, a base commit landing
    # mid-phase must be on exactly one side of the refresh — past the
    # delta cutoff AND invisible to the recompute reads (the next
    # refresh picks it up), never in both: see PinnedSnapshot
    pin = PinnedSnapshot(session)
    refresh_ts = pin.snapshot_ts
    # freshness versions are captured WITH lsn0 for the same reason:
    # absorbing a mid-compute commit's bump would mark the matview
    # fresh while missing its rows
    versions0 = snapshot_versions(c, d)

    gate = (
        parked(c._exec_lock) if concurrently
        else contextlib.nullcontext()
    )
    prev_internal = session._matview_internal
    session._matview_internal = True
    plan = None
    mode = "full"
    try:
        try:
            with gate:
                # failpoint: a stalled or failed compute phase
                FAULT("matview/refresh", matview=d.name)
                if (
                    durable
                    and d.wants_incremental()
                    and c.catalog.has(d.shape.table)
                ):
                    plan = _plan_incremental(session, d, meta, lsn0)
                    if plan is not None:
                        mode = "incremental"
                    else:
                        log.warning(
                            'materialized view "%s" degrading to full '
                            "recompute (deltas unrecoverable from WAL — "
                            "vacuumed tuples, DDL break, or truncated "
                            "stream)", d.name)
                if plan is None:
                    plan = _plan_full(session, d, meta)
        finally:
            # the pinned read snapshot ends with the compute phase
            # (it wrote nothing); the apply runs its own transaction
            pin.release()
        # counters roll forward INSIDE the state row that commits with
        # the contents — a crash can't lose or double-count a refresh
        new_stats = dict(d.stats)
        new_stats["incremental_refreshes"] = d.stats.get(
            "incremental_refreshes", 0
        ) + (1 if mode == "incremental" else 0)
        new_stats["full_refreshes"] = d.stats.get(
            "full_refreshes", 0
        ) + (1 if mode == "full" else 0)
        new_stats["deltas_applied"] = d.stats.get(
            "deltas_applied", 0
        ) + plan.get("deltas", 0)
        staged = MatviewDef(
            name=d.name, query=d.query, text=d.text,
            last_refresh_lsn=lsn0, last_refresh_ts=refresh_ts,
        )
        staged.stats = new_stats
        apply_refresh(session, d, meta, plan, state_row(staged))
    finally:
        pin.release()  # no-op unless the compute phase never ran
        session._matview_internal = prev_internal
    # commit succeeded: publish the new state on the def. Only the
    # refresh-owned counters are written back — live counters (e.g.
    # "rewrites", bumped by concurrent readers during the compute
    # phase) must not be clobbered from the stale copy.
    d.last_refresh_lsn = lsn0
    d.last_refresh_ts = refresh_ts
    for k in ("incremental_refreshes", "full_refreshes",
              "deltas_applied"):
        d.stats[k] = new_stats[k]
    d.stats["last_mode"] = mode
    ms = (time.perf_counter() - t0) * 1000.0
    d.stats["last_refresh_ms"] = round(ms, 3)
    d.base_versions = versions0
    return {"mode": mode, "deltas": plan.get("deltas", 0), "ms": ms}


# ---------------------------------------------------------------------------
# planning: full recompute
# ---------------------------------------------------------------------------


def _plan_full(session, d: MatviewDef, meta) -> dict:
    c = session.cluster
    # the stored defining query is the RAW user text (fingerprints must
    # match incoming queries before expansion): a full recompute runs it
    # through the statement path's rewrite passes (functions, WITH and
    # views, partitions) — a matview over a view would otherwise be
    # unrefreshable
    sel = session._rewrite(_defining_select(d))
    batch = session._run_select(sel)
    cols = list(meta.schema)
    bcols = list(batch.columns.values())
    if len(bcols) != len(cols):
        from opentenbase_tpu_torch.engine import SQLError

        raise SQLError(
            f'materialized view "{d.name}" defining query now returns '
            f"{len(bcols)} columns, expected {len(cols)}"
        )
    mv_rows = {
        col: b.to_python() for col, b in zip(cols, bcols)
    }
    deletes = [A.Delete(table=d.name, where=None)]
    aux_rows = None
    if d.aux_schema and c.catalog.has(d.aux_table) and d.shape:
        aux_meta = c.catalog.get(d.aux_table)
        ab = session._run_select(build_partials_select(d.shape))
        aux_rows = {
            col: b.to_python()
            for col, b in zip(aux_meta.schema, ab.columns.values())
        }
        deletes.append(A.Delete(table=d.aux_table, where=None))
    return {
        "deletes": deletes, "mv_rows": mv_rows, "aux_rows": aux_rows,
        "row_deletes": [], "deltas": 0,
    }


# ---------------------------------------------------------------------------
# planning: incremental delta apply
# ---------------------------------------------------------------------------


def _plan_incremental(session, d: MatviewDef, meta, lsn0: int):
    """Build the incremental apply plan, or None to degrade to full
    recompute (unrecoverable deltas — e.g. vacuumed old tuples)."""
    from opentenbase_tpu_torch.storage.logical import decode_table_deltas

    c = session.cluster
    shape = d.shape
    ins_rows, del_rows, complete = decode_table_deltas(
        c, shape.table, d.last_refresh_lsn, upto=lsn0
    )
    if not complete:
        return None
    ndeltas = len(ins_rows) + len(del_rows)
    if ndeltas == 0:
        return {
            "deletes": [], "mv_rows": None, "aux_rows": None,
            "row_deletes": [], "deltas": 0,
        }
    base_meta = c.catalog.get(shape.table)
    temps = []
    try:
        t_ins = _make_delta_table(session, base_meta, ins_rows)
        temps.append(t_ins)
        t_del = _make_delta_table(session, base_meta, del_rows)
        temps.append(t_del)
        if shape.kind == "project":
            return _plan_project_delta(
                session, d, meta, t_ins, t_del, ndeltas
            )
        return _plan_agg_delta(
            session, d, meta, t_ins, t_del, ndeltas
        )
    finally:
        for t in temps:
            _drop_delta_table(session, t)


def _plan_project_delta(session, d, meta, t_ins, t_del, ndeltas) -> dict:
    """mv_new = mv_old + Q(Δins) − Q(Δdel), as MULTISETS. The two
    sides must net against each other first: a row inserted and later
    deleted within the same delta window never reached the matview, so
    deleting it there would miss and the insert would resurrect it."""
    from collections import Counter

    ins_out = _run_host(session, _defining_select(d, table=t_ins))
    del_out = _run_host(session, _defining_select(d, table=t_del))
    cols = list(meta.schema)
    net = Counter(_batch_rows(ins_out))
    net.subtract(Counter(_batch_rows(del_out)))
    add_rows: list[tuple] = []
    row_deletes: list[dict] = []
    for row, n in net.items():
        if n > 0:
            add_rows.extend([row] * n)
        elif n < 0:
            row_deletes.extend(
                [dict(zip(cols, row))] * (-n)
            )
    mv_rows = None
    if add_rows:
        mv_rows = {
            col: [row[j] for row in add_rows]
            for j, col in enumerate(cols)
        }
    return {
        "deletes": [], "mv_rows": mv_rows, "aux_rows": None,
        "row_deletes": row_deletes, "deltas": ndeltas,
    }


def _batch_rows(batch) -> list[tuple]:
    cols = [b.to_python() for b in batch.columns.values()]
    return [
        tuple(col[r] for col in cols) for r in range(batch.nrows)
    ]


def _rows_by_key(rows, key_idx) -> dict:
    """rows -> {key tuple (taken at key_idx positions): full row}."""
    return {
        tuple(row[j] for j in key_idx): row for row in rows
    }


def _read_aux_rows(session, aux_meta, want: set, nkeys: int) -> dict:
    """Snapshot-visible aux rows whose key prefix is in ``want``,
    read straight from the stores: {key: full aux row}."""
    c = session.cluster
    snap = session._snapshot()
    cols = list(aux_meta.schema)
    out: dict = {}
    for node in aux_meta.node_indices:
        store = c.stores.get(node, {}).get(aux_meta.name)
        if store is None or store.nrows == 0:
            continue
        idx = store.live_index(snap)
        if not len(idx):
            continue
        data = store.take_batch(idx).to_pydict()
        for r in range(len(idx)):
            row = tuple(data[col][r] for col in cols)
            if row[:nkeys] in want:
                out[row[:nkeys]] = row
        if aux_meta.dist.is_replicated:
            break
    return out


def _chunked_rows(session, refs, keys, build_select) -> list[tuple]:
    """Run ``build_select(pred)`` over chunks of dirty keys and
    concatenate the result rows (bounds one OR-chain's width)."""
    out: list[tuple] = []
    keys = list(keys)
    for i in range(0, len(keys), _CHUNK):
        pred = key_predicate(refs, keys[i:i + _CHUNK])
        out.extend(_batch_rows(_run_host(session, build_select(pred))))
    return out


def _plan_agg_delta(session, d, meta, t_ins, t_del, ndeltas) -> dict:
    c = session.cluster
    shape = d.shape
    aux_meta = c.catalog.get(d.aux_table)
    nkeys = len(shape.group_exprs)

    first_k = list(range(nkeys))
    # 1. per-group partial states of the two delta sets — Q(Δ), run
    # through the ordinary vectorized executor
    ins_p = _rows_by_key(
        _batch_rows(_run_host(session,
            build_partials_select(shape, table=t_ins)
        )),
        first_k,
    )
    del_p = _rows_by_key(
        _batch_rows(_run_host(session,
            build_partials_select(shape, table=t_del)
        )),
        first_k,
    )
    dirty = sorted(set(ins_p) | set(del_p), key=repr)
    if not dirty:
        return {
            "deletes": [], "mv_rows": None, "aux_rows": None,
            "row_deletes": [], "deltas": ndeltas,
        }

    aux_cols = list(aux_meta.schema)
    aux_pos = {col: j for j, col in enumerate(aux_cols)}
    g_refs = [A.ColumnRef(f"g{j}", None) for j in range(nkeys)]
    mvkey_refs = [
        A.ColumnRef(col, None) for col in shape.key_cols
    ]

    # 2. current aux state of the dirty groups — a direct snapshot
    # read of our own aux stores (a SQL read would carry a fresh
    # literal predicate every refresh and recompile its kernels)
    old_aux = _read_aux_rows(session, aux_meta, set(dirty), nkeys)

    mv_cols = list(meta.schema)
    new_aux_rows: list[tuple] = []
    new_mv_rows: list[tuple] = []
    recompute: list[tuple] = []

    if shape.has_minmax:
        # min/max are not invertible under deletion: recompute every
        # dirty group from the base table (restricted to those keys)
        recompute = list(dirty)
    else:
        for key in dirty:
            merged = _merge_group(
                shape, aux_pos, aux_cols, mv_cols,
                old_aux.get(key), ins_p.get(key), del_p.get(key), key,
            )
            if merged is None:
                continue  # group emptied
            aux_row, mv_row = merged
            new_aux_rows.append(aux_row)
            new_mv_rows.append(mv_row)

    if recompute:
        key_exprs = [
            copy.deepcopy(k) for k in shape.group_exprs
        ]
        # the matview's key columns may sit anywhere in its schema —
        # key the recomputed rows by their true positions
        mv_key_idx = [mv_cols.index(col) for col in shape.key_cols]
        fresh_mv = _rows_by_key(
            _chunked_rows(
                session, key_exprs, recompute,
                lambda pred: _defining_select(d, extra_pred=pred),
            ),
            mv_key_idx,
        )
        fresh_aux = _rows_by_key(
            _chunked_rows(
                session, key_exprs, recompute,
                lambda pred: build_partials_select(
                    shape, extra_pred=pred
                ),
            ),
            first_k,
        )
        for key in recompute:
            if key in fresh_aux:
                new_aux_rows.append(fresh_aux[key])
            if key in fresh_mv:
                new_mv_rows.append(fresh_mv[key])

    # 3. the apply plan: delete every dirty group, insert survivors
    deletes = []
    for i in range(0, len(dirty), _CHUNK):
        chunk = dirty[i:i + _CHUNK]
        deletes.append(A.Delete(
            table=d.name, where=key_predicate(mvkey_refs, chunk)
        ))
        deletes.append(A.Delete(
            table=d.aux_table, where=key_predicate(g_refs, chunk)
        ))
    mv_rows = None
    if new_mv_rows:
        mv_rows = {
            col: [row[j] for row in new_mv_rows]
            for j, col in enumerate(mv_cols)
        }
    aux_rows = None
    if new_aux_rows:
        aux_rows = {
            col: [row[j] for row in new_aux_rows]
            for j, col in enumerate(aux_cols)
        }
    return {
        "deletes": deletes, "mv_rows": mv_rows, "aux_rows": aux_rows,
        "row_deletes": [], "deltas": ndeltas,
    }


def _merge_group(shape, aux_pos, aux_cols, mv_cols, old, ins, dele, key):
    """Arithmetic merge of one dirty group's partial state (count /
    sum / avg only — min/max groups take the recompute path).
    Returns (aux_row, mv_row) or None when the group becomes empty."""

    def val(row, col, default=0):
        if row is None:
            return default
        v = row[aux_pos[col]]
        return default if v is None else v

    cnt = val(old, "cnt") + val(ins, "cnt") - val(dele, "cnt")
    if cnt <= 0:
        return None
    aux_row = [None] * len(aux_cols)
    for j in range(len(key)):
        aux_row[aux_pos[f"g{j}"]] = key[j]
    aux_row[aux_pos["cnt"]] = cnt
    mv_vals = {}
    for i, a in enumerate(shape.aggs):
        if a.func == "count" and a.star:
            mv_vals[a.col] = cnt
        elif a.func == "count":
            nn = (
                val(old, f"a{i}_nn") + val(ins, f"a{i}_nn")
                - val(dele, f"a{i}_nn")
            )
            aux_row[aux_pos[f"a{i}_nn"]] = nn
            mv_vals[a.col] = nn
        elif a.func in ("sum", "avg"):
            nn = (
                val(old, f"a{i}_nn") + val(ins, f"a{i}_nn")
                - val(dele, f"a{i}_nn")
            )
            s = (
                val(old, f"a{i}_sum") + val(ins, f"a{i}_sum")
                - val(dele, f"a{i}_sum")
            )
            aux_row[aux_pos[f"a{i}_nn"]] = nn
            aux_row[aux_pos[f"a{i}_sum"]] = s if nn > 0 else 0
            if a.func == "sum":
                mv_vals[a.col] = s if nn > 0 else None
            else:
                mv_vals[a.col] = (s / nn) if nn > 0 else None
    key_val = dict(zip(shape.key_cols, key))
    mv_row = []
    for col in mv_cols:
        if col in key_val:
            mv_row.append(key_val[col])
        else:
            mv_row.append(mv_vals[col])
    return tuple(aux_row), tuple(mv_row)


# ---------------------------------------------------------------------------
# the apply transaction
# ---------------------------------------------------------------------------


def _append_rows(session, txn, meta, data: dict) -> int:
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    nrows = len(next(iter(data.values()))) if data else 0
    if not nrows:
        return 0
    batch = ColumnBatch.from_pydict(data, meta.schema, meta.dictionaries)
    return session._route_and_append(meta, batch, txn)


def apply_refresh(session, d: MatviewDef, meta, plan: dict,
                  state: dict) -> None:
    """ONE transaction: dirty-group/full deletes, new rows, aux rows,
    and the otb_matview_state row replacement — committed as one WAL
    frame (crash-atomic refresh)."""
    from opentenbase_tpu_torch.storage.logical import _apply_delete

    c = session.cluster
    txn, implicit = session._begin_implicit()
    prev_txn = session.txn
    session.txn = txn
    try:
        for stmt in plan.get("deletes", ()):
            session._execute_one(stmt)
        if c.catalog.has(STATE_TABLE):
            session._execute_one(A.Delete(
                table=STATE_TABLE,
                where=A.BinOp(
                    "=", A.ColumnRef("mv", None), A.Literal(d.name)
                ),
            ))
        for row in plan.get("row_deletes", ()):
            _apply_delete(session, txn, meta, row)
        if plan.get("mv_rows"):
            _append_rows(session, txn, meta, plan["mv_rows"])
        if plan.get("aux_rows") and c.catalog.has(d.aux_table):
            _append_rows(
                session, txn, c.catalog.get(d.aux_table),
                plan["aux_rows"],
            )
        if c.catalog.has(STATE_TABLE):
            _append_rows(
                session, txn, c.catalog.get(STATE_TABLE),
                {k: [v] for k, v in state.items()},
            )
    except Exception:
        session.txn = prev_txn
        if implicit:
            session._abort_txn(txn)
        raise
    session.txn = prev_txn
    if implicit:
        session._commit_txn(txn)

"""The system views (the reference's engine.py ``_SYSTEM_VIEWS`` and its
``_sv_*`` providers), for the views whose data the port keeps.

A statement that reads a system view sees it as a replicated table the
coordinator fills from the provider just before the statement runs and
drops after it (``Session._system_views``): so joins, filters and
aggregates work over it, and nothing of it reaches the WAL, a
checkpoint or a datanode process. Every other view of the reference is
refused by name (``NotPorted``) with the ROADMAP item that brings its
subsystem.

    pg_views, pg_proc          views, SQL and PL/pgSQL functions
    pg_partitions              each partition's range and live rows
    pg_prepared_xacts          the GTM's prepared registry
    pg_locks                   the lock table (lmgr.py)
    pgxc_node, pgxc_shard_map  the topology and the shard map
    pgxc_gtm_nodes             the GTM's node registry
    pg_stat_user_tables        live and total rows per table and node
    pg_stat_memory             per-store bytes (never folds a store)
    pg_stat_device_cache       DeviceCache.stats
    pg_stat_fused              the fused route's runs, modes and phases
    pg_stat_dml                write sets shipped inside 2PC prepares
    pg_stat_wal                the WAL, group commit and ingest counters
    pg_stat_2pc                the in-doubt resolver's counters
    pg_stat_wlm                each resource group's settings and counters
    pg_stat_wlm_queue          the statements waiting in admission queues
    pg_resgroup_role           role -> resource group bindings
    pg_matviews                each materialized view and its freshness
    pg_stat_matview            refresh counters, modes and rewrite hits
    pg_publication             publications, their tables and node filters
    pg_subscription            subscriptions and their apply positions
    pg_stat_faults             each failpoint seen armed, per process
"""

from __future__ import annotations

from opentenbase_tpu_torch import types as t


def _pg_locks(c):
    return c.locks.snapshot_rows()


def _pg_proc(c):
    return [
        (fn.name,
         ", ".join(f"{n} {ty}" for n, ty in zip(fn.argnames, fn.argtypes)),
         fn.rettype, getattr(fn, "language", "sql"), fn.body)
        for fn in c.functions.values()
    ]


def _partitions(c):
    rows = []
    snap = c.gts.snapshot_ts()
    for name, ps in c.partitions.items():
        for i in range(ps.nparts):
            child = ps.child(i)
            live = 0
            for n in c.catalog.get(child).node_indices:
                store = c.stores.get(n, {}).get(child)
                if store is not None:
                    live += len(store.live_index(snap))
            rows.append((name, child, i, int(ps.boundaries[i]),
                         int(ps.boundaries[i + 1]), live))
    return rows


def _pg_views(c):
    return [(name, text) for name, (_q, text) in c.views.items()]


def _pgxc_node(c):
    return [
        (n.name, n.role.value, n.host, n.port, n.is_primary,
         n.is_preferred, n.mesh_index)
        for n in c.nodes.all_nodes()
    ]


def _prepared_xacts(c):
    return [(p.gxid, p.gid or "", ",".join(map(str, p.partnodes)))
            for p in c.gts.prepared_txns()]


def _shard_map(c):
    return [(i, int(n)) for i, n in enumerate(c.shardmap.map)]


def _stat_tables(c):
    rows = []
    snap = c.gts.snapshot_ts()
    for name in c.catalog.table_names():
        if name in ALL_NAMES:
            continue
        meta = c.catalog.get(name)
        for n in meta.node_indices:
            store = c.stores.get(n, {}).get(name)
            if store is not None:
                rows.append((name, n, len(store.live_index(snap)),
                             store.nrows))
    return rows


def _memory(c):
    rows = []
    seen_dicts: set[int] = set()
    for node, tabs in c.stores.items():
        for name, store in tabs.items():
            if name in ALL_NAMES:
                continue
            col_b, vm_b, mvcc_b = store.memory_stats()
            # a dictionary is shared by the table's stores: count it once
            dict_bytes = 0
            for d in store.dictionaries.values():
                if id(d) not in seen_dicts:
                    seen_dicts.add(id(d))
                    dict_bytes += sum(len(s.encode()) for s in d.values)
            rows.append((name, node, store.nrows, store._capacity,
                         col_b + vm_b + mvcc_b, dict_bytes))
    return rows


def _device_cache(c):
    fx = c._fused
    if fx is None:
        return []
    return [(k, int(v)) for k, v in fx.cache.stats.items()]


def _delta_plane_totals(c) -> tuple[int, int, int]:
    """(fold_on_read_avoided, delta_rows_read, deltas_absorbed) summed
    over every store."""
    avoided = rows_read = absorbed = 0
    for stores in c.stores.values():
        for store in stores.values():
            avoided += int(getattr(store, "fold_reads_avoided", 0))
            rows_read += int(getattr(store, "delta_rows_read", 0))
            absorbed += int(getattr(store, "deltas_absorbed", 0))
    return avoided, rows_read, absorbed


def _fused(c):
    """The reference's rows, but for the device-platform watchdog's
    (``last_run_platform``, ``expected_platform``,
    ``platform_demotions``: ROADMAP A.7) and ``demoted`` (the port's
    fused route never demotes to the host route on a fault)."""
    avoided, rows_read, _absorbed = _delta_plane_totals(c)
    rows = [("fold_on_read_avoided", str(avoided)),
            ("delta_rows_read", str(rows_read))]
    fx = c._fused
    if fx is None:
        return rows
    rows.append(("delta_tail_uploads",
                 str(int(fx.cache.stats.get("delta_tail_uploads", 0)))))
    rows.append(("delta_tail_rows",
                 str(int(fx.cache.stats.get("delta_tail_rows", 0)))))
    dag = fx._dag
    if dag is not None:
        rows.append(("completed", str(dag.completed)))
        if dag.last_mode is not None:
            rows.append(("last_mode", str(dag.last_mode)))
        if dag.last_join_modes:
            rows.append(("last_join_modes", ",".join(dag.last_join_modes)))
        rows.extend(("unsupported", r) for r in dag.unsupported)
    zs = fx.zone_stats
    if zs.get("total_blocks"):
        rows.append(("zone_pruned_blocks", str(zs["pruned_blocks"])))
        rows.append(("zone_total_blocks", str(zs["total_blocks"])))
    for k in sorted(fx.last_phases):
        rows.append((f"last_{k}", f"{fx.last_phases[k]:.3f}"))
    for k in sorted(fx.phase_totals):
        rows.append((f"total_{k}", f"{fx.phase_totals[k]:.3f}"))
    if dag is not None and dag.last_frag_ms:
        for k in sorted(dag.last_frag_ms, key=str):
            rows.append((f"last_frag_ms[{k}]", f"{dag.last_frag_ms[k]:.3f}"))
    return rows


def _gtm_nodes(c):
    return [
        (name, d.get("kind", ""), d.get("host", ""), int(d.get("port", 0)),
         d.get("status", "connected"))
        for name, d in sorted(c.gtm_registered_nodes().items())
    ]


def _dml(c):
    reset = float(c.stats_reset_at)
    rows = [("cn.shipped", int(c.dml_stats.get("shipped", 0)), reset),
            ("cn.stream_only", int(c.dml_stats.get("stream_only", 0)),
             reset)]
    for n, ch in sorted(c.dn_channels.items()):
        try:
            st = ch.rpc({"op": "ping"}).get("dml_stats") or {}
        except Exception:
            continue  # an unreachable datanode reports nothing
        rows.extend((f"dn{n}.{k}", int(st[k]), reset) for k in sorted(st))
    return rows


def _stat_wal(c):
    rows: list[tuple] = []
    p = c.persistence
    if p is not None:
        w = p.wal.stat_snapshot()
        pos = int(w["position"])
        rows += [
            ("wal_position", pos),
            ("fsyncs", int(w["fsyncs"])),
            ("group_fsyncs", int(w["group_fsyncs"])),
            ("commit_flushes", int(w["commit_flushes"])),
            ("fsyncs_saved",
             int(w["commit_flushes"]) - int(w["group_fsyncs"])),
            ("unflushed_bytes", max(pos - int(w["flushed"]), 0)),
        ]
        rows += [(f"batch_le_{b}", int(w["batch_hist"][b]))
                 for b in sorted(w["batch_hist"])]
        for sender in list(getattr(p, "wal_senders", ()) or ()):
            rows += [(f"ack_lag:{addr}", max(pos - int(acked), 0))
                     for addr, acked in sender.peer_acks()]
    gb = c.gts_batcher.stat_snapshot()
    rows += [("gts_grants", int(gb["grants"])),
             ("gts_rounds", int(gb["rounds"])),
             ("gts_rounds_saved", int(gb["grants"]) - int(gb["rounds"]))]
    rows += [(f"gts_batch_le_{b}", int(gb["batch_hist"][b]))
             for b in sorted(gb["batch_hist"])]
    with c._ingest_stats_mu:
        st = dict(c.ingest_stats)
    _avoided, _rows_read, absorbed = _delta_plane_totals(c)
    rows += [
        ("ingest_batches", int(st["batches"])),
        ("ingest_rows", int(st["rows"])),
        ("insert_rewrites", int(st["rewrites"])),
        ("insert_rewrite_rows", int(st["rewrite_rows"])),
        ("compactions", int(st["compactions"])),
        ("delta_batches_folded", int(st["batches_folded"])),
        # lifetime folds: flat across reads while enable_delta_scan is on
        ("deltas_absorbed", absorbed),
        ("pending_delta_rows", sum(
            int(store.pending_delta_rows)
            for stores in c.stores.values() for store in stores.values())),
    ]
    return rows


def _2pc(c):
    with c._2pc_stats_mu:
        rows = [(k, int(v)) for k, v in sorted(c.twophase_stats.items())]
    try:
        rows.append(("prepared_registry", len(c.gts.prepared_txns())))
    except Exception:
        pass  # the GTM unreachable: the counters alone
    return rows


def _faults(c):
    """The coordinator's failpoint counters (node "cn") and each attached
    datanode process's (``fault_stats``); they survive pg_fault_clear,
    so a chaos run stays auditable after the disarm."""
    from opentenbase_tpu_torch import fault

    rows = [("cn",) + tuple(r) for r in fault.stats()]
    for n, ch in sorted(c.dn_channels.items()):
        try:
            resp = ch.rpc({"op": "fault_stats"})
        except Exception:
            continue  # an unreachable datanode is often the point
        for r in resp.get("rows", []):
            rows.append((f"dn{n}",) + tuple(r))
    return rows


def _matviews(c):
    from opentenbase_tpu_torch.matview.defs import is_fresh

    rows = []
    for name, d in c.matviews.items():
        strategy = (c.catalog.get(name).dist.strategy.value
                    if c.catalog.has(name) else "")
        rows.append((name, d.text, bool(d.wants_incremental()), strategy,
                     bool(is_fresh(c, d)), int(d.last_refresh_lsn)))
    return rows


def _matview_stats(c):
    rows = []
    snap = c.gts.snapshot_ts()
    for name, d in c.matviews.items():
        live = 0
        if c.catalog.has(name):
            meta = c.catalog.get(name)
            for n in meta.node_indices:
                store = c.stores.get(n, {}).get(name)
                if store is None:
                    continue
                live += len(store.live_index(snap))
                if meta.dist.is_replicated:
                    break
        st = d.stats
        rows.append((name, live, int(st.get("incremental_refreshes", 0)),
                     int(st.get("full_refreshes", 0)),
                     int(st.get("deltas_applied", 0)),
                     int(st.get("rewrites", 0)),
                     float(st.get("last_refresh_ms", 0.0)),
                     int(d.last_refresh_lsn), st.get("last_mode", "") or ""))
    return rows


def _publication(c):
    return [(name,
             ",".join(pub["tables"]) if pub["tables"] is not None else "*",
             ",".join(str(n) for n in pub["nodes"])
             if pub["nodes"] is not None else "")
            for name, pub in c.publications.items()]


def _subscription(c):
    return [(w.name, w.publication, w.conninfo, int(w.lsn), bool(w.synced),
             w.last_error) for w in c.subscriptions.values()]


# name -> (schema, provider(cluster) -> rows), the reference's schemas
SYSTEM_VIEWS: dict[str, tuple] = {
    "pg_proc": ({"proname": t.TEXT, "proargs": t.TEXT, "prorettype": t.TEXT,
                 "prolang": t.TEXT, "prosrc": t.TEXT}, _pg_proc),
    "pg_locks": ({"node_index": t.INT4, "relation": t.TEXT,
                  "row_id": t.INT8, "mode": t.TEXT, "granted": t.BOOL,
                  "session_id": t.INT4, "gxid": t.INT8}, _pg_locks),
    "pg_views": ({"viewname": t.TEXT, "definition": t.TEXT}, _pg_views),
    "pg_stat_memory": ({"relname": t.TEXT, "node_index": t.INT4,
                        "n_rows": t.INT8, "capacity": t.INT8,
                        "store_bytes": t.INT8, "dict_bytes": t.INT8},
                       _memory),
    "pgxc_node": ({"node_name": t.TEXT, "node_type": t.TEXT,
                   "node_host": t.TEXT, "node_port": t.INT4,
                   "nodeis_primary": t.BOOL, "nodeis_preferred": t.BOOL,
                   "mesh_index": t.INT4}, _pgxc_node),
    "pg_prepared_xacts": ({"gxid": t.INT8, "gid": t.TEXT,
                           "partnodes": t.TEXT}, _prepared_xacts),
    "pgxc_shard_map": ({"shard_id": t.INT4, "node_index": t.INT4},
                       _shard_map),
    "pg_stat_user_tables": ({"relname": t.TEXT, "node_index": t.INT4,
                             "n_live_tup": t.INT8, "n_total_tup": t.INT8},
                            _stat_tables),
    "pg_stat_device_cache": ({"stat": t.TEXT, "value": t.INT8},
                             _device_cache),
    "pg_stat_fused": ({"event": t.TEXT, "detail": t.TEXT}, _fused),
    "pg_stat_dml": ({"stat": t.TEXT, "value": t.INT8,
                     "stats_reset": t.FLOAT8}, _dml),
    "pgxc_gtm_nodes": ({"node_name": t.TEXT, "kind": t.TEXT,
                        "host": t.TEXT, "port": t.INT4, "status": t.TEXT},
                       _gtm_nodes),
    "pg_stat_wal": ({"stat": t.TEXT, "value": t.INT8}, _stat_wal),
    "pg_stat_2pc": ({"stat": t.TEXT, "value": t.INT8}, _2pc),
    "pg_stat_faults": ({"node": t.TEXT, "site": t.TEXT, "action": t.TEXT,
                        "trigger_spec": t.TEXT, "arms": t.INT8,
                        "hits": t.INT8, "fired": t.INT8, "armed": t.BOOL},
                       _faults),
    "pg_partitions": ({"parent": t.TEXT, "partition": t.TEXT,
                       "index": t.INT4, "range_lo": t.INT8,
                       "range_hi": t.INT8, "n_live_tup": t.INT8},
                      _partitions),
    "pg_stat_wlm": ({"group_name": t.TEXT, "concurrency": t.INT4,
                     "memory_limit": t.INT8, "queue_depth": t.INT4,
                     "priority": t.INT4, "running": t.INT4,
                     "waiting": t.INT4, "admitted": t.INT8,
                     "queued": t.INT8, "shed": t.INT8,
                     "timed_out": t.INT8, "peak_memory": t.INT8,
                     "peak_running": t.INT4, "peak_result_bytes": t.INT8,
                     "queue_wait_ms": t.FLOAT8},
                    lambda c: c.wlm.stat_rows()),
    "pg_stat_wlm_queue": ({"group_name": t.TEXT, "session_id": t.INT4,
                           "query": t.TEXT, "wait_ms": t.FLOAT8,
                           "memory_est": t.INT8},
                          lambda c: c.wlm.queue_rows()),
    "pg_resgroup_role": ({"rolname": t.TEXT, "group_name": t.TEXT},
                         lambda c: c.wlm.binding_rows()),
    "pg_matviews": ({"matviewname": t.TEXT, "definition": t.TEXT,
                     "incremental": t.BOOL, "strategy": t.TEXT,
                     "is_fresh": t.BOOL, "last_refresh_lsn": t.INT8},
                    _matviews),
    "pg_stat_matview": ({"matviewname": t.TEXT, "n_rows": t.INT8,
                         "incremental_refreshes": t.INT8,
                         "full_refreshes": t.INT8,
                         "deltas_applied": t.INT8, "rewrites": t.INT8,
                         "last_refresh_ms": t.FLOAT8,
                         "last_refresh_lsn": t.INT8, "last_mode": t.TEXT},
                        _matview_stats),
    "pg_publication": ({"pubname": t.TEXT, "tables": t.TEXT,
                        "nodes": t.TEXT}, _publication),
    "pg_subscription": ({"subname": t.TEXT, "publication": t.TEXT,
                         "conninfo": t.TEXT, "lsn": t.INT8,
                         "synced": t.BOOL, "last_error": t.TEXT},
                        _subscription),
}

# the reference's other views, each with the ROADMAP item that brings
# its subsystem (refused by name until then)
NOT_PORTED: dict[str, str] = {
    "pg_audit_actions": "A.10", "pg_audit_log": "A.10",
    "pg_cluster_health": "A.7", "pgxc_node_health": "A.7",
    "pg_stat_cluster_activity": "A.7",
    "pg_stat_statements": "A.7", "pg_stat_wait_events": "A.7",
    "pg_stat_query_phases": "A.7", "pg_stat_pallas": "A.7",
    "pg_stat_progress_checkpoint": "A.7",
    "pg_stat_progress_recovery": "A.7",
    "pg_stat_progress_refresh": "A.7",
    "pg_stat_plan_cache": "A.9", "pg_stat_result_cache": "A.9",
    "pg_stat_concentrator": "A.9",
    "pg_stat_rebalance": "A.8", "pgxc_group": "A.8",
}

# every name the reference reserves for a system view
ALL_NAMES = frozenset(SYSTEM_VIEWS) | frozenset(NOT_PORTED)

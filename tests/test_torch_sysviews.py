"""The system views the port keeps the data of (opentenbase_tpu_torch/
sysviews.py) and the admin functions whose subsystem is ported, held
against the reference on tests/test_observability.py's cases: the same
statements on a reference and a port cluster, equal rows wherever both
keep the same state. A system view reads like a table (filters, joins
with user tables, aggregates), runs on the host route, and leaves
nothing behind it; a view whose subsystem is not ported is refused by
name with its ROADMAP item."""

import pytest

from opentenbase_tpu_torch import NotPorted
from opentenbase_tpu_torch import sysviews
from torch_pair import Pair


@pytest.fixture()
def p():
    pair = Pair()
    pair.both("create table t (k bigint, v text) distribute by shard(k)")
    pair.both("insert into t values (1,'a'),(2,'b'),(3,'c'),(4,'d')")
    yield pair
    pair.close()


def test_pgxc_node_view(p):
    rows = p.both("select node_name, node_type from pgxc_node "
                  "order by node_name").rows
    names = [r[0] for r in rows]
    assert "cn0" in names and "dn0" in names and "gtm0" in names
    assert len([r for r in rows if r[1] == "datanode"]) == 2
    p.query("select * from pgxc_node order by node_name")


def test_prepared_xacts_view(p):
    p.both("begin")
    p.both("insert into t values (9,'z')")
    p.both("prepare transaction 'viewgid'")
    assert p.both("select gid, partnodes from pg_prepared_xacts").rows == [
        ("viewgid", "1")]
    p.both("commit prepared 'viewgid'")
    assert p.both("select count(*) from pg_prepared_xacts").rows == [(0,)]


def test_shard_map_view(p):
    rows = p.query("select node_index, count(*) from pgxc_shard_map "
                   "group by node_index order by node_index")
    assert [r[0] for r in rows] == [0, 1] and sum(r[1] for r in rows) == 16
    p.query("select shard_id, node_index from pgxc_shard_map "
            "order by shard_id")


def test_stat_user_tables(p):
    assert p.query("select relname, sum(n_live_tup) from pg_stat_user_tables "
                   "where relname = 't' group by relname") == [("t", 4)]
    p.both("delete from t where k = 1")
    assert p.query("select sum(n_live_tup), sum(n_total_tup) from "
                   "pg_stat_user_tables where relname = 't'") == [(3, 4)]
    p.query("select * from pg_stat_user_tables order by relname, node_index")


def test_join_system_view_with_user_table(p):
    rows = p.query(
        "select n.node_name, t3.n_live_tup from pg_stat_user_tables t3 "
        "join pgxc_node n on t3.node_index = n.mesh_index "
        "where t3.relname = 't' order by n.node_name")
    assert len(rows) == 2 and sum(r[1] for r in rows) == 4
    p.query("select t.k, n.node_name from t join pgxc_shard_map m "
            "on t.k = m.shard_id join pgxc_node n on m.node_index = "
            "n.mesh_index order by t.k")


def test_views_and_functions_views(p):
    p.both("create view tv as select k from t where k > 1")
    p.both("create function inc(a bigint) returns bigint as 'select a + 1'")
    p.query("select viewname, definition from pg_views")
    p.query("select proname, proargs, prorettype, prolang, prosrc "
            "from pg_proc")


def test_locks_gtm_nodes_memory_and_counters(p):
    p.query("select * from pgxc_gtm_nodes order by node_name")
    p.query("select relname, node_index, n_rows, capacity, store_bytes, "
            "dict_bytes from pg_stat_memory order by relname, node_index")
    p.query("select stat, value from pg_stat_dml order by stat")
    p.query("select count(*) from pg_locks")


def test_stat_wal_counters(tmp_path):
    """pg_stat_wal on durable clusters: the WAL's fsync and batch
    counters, the GTS grants, the ingest counters and the delta plane's,
    equal where both packages count the same events."""
    p = Pair(data_dir=str(tmp_path))
    try:
        p.both("create table t (k bigint, v bigint) distribute by shard(k)")
        p.both("insert into t values " + ",".join(
            f"({i}, {i})" for i in range(100)))
        p.both("insert into t values (1000, 1)")
        p.both("prepare pi as insert into t values ($1, $2)")
        p.both("execute pi(2000, 2)")
        keys = ("ingest_batches", "ingest_rows", "insert_rewrites",
                "insert_rewrite_rows", "compactions", "delta_batches_folded",
                "deltas_absorbed", "pending_delta_rows", "gts_grants",
                "gts_rounds", "gts_rounds_saved", "commit_flushes")
        want = dict(p.rs.query("select stat, value from pg_stat_wal"))
        got = dict(p.ps.query("select stat, value from pg_stat_wal"))
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        assert set(got) == set(want)
        for c in (p.rc, p.pc):
            c.compact_deltas()
        p.query("select stat, value from pg_stat_wal where stat in "
                "('compactions', 'delta_batches_folded', 'deltas_absorbed', "
                "'pending_delta_rows') order by stat")
        assert p.both("select pg_current_wal_lsn()").columns == ["lsn"]
    finally:
        p.close()


def test_2pc_view_counts_the_resolver(p):
    p.both("begin")
    p.both("insert into t values (9,'z')")
    p.both("prepare transaction 'parked'")
    p.both("select pg_resolve_indoubt()")
    assert p.both("select stat, value from pg_stat_2pc order by stat"
                  ).rows == [("awaiting_operator", 1), ("indoubt_seen", 0),
                             ("prepared_registry", 1), ("resolved_abort", 0),
                             ("resolved_commit", 0), ("resolver_runs", 1),
                             ("unreachable_datanodes", 0)]
    p.both("rollback prepared 'parked'")


def test_device_cache_and_fused_views(p):
    """The fused route's counters after the same reads: the device
    cache's uploads and the DAG's runs and modes."""
    p.both("create table u (k bigint, w bigint) distribute by shard(k)")
    p.both("insert into u values (1,10),(2,20),(3,30),(4,40)")
    p.query("select t.v, sum(u.w) from t join u on t.k = u.k group by t.v "
            "order by t.v")
    p.both("insert into t values (5,'e')")
    p.query("select count(*), sum(k) from t where k > 0")
    keys = ("hits", "full_uploads", "delta_uploads", "delta_rows",
            "delta_tail_uploads", "delta_tail_rows", "mvcc_replays")
    want = dict(p.rs.query("select stat, value from pg_stat_device_cache"))
    got = dict(p.ps.query("select stat, value from pg_stat_device_cache"))
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    ev = ("fold_on_read_avoided", "delta_rows_read", "delta_tail_uploads",
          "delta_tail_rows", "completed", "last_mode", "last_join_modes")
    want = dict(p.rs.query("select event, detail from pg_stat_fused"))
    got = dict(p.ps.query("select event, detail from pg_stat_fused"))
    assert {k: got.get(k) for k in ev} == {k: want.get(k) for k in ev}


def test_a_system_view_leaves_nothing_behind(p):
    p.both("select count(*) from pg_locks")
    assert not p.pc.catalog.has("pg_locks")
    assert all("pg_locks" not in tabs for tabs in p.pc.stores.values())
    assert p.ps.last_route == "host"
    assert "a system view is read" in p.ps.last_declines
    p.both("create table pg_locks2 (k bigint) distribute by shard(k)")
    p.raises("create table pg_locks (k bigint) distribute by shard(k)",
             "reserved")


def test_pg_stat_faults_view(p):
    """pg_stat_faults (taken with the failpoints): each package's
    coordinator row of every site seen armed, its action and trigger,
    counters that outlive pg_fault_clear."""
    import opentenbase_tpu.fault as ref_fault
    import opentenbase_tpu_torch.fault as port_fault

    for f in (ref_fault, port_fault):
        f.clear()
        f.reset_stats()
    try:
        p.both("set fault_injection = on")
        p.both("select pg_fault_inject('x/once', 'error', 'once')")
        p.both("select pg_fault_inject('x/every', 'delay(1)', "
               "'every(2), node=1')")
        q = ("select node, site, action, trigger_spec, arms, hits, fired, "
             "armed from pg_stat_faults order by site")
        assert p.both(q).rows == [
            ("cn", "x/every", "delay(1)", "every(2), node=1", 1, 0, 0, True),
            ("cn", "x/once", "error", "once", 1, 0, 0, True)]
        for f in (ref_fault, port_fault):
            for _ in range(3):
                f.FAULT("x/every", node=1)
            with pytest.raises(f.FaultError):
                f.FAULT("x/once")
        assert p.both("select pg_fault_clear()").rows == [(1,)]
        assert p.both(q).rows == [
            ("cn", "x/every", "", "", 1, 3, 1, False),
            ("cn", "x/once", "", "", 1, 1, 1, False)]
    finally:
        for f in (ref_fault, port_fault):
            f.clear()
            f.reset_stats()


@pytest.mark.parametrize("name", sorted(sysviews.NOT_PORTED))
def test_views_still_to_come_refused_by_name(p, name):
    item = sysviews.NOT_PORTED[name]
    with pytest.raises(NotPorted, match=f"system view {name} .ROADMAP "
                                        f"{item}"):
        p.ps.query(f"select * from {name}")


# the views the port took with workload management, materialized views
# and logical replication: their columns that do not hold a time
PORTED_19 = {
    "pg_stat_wlm": "select group_name, concurrency, memory_limit, "
                   "queue_depth, priority, running, waiting, admitted, "
                   "queued, shed, timed_out, peak_memory, peak_running, "
                   "peak_result_bytes from pg_stat_wlm order by group_name",
    "pg_stat_wlm_queue": "select group_name, session_id, memory_est "
                         "from pg_stat_wlm_queue",
    "pg_resgroup_role": "select * from pg_resgroup_role order by rolname",
    "pg_matviews": "select matviewname, definition, incremental, strategy, "
                   "is_fresh from pg_matviews order by matviewname",
    "pg_stat_matview": "select matviewname, n_rows, incremental_refreshes, "
                       "full_refreshes, deltas_applied, rewrites, last_mode "
                       "from pg_stat_matview order by matviewname",
    "pg_publication": "select * from pg_publication order by pubname",
    "pg_subscription": "select subname, publication from pg_subscription",
}


@pytest.mark.parametrize("name", sorted(PORTED_19))
def test_views_ported_with_wlm_matviews_and_replication(p, name):
    assert name not in sysviews.NOT_PORTED
    p.both("create resource group rg with (concurrency = 2, "
           "memory_limit = '64MB', queue_depth = 3)")
    p.both("alter role alice resource group rg")
    p.both("create materialized view mv as select k, count(*) as n "
           "from t group by k")
    p.both("insert into t values (5, 'e')")
    p.both("create publication pub for table t")
    p.both("set resource_group = rg")
    p.both("select count(*) from t")
    p.both("set resource_group = ''")
    rows = p.both(PORTED_19[name]).rows
    assert name not in ("pg_stat_wlm", "pg_matviews", "pg_publication",
                        "pg_resgroup_role") or rows


def test_admin_functions(p):
    for fn in ("pg_stat_reset()", "pg_sleep(0.01)", "pg_current_wal_lsn()",
               "pg_unlock_check_deadlock()", "pg_unlock_check_dependency()",
               "pg_unlock_execute()"):
        assert p.both(f"select {fn}").columns
    p.query("select stat, value from pg_stat_dml order by stat")
    for fn in ("pg_export_traces(1)", "pg_rebalance_wait(1)",
               "pg_basebackup('/nonexistent')"):
        with pytest.raises(NotPorted, match=fn.split("(")[0]):
            p.ps.execute(f"select {fn}")
    p.raises("create function pg_sleep(a bigint) returns bigint as "
             "'select a'", "reserved")


def test_statement_timeout_cancels_pg_sleep(p):
    for s in (p.rs, p.ps):
        s.execute("set statement_timeout = 50")
    err = p.raises("select pg_sleep(5)", "statement timeout")
    assert err.sqlstate == "57014"

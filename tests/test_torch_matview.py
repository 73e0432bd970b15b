"""Materialized views in the port (opentenbase_tpu_torch/matview/, the
DDL, rewrite and guards in engine.py), held against the reference on
tests/test_matview.py's cases: one statement stream into a durable
reference cluster and a durable port cluster (``device="cpu"``), and
every answer, command, row count, error message and SQLSTATE must be
equal (tests/torch_pair.py; exact: the views hold integers, TEXT and
FLOAT8 averages the two packages compute alike). Most cases share one
pair of module clusters, each on its own tables and view names, with
the fused route off as the reference's module runs it; the fused route
is held on its own (the rewrite's scan, a full REFRESH read right
after). Crash recovery and the cluster without a WAL get their own."""

import random
import threading

import pytest

from opentenbase_tpu.storage import logical as ref_logical
from opentenbase_tpu_torch.storage import logical as port_logical
from torch_pair import Pair, assert_same_rows, make_clusters, recover_clusters

AGG_Q = ("select grp, count(*) as n, count(v) as nv, sum(v) as s, "
         "avg(v) as a from fact group by grp")


@pytest.fixture(scope="module")
def p(tmp_path_factory):
    pair = Pair(shard_groups=16,
                data_dir=str(tmp_path_factory.mktemp("mvpair")))
    pair.set_fused("off")
    pair.both("create table fact (k bigint, grp text, v bigint, w float8) "
              "distribute by shard(k)")
    pair.both("insert into fact values (1,'a',10,1.5),(2,'b',20,2.5),"
              "(3,'a',30,3.5),(4,'b',40,4.5),(5,'c',null,5.5),"
              "(6,'a',60,6.5)")
    yield pair
    pair.close()


def oracle(p, q):
    """``q``'s rows computed from the base tables (no rewrite)."""
    for s in (p.rs, p.ps):
        s.execute("set enable_matview_rewrite = off")
    try:
        return sorted(p.both(q).rows)
    finally:
        for s in (p.rs, p.ps):
            s.execute("set enable_matview_rewrite = on")


def mv_rows(p, name):
    return oracle(p, f"select * from {name}")


def stat(p, name, cols):
    return p.both(f"select {cols} from pg_stat_matview "
                  f"where matviewname = '{name}'").rows


def explained(p, q):
    return [r[0] for r in p.both(f"explain {q}").rows]


# -- DDL, population, the serving rewrite (tests/test_matview.py:81-166) ----


def test_create_populates_and_serves(p):
    p.both(f"create materialized view agg as {AGG_Q}")
    assert mv_rows(p, "agg") == oracle(p, AGG_Q)
    assert p.both("select matviewname, incremental, is_fresh from "
                  "pg_matviews where matviewname = 'agg'").rows == [
        ("agg", True, True)]
    (defn,) = p.both("select definition from pg_matviews "
                     "where matviewname = 'agg'").rows[0]
    assert "group by grp" in defn


def test_rewrite_explain_on_off_stale(p):
    lines = explained(p, AGG_Q)
    assert any("Matview rewrite" in ln for ln in lines), lines
    assert any("Scan on agg" in ln for ln in lines), lines
    before = stat(p, "agg", "rewrites")[0][0]
    explained(p, AGG_Q)
    assert stat(p, "agg", "rewrites")[0][0] == before
    assert sorted(p.both(AGG_Q).rows) == oracle(p, AGG_Q)
    assert stat(p, "agg", "rewrites")[0][0] == before + 1
    for s in (p.rs, p.ps):
        s.execute("set enable_matview_rewrite = off")
    assert not any("Matview rewrite" in ln for ln in explained(p, AGG_Q))
    for s in (p.rs, p.ps):
        s.execute("set enable_matview_rewrite = on")
    p.both("insert into fact values (7,'a',70,7.0)")
    assert not any("Matview rewrite" in ln for ln in explained(p, AGG_Q))
    assert p.both("select is_fresh from pg_matviews "
                  "where matviewname = 'agg'").rows == [(False,)]
    p.both("refresh materialized view agg")
    assert any("Matview rewrite" in ln for ln in explained(p, AGG_Q))
    want = p.rs.query(f"explain analyze {AGG_Q}")
    got = p.ps.query(f"explain analyze {AGG_Q}")
    assert got[0] == want[0] and "Matview rewrite" in got[0][0]
    assert any("Total: rows=" in r[0] for r in got), got


def test_rewrite_skipped_for_own_uncommitted_writes(p):
    p.both("refresh materialized view agg")
    p.both("begin")
    try:
        p.both("insert into fact values (777,'zz',7,0.5)")
        got = sorted(p.both(AGG_Q).rows)
        assert any(r[0] == "zz" for r in got), got
    finally:
        p.both("rollback")


def test_with_options_distribute_and_incremental_off(p):
    q = "select grp, sum(w) as sw from fact group by grp"
    p.both("create materialized view aggrep with "
           f"(distribute = replication, incremental = off) as {q}")
    assert p.both("select strategy, incremental from pg_matviews "
                  "where matviewname = 'aggrep'").rows == [
        ("replicated", False)]
    p.both("insert into fact values (8,'d',80,1.0)")
    p.both("refresh materialized view aggrep")
    assert stat(p, "aggrep", "incremental_refreshes, full_refreshes, "
                "last_mode") == [(0, 1, "full")]
    assert mv_rows(p, "aggrep") == oracle(p, q)
    p.both("drop materialized view aggrep")


def test_unsupported_shape_degrades_to_full(p):
    p.both("create table dim (grp text, label text) distribute by "
           "replication")
    p.both("insert into dim values ('a','alpha'),('b','beta')")
    q = ("select d.label, count(*) as n from fact f join dim d "
         "on f.grp = d.grp group by d.label")
    p.both(f"create materialized view j as {q}")
    assert p.both("select incremental from pg_matviews "
                  "where matviewname = 'j'").rows == [(False,)]
    p.both("insert into fact values (9,'b',90,9.0)")
    p.both("refresh materialized view j")
    assert stat(p, "j", "last_mode") == [("full",)]
    assert mv_rows(p, "j") == oracle(p, q)
    p.both("drop materialized view j")
    p.both("drop table dim")


# -- incremental refresh == recompute (tests/test_matview.py:194-310) -------

DIFF_ROUNDS = 3
DIFF_SHAPES = {
    "d_agg": ("select g, count(*) as n, count(v) as nv, sum(v) as s, "
              "avg(v) as a from dfact group by g"),
    "d_mm": ("select g, min(v) as lo, max(v) as hi, count(*) as n "
             "from dfact group by g"),
    "d_proj": "select k, g, v from dfact where v > 15",
}


def random_dml_round(rng, next_key) -> list:
    out = []
    for _ in range(rng.randint(2, 4)):
        op = rng.random()
        if op < 0.45:
            rows = ", ".join(
                "({}, '{}', {})".format(
                    next_key[0] + i, rng.choice("abcdefg"),
                    rng.choice(["null", str(rng.randint(-50, 100))]))
                for i in range(rng.randint(1, 4)))
            next_key[0] += 4
            out.append(f"insert into dfact values {rows}")
        elif op < 0.75:
            out.append("delete from dfact where k = "
                       f"{rng.randint(1, next_key[0])}")
        else:
            v = rng.choice(["null", str(rng.randint(-50, 100))])
            out.append(f"update dfact set v = {v} where k = "
                       f"{rng.randint(1, next_key[0])}")
    return out


def test_incremental_differential_randomized(p):
    rng = random.Random(20260803)
    p.both("create table dfact (k bigint, g text, v bigint) "
           "distribute by shard(k)")
    p.both("insert into dfact values (1,'a',10),(2,'b',20),(3,'a',30),"
           "(4,'b',null),(5,'c',50),(6,'a',60)")
    for name, q in DIFF_SHAPES.items():
        p.both(f"create materialized view {name} as {q}")
    next_key = [7]
    for rnd in range(DIFF_ROUNDS):
        for sql in random_dml_round(rng, next_key):
            p.both(sql)
        for name, q in DIFF_SHAPES.items():
            p.both(f"refresh materialized view {name}")
            assert mv_rows(p, name) == oracle(p, q), (name, rnd)
    for name in DIFF_SHAPES:
        assert stat(p, name, "incremental_refreshes, full_refreshes") == [
            (DIFF_ROUNDS, 0)], name


def test_refresh_with_no_deltas_counts_incremental(p):
    p.both("refresh materialized view d_agg")
    assert stat(p, "d_agg", "incremental_refreshes, full_refreshes, "
                "last_mode") == [(DIFF_ROUNDS + 1, 0, "incremental")]


def test_vacuumed_deltas_fall_back_to_full_loudly(p, caplog):
    p.both("insert into dfact values (5000,'vv',77)")
    p.both("refresh materialized view d_agg")
    p.both("delete from dfact where k = 5000")
    saved = []
    for c in (p.rc, p.pc):
        saved.append({nm: c.matviews[nm].last_refresh_ts
                      for nm in DIFF_SHAPES})
        for nm in DIFF_SHAPES:
            c.matviews[nm].last_refresh_ts = 0
    try:
        assert p.both("vacuum dfact").rowcount > 0
    finally:
        for c, sv in zip((p.rc, p.pc), saved):
            for nm, ts in sv.items():
                c.matviews[nm].last_refresh_ts = ts
    with caplog.at_level("WARNING", logger="opentenbase_tpu_torch"):
        p.both("refresh materialized view d_agg")
    assert any("degrading to full recompute" in r.getMessage()
               for r in caplog.records)
    assert stat(p, "d_agg", "full_refreshes, last_mode") == [(1, "full")]
    assert mv_rows(p, "d_agg") == oracle(p, DIFF_SHAPES["d_agg"])
    p.both("refresh materialized view d_mm")
    p.both("refresh materialized view d_proj")
    p.both("insert into dfact values (999,'a',1)")
    p.both("refresh materialized view d_agg")
    assert stat(p, "d_agg", "last_mode") == [("incremental",)]


def test_truncate_and_alter_break_the_delta_stream(p):
    p.both("create table tb (k bigint, v bigint) distribute by shard(k)")
    p.both("insert into tb values (1,10),(2,20)")
    p.both("create materialized view tbmv as select k, v from tb "
           "where v > 5")
    p.both("truncate table tb")
    p.both("insert into tb values (9,90)")
    p.both("refresh materialized view tbmv")
    assert stat(p, "tbmv", "last_mode") == [("full",)]
    assert mv_rows(p, "tbmv") == [(9, 90)]
    p.both("alter table tb add column w bigint")
    p.both("insert into tb values (10,100,1)")
    p.both("refresh materialized view tbmv")
    assert mv_rows(p, "tbmv") == [(9, 90), (10, 100)]
    p.both("drop materialized view tbmv")
    p.both("drop table tb")


def test_two_phase_commit_breaks_the_delta_stream(p):
    q = "select k, count(*) as n, sum(v) as s from pb group by k"
    p.both("create table pb (k bigint, v bigint) distribute by shard(k)")
    p.both("insert into pb values (1,10),(2,20)")
    p.both(f"create materialized view pbmv as {q}")
    p.both("begin")
    p.both("insert into pb values (3,30)")
    p.both("prepare transaction 'mv2pc'")
    p.both("commit prepared 'mv2pc'", sessions=p.sessions())
    assert p.both("select is_fresh from pg_matviews "
                  "where matviewname = 'pbmv'").rows == [(False,)]
    p.both("refresh materialized view pbmv")
    assert stat(p, "pbmv", "last_mode") == [("full",)]
    assert mv_rows(p, "pbmv") == oracle(p, q)
    p.both("drop materialized view pbmv")
    p.both("drop table pb")


def test_partitioned_base_staleness(p):
    q = "select count(*) as n, sum(v) as s from pt"
    p.both("create table pt (k bigint, v bigint) distribute by shard(k) "
           "partition by range (k) begin (0) step (100) partitions (3)")
    p.both("insert into pt values (5,50),(150,60)")
    p.both(f"create materialized view ptmv as {q}")
    assert p.both("select incremental, is_fresh from pg_matviews "
                  "where matviewname = 'ptmv'").rows == [(False, True)]
    p.both("insert into pt values (250,70)")
    assert p.both("select is_fresh from pg_matviews "
                  "where matviewname = 'ptmv'").rows == [(False,)]
    p.both("refresh materialized view ptmv")
    assert mv_rows(p, "ptmv") == oracle(p, q)
    p.both("drop materialized view ptmv")
    p.both("drop table pt")


def test_state_row_commits_with_contents(p):
    rows = p.ps.query("select lsn from otb_matview_state where mv = 'd_agg'")
    assert rows and rows[0][0] == p.ps.query(
        "select last_refresh_lsn from pg_matviews "
        "where matviewname = 'd_agg'")[0][0]
    p.both("select mv, incr, fullr, deltas from otb_matview_state "
           "order by mv")


# -- CONCURRENTLY, transaction blocks, WLM (tests/test_matview.py:414-523) --


def test_refresh_concurrently_under_reader(p):
    old_n = len(mv_rows(p, "d_proj"))
    p.both("insert into dfact select k + 10000, 'a', 99 from dfact")
    new_n = len(oracle(p, DIFF_SHAPES["d_proj"]))
    assert new_n > old_n
    counts, errs = set(), []
    stop = threading.Event()
    reader_up = threading.Event()

    def reader():
        rs = p.pc.session()
        rs.execute("set enable_matview_rewrite = off")
        while not stop.is_set():
            try:
                counts.add(rs.query("select count(*) from d_proj")[0][0])
            except Exception as e:  # pragma: no cover
                errs.append(e)
            reader_up.set()

    th = threading.Thread(target=reader)
    th.start()
    try:
        assert reader_up.wait(timeout=30)
        p.both("refresh materialized view concurrently d_proj")
    finally:
        stop.set()
        th.join(timeout=30)
    assert not errs, errs
    assert counts <= {old_n, new_n}, (counts, old_n, new_n)
    assert mv_rows(p, "d_proj") == oracle(p, DIFF_SHAPES["d_proj"])


def test_refresh_and_create_refused_inside_transaction(p):
    p.both("begin")
    try:
        for sql in ("refresh materialized view d_agg",
                    "create materialized view mtx as select k from dfact",
                    "drop materialized view d_agg"):
            assert p.raises(sql, "transaction block").sqlstate == "25001"
    finally:
        p.both("rollback")
    assert p.both("select matviewname from pg_matviews where matviewname "
                  "in ('d_agg', 'mtx')").rows == [("d_agg",)]


def test_matview_over_view_refreshes(p):
    q = "select g, count(*) as n from dview group by g"
    p.both("create view dview as select k, g, v from dfact where v > 0")
    p.both(f"create materialized view dvmv as {q}")
    p.both("insert into dfact values (8000,'vw',5)")
    p.both("refresh materialized view dvmv")
    assert mv_rows(p, "dvmv") == oracle(p, q)
    p.both("drop materialized view dvmv")
    p.both("drop view dview")


def test_refresh_goes_through_wlm_admission(p):
    p.both("create resource group mvtiny with "
           "(concurrency=4, memory_limit='1kB', queue_depth=4)")
    p.both("set resource_group = mvtiny")
    try:
        errs = []
        for s in (p.rs, p.ps):
            try:
                s.execute("refresh materialized view d_agg")
            except Exception as e:  # noqa: BLE001 - compared
                errs.append(getattr(e, "sqlstate", None))
        assert errs == ["53200", "53200"]
    finally:
        p.both("set resource_group = default_group")
    p.both("refresh materialized view d_agg")
    assert mv_rows(p, "d_agg") == oracle(p, DIFF_SHAPES["d_agg"])


# -- dependencies and the write guard (tests/test_matview.py:525-650) -------


def test_drop_table_refuses_with_2bp01_and_cascade_drops(p):
    p.both("create table base1 (k bigint, v bigint) distribute by shard(k)")
    p.both("insert into base1 values (1,1),(2,2)")
    p.both("create materialized view b1mv as select k, v from base1 "
           "where v > 0")
    err = p.raises("drop table base1", "b1mv")
    assert err.sqlstate == "2BP01"
    p.both("drop table base1 cascade")
    assert p.both("select count(*) from pg_matviews "
                  "where matviewname = 'b1mv'").rows == [(0,)]
    assert not p.pc.catalog.has("base1") and not p.pc.catalog.has("b1mv")


def test_drop_matview_dependency_and_cascade(p):
    p.both("create table base2 (k bigint, g text) distribute by shard(k)")
    p.both("insert into base2 values (1,'x'),(2,'y')")
    p.both("create materialized view b2mv as select k, g from base2")
    p.both("create materialized view b2agg as select g, count(*) as n "
           "from b2mv group by g")
    assert p.raises("drop materialized view b2mv",
                    "depend on it").sqlstate == "2BP01"
    p.both("drop materialized view b2mv cascade")
    assert p.both("select count(*) from pg_matviews where matviewname "
                  "in ('b2mv','b2agg')").rows == [(0,)]
    p.both("drop table base2")


def test_direct_writes_refused_42809(p):
    for sql in ("insert into d_agg values ('x',1,1,1,1.0)",
                "update d_agg set n = 0", "delete from d_agg",
                "truncate table d_agg", "drop table d_agg",
                "delete from d_agg$aux",
                "alter table d_agg add column junk bigint",
                "delete from otb_matview_state",
                "update otb_matview_state set lsn = 0",
                "drop table otb_matview_state",
                "truncate table otb_matview_state"):
        err = p.both(sql)
        assert isinstance(err, Exception) and err.sqlstate == "42809", sql


def test_2bp01_rides_both_wire_protocols(p):
    """The JSON wire's frame and the v3 wire's 'E' message carry 2BP01
    from the port's server, as from the reference's."""
    from test_torch_wlm import V3

    from opentenbase_tpu.net import client as ref_client
    from opentenbase_tpu.net import pgwire as ref_pgwire
    from opentenbase_tpu.net import server as ref_server
    from opentenbase_tpu_torch.net import client as port_client
    from opentenbase_tpu_torch.net import pgwire as port_pgwire
    from opentenbase_tpu_torch.net import server as port_server

    def json_wire_sqlstate(c, srv_mod, cl_mod, sql):
        with srv_mod.ClusterServer(c, port=0) as srv:
            cs = cl_mod.connect_tcp(srv.host, srv.port)
            try:
                cs.execute(sql)
            except cl_mod.WireError as e:
                return e.sqlstate
            finally:
                cs.close()

    def v3_sqlstate(c, pg_mod, sql):
        srv = pg_mod.PgWireServer(c, port=0).start()
        try:
            v3 = V3(srv.host, srv.port, "otb")
            state = v3.query(sql)
            v3.close()
            return state[1] if state[0] == "error" else None
        finally:
            srv.stop()

    got = []
    for c, srv_mod, cl_mod, pg_mod in (
            (p.rc, ref_server, ref_client, ref_pgwire),
            (p.pc, port_server, port_client, port_pgwire)):
        got.append((json_wire_sqlstate(c, srv_mod, cl_mod,
                                       "drop table dfact"),
                    v3_sqlstate(c, pg_mod, "drop table dfact")))
    assert got[0] == got[1] == ("2BP01", "2BP01")


# -- the fused route (the port's own checks) --------------------------------


def test_fused_route_reads_a_full_refresh_at_once(p):
    """A matview is a table: after a full REFRESH rewrote it through the
    write path, a read on the fused route answers the new rows, not the
    device planes it cached before (the DeviceCache versions trap)."""
    q = "select grp, sum(v) as s from fact group by grp"
    p.both(f"create materialized view fmv with (incremental = off) as {q}")
    p.set_fused("on")
    # an aggregate over the matview takes the fused route (a bare scan
    # of it is the DAG's "trivial scan", which the host route answers)
    read = "select grp, sum(s) as s from fmv group by grp"
    try:
        before = sorted(p.both(read).rows)
        assert p.ps.last_route == "fused"
        p.both("insert into fact values (60, 'new', 5, 1.0)")
        p.both("refresh materialized view fmv")
        after = sorted(p.both(read).rows)
        assert p.ps.last_route == "fused"
        assert after != before and ("new", 5) in after
        assert after == oracle(p, q)
        assert p.both("select sum(s) from fmv").rows == [
            (sum(r[1] for r in after if r[1] is not None),)]
        assert p.ps.last_route == "fused"
        # the rewrite serves Q from the matview with the fused route on
        assert sorted(p.both(q).rows) == after
    finally:
        p.set_fused("off")
        p.both("drop materialized view fmv")


def test_delta_tables_leave_nothing_behind(p):
    """An incremental refresh's delta tables are dropped with their
    stores and device planes, and never become durable."""
    p.both("insert into dfact values (9100,'q',3)")
    p.both("refresh materialized view d_agg")
    assert stat(p, "d_agg", "last_mode") == [("incremental",)]
    assert not [n for n in p.pc.catalog.table_names()
                if n.startswith("__mvdelta_")]
    assert not p.pc.local_tables
    fx = p.pc._fused
    if fx is not None:
        assert not [k for k in fx.cache._tables
                    if k[0].startswith("__mvdelta_")]


def test_decode_table_deltas_agree_across_packages(tmp_path):
    """One WAL, written by the port, decoded by both packages'
    ``decode_table_deltas`` (each over its own recovery of the
    directory): the same inserts and deletes; and a WAL written by the
    reference, decoded the same way."""
    rc, pc = make_clusters(data_dir=str(tmp_path))
    try:
        for c in (rc, pc):
            s = c.session()
            s.execute("create table dt (k bigint, g text, v float8) "
                      "distribute by shard(k)")
            s.execute("insert into dt values (1,'a',1.5),(2,null,2.5),"
                      "(3,'c',null)")
            s.execute("begin")
            s.execute("insert into dt values (4,'d',4.5)")
            s.execute("update dt set v = 9.0 where k = 4")
            s.execute("commit")
            s.execute("delete from dt where k = 2")
            s.execute("update dt set g = 'z' where k = 1")
    finally:
        rc.close()
        pc.close()
    for swap in (False, True):
        r2, p2 = recover_clusters(str(tmp_path), swap=swap)
        try:
            want = ref_logical.decode_table_deltas(r2, "dt", 0)
            got = port_logical.decode_table_deltas(p2, "dt", 0)
            key = repr
            assert got[2] is want[2] is True
            for g, w in zip(got[:2], want[:2]):
                assert sorted(g, key=key) == sorted(w, key=key)
                assert_same_rows(sorted((tuple(sorted(r.items()))
                                         for r in g), key=key),
                                 sorted((tuple(sorted(r.items()))
                                         for r in w), key=key))
            assert len(got[0]) == 5 and len(got[1]) == 2
        finally:
            r2.close()
            p2.close()


# -- recovery, and a cluster without a WAL (tests/test_matview.py:652-730) --


@pytest.mark.parametrize("swap", [False, True], ids=["own", "swapped"])
def test_crash_recovery_catalog_lsn_and_checkpoint(tmp_path, swap):
    q = "select g, count(*) as n, sum(v) as s from rf group by g"
    p = Pair(shard_groups=16, data_dir=str(tmp_path))
    p.set_fused("off")
    p.both("create table rf (k bigint, g text, v bigint) "
           "distribute by shard(k)")
    p.both("insert into rf values (1,'a',10),(2,'b',20),(3,'a',30)")
    p.both(f"create materialized view rmv as {q}")
    p.both("insert into rf values (4,'b',40)")
    p.both("refresh materialized view rmv")
    for c in (p.rc, p.pc):
        c.persistence.checkpoint()
    before = oracle(p, "select * from rmv")
    p.both("insert into rf values (5,'c',50)")
    p.close()  # crash

    p2 = Pair(clusters=recover_clusters(str(tmp_path), shard_groups=16,
                                        swap=swap))
    p2.set_fused("off")
    rows = p2.both("select matviewname, incremental, is_fresh "
                   "from pg_matviews").rows
    assert rows == [("rmv", True, False)]
    assert p2.both("select incremental_refreshes from "
                   "pg_stat_matview").rows == [(1,)]
    assert oracle(p2, "select * from rmv") == before
    p2.both("refresh materialized view rmv")
    assert p2.both("select incremental_refreshes, last_mode from "
                   "pg_stat_matview").rows == [(2, "incremental")]
    assert oracle(p2, "select * from rmv") == oracle(p2, q)
    assert p2.both("select is_fresh from pg_matviews").rows == [(True,)]
    p2.both("truncate table rf")
    p2.close()

    p3 = Pair(clusters=recover_clusters(str(tmp_path), shard_groups=16,
                                        swap=swap))
    p3.set_fused("off")
    assert p3.both("select is_fresh from pg_matviews").rows == [(False,)]
    assert not any("Matview rewrite" in ln for ln in explained(p3, q))
    p3.both("refresh materialized view rmv")
    assert p3.both("select * from rmv").rows == []
    p3.close()


def test_non_durable_cluster_always_full():
    p = Pair(shard_groups=16)
    p.set_fused("off")
    p.both("create table nf (k bigint, v bigint) distribute by shard(k)")
    p.both("insert into nf values (1,10),(2,20)")
    p.both("create materialized view nmv as select k, v from nf "
           "where v > 5")
    p.both("insert into nf values (3,30)")
    p.both("refresh materialized view nmv")
    assert p.both("select last_mode from pg_stat_matview").rows == [
        ("full",)]
    assert oracle(p, "select * from nmv") == oracle(
        p, "select k, v from nf where v > 5")
    p.close()

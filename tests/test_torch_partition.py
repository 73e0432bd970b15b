"""Interval / range partitioned tables in the port (plan/partition.py and
the engine's partition sites), held against the reference on
tests/test_partition.py's cases and the partitioned cases of
tests/test_constraints.py, tests/test_locks.py, tests/test_alter.py and
tests/test_prepared_stmts.py: the same statements go to a reference and
a port cluster (tests/torch_pair.py), reads with the fused route on and
off, every answer, command tag, row count and error equal (exact). A
read of a parent takes the host route in both packages (the UNION ALL
of its children sits under the WHERE and the aggregate); a child read
by name is a plain table, on the fused route. Each package recovers the
other's data directory holding a partitioned table, a PL/pgSQL function
and a foreign table."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster, carry
from torch_pair import Pair, make_clusters, recover_clusters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

M_DDL = ("create table m (id bigint, ts bigint, v text)"
         " partition by range (ts) begin (0) step (100) partitions (4)"
         " distribute by shard(id)")
M_ROWS = ("insert into m values (1, 10,'a'),(2, 110,'b'),(3, 250,'c'),"
          "(4, 399,'d')")


@pytest.fixture(params=[1, 2], ids=["1dn", "2dn"])
def p(request):
    pair = Pair(nd=request.param, shard_groups=32)
    pair.both(M_DDL)
    pair.both(M_ROWS)
    yield pair
    pair.close()


def scanned(rows) -> set:
    """The relations an EXPLAIN's plan scans."""
    return {ln.split("Scan on ", 1)[1].split()[0] for (ln,) in rows
            if "Scan on " in ln}


def test_insert_routes_and_select_unions(p):
    assert p.query("select id, ts, v from m order by id") == [
        (1, 10, "a"), (2, 110, "b"), (3, 250, "c"), (4, 399, "d")]
    assert p.query("select count(*) from m$p0") == [(1,)]
    assert p.query("select count(*) from m$p2") == [(1,)]


def test_out_of_range_and_null_keys_rejected(p):
    p.raises("insert into m values (9, 400, 'x')", "out of range")
    p.raises("insert into m values (9, null, 'x')", "null partition key")
    assert p.query("select count(*) from m") == [(4,)]


def test_where_pruning_correctness(p):
    assert p.query("select v from m where ts = 250") == [("c",)]
    assert p.query("select v from m where ts >= 100 and ts < 300 "
                   "order by ts") == [("b",), ("c",)]
    assert p.query("select v from m where ts > 1000") == []


@pytest.mark.parametrize("where,kept", [
    ("ts = 250", {"m$p2"}),
    ("ts >= 100 and ts < 300", {"m$p1", "m$p2", "m$p3"}),
    ("250 < ts", {"m$p2", "m$p3"}),
    ("ts > 1000", {"m$p0"}),  # an empty child keeps the schema
    ("v = 'a'", {"m$p0", "m$p1", "m$p2", "m$p3"}),
])
def test_pruning_skips_partitions(p, where, kept):
    """The rewritten plan scans exactly the reference's children."""
    got = p.both(f"explain select v from m where {where}")
    want = p.rs.query(f"explain select v from m where {where}")
    assert scanned(got.rows) == scanned(want) == kept


def test_aggregate_and_join_over_partitions(p):
    p.both("create table ref (id bigint, tag text) distribute by shard(id)")
    p.both("insert into ref values (1,'one'),(3,'three')")
    assert p.query("select count(*), max(ts) from m") == [(4, 399)]
    assert p.query("select m.v, ref.tag from m join ref on m.id = ref.id "
                   "order by m.id") == [("a", "one"), ("c", "three")]


def test_update_delete_fanout_atomic(p):
    assert p.both("update m set v = 'upd' where ts < 200").rowcount == 2
    assert p.query("select v from m where ts = 10") == [("upd",)]
    assert p.both("delete from m where ts >= 300").rowcount == 1
    assert p.query("select count(*) from m") == [(3,)]
    p.both("begin")
    p.both("delete from m")
    assert p.query("select count(*) from m") == [(0,)]
    p.both("rollback")
    assert p.query("select count(*) from m") == [(3,)]


def test_a_failed_fanout_leaves_no_child_written(p):
    """One statement inside an explicit transaction: the last child
    fails (NOT NULL), which undoes the children before it, and the
    transaction goes on."""
    p.both("create table nn (id bigint, ts bigint, v text not null)"
           " partition by range (ts) begin (0) step (100) partitions (4)"
           " distribute by shard(id)")
    p.both(M_ROWS.replace("into m", "into nn"))
    p.both("begin")
    p.both("update nn set v = 'x' where ts = 10")
    p.raises("update nn set v = nullif(v, 'd')",
             "not-null")
    assert p.query("select id, v from nn order by id", fused=("off",)) == [
        (1, "x"), (2, "b"), (3, "c"), (4, "d")]
    p.both("commit")
    assert p.query("select id, v from nn order by id") == [
        (1, "x"), (2, "b"), (3, "c"), (4, "d")]


def test_truncate_and_drop_parent(p):
    p.both("truncate table m")
    assert p.query("select count(*) from m") == [(0,)]
    p.both("insert into m values (1, 50, 'z')")
    p.both("drop table m")
    p.raises("select * from m", "m")
    assert "m" not in p.rc.partitions and "m" not in p.pc.partitions
    assert not any(p.pc.catalog.has(f"m$p{i}") for i in range(4))


def test_calendar_month_partitions():
    pair = Pair(shard_groups=32)
    pair.both("create table ev (id bigint, at timestamp)"
              " partition by range (at) begin ('2024-01-01') step (1 month)"
              " partitions (3) distribute by shard(id)")
    pair.both("insert into ev values (1,'2024-01-15 12:00:00'),"
              "(2,'2024-02-29 23:59:59'),(3,'2024-03-31 00:00:00')")
    for i in range(3):
        assert pair.query(f"select count(*) from ev$p{i}") == [(1,)]
    pair.raises("insert into ev values (4,'2024-04-01 00:00:00')",
                "out of range")
    assert pair.query("select id from ev where at >= '2024-02-01' "
                      "order by id") == [(2,), (3,)]
    pair.close()


def test_pg_partitions_view(p):
    assert p.query(
        "select partition, range_lo, range_hi, n_live_tup from pg_partitions"
        " where parent = 'm' order by index") == [
        ("m$p0", 0, 100, 1), ("m$p1", 100, 200, 1),
        ("m$p2", 200, 300, 1), ("m$p3", 300, 400, 1)]


def test_subquery_over_partitioned_table(p):
    assert p.query("select id from m where ts = (select max(ts) from m)"
                   ) == [(4,)]


def test_timezone_independent_timestamp_boundaries():
    """Boundary and routing math treat naive literals as UTC in both
    packages, whatever the host's time zone."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from opentenbase_tpu.engine import Cluster as R\n"
        "from opentenbase_tpu_torch import Cluster\n"
        "for c in (R(num_datanodes=1, shard_groups=8),"
        " Cluster(num_datanodes=1, shard_groups=8, device='cpu')):\n"
        "    s = c.session()\n"
        "    s.execute(\"create table ev (id bigint, at timestamp)"
        " partition by range (at) begin ('2024-01-01') step (1 month)"
        " partitions (2) distribute by shard(id)\")\n"
        "    s.execute(\"insert into ev values (1,'2024-01-01 02:00:00')\")\n"
        "    assert s.query(\"select id from ev where at = "
        "'2024-01-01 02:00:00'\") == [(1,)]\n"
        "    assert s.query('select count(*) from ev$p0') == [(1,)]\n"
        "print('TZ-OK')\n")
    env = dict(os.environ, TZ="America/New_York", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert "TZ-OK" in out.stdout, out.stderr[-800:]


def test_update_partition_key_rejected(p):
    p.raises("update m set ts = 250 where id = 1", "partition key")
    assert p.both("update m set v = 'ok' where id = 1").rowcount == 1
    assert p.query("select v from m where id = 1") == [("ok",)]


def test_dml_where_subquery_over_parent(p):
    assert p.both("delete from m where ts = (select max(ts) from m)"
                  ).rowcount == 1
    assert p.query("select count(*) from m") == [(3,)]


def test_drop_child_directly_rejected(p):
    p.raises("drop table m$p0", "partition of")
    assert p.query("select count(*) from m") == [(4,)]


def test_dollar_name_not_treated_as_child(tmp_path):
    pair = Pair(shard_groups=32, data_dir=str(tmp_path))
    pair.both("create table a (id bigint, ts bigint) partition by range (ts)"
              " begin (0) step (10) partitions (2) distribute by shard(id)")
    pair.both("create table a$pxy (id bigint, v text) distribute by "
              "shard(id)")
    pair.both("insert into a$pxy values (1,'own-dict')")
    for swap in (False, True):
        rc, pc = recover_clusters(str(tmp_path), shard_groups=32, swap=swap)
        for c in (rc, pc):
            assert c.session().query("select v from a$pxy") == [
                ("own-dict",)]
        rc.close()
        pc.close()
    pair.close()


# -- the partitioned cases of tests/test_constraints.py, tests/test_locks.py,
# tests/test_alter.py and tests/test_prepared_stmts.py -----------------------

def test_pk_on_partitioned_table_rules():
    pair = Pair(shard_groups=32)
    pair.raises("create table pm (id bigint primary key, ts bigint)"
                " partition by range (ts) begin (0) step (10) partitions (2)"
                " distribute by shard(id)", "partition column")
    pair.both("create table pm (ts bigint primary key, v text)"
              " partition by range (ts) begin (0) step (10) partitions (2)"
              " distribute by shard(ts)")
    pair.both("insert into pm values (1,'a')")
    pair.raises("insert into pm values (1,'b')", "duplicate key")
    pair.raises("insert into pm values (2,'b') on conflict (ts) do nothing",
                "ON CONFLICT on partitioned tables")
    pair.close()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_lock_table_covers_partitions(pkg):
    """LOCK TABLE on a partition holds off an INSERT through the parent,
    and LOCK TABLE on the parent one into a partition, each statement
    under the statement lock as the wire servers run it."""
    c = (RefCluster(num_datanodes=2, shard_groups=32) if pkg == "ref"
         else Cluster(num_datanodes=2, shard_groups=32, device="cpu"))

    def run(s, sql):
        with c._exec_lock:
            return s.execute(sql)

    s0, s1, s2 = c.session(), c.session(), c.session()
    run(s0, "create table ev (ts bigint, v bigint) distribute by shard(ts) "
        "partition by range (ts) begin (0) step (100) partitions (2)")
    run(s2, "set lock_timeout = 150")
    run(s1, "begin")
    run(s1, "lock table ev$p0 in exclusive mode")
    with pytest.raises(Exception, match="lock timeout"):
        run(s2, "insert into ev values (1, 1)")
    run(s1, "rollback")
    run(s1, "begin")
    run(s1, "lock table ev in exclusive mode")
    with pytest.raises(Exception, match="lock timeout"):
        run(s2, "insert into ev$p0 values (2, 2)")
    run(s1, "rollback")
    assert run(s2, "insert into ev values (3, 3)").rowcount == 1
    c.close()


def test_add_partitions_extends_range():
    pair = Pair(shard_groups=32)
    pair.both("create table m (id bigint, ts bigint) partition by range (ts)"
              " begin (0) step (100) partitions (2) distribute by shard(id)")
    pair.both("insert into m values (1, 50),(2, 150)")
    pair.raises("insert into m values (3, 250)", "out of range")
    pair.both("alter table m add partitions (2)")
    pair.both("insert into m values (3, 250),(4, 399)")
    assert pair.query("select count(*) from m") == [(4,)]
    assert pair.query("select count(*) from m$p2") == [(1,)]
    pair.raises("alter table m$p0 add column x bigint", "partition of")
    pair.close()


def test_alter_partitioned_parent_column():
    pair = Pair(shard_groups=32)
    pair.both("create table m (id bigint, ts bigint) partition by range (ts)"
              " begin (0) step (100) partitions (2) distribute by shard(id)")
    pair.both("insert into m values (1, 50),(2, 150)")
    pair.both("alter table m add column note text")
    pair.both("update m set note = 'x' where ts < 100")
    assert pair.query("select id, note from m order by id") == [
        (1, "x"), (2, None)]
    pair.raises("alter table m drop column ts", "partition key")
    pair.both("alter table m drop column note")
    assert pair.query("select * from m order by id") == [(1, 50), (2, 150)]
    pair.close()


def test_add_partitions_survives_recovery(tmp_path):
    pair = Pair(shard_groups=32, data_dir=str(tmp_path))
    pair.both("create table m (id bigint, ts bigint) partition by range (ts)"
              " begin (0) step (100) partitions (2) distribute by shard(id)")
    pair.both("alter table m add partitions (1)")
    pair.both("insert into m values (1, 250)")
    for swap in (False, True):
        rc, pc = recover_clusters(str(tmp_path), shard_groups=32, swap=swap)
        for c in (rc, pc):
            assert c.partitions["m"].nparts == 3
            assert c.session().query("select count(*) from m$p2") == [(1,)]
        rc.close()
        pc.close()
    pair.close()


def test_prepared_over_partitioned_table():
    """Repeated EXECUTEs prune anew: the in-place rewrite never reaches
    the stored template."""
    pair = Pair(shard_groups=16)
    pair.both("create table m (id bigint, ts bigint) partition by range (ts)"
              " begin (0) step (100) partitions (3) distribute by shard(id)")
    pair.both("insert into m values (1,50),(2,150),(3,250)")
    pair.both("prepare pq as select id from m where ts = $1")
    assert pair.both("execute pq(150)").rows == [(2,)]
    assert pair.both("execute pq(250)").rows == [(3,)]
    assert pair.both("execute pq(50)").rows == [(1,)]
    pair.close()


# -- COPY, routes, device planes, durability, carrying ---------------------

def test_copy_into_and_out_of_a_parent(p, tmp_path):
    src = tmp_path / "m.csv"
    src.write_text("5,120,e\n6,20,f\n7,399,\\N\n")
    assert p.both(f"copy m from '{src}'").rowcount == 3
    assert p.query("select count(*) from m$p1") == [(2,)]
    assert p.query("select id, ts, v from m order by id") == p.rs.query(
        "select id, ts, v from m order by id")
    bad = tmp_path / "bad.csv"
    bad.write_text("8,999,x\n")
    p.raises(f"copy m from '{bad}'", "out of range")
    outs = []
    for s, tag in ((p.rs, "ref"), (p.ps, "port")):
        dst = tmp_path / f"{tag}.csv"
        assert s.execute(f"copy m to '{dst}'").rowcount == 7
        outs.append(sorted(dst.read_text().splitlines()))
    assert outs[0] == outs[1]


def test_routes_parent_host_child_fused(p):
    """A parent's read answers on the host route; a child read by name on
    the fused route, as in the reference."""
    sql = "select v, count(*) from {} where ts >= 200 group by v order by v"
    assert p.query(sql.format("m")) == [("c", 1), ("d", 1)]
    p.ps.query(sql.format("m"))
    assert p.ps.last_route == "host"
    p.ps.query(sql.format("m$p2"))
    assert p.ps.last_route == "fused"
    assert p.query(sql.format("m$p2")) == [("c", 1)]


STALE = {
    "truncate": ("truncate table m", [M_ROWS.replace("1, 10,", "5, 10,")]),
    "drop": ("drop table m", [M_DDL, "insert into m values (9, 20, 'new')"]),
    "add_partitions": ("alter table m add partitions (1)",
                       ["insert into m values (8, 30, 'x'), (9, 450, 'y')"]),
}


@pytest.mark.parametrize("case", sorted(STALE))
def test_no_stale_planes_for_a_child(case):
    """DROP of a parent, TRUNCATE over its children and ADD PARTITIONS
    leave no child's old device planes behind: the port's fused route
    reads each child's new rows (the reference's host route is the
    oracle: its fused route can answer from old planes, ROADMAP C)."""
    pair = Pair(shard_groups=32)
    pair.both(M_DDL)
    pair.both(M_ROWS)
    q = "select count(*), sum(id), sum(ts) from m$p0"
    assert pair.query(q) == [(1, 1, 10)]
    assert pair.ps.query(q) == [(1, 1, 10)]
    assert pair.ps.last_route == "fused"
    ddl, after = STALE[case]
    pair.both(ddl)
    for sql in after:
        pair.both(sql)
    pair.ps.execute("set enable_fused_execution = on")
    got = pair.ps.query(q)
    assert pair.ps.last_route == "fused"
    pair.rs.execute("set enable_fused_execution = off")
    assert got == pair.rs.query(q) != [(1, 1, 10)]
    if case == "add_partitions":
        assert pair.query("select id from m$p4") == [(9,)]
    pair.close()


def test_concurrent_inserts_through_the_parent():
    """Sessions inserting through one parent at once route every row."""
    pair = Pair(shard_groups=32)
    pair.both(M_DDL)
    for c in (pair.rc, pair.pc):
        def run(k, c=c):
            c.session().execute(
                f"insert into m values ({k}, {k % 400}, 'r{k % 7}')")
        ts = [threading.Thread(target=run, args=(k,)) for k in range(40)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert pair.query("select count(*), sum(id) from m") == [(40, 780)]
    assert pair.query("select count(distinct v) from m") == [(7,)]
    pair.close()


def _ref_rows(rc, table):
    meta = rc.catalog.get(table)
    cols, xmin, xmax = {}, {}, {}
    for node in meta.node_indices:
        v = rc.stores[node][table].scan_view()
        cols[node] = {name: (np.array(v.col(name)), v.validity(name))
                      for name in meta.schema}
        xmin[node] = np.array(v.xmin())
        xmax[node] = np.array(v.xmax())
    return cols, xmin, xmax


def test_carry_a_partitioned_table():
    """A reference partitioned table carried into a port cluster (the
    children's rows, commit stamps and shared dictionaries, the parent's
    clause) answers as the reference does."""
    from opentenbase_tpu.storage.persist import _type_to_str

    rc = RefCluster(num_datanodes=2, shard_groups=32)
    rs = rc.session()
    rs.execute(M_DDL)
    rs.execute(M_ROWS)
    rs.execute("delete from m where id = 2")
    spec = rc.partitions["m"]
    meta = rc.catalog.get("m")
    pc = Cluster(num_datanodes=2, shard_groups=32, device="cpu")
    n = carry.load_partitioned(
        pc, "m", {c: _type_to_str(ty) for c, ty in meta.schema.items()},
        meta.dist.strategy.value, meta.dist.key_columns, spec.spec,
        {ch: _ref_rows(rc, ch) for ch in spec.children()},
        {c: list(d.values) for c, d in meta.dictionaries.items()})
    assert n == 4
    ps = pc.session()
    for q in ("select id, ts, v from m order by id",
              "select count(*) from m$p1",
              "select v from m where ts = 250"):
        assert ps.query(q) == rs.query(q), q
    ps.execute("insert into m values (5, 120, 'c')")
    assert ps.query("select id from m where v = 'c' order by id") == [
        (3,), (5,)]
    rc.close()
    pc.close()


@pytest.mark.parametrize("checkpoint", [False, True],
                         ids=["wal", "checkpoint"])
@pytest.mark.parametrize("swap", [False, True], ids=["own", "swapped"])
def test_each_package_recovers_the_others_directory(tmp_path, checkpoint,
                                                    swap):
    """A data directory holding a partitioned table (after ADD PARTITIONS
    and DML), a PL/pgSQL function and a foreign table: each package
    recovers its own and the other's, from the WAL or past a
    checkpoint, and answers the same."""
    src = tmp_path / "ft.csv"
    src.write_text("1,one\n2,two\n")
    rc, pc = make_clusters(nd=2, shard_groups=32, data_dir=str(tmp_path))
    pair = Pair(clusters=(rc, pc))
    pair.both(M_DDL)
    pair.both(M_ROWS)
    pair.both("alter table m add partitions (2)")
    pair.both("insert into m values (5, 450, 'e'), (6, 599, 'a')")
    pair.both("delete from m where ts = 110")
    pair.both("create function bump(k bigint) returns bigint as '"
              "begin update m set v = ''bumped'' where id = k; "
              "return k * 10; end' language plpgsql")
    pair.both(f"create foreign table ft (k bigint, name text) server file "
              f"options (filename '{src}', format 'csv')")
    if checkpoint:
        for c in (rc, pc):
            c.persistence.checkpoint()
        pair.both("insert into m values (7, 520, 'g')")
    qs = ["select id, ts, v from m order by id",
          "select count(*) from m$p5",
          "select partition, n_live_tup from pg_partitions order by index",
          "select m.id, ft.name from m join ft on m.id = ft.k order by m.id"]
    want = [rc.session().query(q) for q in qs]
    pair.close()
    r2, p2 = recover_clusters(str(tmp_path), shard_groups=32, swap=swap)
    after = Pair(clusters=(r2, p2))
    for q, w in zip(qs, want):
        assert after.query(q) == w, q
    if checkpoint:
        # a function created before a checkpoint is lost at recovery in
        # both packages (ROADMAP C, kept from the reference)
        after.raises("select bump(4)", "unknown function")
    else:
        assert after.both("select bump(4)").rows == [(40,)]
        assert after.query("select v from m where id = 4") == [("bumped",)]
    after.both("insert into m values (8, 150, 'h')")
    assert after.query("select count(*) from m$p1") == [(1,)]
    after.raises("insert into ft values (3, 'x')", "foreign table")
    after.close()


def test_hot_standby_replays_the_new_records(tmp_path):
    """A hot standby replays the partitioned table's, the PL/pgSQL
    function's and the foreign table's records through the same redo:
    it reads the parent, a child, the function's answer and the file
    as its primary does, and refuses a recursive query (materializing
    it writes tables)."""
    from test_torch_replication import standby
    from opentenbase_tpu_torch.storage.replication import WalSender

    src = tmp_path / "sb.csv"
    src.write_text("1,one\n4,four\n")
    c = Cluster(num_datanodes=2, shard_groups=32,
                data_dir=str(tmp_path / "cn"), device="cpu")
    sender = WalSender(c.persistence, poll_s=0.01)
    s = c.session()
    for sql in (M_DDL, M_ROWS, "alter table m add partitions (1)",
                "insert into m values (5, 450, 'e')",
                "create function twice(k bigint) returns bigint as "
                "'begin return k * 2; end' language plpgsql",
                f"create foreign table ft (k bigint, name text) server file "
                f"options (filename '{src}', format 'csv')"):
        s.execute(sql)
    sb = standby(tmp_path, sender)
    try:
        assert sb.wait_caught_up(c.persistence)
        rs = sb.session()
        for q in ("select id, ts, v from m order by id",
                  "select count(*) from m$p4", "select twice(21)",
                  "select m.id, ft.name from m join ft on m.id = ft.k "
                  "order by m.id"):
            assert rs.query(q) == s.query(q), q
        with pytest.raises(Exception, match="read-only"):
            rs.query("with recursive t(n) as (select 1 union all "
                     "select n + 1 from t where n < 3) select sum(n) from t")
    finally:
        sb.close()
        sender.stop()
        c.close()

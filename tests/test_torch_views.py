"""Views, WITH, CREATE TABLE AS and INSERT ... SELECT in the port, held
against the reference: the same statements go to a reference
``Cluster(num_datanodes=2)`` and a port ``Cluster(..., device="cpu")``,
and every answer, command tag and row count must be equal (exact
equality: integers and decimals). The cases are tests/test_views.py's
(the partitioned table's are tests/test_torch_partition.py's), the
WITH cases of tests/test_views.py and tests/test_recursive_cte.py that
do not recurse (those that do are tests/test_torch_recursive_cte.py's),
and INSERT ... SELECT and CREATE TABLE AS across dictionaries, types and
transactions. What stays refused raises ``NotPorted`` by name: the
system views whose subsystem is not ported."""

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster, NotPorted

EMP = [
    "create table emp (id bigint, dept text, sal bigint)"
    " distribute by shard(id)",
    "insert into emp values (1,'eng',100),(2,'eng',200),(3,'ops',50)",
]


class Pair:
    """One statement stream into a reference session and a port one."""

    def __init__(self, nd: int = 2):
        self.rs = RefCluster(num_datanodes=nd, shard_groups=16).session()
        self.ps = Cluster(num_datanodes=nd, shard_groups=16,
                          device="cpu").session()

    def both(self, sql: str):
        """Run on both; equal command, rows and row count."""
        want = self.rs.execute(sql)
        got = self.ps.execute(sql)
        assert got.command == want.command, sql
        assert got.rows == want.rows, sql
        assert got.rowcount == want.rowcount, sql
        return got

    def query(self, sql: str, fused=("on", "off")):
        """A query on both, with the fused route on and off."""
        rows = None
        for f in fused:
            for s in (self.rs, self.ps):
                s.execute(f"set enable_fused_execution = {f}")
            want = self.rs.query(sql)
            assert self.ps.query(sql) == want, (sql, f)
            rows = want
        for s in (self.rs, self.ps):
            s.execute("set enable_fused_execution = on")
        return rows

    def raises(self, sql: str, match: str):
        """Both refuse with the reference's message."""
        with pytest.raises(Exception, match=match):
            self.rs.execute(sql)
        with pytest.raises(Exception, match=match):
            self.ps.execute(sql)


@pytest.fixture()
def p():
    pair = Pair()
    for sql in EMP:
        pair.both(sql)
    return pair


def test_view_select_and_join(p):
    p.both("create view eng as select id, sal from emp where dept = 'eng'")
    assert p.query("select count(*) from eng") == [(2,)]
    assert p.query(
        "select e.id, e.sal from eng e join emp on e.id = emp.id"
        " where emp.sal > 150 order by e.id") == [(2, 200)]


def test_view_over_aggregate_and_nested_views(p):
    p.both("create view dept_tot as select dept, sum(sal) as total from emp"
           " group by dept")
    p.both("create view big_depts as select dept from dept_tot"
           " where total > 100")
    assert p.query("select dept from big_depts") == [("eng",)]


def test_view_dml_rejected_and_drop_semantics(p):
    p.both("create view v1 as select id from emp")
    p.raises("insert into v1 values (9)", "cannot insert into view")
    p.raises("update v1 set id = 9", "cannot update view")
    p.raises("delete from v1", "cannot delete from view")
    p.raises("drop table v1", "use DROP VIEW")
    p.both("drop view v1")
    p.raises("drop view v1", "does not exist")
    p.both("drop view if exists v1")


def test_create_or_replace_and_validation(p):
    p.both("create view v as select id from emp")
    p.raises("create view v as select sal from emp", "already exists")
    p.both("create or replace view v as select sal from emp")
    assert p.query("select count(*) from v") == [(3,)]
    p.raises("create view broken as select nope from emp", "nope")
    p.raises("create view emp as select 1 is not null",
             "already exists as a table")


def test_system_views_refused_by_name(p):
    """pg_views and pg_proc (the reference's catalog views) answer as the
    reference's, a view over one reads it, a system view whose subsystem
    is not ported is refused by name, and every system view's name stays
    reserved as in the reference."""
    p.both("create view v2 as select id from emp where sal > 99")
    assert p.both(
        "select definition from pg_views where viewname = 'v2'").rows == [
        ("select id from emp where sal > 99",)]
    p.both("select viewname, definition from pg_views order by viewname")
    p.both("select proname from pg_proc")
    p.both("create view vnames as select viewname from pg_views")
    p.both("select count(*) from vnames")
    with pytest.raises(NotPorted, match="system view pg_stat_statements"):
        p.ps.query("select query from pg_stat_statements")
    p.raises("create view pg_stat_memory as select id from emp", "reserved")
    p.raises("create table pg_views as select id from emp", "reserved")


def test_materialized_views_refused_by_name(p):
    """Materialized views answer as the reference's since the port took
    them (tests/test_torch_matview.py holds the rest); their DDL is
    still refused inside a transaction block, and a view over a
    matview blocks its DROP, as the reference's are."""
    p.both("create materialized view mv as select id, sal from emp")
    assert p.query("select id, sal from mv order by id") == p.query(
        "select id, sal from emp order by id")
    p.both("begin")
    p.raises("refresh materialized view mv", "transaction block")
    p.both("rollback")
    p.both("create view over_mv as select id from mv")
    p.raises("drop materialized view mv", "depend on it")
    p.both("drop view over_mv")
    p.both("refresh materialized view mv")
    p.both("drop materialized view mv")


def test_create_table_as(p):
    p.both("create table eng_copy as select id, sal * 2 as dbl from emp"
           " where dept = 'eng'")
    assert p.query("select id, dbl from eng_copy order by id") == [
        (1, 200), (2, 400)]
    p.both("insert into eng_copy values (9, 999)")
    assert p.query("select count(*) from eng_copy") == [(3,)]
    p.raises("create table eng_copy as select 1 is not null as x",
             "already exists")


def test_ctas_from_view_and_text_reencoded(p):
    """CREATE TABLE AS re-encodes TEXT through the new table's own
    dictionary: the copy compares and groups on its own codes."""
    p.both("create view small as select id, dept from emp where sal < 150")
    p.both("create table snap as select id, dept from small")
    assert p.query("select id from snap order by id") == [(1,), (3,)]
    assert p.query("select dept, count(*) from snap where dept = 'ops'"
                   " group by dept") == [("ops", 1)]
    assert p.query("select dept from snap where dept < 'f'") == [("eng",)]
    meta = p.ps.cluster.catalog.get("snap")
    assert meta.dist.strategy.value == "roundrobin"
    assert meta.dictionaries["dept"].values == ["eng", "ops"]


def test_drop_rejected_while_views_depend(p):
    p.both("create view dep1 as select id from emp")
    p.both("create view dep2 as select id from dep1")
    p.raises("drop table emp", "depend on it")
    p.raises("drop view dep1", "depend on it")
    p.both("drop view dep2")
    p.both("drop view dep1")
    p.both("drop table emp")


def test_drop_table_cascade_drops_dependent_views(p):
    p.both("create view dep1 as select id from emp")
    p.both("create view dep2 as select id from dep1")
    p.both("drop table emp cascade")
    assert p.ps.cluster.views == {} and p.rs.cluster.views == {}
    p.raises("select * from dep2", "dep2")


def test_ctes_expand_as_statement_scoped_views():
    pair = Pair()
    pair.both("create table t (k bigint, g bigint, v bigint) "
              "distribute by shard(k)")
    pair.both("insert into t values (1,1,10),(2,1,20),(3,2,30),(4,2,5)")
    for sql in [
        "with big as (select * from t where v > 15) "
        "select count(*) from big",
        "with big as (select * from t where v > 15), "
        "bigger as (select * from big where v > 25) select k from bigger",
        "with a (x) as (select k from t where k < 3) select sum(x) from a",
        "with a as (select k from t), b as (select k from t where k > 2) "
        "select count(*) from a join b on a.k = b.k",
        "select (with m as (select max(v) as mv from t) select mv from m)",
        "select k from t where k in (with w as "
        "(select k from t where v > 15) select k from w) order by k",
        "with q as (select g, sum(v) as sv from t group by g) "
        "select g from q where sv > 30 order by g",
        "with recursive r as (select 1 as one) select * from r",
    ]:
        pair.query(sql)
    pair.both("create view vv as select * from t where v > 15")
    assert pair.query("select count(*) from vv") == [(2,)]
    assert pair.query(
        "with vv as (select k from t) select count(*) from vv") == [(4,)]
    pair.both("create view wv as with base as (select * from t where g = 2)"
              " select sum(v) as s2 from base")
    assert pair.query("select s2 from wv") == [(35,)]
    # a recursive CTE below the top level is refused in both, by the
    # same expansion check
    pair.raises("select * from (with recursive r(n) as"
                " (select 1 union all select n+1 from r where n < 3)"
                " select * from r) d", "top level")


def test_cte_scoping_and_dependencies():
    """tests/test_views.py's scoping regressions (the UPDATE whose SET
    holds a WITH subquery is left out: a scalar subquery in UPDATE is
    refused by the port's DML)."""
    pair = Pair()
    pair.both("create table t (k bigint, v bigint) distribute by shard(k)")
    pair.both("insert into t values (1,10),(2,20),(3,30)")
    assert pair.query("with a as (select 1 as x) select (with a as "
                      "(select 2 as x) select x from a)") == [(2,)]
    assert pair.query("select * from (with a as (select 1 as x) "
                      "select * from a) s") == [(1,)]
    pair.raises("with a as (select 1 as x), a as (select 2 as x) "
                "select * from a", "more than once")
    pair.both("create table u2 (k bigint) distribute by shard(k)")
    pair.both("create view cv as with b as (select * from u2) "
              "select count(*) as c from b")
    pair.raises("drop table u2", "depend")
    pair.both("create view v1 as select * from t where v > 15")
    pair.both("create view wv as with b as (select * from v1) "
              "select count(*) as c from b")
    assert pair.query("select c from wv") == [(2,)]


def test_recursive_keyword_without_recursion():
    """RECURSIVE over CTEs that do not recurse is a plain WITH (the
    reference's _materialize_recursive_ctes returns None there)."""
    pair = Pair()
    assert pair.query(
        "with recursive x as (select 42 as v) select v from x") == [(42,)]
    pair.both("create table t (k bigint) distribute by shard(k)")
    pair.both("insert into t values (1),(2)")
    assert pair.query("with recursive a as (select k from t), b as "
                      "(select k from a where k > 1) select k from b") == [
        (2,)]


@pytest.mark.parametrize("sql", [
    "with recursive t(n) as (select 1 union all select n+1 from t"
    " where n < 5) select sum(n) from t",
    "create table seq5 as with recursive t(n) as (select 1 union all"
    " select n+1 from t where n < 5) select n from t",
])
def test_with_recursive_that_recurses_answers_as_the_reference(sql):
    """Once refused by name; the port now materializes the fixpoint as
    the reference does (tests/test_torch_recursive_cte.py holds the
    rest)."""
    pair = Pair()
    if sql.startswith("create"):
        pair.both(sql)
        assert pair.query("select count(*), max(n) from seq5") == [(5, 5)]
    else:
        assert pair.query(sql) == [(15,)]


@pytest.fixture()
def ins():
    pair = Pair()
    for sql in [
        "create table src (k bigint, name text, amt numeric(10,2), d date,"
        " x int) distribute by shard(k)",
        "insert into src values (1,'ada',1.50,'2024-01-05',7),"
        " (2,'bob',-2.25,'2024-02-29',null), (3,null,0.00,'2023-12-31',9),"
        " (4,'ada',10.00,null,1), (5,'cy',3.33,'2024-03-01',2)",
        "create table dst (id bigint, who text, money numeric(12,2),"
        " day date, big bigint) distribute by shard(id)",
        "create table rep (who text, n bigint) distribute by replication",
    ]:
        pair.both(sql)
    return pair


def test_insert_select_matches_reference(ins):
    """Rows cast to the target's types (int to bigint, numeric(10,2) to
    numeric(12,2)), TEXT re-encoded into the target's dictionary (which
    holds other values first), NULLs kept, absent columns NULL."""
    ins.both("insert into dst values (100, 'zed', 1, '2020-01-01', 0)")
    ins.both("insert into dst select k, name, amt, d, x from src"
             " where k < 5")
    ins.both("insert into dst (id, who) select k + 10, upper(name)"
             " from src where name is not null")
    assert ins.query("select * from dst order by id") is not None
    assert ins.query("select who, count(*), sum(money) from dst"
                     " group by who order by who") is not None
    assert ins.query("select id from dst where who = 'ada' order by id") \
        == [(1,), (4,)]


def test_insert_select_replicated_and_grouped(ins):
    ins.both("insert into rep select name, count(*) from src"
             " where name is not null group by name")
    assert ins.query("select who, n from rep order by who") == [
        ("ada", 2), ("bob", 1), ("cy", 1)]


def test_insert_select_with_cte_view_and_self(ins):
    ins.both("create view recent as select k, name from src"
             " where d >= date '2024-01-01'")
    ins.both("insert into dst (id, who) with r as (select * from recent)"
             " select k, name from r")
    ins.both("insert into dst (id, who) select id + 100, who from dst")
    assert ins.query("select id, who from dst order by id") is not None
    assert ins.query("select count(*) from dst") == [(6,)]


def test_insert_select_inside_a_transaction(ins):
    """Inside an explicit transaction the source reads the transaction's
    own writes; ROLLBACK takes the inserted rows back."""
    for sql in ["begin",
                "insert into src values (6,'dee',1.00,'2024-04-01',3)",
                "insert into dst (id, who) select k, name from src"
                " where k >= 5"]:
        ins.both(sql)
    for s in (ins.rs, ins.ps):
        assert s.query("select id, who from dst order by id") == [
            (5, "cy"), (6, "dee")]
    ins.both("rollback")
    assert ins.query("select count(*) from dst") == [(0,)]
    ins.both("begin")
    ins.both("insert into dst (id) select k from src")
    ins.both("commit")
    assert ins.query("select count(*), sum(id) from dst") == [(5, 15)]


def test_insert_select_refusals(ins):
    ins.raises("insert into dst select k, name from src",
               "different number of columns")
    # RETURNING, once refused here (the test keeps its name), returns
    # the inserted rows as the reference's does
    assert sorted(ins.both("insert into dst (id) select k from src where"
                           " k < 3 returning id").rows) == [(1,), (2,)]

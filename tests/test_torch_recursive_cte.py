"""WITH RECURSIVE in the port (engine.py ``_materialize_recursive_ctes``,
``_recursive_union``; sql/deparse.py; plan/astwalk.rename_relations),
held against the reference on tests/test_recursive_cte.py's cases: a
self-referencing CTE is evaluated to its fixpoint into temporary tables
before analysis (the non-recursive term materialized, the recursive
term run over the previous iteration's rows, UNION less every row seen,
UNION ALL appending), and every answer, error and EXPLAIN line must
equal the reference's, with the fused route on and off, on 1 and 2
datanodes. No temporary table outlives its statement."""

import threading

import pytest

from torch_pair import Pair

EDGES = [
    "create table edges (k bigint, src bigint, dst bigint)"
    " distribute by shard(k)",
    "insert into edges values (1,1,2),(2,2,3),(3,3,1),(4,3,4)",
]


@pytest.fixture(scope="module", params=[1, 2], ids=["1dn", "2dn"])
def p(request):
    pair = Pair(nd=request.param, shard_groups=16)
    for sql in EDGES:
        pair.both(sql)
    yield pair
    pair.close()


def no_rec_temps(p):
    for c in (p.rc, p.pc):
        assert [n for n in c.catalog._tables if n.startswith("__rec")] == []


def test_counter_union_all(p):
    assert p.query("with recursive t(n) as"
                   " (select 1 union all select n+1 from t where n < 5)"
                   " select sum(n), count(*) from t") == [(15, 5)]
    assert p.ps.recursive_iterations == {"t": 5}
    no_rec_temps(p)


def test_cycle_terminates_under_union(p):
    assert p.query("with recursive reach(node) as ("
                   " select 2 union"
                   " select e.dst from edges e join reach r on e.src = r.node"
                   ") select node from reach order by node") == [
        (1,), (2,), (3,), (4,)]
    no_rec_temps(p)


def test_delta_semantics_union_all(p):
    assert p.query("with recursive b(m) as"
                   " (select 10 union all select m+1 from b where m < 12)"
                   " select sum(m) from b") == [(33,)]


def test_second_cte_uses_first(p):
    assert p.query("with recursive a(n) as"
                   " (select 1 union all select n+1 from a where n < 3),"
                   " b(m) as (select n*10 from a union all"
                   "          select m+1 from b where m < 12)"
                   " select sum(m) from b") == [(83,)]


def test_plain_cte_after_recursive(p):
    assert p.query("with recursive t(n) as"
                   " (select 1 union all select n+1 from t where n < 4),"
                   " doubled as (select n*2 as d from t)"
                   " select sum(d) from doubled") == [(20,)]


def test_recursive_keyword_without_recursion(p):
    assert p.query("with recursive x as (select 42 as v) select v from x"
                   ) == [(42,)]


def test_text_columns_roundtrip(p):
    p.both("create table if not exists nm (k bigint, label text) "
           "distribute by shard(k)")
    p.both("truncate table nm")
    p.both("insert into nm values (1,'uno'),(2,'dos'),(3,'tres'),(4,'vier')")
    assert p.query("with recursive r(node, label) as ("
                   " select 1, 'start'"
                   " union"
                   " select e.dst, nm.label from edges e"
                   "  join r on e.src = r.node join nm on nm.k = e.dst"
                   ") select node, label from r order by node, label") == [
        (1, "start"), (1, "uno"), (2, "dos"), (3, "tres"), (4, "vier")]


def test_into_insert_and_ctas(p):
    p.both("create table fib (i bigint, f bigint) distribute by shard(i)")
    p.both("insert into fib"
           " with recursive fb(i, a, b) as ("
           "  select 1, 0, 1"
           "  union all select i+1, b, a+b from fb where i < 8"
           " ) select i, a from fb")
    assert p.query("select f from fib order by i") == [
        (0,), (1,), (1,), (2,), (3,), (5,), (8,), (13,)]
    p.both("create table seq5 as with recursive t(n) as"
           " (select 1 union all select n+1 from t where n < 5)"
           " select n from t")
    assert p.query("select count(*), max(n) from seq5") == [(5, 5)]
    for sql in ("drop table fib", "drop table seq5"):
        p.both(sql)
    no_rec_temps(p)


@pytest.mark.parametrize("sql,match", [
    ("with recursive t(n) as (select n+1 from t where n < 3)"
     " select * from t", "UNION"),
    ("with recursive t(n) as (select n from t union all select 1)"
     " select * from t", "non-recursive term"),
    ("with recursive t(n) as (select 1 union all"
     " select a.n + b.n from t a, t b) select * from t", "exactly once"),
    ("with recursive t(n) as (select 1 union all"
     " select n+1 from t where n < 3 order by n) select * from t",
     "ORDER BY"),
    ("with recursive t(n) as (select 1 union all select n+1 from t)"
     " select count(*) from t", "recursion limit"),
    ("with recursive t(n) as (select 1 intersect select n+1 from t)"
     " select * from t", "UNION"),
])
def test_malformed_and_limits(p, sql, match, monkeypatch):
    monkeypatch.setenv("OTB_MAX_RECURSION", "20")
    p.raises(sql, match)
    no_rec_temps(p)


def test_recursive_body_uses_earlier_plain_sibling(p):
    assert p.query("with recursive seed as (select 1 as n),"
                   " t(n) as (select n from seed"
                   "          union all select n+1 from t where n < 3)"
                   " select n from t order by n") == [(1,), (2,), (3,)]


def test_explain_recursive_plain(p):
    """Plain EXPLAIN prints the Recursive Union's shape, the same lines
    as the reference's, executing nothing and leaving no table."""
    sql = ("explain with recursive t(n) as"
           " (select 1 union all select n+1 from t where n < 3)"
           " select * from t")
    before = set(p.pc.catalog.table_names())
    got = [r[0] for r in p.both(sql).rows]
    text = "\n".join(got)
    assert 'Recursive Union "t" (UNION ALL)' in text
    assert "Non-recursive term:" in text and "Recursive term:" in text
    assert "__recshape_" not in text
    assert set(p.pc.catalog.table_names()) == before
    assert p.ps._explain_prelude == [] and p.ps._explain_rename == {}


def test_explain_analyze_recursive_executes(p):
    sql = ("explain analyze with recursive t(n) as"
           " (select 1 union all select n+1 from t where n < 3)"
           " select count(*) from t")
    for s in (p.rs, p.ps):
        text = "\n".join(r[0] for r in s.query(sql))
        assert "Total: rows=1" in text
    no_rec_temps(p)


def test_concurrent_sessions_no_collision(p):
    """Temporary names are unique across the cluster, not per session."""
    for c in (p.rc, p.pc):
        results = {}

        def run(tag, c=c):
            results[tag] = c.session().query(
                "with recursive t(n) as"
                " (select 1 union all select n+1 from t where n < 6)"
                " select sum(n) from t")

        ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert all(results[i] == [(21,)] for i in range(3))
    no_rec_temps(p)


def test_refused_on_a_read_only_cluster(p):
    """A hot standby refuses a recursive query with the reference's
    message (materializing it writes tables)."""
    sql = ("with recursive t(n) as (select 1 union all select n+1 from t"
           " where n < 3) select count(*) from t")
    for c in (p.rc, p.pc):
        c.read_only = True
    try:
        p.raises(sql, "read-only")
    finally:
        for c in (p.rc, p.pc):
            c.read_only = False


def test_hierarchy_under_a_manager():
    """The PostgreSQL manual's hierarchy walk: the reports under one
    manager with their count and summed salary, UNION ALL over a tree."""
    pair = Pair(shard_groups=16)
    pair.both("create table emp (id bigint, mgr bigint, salary bigint)"
              " distribute by shard(id)")
    rows = ["(1, null, 100)"] + [f"({i}, {(i - 2) // 3 + 1}, {i * 7 % 50})"
                                 for i in range(2, 60)]
    pair.both("insert into emp values " + ",".join(rows))
    sql = ("with recursive sub(id, salary) as ("
           " select id, salary from emp where id = 2"
           " union all select e.id, e.salary from emp e join sub s"
           " on e.mgr = s.id) select count(*), sum(salary) from sub")
    got = pair.query(sql)
    assert got[0][0] > 1
    assert pair.ps.recursive_iterations["sub"] >= 3
    pair.close()

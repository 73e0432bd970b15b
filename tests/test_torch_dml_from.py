"""UPDATE ... FROM, DELETE ... USING, RETURNING, INSERT VALUES holding
expressions and UPDATE with a scalar subquery in the port, held against
the reference: the same statements go to a reference and a port cluster
(tests/torch_pair.py), reads with the fused route on and off, every
answer, returned row and error equal. The port's join runs on the
cluster's device and gathers only the target columns the statement
reads; the answers are the reference's, which gathers them all."""

import pytest

from torch_pair import Pair

SETUP = (
    "create table o (ok bigint, ck bigint, pri text, tot numeric(12,2), "
    "w float8) distribute by shard(ok)",
    "create table c (ck bigint primary key, nat int, bal numeric(12,2), "
    "seg text) distribute by shard(ck)",
    "create table keys (k bigint primary key) distribute by replication",
)


@pytest.fixture(params=["on", "off"])
def p(request):
    pair = Pair()
    for sql in SETUP:
        pair.both(sql)
    pair.both("insert into o values " + ",".join(
        f"({i}, {i % 13 + 1}, '{['1-URGENT', '2-HIGH', '3-MEDIUM'][i % 3]}',"
        f" {i * 7 % 1000}.{i % 100:02d}, {i / 8})" for i in range(1, 121)))
    pair.both("insert into c values " + ",".join(
        f"({k}, {k % 4}, {(k * 37) % 200 - 100}.50, "
        f"{'null' if k % 5 == 0 else repr('seg%d' % (k % 3))})"
        for k in range(1, 14)))
    pair.both("insert into keys values (3), (17), (40), (41), (999)")
    pair.set_fused(request.param)
    yield pair
    pair.close()


def test_update_from(p):
    r = p.both("update o set pri = '1-URGENT' from c where o.ck = c.ck "
               "and c.nat = 2 and c.bal < 0")
    assert r.rowcount > 0
    p.query("select pri, count(*) from o group by pri order by pri")
    p.both("update o set tot = tot + c.bal, w = w * 2 from c "
           "where c.ck = o.ck and c.seg = 'seg1'")
    p.query("select ok, tot, w from o order by ok")


def test_update_from_with_alias_and_returning(p):
    r = p.both("update o x set pri = s.seg from c s where x.ck = s.ck and "
               "s.nat = 1 returning ok, pri")
    assert r.rows and all(len(row) == 2 for row in r.rows)
    p.query("select pri, count(*) from o group by pri order by pri "
            "nulls first")


def test_delete_using_returning(p):
    r = p.both("delete from o using keys where o.ok = keys.k "
               "returning ok, ck")
    assert sorted(r.rows) == [(3, 4), (17, 5), (40, 2), (41, 3)]
    assert p.query("select count(*) from o") == [(116,)]
    p.both("delete from o using c where o.ck = c.ck and c.seg is null")
    p.query("select count(*), sum(tot) from o")


def test_delete_using_in_a_transaction(p):
    p.both("begin")
    p.both("insert into keys values (5), (6)")
    r = p.both("delete from o using keys where ok = k returning *")
    assert len(r.rows) == 6
    p.query("select count(*) from o")
    p.both("rollback")
    assert p.query("select count(*) from o") == [(120,)]


def test_update_from_replicated_target(p):
    p.both("create table rt (k bigint, v bigint) distribute by replication")
    p.both("insert into rt values (3, 0), (17, 0), (99, 0)")
    assert p.both("update rt set v = keys.k * 2 from keys where "
                  "rt.k = keys.k").rowcount == 2
    assert p.query("select k, v from rt order by k") == [
        (3, 6), (17, 34), (99, 0)]
    for c in (p.rc, p.pc):
        snap = c.gts.snapshot_ts()
        assert [len(c.stores[n]["rt"].live_index(snap))
                for n in c.catalog.get("rt").node_indices] == [3, 3]


def test_dml_from_refusals(p):
    p.raises("update o set pri = 'x' from c", "require a WHERE")
    p.raises("update o set pri = 'x' from c where c.nat = 1",
             "need an equality")
    p.raises("delete from o using c where o.ck = c.ck and c.bal > "
             "(select avg(bal) from c)", "subqueries are not supported")
    p.raises("delete from o using c where o.ck = c.ck and c.ck in "
             "(select ck from c)", "only supported in WHERE")
    p.raises("update o set nope = 1 from c where o.ck = c.ck",
             "does not exist")
    p.raises("update o set pri = 'x' from c where o.ck = c.ck "
             "returning c.seg", "invalid reference")


def test_returning_on_insert_update_delete(p):
    r = p.both("insert into c values (100, 1, 2.25, 'n') returning ck, "
               "bal, seg as s")
    assert r.columns == ["ck", "bal", "s"]
    assert r.rows == [(100, 2.25, "n")]
    r = p.both("update c set bal = bal * 2 where nat = 1 returning *")
    assert len(r.rows) == r.rowcount > 0
    r = p.both("delete from c where seg = 'n' returning ck")
    assert r.rows == [(100,)]
    p.raises("insert into c values (101, 1, 1, 'x') returning nope",
             "does not exist")
    p.raises("update c set bal = 0 returning ck + 1", "column references")
    # a refused RETURNING list writes nothing
    assert p.query("select count(*) from c where ck = 101") == [(0,)]
    assert p.query("select count(*) from c where bal = 0") == [(0,)]


def test_insert_values_holding_expressions(p):
    p.both("insert into c values (200, 1 + 2, cast('7.25' as numeric(12,2))"
           ", upper('abc'))")
    p.both("insert into c (ck, nat, bal) values (201, 2 * 3, 1.5 + 1), "
           "(202, -1, -(4.75))")
    p.both("insert into o values (500, 200, 'x' || 'y', 12.5 * 2, 1e3 / 8)")
    p.raises("insert into c (nat) values (1 + 1)", "not-null")
    p.raises("insert into c values (3, 4 - 1, 1, 'a')", "duplicate key")
    p.query("select ck, nat, bal, seg from c where ck >= 200 order by ck")
    p.query("select ok, pri, tot, w from o where ok = 500")


def test_update_with_scalar_subquery(p):
    p.both("update c set bal = (select max(bal) from c) where ck = 1")
    p.both("update o set w = (select avg(w) from o where ck = 2) "
           "where ok < 5")
    p.both("delete from o where tot > (select avg(tot) from o)")
    p.raises("update c set bal = (select bal from c) where ck = 2",
             "more than one row")
    p.query("select ck, bal from c order by ck")
    p.query("select count(*), sum(w) from o")

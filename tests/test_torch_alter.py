"""TRUNCATE and ALTER TABLE (ADD COLUMN, DROP COLUMN, DISTRIBUTE BY) in
the port, held against the reference on tests/test_alter.py's cases
(the partitioned tables' are tests/test_torch_partition.py's): the same statements go to a reference and a port cluster
(tests/torch_pair.py), reads with the fused route on and off, every
answer and error equal. Each DDL record recovers in both packages, from
either one's data directory. After TRUNCATE, a redistribution or a DROP
then ADD COLUMN, the port's fused route answers from the new rows; the
reference's fused route answers from the old planes after the first two
(ROADMAP C), so its host route is the oracle there."""

import pytest

from torch_pair import Pair, recover_clusters


@pytest.fixture()
def p():
    pair = Pair(shard_groups=32)
    yield pair
    pair.close()


def test_add_column_null_fill_and_use(p):
    p.both("create table t (k bigint, v text) distribute by shard(k)")
    p.both("insert into t values (1,'a'),(2,'b')")
    p.both("alter table t add column score float8")
    assert p.query("select k, score from t order by k") == [
        (1, None), (2, None)]
    p.both("insert into t values (3,'c')")
    p.both("update t set score = 9.5 where k = 3")
    assert p.query("select k from t where score is not null") == [(3,)]
    p.both("alter table t add column tag text")
    p.both("update t set tag = 'new' where k = 1")
    assert p.query("select tag from t order by k") == [
        ("new",), (None,), (None,)]
    p.raises("alter table t add column tag text", "already exists")


def test_drop_column_and_guards(p):
    p.both("create table t (k bigint, v text, x bigint) "
           "distribute by shard(k)")
    p.both("insert into t values (1,'a',10)")
    p.both("alter table t drop column x")
    assert p.query("select * from t") == [(1, "a")]
    p.raises("alter table t drop column k", "distribution key")
    p.raises("alter table t drop column nope", "does not exist")
    p.raises("alter table nope add column y int", "does not exist")


def test_redistribute_shard_to_replicated_and_back(p):
    p.both("create table t (k bigint, v text) distribute by shard(k)")
    p.both("insert into t values (1,'a'),(2,'b'),(3,'c'),(4,'d')")
    assert p.both("alter table t distribute by replication").rowcount == 4
    for c in (p.rc, p.pc):
        for n in c.catalog.get("t").node_indices:
            assert c.stores[n]["t"].nrows == 4
    assert p.query("select count(*) from t") == [(4,)]
    p.both("alter table t distribute by hash(k)")
    for c in (p.rc, p.pc):
        assert sum(c.stores[n]["t"].nrows
                   for n in c.catalog.get("t").node_indices) == 4
    assert p.query("select k from t order by k") == [(1,), (2,), (3,), (4,)]
    p.both("insert into t values (5,'e')")  # the new locator routes
    assert p.query("select count(*) from t") == [(5,)]
    p.both("alter table t distribute by modulo(k)")
    p.query("select k, v from t where k = 3")
    p.raises("alter table t distribute by hash(nope)", "not a column")
    p.raises("alter table t distribute by bogus(k)", "unknown distribution")


def test_redistribute_drops_dead_versions(p):
    p.both("create table t (k bigint) distribute by shard(k)")
    p.both("insert into t values (1),(2),(3)")
    p.both("delete from t where k = 2")
    p.both("alter table t distribute by roundrobin")
    assert p.query("select k from t order by k") == [(1,), (3,)]
    for c in (p.rc, p.pc):  # the rewrite vacuumed
        assert sum(c.stores[n]["t"].nrows
                   for n in c.catalog.get("t").node_indices) == 2


def test_redistribute_blocked_by_prepared_txn(p):
    p.both("create table t (k bigint) distribute by shard(k)")
    p.both("insert into t values (1),(2)")
    p.both("begin")
    p.both("insert into t values (99)")
    p.both("prepare transaction 'hold'")
    p.raises("alter table t distribute by roundrobin", "prepared")
    p.both("commit prepared 'hold'")
    p.both("alter table t distribute by roundrobin")
    assert p.query("select count(*) from t") == [(3,)]


def test_truncate(p):
    p.both("create table t (k bigint, v text) distribute by shard(k)")
    p.both("create table u (k bigint) distribute by replication")
    p.both("insert into t values (1,'a'),(2,'b')")
    p.both("insert into u values (7)")
    p.both("truncate table t, u")
    assert p.query("select count(*) from t") == [(0,)]
    assert p.query("select count(*) from u") == [(0,)]
    p.both("insert into t values (3,'a'),(4,'c')")  # the dictionary stays
    assert p.query("select k, v from t order by k") == [(3, "a"), (4, "c")]
    assert p.rc.catalog.get("t").dictionaries["v"].values == \
        p.pc.catalog.get("t").dictionaries["v"].values


def test_truncate_refused_while_a_transaction_holds_the_table(p):
    """The port refuses a TRUNCATE of a table an open transaction has
    written (its positions point into the stores TRUNCATE replaces);
    the reference replaces them under the transaction."""
    p.both("create table t (k bigint) distribute by shard(k)")
    other = p.pc.session()
    other.execute("begin")
    other.execute("insert into t values (1)")
    with pytest.raises(Exception, match="open or prepared transactions"):
        p.ps.execute("truncate table t")
    other.execute("commit")
    p.ps.execute("truncate table t")
    assert p.ps.query("select count(*) from t") == [(0,)]


def test_add_partitions_answers_as_the_reference(p):
    """Once refused by name: ADD PARTITIONS of a table that is not
    partitioned fails as the reference's does, and of a partitioned one
    extends its range (tests/test_torch_partition.py holds the rest)."""
    p.both("create table m (id bigint, ts bigint) distribute by shard(id)")
    p.raises("alter table m add partitions (2)", "not a partitioned table")
    p.both("create table mp (id bigint, ts bigint) partition by range (ts)"
           " begin (0) step (10) partitions (1) distribute by shard(id)")
    p.raises("insert into mp values (1, 15)", "out of range")
    p.both("alter table mp add partitions (2)")
    p.both("insert into mp values (1, 15), (2, 25)")
    assert p.query("select count(*) from mp$p2") == [(1,)]


STALE = {
    "truncate": ("truncate table t",
                 "insert into t values (1, 1000), (2, 2000)"),
    # a redistribution, then one stamp on each node: the new stores
    # stand at the old versions
    "redistribute": ("alter table t distribute by roundrobin",
                     "delete from t where v > 40"),
    "drop_then_add_column": ("alter table t drop column v",
                             "alter table t add column v bigint",
                             "update t set v = k * 500"),
}


@pytest.mark.parametrize("case", sorted(STALE))
def test_fused_route_answers_from_the_new_rows(p, case):
    """TRUNCATE, DISTRIBUTE BY and DROP then ADD COLUMN free the table's
    device planes: the port's fused route answers from the new rows.
    (The reference's fused route answers from the old planes after
    TRUNCATE and DISTRIBUTE BY: its host route is the oracle.)"""
    p.both("create table t (k bigint, v bigint) distribute by shard(k)")
    if case == "truncate":
        p.both("insert into t values (1, 10), (2, 20)")
    else:
        p.both("insert into t values " + ",".join(
            f"({k}, {10 * k})" for k in range(1, 9)))
        p.both("delete from t where v % 20 = 10")
    q = "select sum(v), count(*) from t"
    before = p.query(q, fused=("on",))
    fx = p.pc.fused_executor()
    assert any(k[0] == "t" for k in fx.cache._tables)
    old = [st["t"].version for st in p.pc.stores.values()]
    for sql in STALE[case]:
        p.both(sql)
    p.set_fused("off")
    want = p.rs.query(q)
    assert p.ps.query(q) == want and want != before
    p.set_fused("on")
    assert p.ps.query(q) == want
    assert p.ps.last_route == "fused"
    stale = p.rs.query(q)
    if case == "drop_then_add_column":
        assert stale == want
    else:
        # the new stores stand at the old versions, and the reference's
        # fused route reads the old planes
        assert [st["t"].version for st in p.pc.stores.values()] == old
        assert stale == before != want


RECOVERY = {
    "truncate": ("truncate table t", "insert into t values (7, 'x')"),
    "add_column": ("alter table t add column score float8",
                   "update t set score = 1.5 where k = 1",
                   "insert into t values (3, 'c', 2.5)"),
    "drop_column": ("alter table t drop column v",
                    "insert into t values (3)"),
    "drop_readd_text": ("alter table t drop column v",
                        "alter table t add column v text",
                        "insert into t values (3,'p')",
                        "update t set v = 'q' where k = 1"),
    "redistribute": ("alter table t distribute by replication",
                     "insert into t values (3, 'c')",
                     "delete from t where k = 2"),
}


@pytest.mark.parametrize("swap", [False, True], ids=["own", "other"])
@pytest.mark.parametrize("case", sorted(RECOVERY))
def test_ddl_records_recover_in_both_packages(tmp_path, case, swap):
    """Each DDL record replays from the WAL (a redistribution from the
    checkpoint that follows it), in its own package and in the other."""
    d = str(tmp_path)
    p = Pair(shard_groups=32, data_dir=d)
    p.both("create table t (k bigint, v text) distribute by shard(k)")
    p.both("insert into t values (1,'a'),(2,'b')")
    for sql in RECOVERY[case]:
        p.both(sql)
    q = "select * from t order by k"
    want = p.query(q)
    r = Pair(shard_groups=32, clusters=recover_clusters(d, shard_groups=32,
                                                        swap=swap))
    assert r.query(q) == want
    for c in (r.rc, r.pc):
        meta = c.catalog.get("t")
        assert list(meta.schema) == list(p.pc.catalog.get("t").schema)
        assert meta.dist.strategy.value == p.pc.catalog.get(
            "t").dist.strategy.value
    r.both("insert into t select * from t")  # the recovered table writes
    r.query("select count(*) from t")
    r.close()

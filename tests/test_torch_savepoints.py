"""SAVEPOINT, ROLLBACK TO SAVEPOINT and RELEASE SAVEPOINT in the port,
held against the reference on tests/test_savepoints.py's cases: the
same statements go to a reference ``Cluster(num_datanodes=2)`` and a port
``Cluster(..., device="cpu")`` (tests/torch_pair.py), each read with the
fused route on and off, every answer and error equal. Beyond the
reference's cases: the write set shipped to datanode processes after a
rollback-to is the surviving one, and the device cache answers for the
rows a rollback-to left dead."""

import numpy as np
import pytest

from torch_pair import Pair

BASE = ("create table t (k bigint, v text) distribute by shard(k)",
        "insert into t values (1,'base')")


@pytest.fixture()
def p():
    pair = Pair()
    for sql in BASE:
        pair.both(sql)
    yield pair
    pair.close()


def test_rollback_to_savepoint_undoes_partially(p):
    p.both("begin")
    p.both("insert into t values (2,'keep')")
    p.both("savepoint sp1")
    p.both("insert into t values (3,'drop')")
    p.both("delete from t where k = 1")
    assert p.query("select count(*) from t") == [(2,)]
    p.both("rollback to savepoint sp1")
    assert p.query("select k from t order by k") == [(1,), (2,)]
    p.both("commit")
    assert p.query("select k from t order by k") == [(1,), (2,)]


def test_savepoint_reusable_after_rollback(p):
    p.both("begin")
    p.both("savepoint a")
    p.both("insert into t values (10,'x')")
    p.both("rollback to savepoint a")
    p.both("insert into t values (11,'y')")
    p.both("rollback to savepoint a")  # it survives; undoes 11 too
    p.both("insert into t values (12,'z')")
    p.both("commit")
    assert p.query("select k from t order by k") == [(1,), (12,)]


def test_nested_savepoints_and_release(p):
    p.both("begin")
    p.both("savepoint outer1")
    p.both("insert into t values (20,'a')")
    p.both("savepoint inner1")
    p.both("insert into t values (21,'b')")
    p.both("rollback to savepoint inner1")
    p.both("release savepoint outer1")  # destroys outer1 AND inner1
    p.raises("rollback to savepoint inner1", "does not exist")
    p.both("commit")
    assert p.query("select k from t order by k") == [(1,), (20,)]


def test_savepoint_outside_txn_rejected(p):
    p.raises("savepoint nope", "transaction blocks")
    p.raises("rollback to savepoint nope", "transaction blocks")
    p.raises("release savepoint nope", "transaction blocks")


def test_full_rollback_discards_savepoint_work(p):
    p.both("begin")
    p.both("savepoint sp")
    p.both("insert into t values (30,'gone')")
    p.both("rollback")
    assert p.query("select count(*) from t") == [(1,)]


def test_update_rolled_back_to_savepoint(p):
    p.both("begin")
    p.both("savepoint sp")
    p.both("update t set v = 'changed' where k = 1")
    assert p.query("select v from t where k = 1") == [("changed",)]
    p.both("rollback to savepoint sp")
    assert p.query("select v from t where k = 1") == [("base",)]
    p.both("commit")
    assert p.query("select v from t where k = 1") == [("base",)]


def test_rollback_to_savepoint_clears_2pc_participation(p):
    """A node whose writes were all undone is no 2PC participant."""
    p.both("begin")
    p.both("savepoint before_all")
    # spans both datanodes; all of it rolled back
    p.both("insert into t values (100,'a'),(101,'b'),(102,'c'),(103,'d')")
    txns = (p.rs.txn, p.ps.txn)
    assert [len(x.touched_nodes()) for x in txns] == [2, 2]
    p.both("rollback to savepoint before_all")
    assert [x.touched_nodes() for x in txns] == [[], []]
    p.both("insert into t values (200,'z')")  # one node again
    assert [len(x.touched_nodes()) for x in txns] == [1, 1]
    p.both("commit")
    for c in (p.rc, p.pc):
        assert [i.gid for i in c.gts.prepared_txns()] == []
    assert p.query("select v from t where k = 200") == [("z",)]


def test_shipped_write_set_is_the_surviving_one(p):
    """The frame a commit ships to datanode processes (the 2PC journal's
    write set) holds the rows that survived the rollback-to, and no
    range the rollback undid."""
    p.both("begin")
    p.both("insert into t values (300,'keep'),(301,'keep')")
    p.both("savepoint s")
    p.both("insert into t values (302,'gone'),(303,'gone'),(304,'gone')")
    p.both("delete from t where k = 1")
    p.both("rollback to savepoint s")
    sub, arrays = p.ps._txn_write_frame(p.ps.txn)
    rows = [r for r in sub if r.get("kind") == "ins"]
    assert sum(r["nrows"] for r in rows) == 2
    assert not [r for r in sub if r.get("kind") == "del"]
    keys = np.concatenate([arrays[f"w{i}_k"] for i, r in enumerate(sub)
                           if r.get("kind") == "ins"])
    assert sorted(keys.tolist()) == [300, 301]
    p.both("commit")
    assert p.query("select k from t order by k") == [
        (1,), (300,), (301,)]


def test_device_cache_after_rollback_to_savepoint(p):
    """The fused route's planes, warm before the transaction, answer
    after it without the rows the rollback-to left dead; inside the
    transaction the read takes the host route with its own writes (the
    fused route declines a writing transaction, as the reference's)."""
    p.both("insert into t values " + ",".join(
        f"({k},'w{k % 3}')" for k in range(2, 60)))
    q = "select count(*), sum(k) from t"
    p.query(q)
    fx = p.pc.fused_executor()
    assert fx.cache.stats["full_uploads"] == 1
    p.both("begin")
    p.both("insert into t values (1000,'x'),(1001,'y')")
    p.both("savepoint s")
    p.both("insert into t values " + ",".join(
        f"({k},'z')" for k in range(2000, 2040)))
    p.both("delete from t where k < 10")
    p.both("rollback to savepoint s")
    assert p.query(q, fused=("on",)) == [(61, 3771)]
    assert p.ps.last_route == "host"
    p.both("commit")
    replays = fx.cache.stats["mvcc_replays"]
    assert p.query(q, fused=("on",)) == [(61, 3771)]
    assert p.ps.last_route == "fused"
    # the dead rows reached the planes as replayed stamps or a rebuild
    assert (fx.cache.stats["mvcc_replays"] > replays
            or fx.cache.stats["full_uploads"] > 1)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_savepoints_around_failed_statements(p, fused):
    """A failed statement rolls back to its own mark and leaves the
    named savepoints as they were."""
    p.set_fused(fused)
    p.both("create table u (k bigint primary key, v text not null) "
           "distribute by shard(k)")
    p.both("insert into u values (1,'a')")
    p.both("begin")
    p.both("savepoint a")
    p.both("insert into u values (2,'b')")
    p.raises("insert into u values (3,'c'),(1,'dup')", "duplicate key")
    p.both("savepoint b")
    p.raises("update u set v = null where k = 2", "not-null")
    p.both("insert into u values (4,'d')")
    p.both("rollback to savepoint b")
    assert p.query("select k, v from u order by k") == [(1, "a"), (2, "b")]
    p.both("release savepoint a")
    p.raises("rollback to savepoint b", "does not exist")
    p.both("commit")
    assert p.query("select k, v from u order by k") == [(1, "a"), (2, "b")]

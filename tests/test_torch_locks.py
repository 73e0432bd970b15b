"""SELECT ... FOR UPDATE / FOR SHARE [NOWAIT], LOCK TABLE and the lock
waits' settings (lock_timeout, deadlock_timeout) in the port, on
tests/test_locks.py's cases. Each case runs on a reference and on a port
cluster (``pkg``) with the same statements and the same expected
outcomes; concurrency is real threads, each statement under the
cluster's statement lock as the wire servers run it (a lock wait drops
that lock). pg_unlock's functions, the pg_locks view and the victim
markers are held in tests/test_torch_unlock.py, the partitioned table's
case in tests/test_torch_partition.py."""

import threading
import time

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster


def _cluster(pkg):
    if pkg == "ref":
        return RefCluster(num_datanodes=2, shard_groups=32)
    return Cluster(num_datanodes=2, shard_groups=32, device="cpu")


@pytest.fixture(params=["ref", "port"])
def c(request):
    cluster = _cluster(request.param)
    s = cluster.session()
    s.execute("create table acct (id bigint primary key, bal bigint) "
              "distribute by shard(id)")
    s.execute("insert into acct values (1,100),(2,200),(3,300),(4,400)")
    yield cluster
    cluster.close()


def run(cluster, session, sql):
    """As the wire servers run a statement: under the statement lock."""
    with cluster._exec_lock:
        return session.execute(sql)


def _sqlerror(c):
    mod = __import__(type(c).__module__, fromlist=["SQLError"])
    return mod.SQLError


def test_for_update_blocks_concurrent_update(c):
    s1, s2 = c.session(), c.session()
    run(c, s1, "begin")
    run(c, s1, "select * from acct where id = 1 for update")
    done = []

    def writer():
        run(c, s2, "update acct set bal = 0 where id = 1")
        done.append(time.monotonic())

    th = threading.Thread(target=writer)
    t0 = time.monotonic()
    th.start()
    time.sleep(0.3)
    assert not done, "UPDATE should wait for FOR UPDATE"
    run(c, s1, "commit")
    th.join(timeout=10)
    assert not th.is_alive()
    assert done and done[0] - t0 >= 0.25
    assert run(c, c.session(),
               "select bal from acct where id = 1").rows == [(0,)]


def test_for_update_nowait_raises(c):
    s1, s2 = c.session(), c.session()
    run(c, s1, "begin")
    run(c, s1, "select * from acct where id = 2 for update")
    run(c, s2, "begin")
    t0 = time.monotonic()
    with pytest.raises(_sqlerror(c), match="could not obtain lock"):
        run(c, s2, "select * from acct where id = 2 for update nowait")
    assert time.monotonic() - t0 < 1.0
    run(c, s1, "rollback")
    assert run(c, s2, "select * from acct where id = 2 for update "
               "nowait").rowcount == 1
    run(c, s2, "rollback")


def test_for_share_coexists_but_blocks_writers(c):
    s1, s2, s3 = c.session(), c.session(), c.session()
    run(c, s1, "begin")
    run(c, s2, "begin")
    run(c, s1, "select * from acct where id = 3 for share")
    run(c, s2, "select * from acct where id = 3 for share")  # no wait
    run(c, s3, "set lock_timeout = 200")
    with pytest.raises(_sqlerror(c), match="lock timeout"):
        run(c, s3, "delete from acct where id = 3")
    run(c, s1, "commit")
    run(c, s2, "commit")


def test_lock_timeout_on_update(c):
    s1, s2 = c.session(), c.session()
    run(c, s1, "begin")
    run(c, s1, "update acct set bal = bal + 1 where id = 1")
    run(c, s2, "set lock_timeout = 150")
    t0 = time.monotonic()
    with pytest.raises(_sqlerror(c), match="lock timeout") as ei:
        run(c, s2, "update acct set bal = bal - 1 where id = 1")
    assert time.monotonic() - t0 < 5
    assert ei.value.sqlstate == "XX000"  # the reference's
    run(c, s1, "rollback")


def test_serialization_error_after_lock_wait(c):
    """The waiter wakes because the holder committed an update of the
    locked row: a serialization failure, never a double apply."""
    s1, s2 = c.session(), c.session()
    run(c, s1, "begin")
    run(c, s1, "update acct set bal = 111 where id = 1")
    errs = []

    def waiter():
        try:
            run(c, s2, "update acct set bal = 222 where id = 1")
        except _sqlerror(c) as e:
            errs.append(str(e))

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.3)
    run(c, s1, "commit")
    th.join(timeout=10)
    assert not th.is_alive()
    assert errs and "serialize" in errs[0]
    assert run(c, c.session(),
               "select bal from acct where id = 1").rows == [(111,)]


def test_deadlock_detected_and_broken(c):
    """Two sessions' cycle over rows on two datanodes: the detecting
    waiter fails with a deadlock error, the other proceeds."""
    s1, s2 = c.session(), c.session()
    for s in (s1, s2):
        run(c, s, "set deadlock_timeout = 200")
    run(c, s1, "begin")
    run(c, s2, "begin")
    run(c, s1, "update acct set bal = 0 where id = 1")
    run(c, s2, "update acct set bal = 0 where id = 2")
    outcome = {}

    def t(sess, key, sql):
        try:
            run(c, sess, sql)
            outcome[key] = "ok"
        except _sqlerror(c) as e:
            outcome[key] = str(e)

    a = threading.Thread(target=t, args=(
        s1, "s1", "update acct set bal = 0 where id = 2"))
    b = threading.Thread(target=t, args=(
        s2, "s2", "update acct set bal = 0 where id = 1"))
    a.start()
    time.sleep(0.15)
    b.start()
    a.join(timeout=15)
    b.join(timeout=15)
    assert not a.is_alive() and not b.is_alive()
    assert len(outcome) == 2
    assert any("deadlock detected" in x for x in outcome.values()), outcome
    survivor = s1 if "deadlock" not in outcome["s1"] else s2
    assert outcome["s1" if survivor is s1 else "s2"] == "ok"
    run(c, survivor, "commit")


def test_lock_table_exclusive_blocks_insert_and_for_update(c):
    s1, s2 = c.session(), c.session()
    run(c, s1, "begin")
    run(c, s1, "lock table acct in exclusive mode")
    run(c, s2, "set lock_timeout = 150")
    with pytest.raises(_sqlerror(c), match="lock timeout"):
        run(c, s2, "insert into acct values (9, 900)")
    with pytest.raises(_sqlerror(c), match="lock timeout"):
        run(c, s2, "select * from acct where id = 1 for update")
    run(c, s1, "rollback")
    assert run(c, s2, "insert into acct values (9, 900)").rowcount == 1


def test_lock_table_holds_off_an_insert_until_commit(c):
    s1, s2 = c.session(), c.session()
    run(c, s1, "begin")
    run(c, s1, "lock table acct in exclusive mode")
    done = []

    def writer():
        run(c, s2, "insert into acct values (20, 2000)")
        done.append(time.monotonic())

    th = threading.Thread(target=writer)
    th.start()
    time.sleep(0.3)
    assert not done, "INSERT should wait for LOCK TABLE"
    t0 = time.monotonic()
    run(c, s1, "commit")
    th.join(timeout=10)
    assert not th.is_alive() and done and done[0] >= t0
    assert run(c, c.session(), "select count(*) from acct").rows == [(5,)]


def test_lock_table_requires_txn_block_and_nowait(c):
    s1, s2 = c.session(), c.session()
    with pytest.raises(_sqlerror(c), match="transaction block"):
        run(c, s1, "lock table acct")
    run(c, s1, "begin")
    run(c, s1, "lock table acct in access exclusive mode")
    run(c, s2, "begin")
    with pytest.raises(_sqlerror(c), match="could not obtain lock"):
        run(c, s2, "lock table acct nowait")
    run(c, s1, "commit")
    run(c, s2, "lock table acct nowait")
    run(c, s2, "commit")


def test_shared_lock_table_coexists(c):
    s1, s2 = c.session(), c.session()
    run(c, s1, "begin")
    run(c, s2, "begin")
    run(c, s1, "lock table acct in share mode")
    run(c, s2, "lock table acct in share mode")  # no conflict
    run(c, s1, "insert into acct values (10, 0)")  # shared with inserts
    run(c, s1, "commit")
    run(c, s2, "commit")


def test_locks_released_on_rollback(c):
    s1, s2 = c.session(), c.session()
    run(c, s1, "begin")
    run(c, s1, "select * from acct for update")
    run(c, s1, "rollback")
    run(c, s2, "begin")
    run(c, s2, "select * from acct for update nowait")
    run(c, s2, "commit")


def test_for_update_outside_txn_releases_immediately(c):
    s1, s2 = c.session(), c.session()
    assert run(c, s1, "select * from acct where id = 1 "
               "for update").rowcount == 1
    run(c, s2, "begin")
    run(c, s2, "select * from acct where id = 1 for update nowait")
    run(c, s2, "commit")


def test_for_update_restrictions(c):
    s = c.session()
    with pytest.raises(_sqlerror(c), match="FOR UPDATE is only allowed"):
        run(c, s, "select count(*) from acct group by bal for update")
    with pytest.raises(_sqlerror(c), match="FOR UPDATE is only allowed"):
        run(c, s, "select distinct bal from acct for update")


def test_for_share_serialization_after_holder_commit(c):
    """FOR SHARE fails too when the awaited row version was superseded
    by a committed update."""
    s1, s2 = c.session(), c.session()
    run(c, s1, "begin")
    run(c, s1, "update acct set bal = 999 where id = 4")
    errs = []

    def waiter():
        try:
            run(c, s2, "select * from acct where id = 4 for share")
        except _sqlerror(c) as e:
            errs.append(str(e))

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.3)
    run(c, s1, "commit")
    th.join(timeout=10)
    assert not th.is_alive()
    assert errs and "serialize" in errs[0]


def test_lock_timeout_accepts_pg_duration_strings(c):
    s1, s2 = c.session(), c.session()
    run(c, s1, "begin")
    run(c, s1, "select * from acct where id = 1 for update")
    run(c, s2, "set lock_timeout = '150ms'")
    with pytest.raises(_sqlerror(c), match="lock timeout"):
        run(c, s2, "delete from acct where id = 1")
    with pytest.raises(_sqlerror(c), match="invalid duration"):
        run(c, s2, "set lock_timeout = 'bogus'")
    run(c, s1, "rollback")

"""The port's WAL, checkpoints and crash recovery
(opentenbase_tpu_torch/storage/persist.py) against the reference's
(opentenbase_tpu/storage/persist.py): the shapes of
tests/test_persistence.py for the statements the port takes. Each runs
the same statements on a reference ``Cluster(data_dir=a)`` and a port
``Cluster(data_dir=b, device="cpu")``, abandons both (a crash: no
close), recovers both and compares the answers; the two recover each
other's data directories too."""

import os
import threading

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import NotPorted
from opentenbase_tpu_torch.engine import Cluster
from opentenbase_tpu_torch.storage import persist
from opentenbase_tpu_torch.storage.persist import WAL
from opentenbase_tpu_torch.storage.table import PENDING_TS


def _dirs(tmp_path):
    return str(tmp_path / "ref"), str(tmp_path / "port")


def _make(tmp_path):
    rd, pd = _dirs(tmp_path)
    return (RefCluster(num_datanodes=2, shard_groups=32, data_dir=rd),
            Cluster(num_datanodes=2, shard_groups=32, data_dir=pd,
                    device="cpu"))


def _recover(tmp_path, shard_groups=32):
    rd, pd = _dirs(tmp_path)
    return (RefCluster.recover(rd, num_datanodes=2,
                               shard_groups=shard_groups),
            Cluster.recover(pd, num_datanodes=2, shard_groups=shard_groups,
                            device="cpu"))


def _both(sessions, sql):
    """Run ``sql`` on every session: all answer the same, or all fail."""
    out = []
    for s in sessions:
        try:
            out.append(("ok", s.execute(sql).rows))
        except Exception as e:  # noqa: BLE001 - compared across sessions
            out.append(("err", type(e).__name__))
    assert all(o[0] == out[0][0] for o in out), (sql, out)
    if out[0][0] == "ok":
        assert all(o == out[0] for o in out), (sql, out)
    return out[0]


def _same(clusters, sql, want=None):
    got = [c.session().query(sql) for c in clusters]
    assert got[0] == got[1], (sql, got)
    if want is not None:
        assert got[1] == want, (sql, got[1])
    return got[1]


def _run(clusters, *stmts):
    ss = [c.session() for c in clusters]
    for sql in stmts:
        _both(ss, sql)
    return ss


def test_wal_replay_from_empty(tmp_path):
    cs = _make(tmp_path)
    _run(cs,
         "create table t (k bigint, v text) distribute by shard(k)",
         "insert into t values (1,'a'),(2,'b'),(3,'c')",
         "delete from t where k = 2",
         "update t set v = 'z' where k = 3")
    _same(_recover(tmp_path), "select k, v from t order by k",
          [(1, "a"), (3, "z")])


def test_checkpoint_plus_tail(tmp_path):
    cs = _make(tmp_path)
    ss = _run(cs,
              "create table t (k bigint, v text) distribute by shard(k)",
              "insert into t values (1,'a'),(2,'b')")
    for c in cs:
        c.persistence.checkpoint()
    for sql in ("insert into t values (3,'c')", "delete from t where k = 1"):
        _both(ss, sql)
    _same(_recover(tmp_path), "select k, v from t order by k",
          [(2, "b"), (3, "c")])


def test_dictionary_growth_replayed(tmp_path):
    cs = _make(tmp_path)
    ss = _run(cs,
              "create table t (k bigint, v text) distribute by shard(k)",
              "insert into t values (1,'early')")
    for c in cs:
        c.persistence.checkpoint()
    # values after the checkpoint extend the dictionary through the WAL
    _both(ss, "insert into t values (2,'later'),(3,'latest'),(4,null)")
    rs = _recover(tmp_path)
    _same(rs, "select v from t order by k",
          [("early",), ("later",), ("latest",), (None,)])
    # every string kept its code (TEXT is int32 codes on the device)
    pt = cs[1].catalog.get("t").dictionaries["v"].values
    assert rs[1].catalog.get("t").dictionaries["v"].values == pt


def test_ddl_replay(tmp_path):
    cs = _make(tmp_path)
    _run(cs,
         "create table a (x int, y bigint) distribute by roundrobin",
         "create table b (y int) distribute by roundrobin",
         "insert into a values (1, 10)",
         "drop table b",
         "create index ax on a (y)",
         "create user app with password 'pw'",
         "create user gone with password 'x'",
         "drop user gone",
         "drop user if exists nobody",
         "insert into a values (2, 20)",
         "drop table if exists nope")
    rs = _recover(tmp_path)
    _same(rs, "select x, y from a order by x", [(1, 10), (2, 20)])
    for c in rs:
        with pytest.raises(Exception, match="does not exist"):
            c.session().query("select * from b")
        assert c.catalog.get("a").zone_cols == {"y"}
        assert list(c.users) == ["app"]
    # the verifier itself is replayed, never recomputed
    assert rs[1].users == cs[1].users and rs[0].users == cs[0].users


def test_vacuum_checkpoints(tmp_path):
    cs = _make(tmp_path)
    _run(cs,
         "create table t (k bigint) distribute by shard(k)",
         "insert into t values (1),(2),(3),(4)",
         "delete from t where k <= 2",
         "vacuum t",
         "delete from t where k = 3")  # post-vacuum row positions
    for c in cs:
        assert os.path.exists(os.path.join(c.persistence.dir,
                                           "checkpoint.json"))
    _same(_recover(tmp_path), "select k from t", [(4,)])


def test_aborted_txn_not_replayed(tmp_path):
    cs = _make(tmp_path)
    _run(cs,
         "create table t (k bigint) distribute by shard(k)",
         "insert into t values (1)",
         "begin", "insert into t values (99)", "delete from t where k = 1",
         "rollback",
         "insert into t values (2)")
    _same(_recover(tmp_path), "select k from t order by k", [(1,), (2,)])


def test_recover_num_shards_from_checkpoint(tmp_path):
    cs = _make(tmp_path)
    _run(cs,
         "create table t (k bigint) distribute by shard(k)",
         "insert into t values (1),(2),(3)")
    for c in cs:
        c.persistence.checkpoint()
    # recover with the default 256 shard groups: the checkpoint wins
    rs = _recover(tmp_path, shard_groups=256)
    for c in rs:
        assert c.shardmap.num_shards == 32 and len(c.shardmap.map) == 32
    _run(rs, "insert into t values (4)")
    _same(rs, "select k from t order by k", [(1,), (2,), (3,), (4,)])


def test_multi_table_commit_is_one_frame(tmp_path):
    cs = _make(tmp_path)
    _run(cs,
         "create table a (k bigint) distribute by shard(k)",
         "create table b (k bigint) distribute by shard(k)",
         "begin", "insert into a values (1),(2)",
         "insert into b values (3),(4)", "commit")
    for c in cs:
        wal = os.path.join(c.persistence.dir, "wal.log")
        tags = [t for t, _h, _a, _o in WAL.read_records(wal)]
        assert tags.count("G") == 1
        # a crash mid-append of that frame: drop its last byte
        size = os.path.getsize(wal)
        c.persistence.wal.close()
        with open(wal, "r+b") as f:
            f.truncate(size - 1)
    rs = _recover(tmp_path)
    _same(rs, "select k from a", [])  # all or nothing
    _same(rs, "select k from b", [])


def test_zero_filled_wal_tail(tmp_path):
    cs = _make(tmp_path)
    _run(cs,
         "create table t (k bigint) distribute by shard(k)",
         "insert into t values (1)")
    for c in cs:
        c.persistence.wal.close()
        with open(os.path.join(c.persistence.dir, "wal.log"), "ab") as f:
            f.write(b"\x00" * 64)
    rs = _recover(tmp_path)
    _run(rs, "insert into t values (2)")
    _same(_recover(tmp_path), "select k from t order by k", [(1,), (2,)])


def test_checkpoint_excludes_inflight_uncommitted_rows(tmp_path):
    cs = _make(tmp_path)
    _run(cs,
         "create table t (k bigint) distribute by shard(k)",
         "insert into t values (1)")
    ss2 = _run(cs, "begin", "insert into t values (99)")
    for c in cs:
        c.persistence.checkpoint()
    for s in ss2:
        s.execute("commit")  # its 'G' frame lies after the checkpoint
    rs = _recover(tmp_path)
    _same(rs, "select k from t order by k", [(1,), (99,)])
    for node_stores in rs[1].stores.values():
        for store in node_stores.values():
            assert not (store.xmin_ts[: store.nrows] == PENDING_TS).any()


def test_wal_array_framing_matches_the_reference():
    """The raw array framing of a commit frame is byte-identical to the
    reference's, and each package decodes the other's."""
    import numpy as np

    from opentenbase_tpu.storage import persist as ref_persist

    arrays = {
        "w0_k": np.arange(5, dtype=np.int64),
        "w0_v": np.array([1, -2, 3, 0, 7], dtype=np.int32),
        "w0__v_v": np.array([True, False, True, True, False]),
        "w1_del": np.array([], dtype=np.int64),
        "w2_f": np.array([0.5, np.nan], dtype=np.float64),
    }
    ours = persist.pack_arrays(arrays)
    assert ours == ref_persist.pack_arrays(arrays)
    for dec in (persist.unpack_arrays, ref_persist.unpack_arrays):
        back = dec(ours)
        assert list(back) == list(arrays)
        for k, v in arrays.items():
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)


def test_checkpoint_generations_gc(tmp_path):
    cs = _make(tmp_path)
    ss = _run(cs,
              "create table t (k bigint) distribute by shard(k)",
              "insert into t values (1)")
    for c in cs:
        c.persistence.checkpoint()
    _both(ss, "insert into t values (2)")
    for c in cs:
        c.persistence.checkpoint()
        files = [f for f in os.listdir(c.persistence.dir)
                 if f.endswith(".npz")]
        assert files and all(f.startswith("ckpt2_") for f in files)
    _same(_recover(tmp_path), "select k from t order by k", [(1,), (2,)])


CROSS = (
    "create table li (k bigint, q decimal(10,2), d date, tag text, "
    "f double precision, b boolean) distribute by shard(k)",
    "create table dim (k bigint, name text) distribute by replication",
    "insert into li values (1, 12.34, '1994-01-02', 'héllo', 0.5, true), "
    "(2, null, '1995-03-04', null, null, false), "
    "(3, 7.00, null, 'x', -1.25, null), (4, 0.01, '1998-12-01', 'héllo', "
    "2.0, true)",
    "insert into dim values (1, 'one'), (2, 'two')",
    "delete from li where k = 2",
    "update li set tag = 'new', q = 8.50 where k = 3",
    "begin", "insert into li values (5, 1.00, '1996-06-06', 'gone', 1.0, "
    "false)", "rollback",
)
CROSS_TAIL = (
    "insert into li values (6, 6.66, '1997-07-07', 'tail', 6.5, true)",
    "delete from dim where k = 1",
)
CROSS_Q = (
    "select k, q, d, tag, f, b from li order by k",
    "select k, name from dim order by k",
    "select tag, count(*), sum(q) from li group by tag order by tag",
    "select li.k, name from li join dim on li.k = dim.k order by li.k",
)


@pytest.mark.parametrize("checkpoint", [False, True])
def test_cross_recovery_both_ways(tmp_path, checkpoint):
    """The port recovers the reference's data directory and the
    reference recovers the port's: the same answers as both live
    clusters, with and without a checkpoint before the tail."""
    cs = _make(tmp_path)
    ss = _run(cs, *CROSS)
    if checkpoint:
        for c in cs:
            c.persistence.checkpoint()
    for sql in CROSS_TAIL:
        _both(ss, sql)
    want = {q: _same(cs, q) for q in CROSS_Q}
    rd, pd = _dirs(tmp_path)
    port_of_ref = Cluster.recover(rd, 2, 32, device="cpu")
    ref_of_port = RefCluster.recover(pd, 2, 32)
    for q in CROSS_Q:
        assert port_of_ref.session().query(q) == want[q], q
        assert ref_of_port.session().query(q) == want[q], q
    # the port's clock stands above every recovered commit
    s = port_of_ref.session()
    s.execute("insert into li values (7, 1.00, '1999-01-01', 'after', "
              "1.0, true)")
    assert s.query("select k, tag from li where k = 7") == [(7, "after")]
    assert s.query("select count(*) from li") == [(5,)]


def test_oversized_frame_refused_before_a_byte_lands(tmp_path, monkeypatch):
    """A commit frame past the u32 length is refused by name before it
    is written; the commit rolls back and recovery never sees it."""
    _, pd = _dirs(tmp_path)
    c = Cluster(num_datanodes=2, shard_groups=32, data_dir=pd, device="cpu")
    s = c.session()
    s.execute("create table t (k bigint, v bigint) distribute by shard(k)")
    s.execute("insert into t values (1, 1)")
    size = os.path.getsize(os.path.join(pd, "wal.log"))
    monkeypatch.setattr(persist, "MAX_FRAME_BYTES", 400)
    big = ",".join(f"({k}, {k})" for k in range(2, 200))
    with pytest.raises(persist.FrameTooLarge, match="frame limit"):
        s.execute(f"insert into t values {big}")
    assert os.path.getsize(os.path.join(pd, "wal.log")) == size
    assert s.query("select count(*) from t") == [(1,)]
    monkeypatch.setattr(persist, "MAX_FRAME_BYTES", 2**32 - 1)
    s.execute("insert into t values (500, 5)")
    r = Cluster.recover(pd, 2, 32, device="cpu")
    assert r.session().query("select k, v from t order by k") == [
        (1, 1), (500, 5)]


def test_drop_and_create_one_name_never_reads_old_planes(tmp_path):
    """DROP TABLE frees the device planes; a table created again under
    the name, with store versions equal to the old ones, answers from
    its own rows. (The reference's fused route answers from the old
    planes here, ROADMAP C: its host route is the oracle.)"""
    cs = _make(tmp_path)
    ss = _run(cs, "create table t (k bigint, v bigint) distribute by "
              "shard(k)", "insert into t values (1, 10), (2, 20)")
    q = "select sum(v), count(*) from t"
    _same(cs, q, [(30, 2)])
    fx = cs[1].fused_executor()
    assert any(k[0] == "t" for k in fx.cache._tables)
    old = [st["t"].version for st in cs[1].stores.values()]
    _both(ss, "drop table t")
    assert not any(k[0] == "t" for k in fx.cache._tables)
    for sql in ("create table t (k bigint, v bigint) distribute by shard(k)",
                "insert into t values (1, 1000), (2, 2000)"):
        _both(ss, sql)
    # the new stores stand at the old versions: a cache keyed by
    # versions alone answers from the old planes
    assert [st["t"].version for st in cs[1].stores.values()] == old
    assert ss[0].query(q) == [(30, 2)]  # the reference's stale planes
    ss[0].execute("set enable_fused_execution = off")
    assert ss[1].query(q) == ss[0].query(q) == [(3000, 2)]
    assert ss[1].last_route == "fused"
    _same(_recover(tmp_path), q, [(3000, 2)])


@pytest.mark.parametrize("checkpoint", [False, True])
def test_drop_and_create_one_name_logs_the_new_dictionary(tmp_path,
                                                          checkpoint):
    """A table created again under a dropped table's name starts with an
    empty dictionary: its TEXT codes must reach the WAL from the first
    value, or recovery decodes them against nothing. (The reference
    keeps the dropped table's count of logged values and loses them,
    ROADMAP C: the answer before the crash is the oracle.)"""
    d = str(tmp_path / "port")
    c = Cluster(num_datanodes=2, shard_groups=32, data_dir=d, device="cpu")
    s = c.session()
    if checkpoint:  # the watermark also comes from a checkpoint
        s.execute("create table t (k bigint, v text) distribute by shard(k)")
        s.execute("insert into t values (1,'a'),(2,'b'),(3,'c')")
        c.persistence.checkpoint()
        s.execute("drop table t")
    else:
        s.execute("create table t (k bigint, v text) distribute by shard(k)")
        s.execute("insert into t values (1,'a'),(2,'b'),(3,'c')")
        s.execute("drop table t")
    s.execute("create table t (k bigint, v text) distribute by shard(k)")
    s.execute("insert into t values (4,'new'),(5,null)")
    q = "select k, v from t order by k"
    before = s.query(q)
    assert before == [(4, "new"), (5, None)]
    # abandoned: no close, no checkpoint
    r = Cluster.recover(d, num_datanodes=2, shard_groups=32, device="cpu")
    assert r.session().query(q) == before
    assert r.session().query(
        "select count(*) from t where v = 'new'") == [(1,)]


def test_not_ported_records_refused_by_name(tmp_path):
    """PITR is refused by name; records the port once refused (a
    PREPARE TRANSACTION, a CREATE VIEW, a CREATE MATERIALIZED VIEW) are
    recovered as the reference recovers them."""
    rd, pd = _dirs(tmp_path)
    r = RefCluster(num_datanodes=2, shard_groups=32, data_dir=rd)
    s = r.session()
    s.execute("create table t (k bigint) distribute by shard(k)")
    s.execute("begin")
    s.execute("insert into t values (1)")
    s.execute("prepare transaction 'g1'")
    c = Cluster.recover(rd, 2, 32, device="cpu")
    assert list(c._prepared) == ["g1"]
    c.session().execute("commit prepared 'g1'")
    assert c.session().query("select k from t") == [(1,)]
    c.close()
    s.execute("create view v as select k from t")
    c = Cluster.recover(rd, 2, 32, device="cpu")
    assert c.session().query("select k from v") == [(1,)]
    c.close()
    # a materialized view's records recover since the port took them
    s.execute("create materialized view mv as select k from t")
    c = Cluster.recover(rd, 2, 32, device="cpu")
    assert c.session().query("select k from mv") == s.query(
        "select k from mv")
    assert list(c.matviews) == ["mv"]
    c.close()
    Cluster(num_datanodes=2, shard_groups=32, data_dir=pd,
            device="cpu").close()
    with pytest.raises(NotPorted, match="PITR"):
        Cluster.recover(pd, 2, 32, until_barrier="b1", device="cpu")


@pytest.mark.parametrize("mode", ["local", "off"])
def test_synchronous_commit_and_group_flush(tmp_path, mode):
    """``local`` commits wait for the group fsync, ``off`` ones do not;
    concurrent committers share fsyncs; every acknowledged commit is
    recovered from a crash image (no close)."""
    _, pd = _dirs(tmp_path)
    c = Cluster(num_datanodes=2, shard_groups=32, data_dir=pd, device="cpu")
    n = 8
    s0 = c.session()
    for i in range(n):
        s0.execute(f"create table t{i} (k bigint) distribute by shard(k)")
    before = c.persistence.wal.stat_snapshot()
    barrier = threading.Barrier(n)
    errs = []

    def writer(i):
        try:
            s = c.session()
            s.execute(f"set synchronous_commit = {mode}")
            s.execute("set commit_delay_us = 20000")
            s.execute("set commit_siblings = 0")
            barrier.wait(timeout=10)
            s.execute(f"insert into t{i} values ({i})")
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=writer, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errs and not any(t.is_alive() for t in ts)
    after = c.persistence.wal.stat_snapshot()
    flushes = after["commit_flushes"] - before["commit_flushes"]
    fsyncs = after["fsyncs"] - before["fsyncs"]
    if mode == "local":
        assert flushes == n and 1 <= fsyncs < n
    else:
        assert flushes == 0 and fsyncs == 0
    r = Cluster.recover(pd, 2, 32, device="cpu")
    rs = r.session()
    assert [rs.query(f"select k from t{i}") for i in range(n)] == [
        [(i,)] for i in range(n)]


VIEWS_AND_FUNCTIONS = [
    "create table t (k bigint, v text) distribute by shard(k)",
    "insert into t values (1, 'a'), (2, 'b'), (3, null)",
    "create view recent as select k, v from t where k > 1",
    "create view doomed as select k from t",
    "drop view doomed",
    "create function inc(x bigint) returns bigint as 'select x + 1'",
    "create function gone(x bigint) returns bigint as 'select x'",
    "drop function gone",
    "create function tot() returns bigint as 'select sum(k) from t'",
]
VIEWS_AND_FUNCTIONS_Q = [
    "select k, v from recent order by k",
    "select inc(k) from t order by k",
    "select inc(k), tot() from recent order by k",
]


@pytest.mark.parametrize("checkpoint", [False, True],
                         ids=["wal", "checkpoint"])
def test_views_and_functions_cross_recovery(tmp_path, checkpoint):
    """Views and SQL functions in the 'D' records (and views in the
    checkpoint) in the reference's format: each package recovers the
    data directory the other wrote, with the answers of the live
    clusters. Functions ride the WAL only, as in the reference: a
    checkpoint taken after them leaves them out in both packages
    (ROADMAP C), so the checkpoint case creates them after it."""
    cs = _make(tmp_path)
    ss = [c.session() for c in cs]
    body = VIEWS_AND_FUNCTIONS
    if checkpoint:
        for sql in body[:5]:
            _both(ss, sql)
        for c in cs:
            c.persistence.checkpoint()
        body = body[5:]
    for sql in body:
        _both(ss, sql)
    want = {q: _same(cs, q) for q in VIEWS_AND_FUNCTIONS_Q}
    rd, pd = _dirs(tmp_path)
    port_of_ref = Cluster.recover(rd, 2, 32, device="cpu")
    ref_of_port = RefCluster.recover(pd, 2, 32)
    for c in (port_of_ref, ref_of_port):
        assert sorted(c.views) == ["recent"]
        assert sorted(c.functions) == ["inc", "tot"]
        for q in VIEWS_AND_FUNCTIONS_Q:
            assert c.session().query(q) == want[q], q
    port_of_ref.close()


def test_functions_before_a_checkpoint_are_lost_in_both(tmp_path):
    """The reference's checkpoint carries views but no SQL functions, and
    recovery replays only the WAL past it: a function created before
    the checkpoint is gone after recovery. The port keeps that
    behaviour (ROADMAP C, found in the reference)."""
    cs = _make(tmp_path)
    ss = [c.session() for c in cs]
    for sql in VIEWS_AND_FUNCTIONS[:6]:
        _both(ss, sql)
    for c in cs:
        c.persistence.checkpoint()
    for c in _recover(tmp_path):
        assert sorted(c.views) == ["recent"]
        assert c.functions == {}


def test_plpgsql_function_record_recovered(tmp_path):
    """A reference WAL holding a PL/pgSQL function's 'D' record (refused
    by name before PL/pgSQL was ported) recovers in the port, and the
    function answers as the reference's."""
    rd, _pd = _dirs(tmp_path)
    r = RefCluster(num_datanodes=2, shard_groups=32, data_dir=rd)
    r.session().execute(
        "create function fib(n bigint) returns bigint as '"
        "declare a bigint := 0; b bigint := 1; t bigint; begin "
        "for i in 1 .. n loop t := a + b; a := b; b := t; end loop; "
        "return a; end' language plpgsql")
    c = Cluster.recover(rd, 2, 32, device="cpu")
    assert c.functions["fib"].language == "plpgsql"
    assert c.session().query("select fib(10)") == r.session().query(
        "select fib(10)") == [(55,)]
    c.close()

"""The port's incremental device cache (``DeviceCache._try_delta`` and
``_replay_mvcc``) against the reference's, on the CPU.

Each case drives the same statements through a reference
``Cluster(num_datanodes=2)`` and a port ``Cluster(..., device="cpu")``
and holds the port to the reference's answers and to the reference's
refresh kinds: a ``full_uploads`` that stays flat in the reference stays
flat in the port. After every refresh the port's resident planes must
equal a fresh full upload of the same stores (real rows; compact planes
broadcast). The shapes are those of ``tests/test_device_cache.py`` (all
five) and of ``tests/test_delta_scan.py``'s device-cache cases
(read-after-write, UPDATE/DELETE on delta rows, the stamp burst, the
ingest burst past the stamp log's cap). ``test_delta_scan.py``'s cases
that need the WAL, fault injection, EXPLAIN ANALYZE or the
``enable_delta_scan`` GUC are not held: the port has none of them.
The reference's bare-scan reads (``select k, v from t``) are asked as
grouped aggregates, which the port's device path answers.
"""

import numpy as np
import pytest
import torch

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster
from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.executor.fused import DeviceCache
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import ColumnBatch, ShardStore

STATS = ("full_uploads", "delta_uploads", "delta_rows", "delta_tail_uploads",
         "delta_tail_rows")


class Pair:
    """The same statements through a reference and a port session."""

    def __init__(self, ddl: str):
        self.rc = RefCluster(num_datanodes=2, shard_groups=16)
        self.pc = Cluster(num_datanodes=2, shard_groups=16, device="cpu")
        self.rs, self.ps = self.rc.session(), self.pc.session()
        self.rs.execute("set enable_fused_execution = on")
        self.both(ddl)

    def both(self, sql: str) -> None:
        a, b = self.rs.execute(sql), self.ps.execute(sql)
        assert a.rowcount == b.rowcount, sql

    def query(self, sql: str) -> list:
        want = self.rs.query(sql)
        got = self.ps.query(sql)
        assert got == want, sql
        return got

    def stats(self) -> tuple[dict, dict]:
        return (dict(self.rc.fused_executor().cache.stats),
                dict(self.pc.fused_executor().cache.stats))

    def close(self) -> None:
        self.rc.close()


def _moved(before, after, key) -> int:
    return after[key] - before[key]


def assert_fresh(cluster, table: str) -> None:
    """Every resident plane of ``table`` equals a fresh full upload of
    the same stores over the real rows."""
    fx = cluster.fused_executor()
    meta = cluster.catalog.get(table)
    nodes = tuple(meta.node_indices)
    dt = fx.cache._tables[(table, nodes)]
    fresh = DeviceCache("cpu").get(table, meta, cluster.stores, nodes,
                                   columns=list(dt.columns))
    assert list(dt.nrows) == list(fresh.nrows)
    S = len(nodes)

    def full(x, rmax):
        return x.expand(S, rmax) if x.shape[1] == 1 else x

    for i, n in enumerate(dt.nrows):
        for a, b in ((dt.xmin, fresh.xmin), (dt.xmax, fresh.xmax)):
            assert torch.equal(full(a, dt.rmax)[i, :n],
                               full(b, fresh.rmax)[i, :n])
        for c in dt.columns:
            assert torch.equal(dt.columns[c][i, :n], fresh.columns[c][i, :n])
            va, vb = dt.validity[c], fresh.validity[c]
            assert (va is None) == (vb is None), c
            if va is not None:
                assert torch.equal(va[i, :n], vb[i, :n])
    assert list(dt.nrows_dev.tolist()) == list(dt.nrows)
    for c in dt.columns:
        if fresh.col_range.get(c) is not None:
            lo, hi = dt.col_range[c]
            assert lo <= fresh.col_range[c][0] and hi >= fresh.col_range[c][1]
            assert dt.col_maxabs[c] >= fresh.col_maxabs[c]


# -- tests/test_device_cache.py's five shapes ------------------------------


@pytest.fixture()
def dc():
    p = Pair("create table dc (k bigint, v numeric(10,2)) "
             "distribute by shard(k)")
    p.both("insert into dc values "
           + ",".join(f"({i}, {i}.50)" for i in range(200)))
    yield p
    p.close()


def test_insert_is_delta_not_full_reload(dc):
    assert dc.query("select count(*), sum(v) from dc") == [(200, 20000.0)]
    r0, p0 = dc.stats()
    dc.both("insert into dc values (1000, 1.00), (1001, 2.00)")
    dc.query("select count(*), sum(v) from dc")
    r1, p1 = dc.stats()
    for key in STATS:
        assert _moved(p0, p1, key) == _moved(r0, r1, key), key
    assert _moved(p0, p1, "full_uploads") == 0
    assert _moved(p0, p1, "delta_rows") == 2
    assert_fresh(dc.pc, "dc")


def test_delete_replays_mvcc_stamps(dc):
    dc.query("select count(*), sum(v) from dc")
    r0, p0 = dc.stats()
    dc.both("delete from dc where k < 10")
    assert dc.query("select count(*), sum(v) from dc")[0][0] == 190
    r1, p1 = dc.stats()
    assert _moved(p0, p1, "full_uploads") == _moved(r0, r1, "full_uploads") == 0
    assert _moved(p0, p1, "mvcc_replays") == _moved(r0, r1, "mvcc_replays") > 0
    assert_fresh(dc.pc, "dc")


def test_update_correct_through_cache(dc):
    dc.query("select count(*) from dc")
    dc.both("update dc set v = 99.00 where k = 5")
    assert dc.query("select sum(v) from dc where k = 5") == [(99.0,)]
    dc.query("select sum(v), count(*) from dc")
    assert_fresh(dc.pc, "dc")


def test_vacuum_forces_full_reload(dc):
    dc.query("select count(*), sum(v) from dc")
    dc.both("delete from dc where k < 100")
    dc.query("select count(*), sum(v) from dc")
    r0, p0 = dc.stats()
    dc.both("vacuum dc")
    assert dc.query("select count(*), sum(v) from dc")[0][0] == 100
    r1, p1 = dc.stats()
    assert _moved(p0, p1, "full_uploads") == _moved(r0, r1, "full_uploads") == 1
    assert_fresh(dc.pc, "dc")


def test_first_null_forces_reload_and_is_correct(dc):
    dc.query("select count(*), sum(v) from dc")
    r0, p0 = dc.stats()
    dc.both("insert into dc values (5000, null)")
    assert dc.query("select count(*), count(v), sum(v) from dc")[0][:2] == (
        201, 200)
    r1, p1 = dc.stats()
    assert _moved(p0, p1, "full_uploads") == _moved(r0, r1, "full_uploads") == 1
    assert dc.pc.fused_executor().cache._tables[
        ("dc", (0, 1))].validity["v"] is not None
    assert_fresh(dc.pc, "dc")


# -- tests/test_delta_scan.py's device-cache shapes ------------------------


def _kv_pair(n: int, v=lambda i: i) -> Pair:
    p = Pair("create table t (k bigint, v bigint) distribute by shard(k)")
    p.both("insert into t values "
           + ",".join(f"({i},{v(i)})" for i in range(n)))
    return p


def test_read_after_write_is_a_tail_upload():
    p = _kv_pair(1100, lambda i: i * 2)
    assert p.query("select count(*) from t") == [(1100,)]
    r0, p0 = p.stats()
    p.both("insert into t values "
           + ",".join(f"({2000 + i},{i})" for i in range(400)))
    assert p.query("select count(*), sum(v) from t") == [
        (1500, 2 * sum(range(1100)) + sum(range(400)))]
    r1, p1 = p.stats()
    for key in STATS:
        assert _moved(p0, p1, key) == _moved(r0, r1, key), key
    assert _moved(p0, p1, "delta_tail_rows") == 400
    # the rows stayed in their delta batches: nothing folded
    assert sum(p.pc.stores[n]["t"].pending_delta_rows for n in (0, 1)) > 0
    assert_fresh(p.pc, "t")
    p.close()


def test_update_delete_on_delta_rows_replay_on_the_device():
    p = _kv_pair(1000)
    p.query("select count(*) from t")
    r0, p0 = p.stats()
    p.both("insert into t values "
           + ",".join(f"({2000 + i},{i})" for i in range(200)))
    p.both("update t set v = v + 1000 where k >= 2000 and k < 2010")
    p.both("delete from t where k >= 2190")
    rows = p.query("select k, sum(v) from t where k >= 2000 "
                   "group by k order by k")
    assert len(rows) == 190 and rows[5] == (2005, 1005)
    r1, p1 = p.stats()
    assert _moved(p0, p1, "full_uploads") == _moved(r0, r1, "full_uploads") == 0
    assert sum(p.pc.stores[n]["t"].pending_delta_rows for n in (0, 1)) > 0
    assert_fresh(p.pc, "t")
    p.close()


def test_stamp_burst_replays_coalesced_not_full_plane():
    p = _kv_pair(2000)
    p.rc.compact_deltas()
    p.pc.compact_deltas()
    p.query("select count(*), sum(v) from t")
    r0, p0 = p.stats()
    for k in range(0, 24, 2):  # 12 single-row DELETEs
        p.both(f"delete from t where k = {k}")
    assert p.query("select count(*), sum(v) from t")[0][0] == 1988
    r1, p1 = p.stats()
    assert _moved(p0, p1, "full_uploads") == _moved(r0, r1, "full_uploads") == 0
    assert _moved(p0, p1, "mvcc_replays") > 0
    assert_fresh(p.pc, "t")
    p.close()


def test_ingest_burst_longer_than_the_log_cap_stays_tail_only():
    p = _kv_pair(1000)
    p.query("select count(*) from t")
    r0, p0 = p.stats()
    for i in range(80):  # > _MVCC_LOG_CAP (64) statements
        p.both(f"insert into t values ({3000 + i}, {i})")
    assert p.query("select count(*), sum(v) from t") == [
        (1080, sum(range(1000)) + sum(range(80)))]
    r1, p1 = p.stats()
    assert _moved(p0, p1, "full_uploads") == _moved(r0, r1, "full_uploads") == 0
    assert _moved(p0, p1, "delta_rows") == _moved(r0, r1, "delta_rows") == 80
    assert_fresh(p.pc, "t")
    p.close()


# -- the port's own cases ---------------------------------------------------


def _bulk(cluster, table, n):
    """A bulk load at one commit timestamp (compact planes)."""
    meta = cluster.catalog.get(table)
    ts = cluster.gts.get_gts()
    for i, node in enumerate(meta.node_indices):
        k = np.arange(i * n, (i + 1) * n, dtype=np.int64)
        cols = {"k": Column(t.INT8, k), "v": Column(t.INT8, k % 97)}
        cluster.stores[node][table].append_batch(ColumnBatch(cols, n), ts)


def test_compact_planes_expand_at_the_first_write():
    c = Cluster(num_datanodes=2, device="cpu")
    s = c.session()
    s.execute("create table t (k bigint, v bigint) distribute by roundrobin")
    _bulk(c, "t", 500)
    assert s.query("select count(*), sum(v) from t")[0][0] == 1000
    dt = c.fused_executor().cache._tables[("t", (0, 1))]
    assert dt.xmin.shape == (2, 1)
    s.execute("delete from t where k < 7")
    got = s.query("select count(*), sum(v) from t")
    want_k = np.arange(7, 1000)
    assert got == [(len(want_k), int((want_k % 97).sum()))]
    assert dt.xmin.shape == (2, dt.rmax) and dt.xmax.shape == (2, dt.rmax)
    assert c.fused_executor().cache.stats["full_uploads"] == 1
    assert_fresh(c, "t")


@pytest.mark.parametrize("order", ["stamp_then_undo", "undo_then_stamp"])
def test_stamp_burst_with_repeated_positions_keeps_the_last_write(order):
    """Positions stamped more than once between two refreshes: the
    replay's scatter keeps the log's last write for each."""
    schema = {"k": t.INT8}
    st = ShardStore(schema, {})
    n = 64
    st.append_batch(ColumnBatch({"k": Column(t.INT8, np.arange(n))}, n), 5)
    cache = DeviceCache("cpu")

    class M:
        pass

    meta = M()
    meta.schema = schema
    stores = {0: {"x": st}}
    dt = cache.get("x", meta, stores, (0,), ["k"])
    hot = np.array([3, 9, 9, 20], dtype=np.int64)
    st.stamp_xmax(hot, 7)
    st.stamp_xmax(np.array([9, 30]), 8)
    if order == "stamp_then_undo":
        st.unstamp_xmax(np.array([3]))
        st.stamp_xmax(np.array([20, 3]), 9)
    else:
        st.stamp_xmax(np.array([3]), 9)
        st.unstamp_xmax(np.array([20, 3]))
    dt = cache.get("x", meta, stores, (0,), ["k"])
    assert cache.stats["full_uploads"] == 1
    assert cache.stats["mvcc_replays"] == 1  # one scatter, xmax only
    want = st.scan_view().xmax()
    assert torch.equal(dt.xmax[0, :n], torch.from_numpy(want))
    assert dt.xmax[0, 9] == 8 and dt.xmax[0, 30] == 8


def test_tail_widening_a_range_keeps_the_kernel_exact():
    """A tail whose values pass the uploaded |max| must widen the stats
    the certifier reads: K1's answer (its plain version on the CPU)
    stays exact, or the fragment program takes over, never a stale
    bound."""
    p = Pair("create table w (g int, a bigint, b bigint) "
             "distribute by roundrobin")
    p.both("insert into w values "
           + ",".join(f"({i % 3}, {i % 50}, {i % 7})" for i in range(300)))
    q = ("select g, sum(a * b), count(*) from w where a < 40 "
         "group by g order by g")
    p.query(q)
    fx = p.pc.fused_executor()
    assert fx.last_route == "scan_agg"
    big = 3_000_000_000_000
    p.both(f"insert into w values (1, 5, {big}), (2, 7, {big // 3}), "
           "(0, 30, 2)")
    got = p.query(q)
    dt = fx.cache._tables[("w", (0, 1))]
    assert dt.col_range["b"][1] == big and dt.col_maxabs["b"] == float(big)
    assert got[1][1] == sum((i % 50) * (i % 7) for i in range(300)
                            if i % 3 == 1 and i % 50 < 40) + 5 * big
    assert fx.cache.stats["full_uploads"] == 1
    assert_fresh(p.pc, "w")
    p.close()


def test_grouped_kernel_sees_a_new_group_key_from_the_tail():
    """A group key past the uploaded range arrives in a tail: the
    group-key domain widens and the new group is counted."""
    p = Pair("create table gk (g int, v bigint) distribute by roundrobin")
    p.both("insert into gk values "
           + ",".join(f"({i % 4}, {i})" for i in range(200)))
    q = "select g, sum(v), count(*) from gk group by g order by g"
    p.query(q)
    assert p.pc.fused_executor().last_route == "scan_agg"
    p.both("insert into gk values (9, 5), (9, 6), (-2, 1)")
    got = p.query(q)
    assert (9, 11, 2) in got and (-2, 1, 1) in got
    assert p.pc.fused_executor().cache.stats["full_uploads"] == 1
    p.close()


def test_rollback_truncation_replays_as_dead_rows():
    p = _kv_pair(300)
    p.query("select count(*), sum(v) from t")
    r0, p0 = p.stats()
    p.both("begin")
    p.both("insert into t values " + ",".join(
        f"({5000 + i}, {i})" for i in range(40)))
    p.both("rollback")
    p.both("insert into t values (7000, 3)")
    assert p.query("select count(*), sum(v) from t") == [
        (301, sum(range(300)) + 3)]
    r1, p1 = p.stats()
    assert _moved(p0, p1, "full_uploads") == _moved(r0, r1, "full_uploads") == 0
    assert_fresh(p.pc, "t")
    p.close()


def test_text_update_grows_the_dictionary_under_the_cache():
    p = Pair("create table tx (k bigint, s text, v bigint) "
             "distribute by shard(k)")
    p.both("insert into tx values " + ",".join(
        f"({i}, 'w{i % 3}', {i})" for i in range(120)))
    q = "select s, count(*), sum(v) from tx where s <> 'w1' group by s order by s"
    p.query(q)
    p.both("update tx set s = 'zz-new' where k < 10")
    p.both("insert into tx values (500, 'aa-new', 1)")
    got = p.query(q)
    assert ("zz-new", 10, sum(range(10))) in got and ("aa-new", 1, 1) in got
    assert p.query("select count(*) from tx where s like '%-new'") == [(11,)]
    assert_fresh(p.pc, "tx")
    p.close()


def test_full_upload_ships_bytes_and_a_tail_ships_only_the_tail():
    p = _kv_pair(4000)
    p.query("select sum(v) from t")
    _r0, p0 = p.stats()
    p.both("insert into t values (9000, 1), (9001, 2)")
    p.query("select sum(v) from t")
    _r1, p1 = p.stats()
    # one int64 column and both MVCC planes, two rows
    assert _moved(p0, p1, "h2d_bytes") == 2 * 8 * 3
    p.close()


def test_tail_past_rmax_rebuilds_as_the_reference_does():
    """A tail that stays inside a shard's padded rows is a delta; one
    that outgrows it is a full rebuild in both packages, and the port
    counts it as such (``rmax_rebuilds``)."""
    p = _kv_pair(1000)
    p.query("select count(*), sum(v) from t")
    dt = p.pc.fused_executor().cache._tables[("t", (0, 1))]
    rmax = dt.rmax
    r0, p0 = p.stats()
    p.both("insert into t values (5000, 1), (5001, 2)")
    p.query("select count(*), sum(v) from t")
    r1, p1 = p.stats()
    assert _moved(p0, p1, "full_uploads") == _moved(r0, r1, "full_uploads") == 0
    assert _moved(p0, p1, "rmax_rebuilds") == 0
    p.both("insert into t values "
           + ",".join(f"({6000 + i},{i})" for i in range(2 * rmax)))
    assert p.query("select count(*), sum(v) from t") == [
        (1002 + 2 * rmax, sum(range(1000)) + 3 + sum(range(2 * rmax)))]
    r2, p2 = p.stats()
    assert _moved(p1, p2, "full_uploads") == _moved(r1, r2, "full_uploads") == 1
    assert _moved(p1, p2, "rmax_rebuilds") == 1
    assert p.pc.fused_executor().cache._tables[("t", (0, 1))].rmax > rmax
    assert_fresh(p.pc, "t")
    p.close()

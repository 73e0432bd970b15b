"""Delta compaction in the port (storage/compaction.py and
``Cluster.compact_deltas``), held against the reference on
tests/test_write_path.py's compaction cases: ingest parks delta batches,
reads serve them in place, one compaction pass folds them with the same
answers, a crash image with deltas pending recovers in either package,
and the background job (``delta_compaction_naptime_ms``) folds them on
its own. The failpoint case (tests/test_write_path.py's
``test_compaction_crash_mid_fold_recovers``) is held in
tests/test_torch_fault.py."""

import shutil
import time

import pytest

from torch_pair import Pair, recover_clusters


def _pending(c) -> int:
    return sum(st.pending_delta_rows for stores in c.stores.values()
               for st in stores.values())


@pytest.mark.parametrize("swap", [False, True], ids=["own", "other"])
def test_delta_ingest_scan_parity_and_compaction(tmp_path, swap):
    d = str(tmp_path / "live")
    p = Pair(data_dir=d)
    p.both("create table t (k bigint, v bigint, w text) "
           "distribute by shard(k)")
    for base in range(0, 3000, 500):
        p.both("insert into t values " + ",".join(
            f"({base + i}, {i * 3}, 'w{i % 7}')" for i in range(500)))
    assert _pending(p.rc) > 0 and _pending(p.pc) > 0
    q = "select k, v, w from t order by k"
    want = p.query(q)
    assert len(want) == 3000
    crash = str(tmp_path / "crash")
    shutil.copytree(d, crash)  # deltas pending, no close
    p.both("insert into t values (90001, 1, 'x'), (90002, 2, 'y')")
    fx = p.pc.fused_executor()
    uploads = fx.cache.stats["full_uploads"]
    assert p.pc.compact_deltas() > 0
    p.rc.compact_deltas()
    assert _pending(p.pc) == 0
    after = p.query(q)
    assert after[:3000] == want and len(after) == 3002
    # the fold kept every position: the planes stay valid
    assert fx.cache.stats["full_uploads"] == uploads
    p.close()
    r = Pair(clusters=recover_clusters(crash, swap=swap))
    assert r.query(q) == want
    r.close()


def test_delta_dml_interleaving():
    """UPDATE and DELETE stamp delta rows in place, VACUUM compacts, a
    rolled-back insert stays invisible; the same on both routes."""
    p = Pair()
    p.both("create table t (k bigint, v bigint) distribute by shard(k)")
    p.both("insert into t values " + ",".join(
        f"({i}, {i})" for i in range(100)))
    p.both("delete from t where k % 10 = 0")
    p.both("update t set v = v + 1000 where k < 5")
    rows = p.query("select k, v from t order by k")
    assert (0, 0) not in rows and (1, 1001) in rows and (7, 7) in rows
    p.both("vacuum")
    assert p.query("select k, v from t order by k") == rows
    p.both("begin")
    p.both("insert into t values (555, 5), (556, 6)")
    p.both("rollback")
    assert p.query("select count(*) from t where k in (555, 556)") == [(0,)]
    assert p.pc.compact_deltas() >= 0
    assert p.query("select k, v from t order by k") == rows
    p.close()


def test_background_compaction_job(tmp_path):
    """With ``delta_compaction_naptime_ms`` the job folds pending deltas
    on its own, the answers unchanged; ``close`` stops it."""
    p = Pair(data_dir=str(tmp_path),
             conf={"delta_compaction_naptime_ms": "20ms"})
    assert p.pc._compaction_stop is not None
    p.both("create table t (k bigint, v bigint) distribute by shard(k)")
    p.both("insert into t values " + ",".join(
        f"({i}, {i % 9})" for i in range(400)))
    deadline = time.monotonic() + 10
    while _pending(p.pc) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert _pending(p.pc) == 0
    assert p.query("select count(*), sum(v) from t") == [(400, 1590)]
    p.close()
    assert p.pc._compaction_stop is None

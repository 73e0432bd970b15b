"""Streaming replication in the port (tests/test_replication.py's shapes
that need no sequences, partitions or promotion): hot-standby reads,
writes refused, a resync after a restart, pure reads; the
``synchronous_commit`` standby rungs; the walsender and otb_standby as
processes; and the stream held byte for byte across the packages: the
reference's standby follows the port's walsender and the port's
standby follows the reference's, each answering exactly as the primary
does (tolerance: none)."""

import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.storage.replication import StandbyCluster as RefStandby
from opentenbase_tpu.storage.replication import WalSender as RefSender
from opentenbase_tpu_torch.engine import Cluster, SQLError
from opentenbase_tpu_torch.storage.replication import StandbyCluster, WalSender

from test_torch_dn import ROOT, START_S, reap

WRITES = (
    "create table t (k bigint, v text, n numeric(10,2)) "
    "distribute by shard(k)",
    "create table r (k bigint, w bigint) distribute by replication",
    "insert into t values (1,'a',1.50),(2,'b',null),(3,null,3.25),"
    "(4,'a',4.00)",
    "insert into r values (1,10),(2,20)",
    "begin",
    "insert into t values (5,'c',5.00)",
    "update t set v = 'z' where k = 2",
    "commit",
    "begin",
    "insert into t values (6,'never',6.00)",
    "rollback",
    "delete from t where k = 1",
    "update r set w = w + 1 where k = 2",
)
READS = (
    "select k, v, n from t order by k",
    "select v, count(*), sum(n) from t group by v order by v",
    "select t.k, r.w from t, r where t.k = r.k order by t.k",
    "select count(*), min(v), max(v) from t",
)


@pytest.fixture()
def primary(tmp_path):
    c = Cluster(num_datanodes=2, shard_groups=32,
                data_dir=str(tmp_path / "pri"), device="cpu")
    sender = WalSender(c.persistence)
    yield c, sender, tmp_path
    sender.stop()
    c.close()


def standby(tmp, sender, name="sb"):
    sb = StandbyCluster(str(tmp / name), num_datanodes=2, shard_groups=32,
                        device="cpu")
    return sb.start_replication(sender.host, sender.port)


def test_hot_standby_reads_replicated_data(primary):
    c, sender, tmp = primary
    s = c.session()
    s.execute("create table t (k bigint, v text) distribute by shard(k)")
    s.execute("insert into t values (1,'a'),(2,'b')")
    sb = standby(tmp, sender)
    try:
        assert sb.wait_caught_up(c.persistence)
        rs = sb.session()
        assert rs.query("select k, v from t order by k") == [(1, "a"),
                                                             (2, "b")]
        s.execute("insert into t values (3,'c')")
        s.execute("delete from t where k = 1")
        assert sb.wait_caught_up(c.persistence)
        assert rs.query("select k from t order by k") == [(2,), (3,)]
        assert sb.lag_bytes(c.persistence) == 0
        (addr, acked), = sender.peer_acks()
        assert addr == sb.repl_addr and acked == c.persistence.wal.position
    finally:
        sb.close()


def test_standby_rejects_writes(primary):
    c, sender, tmp = primary
    c.session().execute("create table x (k bigint) distribute by shard(k)")
    sb = standby(tmp, sender)
    try:
        assert sb.wait_caught_up(c.persistence)
        rs = sb.session()
        for sql in ("create table y (k bigint) distribute by shard(k)",
                    "insert into x values (1)", "delete from x",
                    "vacuum"):
            with pytest.raises(SQLError, match="read-only") as ei:
                rs.execute(sql)
            assert ei.value.sqlstate == "25006"
        # a promotion ends the refusals: the standby takes writes
        sb.promote()
        rs.execute("insert into x values (1)")
        assert rs.query("select count(*) from x") == [(1,)]
    finally:
        sb.close()


def test_a_stopped_walsender_sends_nothing_more(primary):
    """Once WalSender.stop() returns, no frame the WAL gains reaches a
    standby, even from a stream thread already past its stop check (the
    reference's sends it: ROADMAP C)."""
    c, sender, tmp = primary
    s = c.session()
    s.execute("create table t (k bigint) distribute by shard(k)")
    s.execute("insert into t values (1)")
    sb = standby(tmp, sender)
    try:
        assert sb.wait_caught_up(c.persistence)
        applied = sb.applied
        parked, release = threading.Event(), threading.Event()
        real = sender._note_position

        def note():
            # the stream thread, inside its loop, waits for the test
            parked.set()
            release.wait(10)
            real()

        sender._note_position = note
        assert parked.wait(10)
        sender.stop()
        s.execute("insert into t values (2)")
        release.set()
        time.sleep(0.5)
        assert sb.applied == applied
        assert sb.session().query("select count(*) from t") == [(1,)]
    finally:
        release.set()
        sb.close()


def test_standby_resync_after_restart(primary):
    """The standby reconnects from its own durable offset."""
    c, sender, tmp = primary
    s = c.session()
    s.execute("create table t (k bigint) distribute by shard(k)")
    s.execute("insert into t values (1)")
    sb = standby(tmp, sender)
    assert sb.wait_caught_up(c.persistence)
    applied = sb.applied
    sb.close()  # the standby "crashes"
    s.execute("insert into t values (2)")
    sb2 = standby(tmp, sender)
    try:
        assert sb2.wait_caught_up(c.persistence)
        assert sb2.applied > applied
        assert sb2.session().query("select k from t order by k") == [
            (1,), (2,)]
    finally:
        sb2.close()


def test_standby_allows_pure_reads(primary):
    c, sender, tmp = primary
    s = c.session()
    s.execute("create table t (k bigint) distribute by shard(k)")
    s.execute("insert into t values (1)")
    sb = standby(tmp, sender)
    try:
        assert sb.wait_caught_up(c.persistence)
        rs = sb.session()
        for sql in ("set enable_fused_execution = off", "begin"):
            rs.execute(sql)
        assert rs.query("select count(*) from t") == [(1,)]
        rs.execute("commit")
    finally:
        sb.close()


def test_synchronous_commit_waits_for_the_standby(primary):
    """``remote_write``: a majority of the walsender's standbys acked
    the commit's frame before COMMIT returns; with no standby attached
    a commit waits for nothing."""
    c, sender, tmp = primary
    s = c.session()
    s.execute("create table t (k bigint) distribute by shard(k)")
    s.execute("set synchronous_commit = remote_write")
    s.execute("insert into t values (1)")  # no standby yet: no wait
    sb = standby(tmp, sender)
    try:
        assert sb.wait_caught_up(c.persistence)
        s.execute("insert into t values (2), (3)")
        # the ack covered this commit's frame before the statement
        # returned
        assert max(a for _p, a in sender.peer_acks()) >= s.last_commit_lsn
        assert sb.applied >= s.last_commit_lsn
        s.execute("set synchronous_commit = on")  # no datanodes: local
        s.execute("insert into t values (4)")
        with pytest.raises(SQLError, match="must be one of"):
            s.execute("set synchronous_commit = quorum")
    finally:
        sb.close()


def test_a_record_larger_than_the_window_streams_whole(primary,
                                                        monkeypatch):
    """Acks move by whole records, so a commit frame larger than the
    walsender's window must still go out whole (a bulk load's frames are
    hundreds of MB against a 16 MB window)."""
    c, sender, tmp = primary
    monkeypatch.setattr(WalSender, "WINDOW_BYTES", 4096)
    monkeypatch.setattr(WalSender, "CHUNK_BYTES", 4096)
    s = c.session()
    s.execute("create table t (k bigint, v bigint) distribute by shard(k)")
    sb = standby(tmp, sender)
    try:
        assert sb.wait_caught_up(c.persistence)  # acked: the window holds
        s.execute("insert into t values " + ",".join(
            f"({i}, {i * 7})" for i in range(5000)))
        assert c.persistence.wal.position - sb.applied > 4 * 4096
        assert sb.wait_caught_up(c.persistence, 30.0)
        assert sb.session().query("select count(*), sum(v) from t") == [
            (5000, 7 * sum(range(5000)))]
    finally:
        sb.close()


def test_a_bulk_frame_is_folded_into_the_base(primary, monkeypatch):
    """A store that replay left with ``FOLD_ROWS`` delta rows is folded
    into its base arrays (positions kept); a small commit stays a delta
    batch. The answers do not change."""
    c, sender, tmp = primary
    monkeypatch.setattr(StandbyCluster, "FOLD_ROWS", 1000)
    s = c.session()
    s.execute("create table t (k bigint, v bigint) distribute by shard(k)")
    s.execute("insert into t values " + ",".join(
        f"({i}, {i})" for i in range(4000)))
    sb = standby(tmp, sender)
    try:
        assert sb.wait_caught_up(c.persistence)
        stores = [sb.cluster.stores[n]["t"] for n in (0, 1)]
        assert [st.pending_delta_rows for st in stores] == [0, 0]
        assert sum(st.nrows for st in stores) == 4000
        s.execute("insert into t values (5000, 1)")
        assert sb.wait_caught_up(c.persistence)
        assert sum(st.pending_delta_rows for st in stores) == 1
        q = "select count(*), sum(v) from t"
        assert sb.session().query(q) == s.query(q)
    finally:
        sb.close()


@pytest.mark.parametrize("direction", ["reference follows port",
                                       "port follows reference"])
def test_stream_crosses_packages(tmp_path, direction):
    """One package's walsender, the other's standby: the standby answers
    every read as the primary does."""
    port_primary = direction == "reference follows port"
    if port_primary:
        c = Cluster(2, 32, data_dir=str(tmp_path / "pri"), device="cpu")
        sender = WalSender(c.persistence)
        sb = RefStandby(str(tmp_path / "sb"), 2, 32)
    else:
        c = RefCluster(2, 32, data_dir=str(tmp_path / "pri"))
        sender = RefSender(c.persistence)
        sb = StandbyCluster(str(tmp_path / "sb"), 2, 32, device="cpu")
    try:
        s = c.session()
        for sql in WRITES[:4]:
            s.execute(sql)
        sb.start_replication(sender.host, sender.port)
        for sql in WRITES[4:]:  # the rest while streaming
            s.execute(sql)
        assert sb.wait_caught_up(c.persistence, 30.0)
        assert sb.applied == c.persistence.wal.position
        rs = sb.session()
        for q in READS:
            assert rs.query(q) == s.query(q), q
    finally:
        sb.stop()
        sender.stop()
        c.close()


def _lines(proc) -> queue.Queue:
    """The process's stdout lines, read by one thread ('' at the end)."""
    q: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [q.put(ln) for ln in iter(
        proc.stdout.readline, "")] + [q.put("")], daemon=True).start()
    return q


def _banner(q, pattern: str, timeout: float = START_S) -> str:
    seen = []
    while True:
        line = q.get(timeout=timeout)
        if not line:
            raise AssertionError(f"process ended: {seen}")
        seen.append(line)
        if pattern in line:
            return line


def test_otb_server_wal_port_and_otb_standby(tmp_path):
    """otb_server --wal-port streams to an otb_standby process, whose
    SQL port answers the primary's rows; its control port reports the
    applied offset and refuses promotion by name."""
    from opentenbase_tpu_torch.net.client import connect_tcp

    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = []
    try:
        srv = subprocess.Popen(
            [sys.executable, "-m", "opentenbase_tpu_torch.cli.otb_server",
             "--data-dir", str(tmp_path / "pri"), "--port", "0",
             "--wal-port", "0", "--device", "cpu"],
            stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        procs.append(srv)
        out = _lines(srv)
        wal_port = int(_banner(out, "walsender on").split(":")[-1])
        line = _banner(out, "listening on")
        port = int(line.split("127.0.0.1:")[1].split()[0])
        with connect_tcp("127.0.0.1", port, timeout=60) as cs:
            cs.execute("create table t (k bigint, v text) "
                       "distribute by shard(k)")
            cs.execute("insert into t values (1,'a'),(2,'b'),(3,'a')")
            wal_pos = cs.execute("insert into t values (4,'c')").wal_pos
        sb = subprocess.Popen(
            [sys.executable, "-m", "opentenbase_tpu_torch.cli.otb_standby",
             "--primary-port", str(wal_port), "--data-dir",
             str(tmp_path / "sb"), "--device", "cpu"],
            stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        procs.append(sb)
        line = _banner(_lines(sb), "standby ready")
        sql_port = int(line.split("sql=127.0.0.1:")[1].split()[0])
        ctl_port = int(line.split("control=127.0.0.1:")[1].split()[0])
        with socket.create_connection(("127.0.0.1", ctl_port),
                                      timeout=60) as ctl:
            f = ctl.makefile("rw")
            for _ in range(3000):
                f.write("status\n")
                f.flush()
                st = json.loads(f.readline())
                if st["applied"] >= wal_pos:
                    break
            assert st == {"role": "standby", "applied": st["applied"],
                          "read_only": True} and st["applied"] >= wal_pos
        with connect_tcp("127.0.0.1", sql_port, timeout=60) as rs:
            assert rs.query("select v, count(*) from t group by v "
                            "order by v") == [("a", 2), ("b", 1), ("c", 1)]
            with pytest.raises(Exception, match="read-only"):
                rs.execute("insert into t values (9,'x')")
        with socket.create_connection(("127.0.0.1", ctl_port),
                                      timeout=60) as ctl:
            f = ctl.makefile("rw")
            f.write("promote\n")
            f.flush()
            assert json.loads(f.readline()) == {"promoted": True}
            f.write("status\n")
            f.flush()
            st = json.loads(f.readline())
            assert st["role"] == "primary" and st["read_only"] is False
        with connect_tcp("127.0.0.1", sql_port, timeout=60) as rs:
            rs.execute("insert into t values (9,'x')")
            assert rs.query("select count(*) from t") == [(5,)]
    finally:
        reap(procs)

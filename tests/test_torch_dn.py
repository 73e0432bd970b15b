"""The port's datanode processes against the reference's cluster.

A port coordinator (``Cluster(..., device="cpu")`` with a data
directory) streams its WAL to two datanode processes (``python -m
opentenbase_tpu_torch.dn.server --device cpu``) that run the host
route's fragments; a reference ``Cluster`` holds the same rows in
process. tests/test_dn_process.py's shapes: every answer must equal the
reference's exactly (tolerance: none), with the fragments marked
``remote`` and the redistribution on the peer exchange. Every
subprocess wait has a time limit and every teardown step is guarded.
"""

import os
import queue
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import NotPorted
from opentenbase_tpu_torch.engine import Cluster
from opentenbase_tpu_torch.storage.replication import WalSender

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START_S = 120.0  # a datanode's READY, on a loaded machine

T_DDL = ("create table t (k bigint, v numeric(10,2), tag text) "
         "distribute by shard(k)")


def t_rows() -> str:
    rng = np.random.default_rng(4)
    return ",".join(
        f"({i}, {i}.25, '{w}')"
        for i, w in zip(range(500), rng.choice(["x", "y", "z"], 500)))


def spawn_dns(base, sender, nodes=(0, 1), extra_args=(), python_args=()):
    """Start one datanode process a node, all at once, and read each
    READY line through a reader thread with a deadline. Returns
    ([Popen], [port]); a failed start kills every child first."""
    procs, lines = [], []
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    try:
        for node in nodes:
            p = subprocess.Popen(
                [sys.executable, *python_args, "-m",
                 "opentenbase_tpu_torch.dn.server",
                 "--data-dir", str(base / f"dn{node}"),
                 "--wal-host", sender.host, "--wal-port", str(sender.port),
                 "--num-datanodes", "2", "--shard-groups", "32",
                 "--device", "cpu", *extra_args],
                stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
            procs.append(p)
            q: queue.Queue = queue.Queue()
            threading.Thread(target=lambda p=p, q=q: [
                q.put(ln) for ln in iter(p.stdout.readline, "")],
                daemon=True).start()
            lines.append(q)
        ports = []
        for p, q in zip(procs, lines):
            line = q.get(timeout=START_S).strip()
            assert line.startswith("READY "), line
            ports.append(int(line.split()[1]))
        return procs, ports
    except BaseException:
        reap(procs)
        raise


def reap(procs) -> None:
    """Terminate, then kill on a timeout; one failure never skips the
    rest."""
    for p in procs:
        try:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=10)
        except Exception:
            pass


def wait_applied(c, timeout_s: float = 30.0) -> None:
    """Until every attached datanode replayed the coordinator's WAL."""
    pos = c.persistence.wal.position
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(ch.rpc({"op": "ping"})["applied"] >= pos
               for ch in c.dn_channels.values()):
            return
        time.sleep(0.02)
    raise AssertionError("datanodes never caught up")


def topology_impl(base, poll_s: float = 0.05):
    """A port coordinator with t loaded, its walsender and two datanode
    processes attached; a reference cluster with the same rows. Yields
    (port cluster, port session, reference session, procs, sender)."""
    ref = RefCluster(num_datanodes=2, shard_groups=32)
    rs = ref.session()
    c = Cluster(num_datanodes=2, shard_groups=32,
                data_dir=str(base / "cn"), device="cpu")
    s = c.session()
    for sess in (rs, s):
        sess.execute(T_DDL)
        sess.execute(f"insert into t values {t_rows()}")
    sender = WalSender(c.persistence, poll_s=poll_s)
    procs = []
    try:
        procs, ports = spawn_dns(base, sender)
        for node, port in zip((0, 1), ports):
            c.attach_datanode(node, "127.0.0.1", port, pool_size=2,
                              rpc_timeout=120)
        yield c, s, rs, procs, sender
    finally:
        for node in (0, 1):
            try:
                c.detach_datanode(node)
            except Exception:
                pass
        reap(procs)
        try:
            sender.stop()
        except Exception:
            pass
        c.close()


@pytest.fixture()
def topology(tmp_path):
    yield from topology_impl(tmp_path)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One topology for the tests that only read."""
    yield from topology_impl(tmp_path_factory.mktemp("dn"))


def remote_query(s, q):
    """``q`` on the host route; asserts every fragment ran remotely."""
    s.execute("set enable_fused_execution = off")
    rows = s.query(q)
    instr = s.last_executor.instrumentation
    assert instr and all(i.get("remote") for i in instr), instr
    return rows


def ref_query(rs, q):
    rs.execute("set enable_fused_execution = off")
    return rs.query(q)


SHAPES = [
    "select count(*), sum(v) from t where k < 100",
    "select tag, count(*) from t group by tag order by tag",
    "select k, v from t where tag = 'x' and k < 50 order by k",
    "select count(*) from t a, t b where a.k = b.k and b.v < 100",
    "select a.tag, count(*), sum(b.v) from t a, t b where a.k = b.k "
    "group by a.tag order by a.tag",
    "select k, v from t order by v desc, k limit 7",
    "select avg(v), min(v), max(v), min(tag), max(tag) from t",
]


@pytest.mark.parametrize("q", SHAPES)
def test_remote_matches_reference_including_text(shared, q):
    c, s, rs, _p, _s = shared
    got = remote_query(s, q)
    want = ref_query(rs, q)
    if "order by" in q:
        assert got == want, q
    else:
        assert sorted(got) == sorted(want), q


def test_fragments_execute_in_dn_processes(shared):
    c, s, rs, _p, _s = shared
    q = "select count(*), sum(v) from t where k < 100"
    got = remote_query(s, q)
    assert got == ref_query(rs, q)
    instr = s.last_executor.instrumentation
    assert {i["node"] for i in instr} == {0, 1}
    assert all(i["wire_bytes"] > 0 and i["dn_ms"] > 0 for i in instr)


def test_pool_reuses_channels(shared):
    c, s, _rs, _p, _s = shared
    for _ in range(3):
        remote_query(s, "select count(*) from t")
    pool = c.dn_channels[0]
    assert pool.stats["acquired"] >= 3
    assert pool.stats["opened"] <= 2  # warm channels were reused


def test_fused_route_still_answers_on_the_coordinator(shared):
    """With datanodes attached the fused route answers first, on the
    coordinator's own stores, as the reference's does."""
    c, s, rs, _p, _s = shared
    s.execute("set enable_fused_execution = on")
    q = "select count(*), sum(v) from t where k < 300"
    assert s.query(q) == rs.query(q)
    assert s.last_route == "fused" and s.last_executor is None


def test_read_your_writes_through_dn(topology):
    c, s, rs, _p, _s = topology
    q = "select count(*) from t"
    for sess in (s, rs):
        sess.execute("insert into t values (9001, 1.00, 'w')")
    assert remote_query(s, q) == ref_query(rs, q) == [(501,)]


def test_writing_txn_still_reads_other_tables_remotely(topology):
    """A transaction that wrote u still runs fragments over t in the
    datanode processes; a fragment over u stays in process (its rows
    exist only in the coordinator's stores until commit)."""
    c, s, rs, _p, _s = topology
    for sess in (s, rs):
        sess.execute("set enable_fused_execution = off")
        sess.execute("create table u (k bigint, w bigint) "
                     "distribute by shard(k)")
        sess.execute("begin")
        sess.execute("insert into u values (1, 10), (2, 20)")
    assert s.query("select count(*) from t") == rs.query(
        "select count(*) from t") == [(500,)]
    assert all(i.get("remote") for i in s.last_executor.instrumentation)
    assert s.query("select count(*), sum(w) from u") == rs.query(
        "select count(*), sum(w) from u")
    assert not any(i.get("remote")
                   for i in s.last_executor.instrumentation)
    for sess in (s, rs):
        sess.execute("commit")
    assert remote_query(s, "select sum(w) from u") == [(30,)]


def test_implicit_2pc_votes_on_dn_processes(topology):
    """A write over both nodes commits through implicit 2PC: each
    datanode journals a vote carrying the write set and phase 2 retires
    it, applying the rows ahead of the stream."""
    c, s, rs, _p, _s = topology
    ins = "insert into t values " + ",".join(
        f"({i}, 0.10, 'w')" for i in range(6000, 6040))
    for sess in (s, rs):
        sess.execute("begin")
        sess.execute(ins)
        sess.execute("commit")
    assert s.last_2pc["nodes"] == [0, 1]
    assert c.dml_stats["shipped"] == 1
    for n, ch in c.dn_channels.items():
        assert ch.rpc({"op": "2pc_list"})["gids"] == [], n
    q = "select count(*), sum(v) from t where k >= 6000"
    assert remote_query(s, q) == ref_query(rs, q)
    for sess in (s, rs):  # one row: one node, no 2PC
        sess.execute("insert into t values (6100, 0.10, 'w')")
    assert s.last_2pc is None
    assert remote_query(s, q) == ref_query(rs, q)


def test_orphan_sweep_and_explicit_prepare_refused(topology):
    """A vote no coordinator state knows is retired by clean_2pc; an
    explicit PREPARE TRANSACTION (once refused by name) journals a vote
    on each datanode process it wrote to, which ROLLBACK PREPARED
    retires."""
    c, s, _rs, _p, _s = topology
    c.dn_channels[0].rpc({"op": "2pc_prepare", "gid": "orphan_gid",
                          "gxid": 999999})
    assert c.dn_channels[0].rpc({"op": "2pc_list"})["gids"] == [
        "orphan_gid"]
    assert c.clean_2pc(max_age_s=3600.0) == []  # too young to sweep
    assert c.clean_2pc(max_age_s=0.0) == ["dn0:orphan_gid"]
    assert c.dn_channels[0].rpc({"op": "2pc_list"})["gids"] == []
    s.execute("begin")
    s.execute("insert into t values (7000, 0.20, 'p')")
    s.execute("prepare transaction 'gid_dn_test'")
    votes = {n: ch.rpc({"op": "2pc_list"})["gids"]
             for n, ch in c.dn_channels.items()}
    assert sorted(g for gids in votes.values() for g in gids) == [
        "gid_dn_test"]
    # its votes are no orphans (the GTM lists the gid), and it is too
    # young for the staleness rule
    assert c.clean_2pc(max_age_s=3600.0) == []
    s.execute("rollback prepared 'gid_dn_test'")
    assert all(ch.rpc({"op": "2pc_list"})["gids"] == []
               for ch in c.dn_channels.values())


def test_refused_ops_name_what_is_not_ported(shared):
    from opentenbase_tpu_torch.net.pool import ChannelError

    c, _s, _rs, _p, _s2 = shared
    for op, what in (("trace_fetch", "trace ring"),
                     ("rebalance_apply", "rebalance"),
                     ("log_fetch", "log ring")):
        with pytest.raises(ChannelError, match=f"NotPorted: {op}.*{what}"):
            c.dn_channels[0].rpc({"op": op})
    # the fault-control ops are no longer refused (fault/): an arm, its
    # counters and its clear, in the datanode process's own registry
    ch = c.dn_channels[0]
    assert ch.rpc({"op": "fault_arm", "site": "x/y", "action": "error",
                   "spec": "once"})["ok"]
    rows = ch.rpc({"op": "fault_stats"})["rows"]
    assert ["x/y", "error", "once", 1, 0, 0, True] in rows
    assert ch.rpc({"op": "fault_clear", "site": "x/y"})["cleared"] == 1
    # within-fragment parallel workers are no longer refused: under the
    # row threshold a fragment asking for 4 runs the serial path
    from opentenbase_tpu_torch.executor.dist import DistExecutor
    from opentenbase_tpu_torch.plan import analyze_statement
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse

    q = "select tag, count(*), sum(v) from t group by tag"
    dp = distribute_statement(optimize_statement(
        analyze_statement(parse(q)[0], c.catalog), c.catalog), c.catalog)
    got = [sorted(DistExecutor(
        c.catalog, c.stores, c.gts.snapshot_ts(), device="cpu",
        dn_channels=c.dn_channels, min_lsn=c.persistence.wal.position,
        parallel_workers=k).run(dp).to_rows()) for k in (1, 4)]
    assert got[0] == got[1] and len(got[0]) == 3


def test_peer_exchange_data_plane(topology, monkeypatch):
    """A redistribution between the two datanode processes goes
    producer to consumer directly: the producer's call returns a row
    count, the consumer's carries no inline batch, and the datanodes
    count the parts they moved."""
    import opentenbase_tpu_torch.net.pool as pool

    c, s, rs, _p, _s = topology
    o2 = ("create table o2 (ok bigint, cust bigint, total numeric(10,2)) "
          "distribute by shard(ok)")
    ins = "insert into o2 values " + ",".join(
        f"({i}, {i % 500}, 2.00)" for i in range(1000))
    for sess in (s, rs):
        sess.execute(o2)
        sess.execute(ins)
    traffic = []
    orig = pool.ChannelPool.rpc

    def spy(self, msg, timeout_s=None):
        resp = orig(self, msg, timeout_s)
        traffic.append((msg, resp))
        return resp

    monkeypatch.setattr(pool.ChannelPool, "rpc", spy)
    q = ("select t.tag, sum(o2.total) from t join o2 on t.k = o2.cust "
         "group by t.tag order by t.tag")
    got = remote_query(s, q)
    monkeypatch.setattr(pool.ChannelPool, "rpc", orig)
    assert got == ref_query(rs, q)
    producers = [(m, r) for m, r in traffic
                 if m.get("op") == "exec_fragment" and m.get("motion")]
    consumers = [(m, r) for m, r in traffic
                 if m.get("op") == "exec_fragment" and m.get("exchanges")]
    assert producers and consumers
    for m, r in producers:
        assert m["motion"]["kind"] in ("redistribute", "broadcast")
        assert "batch" not in r
    for m, _r in consumers:
        assert not m.get("inputs")
    assert any(st.get("peer") for st in
               s.last_executor.motion_stats.values())
    stats = [ch.rpc({"op": "ping"})["dml_stats"]
             for ch in c.dn_channels.values()]
    assert sum(st.get("exch_parts_in", 0) for st in stats) >= 2, stats


def test_serde_matches_the_reference_both_ways(shared, tmp_path):
    """The same SQL's fragments serialize to equal JSON in both
    packages; a fragment serialized by the reference, run by an
    in-process port DNServer, gives the batch the reference's
    LocalExecutor gives."""
    from opentenbase_tpu.executor.local import LocalExecutor as RefLocal
    from opentenbase_tpu.plan import serde as ref_serde
    from opentenbase_tpu.plan.analyze import analyze_statement as ref_an
    from opentenbase_tpu.plan.distribute import (
        distribute_statement as ref_dist,
    )
    from opentenbase_tpu.plan.optimize import optimize_statement as ref_opt
    from opentenbase_tpu.sql.parser import parse as ref_parse
    from opentenbase_tpu_torch.dn.server import DNServer
    from opentenbase_tpu_torch.plan import analyze_statement, serde
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse

    c, s, rs, _p, sender = shared
    ref = rs.cluster
    dn = DNServer(str(tmp_path / "dn_inproc"), sender.host, sender.port,
                  2, 32, device="cpu").start()
    try:
        assert dn.standby.wait_caught_up(c.persistence, 30.0)
        for q in SHAPES:
            rp = ref_dist(ref_opt(ref_an(ref_parse(q)[0], ref.catalog),
                                  ref.catalog), ref.catalog)
            pp = distribute_statement(optimize_statement(
                analyze_statement(parse(q)[0], c.catalog), c.catalog),
                c.catalog)
            assert [ref_serde.dumps_plan(f.root) for f in rp.fragments] == [
                serde.dumps_plan(f.root) for f in pp.fragments], q
            for f in rp.fragments:
                js = ref_serde.dumps_plan(f.root)
                if "RemoteSource" in js:
                    continue  # its input comes from another fragment
                for node in f.nodes:
                    want = RefLocal(ref.catalog, ref.stores[node],
                                    ref.gts.snapshot_ts()).run_plan(f.root)
                    resp = dn._dispatch({
                        "op": "exec_fragment", "node": node,
                        "plan": js,
                        "snapshot_ts": c.gts.snapshot_ts()})
                    got = serde.batch_from_wire(resp["batch"], c.catalog)
                    assert got.column_names() == want.column_names(), q
                    assert sorted(map(tuple, got.to_rows())) == sorted(
                        map(tuple, want.to_rows())), q
    finally:
        dn.stop()
        dn.standby.close()


def test_dn_process_loads_neither_jax_nor_the_reference(tmp_path):
    """A datanode process that served a fragment has no ``jax`` and no
    ``opentenbase_tpu`` module loaded (checked at its exit)."""
    c = Cluster(2, 32, data_dir=str(tmp_path / "cn"), device="cpu")
    s = c.session()
    s.execute(T_DDL)
    s.execute(f"insert into t values {t_rows()}")
    sender = WalSender(c.persistence)
    probe = ("import atexit, runpy, sys\n"
             "def report():\n"
             "    bad = sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith('jax.') or m == 'opentenbase_tpu' or "
             "m.startswith('opentenbase_tpu.'))\n"
             "    print('LOADED', bad, flush=True)\n"
             "atexit.register(report)\n"
             "sys.argv[0] = 'dn'\n"
             "runpy.run_module('opentenbase_tpu_torch.dn.server', "
             "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.Popen(
        [sys.executable, "-c", probe, "--data-dir", str(tmp_path / "dn0"),
         "--wal-host", sender.host, "--wal-port", str(sender.port),
         "--num-datanodes", "2", "--shard-groups", "32", "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        q: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [q.put(ln) for ln in iter(
            p.stdout.readline, "")] + [q.put("")], daemon=True).start()
        line = q.get(timeout=START_S)
        assert line.startswith("READY "), line
        c.attach_datanode(0, "127.0.0.1", int(line.split()[1]))
        s.execute("set enable_fused_execution = off")
        n = s.query("select count(*) from t where tag = 'x'")
        assert any(i.get("remote") for i in s.last_executor.instrumentation)
        assert n[0][0] > 0
        c.detach_datanode(0)
        p.terminate()
        p.wait(timeout=30)
        out = []
        while True:
            ln = q.get(timeout=30)
            if not ln:
                break
            out.append(ln)
        assert "LOADED []\n" in out, out
    finally:
        reap([p])
        sender.stop()
        c.close()


def cut_pool(calls: list):
    """A stand-in for a datanode's channel pool whose fragment calls are
    all cut at their socket deadline; every call is noted in ``calls``
    as (op, token, timeout_s)."""
    from opentenbase_tpu_torch.net.pool import ChannelError

    class CutPool:
        host, port, rpc_timeout = "127.0.0.1", 1, 120.0

        def rpc(self, msg, timeout_s=None):
            calls.append((msg["op"], msg.get("cancel_token")
                          or msg.get("token"), timeout_s))
            if msg["op"] == "exec_fragment":
                try:
                    raise TimeoutError("timed out")
                except TimeoutError as e:
                    raise ChannelError("channel I/O failed") from e
            return {"ok": True}

    return CutPool()


def test_a_remote_fragment_cut_at_its_deadline_is_cancelled():
    """A statement deadline bounds each remote call; a call cut at its
    socket deadline sends ``cancel_fragment`` with the fragment's token
    and raises the statement timeout (SQLSTATE 57014)."""
    from opentenbase_tpu_torch.executor.dist import (
        DistExecutor,
        StatementTimeout,
    )
    from opentenbase_tpu_torch.plan import analyze_statement
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse

    c = Cluster(2, 32, device="cpu")
    s = c.session()
    s.execute(T_DDL)
    s.execute(f"insert into t values {t_rows()}")
    calls = []
    dp = distribute_statement(optimize_statement(analyze_statement(
        parse("select count(*) from t")[0], c.catalog), c.catalog),
        c.catalog)
    ex = DistExecutor(c.catalog, c.stores, c.gts.snapshot_ts(),
                      device="cpu",
                      dn_channels={0: cut_pool(calls), 1: cut_pool(calls)},
                      deadline=time.monotonic() + 30)
    with pytest.raises(StatementTimeout) as ei:
        ex.run(dp)
    assert ei.value.sqlstate == "57014"
    sent = {tok: t for op, tok, t in calls if op == "exec_fragment"}
    cancelled = {tok for op, tok, _t in calls if op == "cancel_fragment"}
    assert cancelled and cancelled <= set(sent)
    assert all(0 < t <= 30 for t in sent.values())


def test_statement_timeout_bounds_a_sessions_remote_fragments():
    """``SET statement_timeout`` gives each statement the deadline its
    remote calls honor: a fragment cut at it is cancelled and the
    statement fails with SQLSTATE 57014; the deadline ends with its
    statement, and 0 or RESET takes it away. The setting parses as the
    reference's does (ms or a duration string)."""
    from opentenbase_tpu_torch.engine import SQLError

    c = Cluster(2, 32, device="cpu")
    s = c.session()
    s.execute(T_DDL)
    s.execute(f"insert into t values {t_rows()}")
    ref = RefCluster(num_datanodes=2, shard_groups=32).session()
    for sql, ms in (("set statement_timeout = '2s'", 2000),
                    ("set statement_timeout = '150ms'", 150),
                    ("set statement_timeout = 250", 250),
                    ("reset statement_timeout", 0)):
        s.execute(sql)
        ref.execute(sql)
        assert s.gucs["statement_timeout"] == ms
        assert ref._duration_ms(ref.gucs.get("statement_timeout", 0),
                                "statement_timeout") == ms
    with pytest.raises(SQLError):
        s.execute("set statement_timeout = 'soon'")
    s.execute("set enable_fused_execution = off")
    calls = []
    c.dn_channels.update({0: cut_pool(calls), 1: cut_pool(calls)})
    s.execute("set statement_timeout = '30s'")
    with pytest.raises(SQLError) as ei:
        s.query("select count(*) from t")
    assert ei.value.sqlstate == "57014"
    sent = [t for op, _tok, t in calls if op == "exec_fragment"]
    assert sent and all(0 < t <= 30 for t in sent)
    assert any(op == "cancel_fragment" for op, _tok, _t in calls)
    assert s._stmt_deadline is None  # ended with its statement
    c.dn_channels.clear()
    assert s.query("select count(*) from t") == [(500,)]
    s.execute("set statement_timeout = 0")
    s.execute("set fragment_retry_backoff_ms = 0")
    c.dn_channels.update({0: cut_pool(calls), 1: cut_pool(calls)})
    del calls[:]
    # no deadline: the channel's own failure is retried, then the
    # fragment fails over to the coordinator's stores
    assert s.query("select count(*) from t") == [(500,)]
    assert s.last_executor.retry_stats == {"retries": 4, "failovers": 2,
                                           "cancels": 0}
    sent = [t for op, _tok, t in calls if op == "exec_fragment"]
    assert len(sent) == 6 and all(t is None for t in sent)  # no deadline
    c.dn_channels.clear()


# a datanode's main() with a stand-in server: a SIGTERM aimed at another
# thread of the process, once main() has installed its handler
SIGTERM_ON_A_THREAD = r"""
import signal, sys, threading, time
from opentenbase_tpu_torch.dn import server

class Stub:
    port = 1
    def __init__(self, *a, **k):
        self.standby = self
    def start(self):
        return self
    def stop(self):
        pass
    def close(self):
        pass

server.DNServer = Stub
other = threading.Thread(target=time.sleep, args=(60,), daemon=True)
other.start()

def hit():
    while signal.getsignal(signal.SIGTERM) is signal.SIG_DFL:
        time.sleep(0.01)
    time.sleep(0.2)
    signal.pthread_kill(other.ident, signal.SIGTERM)

threading.Thread(target=hit, daemon=True).start()
sys.exit(server.main(["--data-dir", "unused", "--wal-host", "127.0.0.1",
                      "--wal-port", "1"]))
"""


def test_a_sigterm_taken_by_another_thread_stops_a_datanode():
    """The kernel may hand a process's SIGTERM to any thread, and CPython
    runs the handler only in the main thread: the datanode's main thread
    must still wake and stop (an untimed wait slept on, and the parent
    killed it after its grace)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen([sys.executable, "-c", SIGTERM_ON_A_THREAD],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, cwd=ROOT)
    try:
        out, err = p.communicate(timeout=START_S)
    finally:
        reap([p])
    assert p.returncode == 0, err
    assert "READY 1" in out and "STOPPED 1" in err

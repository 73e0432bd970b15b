"""Self-healing HA, the port against the reference: the same script runs
on the reference (``opentenbase_tpu``) and on the port
(``opentenbase_tpu_torch``, every cluster on ``device="cpu"``), and the
rows, generations, SQLSTATEs, ``events`` kinds and truncated byte counts
are compared. The cases are tests/test_ha.py's and
tests/test_replication.py's promotion, held without the fault harness
(tests/test_torch_fault.py and tests/test_torch_chaos.py hold the
failpoint cases): a torn tail is half a record appended by hand, a dead
datanode is a stopped server, lost phase-2 messages are a 2PC fan-out
that drops them. Every wait has a deadline; every socket
binds port 0."""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import pytest

import opentenbase_tpu.ha as ref_ha
import opentenbase_tpu_torch.ha as port_ha
from opentenbase_tpu import engine as ref_engine
from opentenbase_tpu.dn.server import DNServer as RefDNServer
from opentenbase_tpu.net import client as ref_client
from opentenbase_tpu.storage import persist as ref_persist
from opentenbase_tpu.storage import replication as ref_repl
from opentenbase_tpu_torch import engine as port_engine
from opentenbase_tpu_torch.dn.server import DNServer as PortDNServer
from opentenbase_tpu_torch.net import client as port_client
from opentenbase_tpu_torch.storage import persist as port_persist
from opentenbase_tpu_torch.storage import replication as port_repl

# tests/test_ha.py's topology configuration
HA_CONF = {
    "enable_fused_execution": "off",
    "synchronous_commit": "on",
    "failover_detect_ms": 1000,
    "failover_beats": 3,
    "fragment_retries": 1,
    "fragment_retry_backoff_ms": 5,
    "statement_timeout": 8000,
}

REF = SimpleNamespace(
    name="ref", ha=ref_ha, engine=ref_engine, Cluster=ref_engine.Cluster,
    SQLError=ref_engine.SQLError, repl=ref_repl, WAL=ref_persist.WAL,
    client=ref_client, DNServer=RefDNServer, kw={})
PORT = SimpleNamespace(
    name="port", ha=port_ha, engine=port_engine, Cluster=port_engine.Cluster,
    SQLError=port_engine.SQLError, repl=port_repl, WAL=port_persist.WAL,
    client=port_client, DNServer=PortDNServer, kw={"device": "cpu"})


def both(fn, tmp_path, *args):
    """``fn(pkg, dir, *args)`` on the reference and on the port."""
    return (fn(REF, str(tmp_path / "ref"), *args),
            fn(PORT, str(tmp_path / "port"), *args))


def wait_until(pred, timeout_s: float = 20.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def topology(pkg, d, **conf):
    gucs = dict(HA_CONF)
    gucs.update(conf)
    return pkg.ha.HATopology(d, num_datanodes=2, shard_groups=16,
                             conf_gucs=gucs, **pkg.kw)


def kinds(topo) -> list:
    return [e["kind"] for e in topo.events]


# -- tests/test_ha.py:70 -----------------------------------------------------
def _auto_promote(pkg, d):
    topo = topology(pkg, d)
    mon = None
    rc = pkg.ha.RoutingClient(topo)
    try:
        rc.execute("create table t (k bigint, v bigint) "
                   "distribute by shard(k)")
        for i in range(8):
            rc.execute(f"insert into t values ({i}, {i * 10})")
        mon = pkg.ha.HAMonitor(topo).start()
        assert mon.detect_ms == 1000 and mon.beats == 3  # from the conf
        t_crash = time.time()
        topo.crash_primary()
        resumed = None
        deadline = time.time() + 20
        while time.time() < deadline:
            try:
                rc.execute("insert into t values (100, 1000)")
                resumed = time.time()
                break
            except Exception:
                time.sleep(0.05)
        assert resumed is not None, "writes never resumed"
        # detection within the budget: detect_ms + one beat + slack
        latency_ms = (mon.declared_dead_at - t_crash) * 1000
        assert latency_ms <= 1000 + 1000 / 3 + 600, latency_ms
        return {
            "rows": rc.query("select k, v from t order by k"),
            "promotions": mon.promotions,
            "promoted": topo.promoted_index,
            "generation": topo.active_cluster.node_generation,
            "ha_promotions": topo.active_cluster.ha_stats["promotions"],
            "coordinator": topo.active_cluster.coordinator_name,
            "kinds": kinds(topo),
        }
    finally:
        rc.close()
        if mon is not None:
            mon.stop()
        topo.stop()


def test_failure_detector_auto_promotes_within_budget(tmp_path):
    """A crashed primary under a running monitor: a datanode is promoted
    within the detection budget, writes resume through the routing
    client, no acknowledged write is lost. (The reference test's
    pg_cluster_health and metrics-exporter lines are left out: the port
    has neither yet.)"""
    ref, port = both(_auto_promote, tmp_path)
    assert port == ref
    assert port["rows"] == [(i, i * 10) for i in range(8)] + [(100, 1000)]
    assert port["promotions"] == 1 and port["generation"] == 1
    assert {"declared_dead", "promoted", "repointed",
            "failover_done"} <= set(port["kinds"])


# -- tests/test_ha.py:136 ----------------------------------------------------
def _fencing(pkg, d):
    topo = topology(pkg, d)
    try:
        rc = pkg.ha.RoutingClient(topo)
        rc.execute("create table t (k bigint, v bigint) "
                   "distribute by shard(k)")
        rc.execute("insert into t values (1, 10), (2, 20)")
        topo.crash_primary()
        assert topo.failover(reason="test")["ok"]
        rc.close()
        srv = topo.revive_ex_primary()
        stale = pkg.client.connect_tcp(srv.host, srv.port)
        states = []
        try:
            # the read first: it must meet the fence at the datanode,
            # never fail over to the ex-primary's stale stores
            for sql in ("select count(*) from t",
                        "insert into t values (99, 990)"):
                with pytest.raises(pkg.client.WireError) as ei:
                    stale.execute(sql)
                states.append(ei.value.sqlstate)
        finally:
            stale.close()
        with pytest.raises(pkg.SQLError) as se:
            topo.primary.session().execute("select 1")
        states.append(se.value.sqlstate)
        pings = [topo.dn_ping(i) for i in range(2)]
        return {
            "states": states,
            "demoted": topo.primary.ha_demoted,
            "refusals": topo.primary.ha_stats["fenced_refusals"] >= 1,
            "k99": topo.active_cluster.session().query(
                "select count(*) from t where k = 99"),
            "rows": topo.active_cluster.session().query(
                "select k, v from t order by k"),
            "generations": sorted(p["generation"] for p in pings),
            "dn_refusals": any((p.get("dml_stats") or {}).get(
                "fenced_refusals", 0) >= 1 for p in pings),
            "kinds": kinds(topo),
        }
    finally:
        topo.stop()


def test_fencing_refuses_stale_ex_primary(tmp_path):
    """After a promotion the revived ex-primary is fenced: a read and a
    write are refused with 72000, and it demotes itself."""
    ref, port = both(_fencing, tmp_path)
    assert port == ref
    assert port["states"] == ["72000", "72000", "72000"]
    assert port["demoted"] and port["k99"] == [(0,)]
    assert port["generations"] == [1, 1] and port["dn_refusals"]


# -- tests/test_ha.py:188 ----------------------------------------------------
def _generation_recovery(pkg, d):
    pri = pkg.Cluster(num_datanodes=2, shard_groups=16,
                      data_dir=os.path.join(d, "pri"), **pkg.kw)
    s = pri.session()
    s.execute("set enable_fused_execution = off")
    s.execute("create table t (k bigint) distribute by shard(k)")
    s.execute("insert into t values (1), (2), (3)")
    sender = pkg.repl.WalSender(pri.persistence)
    sb = pkg.repl.StandbyCluster(os.path.join(d, "sb"), 2, 16, **pkg.kw)
    try:
        sb.start_replication(sender.host, sender.port)
        assert sb.wait_caught_up(pri.persistence)
        sender.stop()
        promoted = sb.promote(generation=7)
        out = [promoted.node_generation]
        promoted.session().execute("insert into t values (4)")
        promoted.close()
        rec = pkg.Cluster.recover(os.path.join(d, "sb"), 2, 16, **pkg.kw)
        out += [rec.node_generation,
                rec.session().query("select count(*) from t")]
        # past a checkpoint the replayed tail no longer holds the record
        rec.persistence.checkpoint()
        rec.close()
        rec2 = pkg.Cluster.recover(os.path.join(d, "sb"), 2, 16, **pkg.kw)
        out.append(rec2.node_generation)
        rec2.close()
        return out
    finally:
        sender.stop()
        sb.stop()
        pri.close()


def test_generation_survives_crash_recovery(tmp_path):
    """The fencing generation is WAL-durable: the promoted node's
    ha_generation record replays, and a checkpoint carries it."""
    ref, port = both(_generation_recovery, tmp_path)
    assert port == ref == [7, 7, [(4,)], 7]
    # each package recovers the other's promoted data directory
    for pkg, other in ((PORT, "ref"), (REF, "port")):
        c = pkg.Cluster.recover(str(tmp_path / other / "sb"), 2, 16,
                                **pkg.kw)
        try:
            assert c.node_generation == 7
            assert c.session().query("select count(*) from t") == [(4,)]
        finally:
            c.close()


# -- tests/test_ha.py:222 ----------------------------------------------------
def _resume_own_offset(pkg, d):
    pri = pkg.Cluster(num_datanodes=2, shard_groups=16,
                      data_dir=os.path.join(d, "pri"), **pkg.kw)
    s = pri.session()
    s.execute("set enable_fused_execution = off")
    s.execute("create table t (k bigint) distribute by shard(k)")
    s.execute("insert into t values (1), (2)")
    sender = pkg.repl.WalSender(pri.persistence)
    sender2 = None
    sb = pkg.repl.StandbyCluster(os.path.join(d, "sb"), 2, 16, **pkg.kw)
    try:
        sb.start_replication(sender.host, sender.port)
        assert sb.wait_caught_up(pri.persistence)
        before = sb.applied
        sender.stop()  # the primary restarts its walsender
        s.execute("insert into t values (3), (4)")
        sender2 = pkg.repl.WalSender(pri.persistence)
        sb.restart_replication(sender2.host, sender2.port)
        assert sb.wait_caught_up(pri.persistence)
        return [sb.applied > before,
                sb.session().query("select count(*) from t")]
    finally:
        for x in (sender, sender2):
            if x is not None:
                x.stop()
        sb.stop()
        sb.cluster.close()
        pri.close()


def test_walreceiver_resumes_from_own_offset_after_restart(tmp_path):
    """A re-pointed walreceiver streams from its own offset: 4 rows, not
    6 (a stream from zero would apply the first two again)."""
    ref, port = both(_resume_own_offset, tmp_path)
    assert port == ref == [True, [(4,)]]


# -- tests/test_ha.py:253 ----------------------------------------------------
def _torn_tail(pkg, d):
    pri = pkg.Cluster(num_datanodes=2, shard_groups=16,
                      data_dir=os.path.join(d, "pri"), **pkg.kw)
    s = pri.session()
    s.execute("set enable_fused_execution = off")
    s.execute("create table t (k bigint) distribute by shard(k)")
    sender = pkg.repl.WalSender(pri.persistence, poll_s=0.01)
    sb = pkg.repl.StandbyCluster(os.path.join(d, "sb"), 2, 16, **pkg.kw)
    sender2 = sb2 = promoted = None
    try:
        sb.start_replication(sender.host, sender.port)
        for i in range(30):
            s.execute(f"insert into t values ({i})")
        assert sb.wait_caught_up(pri.persistence)
        sender.stop()
        # the primary dies mid-frame: half of a real record lands past
        # the standby's last complete one
        ends = [off for _t, _h, _a, off in pkg.WAL.read_records(
            pri.persistence.wal.path, decode_arrays=False)]
        with open(pri.persistence.wal.path, "rb") as f:
            f.seek(ends[-2])
            record = f.read(ends[-1] - ends[-2])
        p = sb.cluster.persistence
        p.wal._f.write(record[: len(record) // 2])
        p.wal._f.flush()
        size = os.path.getsize(p.wal.path)
        assert size > sb.applied
        promoted = sb.promote(generation=1)
        if pkg is PORT:
            assert sb.torn_bytes == size - sb.applied
        # the promoted WAL ends on a record boundary
        assert pkg.WAL.scan_end(p.wal.path) == p.wal.position
        s2 = promoted.session()
        # the packages' commit timestamps differ in digits, so their
        # records' lengths do: compare what was truncated with the half
        # record each appended
        out = {"torn_is_half": size - sb.applied == len(record) // 2,
               "count": s2.query("select count(*) from t")}
        s2.execute("insert into t values (1000)")
        sender2 = pkg.repl.WalSender(promoted.persistence)
        sb2 = pkg.repl.StandbyCluster(os.path.join(d, "sb2"), 2, 16,
                                      **pkg.kw)
        sb2.start_replication(sender2.host, sender2.port)
        assert sb2.wait_caught_up(promoted.persistence)
        out.update(source_generation=sb2.source_generation,
                   count2=sb2.session().query("select count(*) from t"),
                   generation2=sb2.cluster.node_generation)
        return out
    finally:
        for x in (sender, sender2, sb2):
            if x is not None:
                x.stop()
        if sb2 is not None:
            sb2.cluster.close()
        sb.stop()
        sb.cluster.close()
        pri.close()


def test_wal_torn_in_promotion_window(tmp_path):
    """A torn tail in the promotion window is truncated: the promoted
    WAL ends on a record boundary, no committed row is lost, and a fresh
    standby follows the new timeline with its generation."""
    ref, port = both(_torn_tail, tmp_path)
    assert port == ref
    assert port["torn_is_half"] and port["count"] == [(30,)]
    assert port["count2"] == [(31,)]
    assert port["source_generation"] == port["generation2"] == 1


# -- tests/test_ha.py:300 ----------------------------------------------------
def _diverge_and_promote(pkg, d):
    """A primary whose last commit never streamed, and its promoted
    standby with one commit of its own and a walsender."""
    pri = pkg.Cluster(num_datanodes=2, shard_groups=16,
                      data_dir=os.path.join(d, "pri"), **pkg.kw)
    s = pri.session()
    s.execute("set enable_fused_execution = off")
    s.execute("create table t (k bigint) distribute by shard(k)")
    s.execute("insert into t values (1), (2)")
    sender = pkg.repl.WalSender(pri.persistence)
    sb = pkg.repl.StandbyCluster(os.path.join(d, "sb"), 2, 16, **pkg.kw)
    sb.start_replication(sender.host, sender.port)
    assert sb.wait_caught_up(pri.persistence)
    # the stream dies, cut at both ends: the reference's walsender can
    # still send a frame written just after its stop() (ROADMAP C)
    sender.stop()
    sb.stop()
    s.execute("insert into t values (3), (4)")  # the divergent tail
    div_end = pri.persistence.wal.position
    pri.close()
    promoted = sb.promote()
    promoted.session().execute("insert into t values (100)")
    return promoted, pkg.repl.WalSender(promoted.persistence), div_end


def _rejoin(pkg, d):
    promoted, sender2, div_end = _diverge_and_promote(pkg, d)
    old = None
    try:
        base = promoted.ha_promote_lsn
        tail = [(tag, off) for tag, _h, _a, off in pkg.WAL.read_records(
            os.path.join(d, "pri", "wal.log"), decode_arrays=False)
            if off > base]
        old = pkg.repl.rejoin_standby(os.path.join(d, "pri"), sender2.host,
                                      sender2.port, 2, 16, **pkg.kw)
        assert old.cluster.read_only
        assert old.wait_caught_up(promoted.persistence)
        truncated = div_end - base
        if pkg is PORT:
            assert old.truncated_bytes == truncated
        out = {
            # the dead timeline is exactly the unstreamed commit frame
            # (its length differs between the packages: their commit
            # timestamps differ in digits)
            "tail": [tag for tag, _off in tail],
            "truncated_is_tail": truncated == tail[-1][1] - base > 0,
            "keys": old.session().query("select k from t order by k"),
            "generation": old.cluster.node_generation,
            "converged": old.applied == promoted.persistence.wal.position,
            "moved": old.applied != div_end,
        }
        # a node of a newer generation refuses to rejoin a stale target
        stale_c = pkg.Cluster(num_datanodes=2, shard_groups=16,
                              data_dir=os.path.join(d, "stale"), **pkg.kw)
        stale_sender = pkg.repl.WalSender(stale_c.persistence)
        try:
            with pytest.raises(RuntimeError, match="refusing rejoin"):
                pkg.repl.rejoin_standby(os.path.join(d, "sb"),
                                        stale_sender.host,
                                        stale_sender.port, 2, 16, **pkg.kw)
        finally:
            stale_sender.stop()
            stale_c.close()
        return out
    finally:
        sender2.stop()
        if old is not None:
            old.stop()
            old.cluster.close()
        promoted.close()


def test_rejoin_standby_truncates_divergence(tmp_path):
    """The pg_rewind analog: the ex-primary's unstreamed tail is
    truncated at the promotion point, and it rejoins read-only on the
    new timeline. (The reference test's pg_cluster_health role line is
    left out: the port has no system views yet.)"""
    ref, port = both(_rejoin, tmp_path)
    assert port == ref
    assert port["keys"] == [(1,), (2,), (100,)]
    assert port["tail"] == ["G"] and port["truncated_is_tail"]
    assert port["generation"] == 1 and port["converged"] and port["moved"]


def _cross_rejoin(ex_pkg, new_pkg, d):
    """``ex_pkg``'s rejoin_standby rewinds its data directory onto
    ``new_pkg``'s promoted timeline."""
    promoted, sender2, div_end = _diverge_and_promote(new_pkg, d)
    old = None
    try:
        old = ex_pkg.repl.rejoin_standby(os.path.join(d, "pri"),
                                         sender2.host, sender2.port, 2, 16,
                                         **ex_pkg.kw)
        assert old.wait_caught_up(promoted.persistence)
        return {
            "keys": old.session().query("select k from t order by k"),
            "generation": old.cluster.node_generation,
            "converged": old.applied == promoted.persistence.wal.position,
            "truncated": div_end - promoted.ha_promote_lsn,
        }
    finally:
        sender2.stop()
        if old is not None:
            old.stop()
            old.cluster.close()
        promoted.close()


@pytest.mark.parametrize("ex,new", [(REF, PORT), (PORT, REF)],
                         ids=["ref-rejoins-port", "port-rejoins-ref"])
def test_rejoin_across_packages(tmp_path, ex, new):
    """Each package's standby rewinds onto the other's promoted
    timeline: the same rows and generation as within one package."""
    got = _cross_rejoin(ex, new, str(tmp_path / "x"))
    assert got["keys"] == [(1,), (2,), (100,)]
    assert got["generation"] == 1 and got["converged"]
    assert got["truncated"] > 0


def test_local_generation_reads_either_packages_wal(tmp_path):
    """local_generation agrees on both packages' WALs (0 before a
    promotion, the promotion's generation after it)."""
    wals = {}
    for pkg in (REF, PORT):
        d = str(tmp_path / pkg.name)
        promoted, sender2, _ = _diverge_and_promote(pkg, d)
        sender2.stop()
        promoted.close()
        wals[pkg.name] = (os.path.join(d, "pri", "wal.log"),
                          os.path.join(d, "sb", "wal.log"))
    for reader in (REF, PORT):
        for name, (ex_wal, promoted_wal) in wals.items():
            assert reader.repl.local_generation(ex_wal) == 0, name
            assert reader.repl.local_generation(promoted_wal) == 1, name


# -- tests/test_ha.py:360 ----------------------------------------------------
def _stop_dn(pkg, topo, i):
    """Take datanode i down as its process dying would."""
    if pkg is REF:
        topo.dns[i]._simulate_crash()
    else:
        topo.dns[i].stop()
        topo.dns[i].standby.close()


def _restart_dn(pkg, topo, i):
    if pkg is REF:
        topo.dns[i]._revive()
        return
    old = topo.dns[i]
    topo.dns[i] = pkg.DNServer(old._data_dir, topo.sender.host,
                               topo.sender.port, 2, 16, port=old.port,
                               **pkg.kw).start()


def _sync_withholds(pkg, d):
    topo = topology(pkg, d)
    rc = pkg.ha.RoutingClient(topo)
    try:
        rc.execute("create table t (k bigint, v bigint) "
                   "distribute by shard(k)")
        rc.execute("insert into t values (1, 10)")
        for i in range(2):
            _stop_dn(pkg, topo, i)
        with pytest.raises(pkg.client.WireError) as ei:
            rc.execute("insert into t values (2, 20)")
        out = [ei.value.sqlstate, "unreplicated" in str(ei.value)]
        for i in range(2):
            _restart_dn(pkg, topo, i)
        rc.execute("insert into t values (3, 30)")
        out.append(rc.query("select k, v from t order by k"))
        return out
    finally:
        rc.close()
        topo.stop()


def test_sync_commit_withholds_unreplicated_acks(tmp_path):
    """synchronous_commit = on with every datanode down: the commit is
    not acknowledged (08006: durable locally, unreplicated); once the
    datanodes are back, acknowledgements resume."""
    ref, port = both(_sync_withholds, tmp_path)
    assert port == ref
    assert port == ["08006", True, [(1, 10), (2, 20), (3, 30)]]


# -- tests/test_ha.py:385 ----------------------------------------------------
def _drop_phase2(monkeypatch, pkg):
    """Every phase-2 ``2pc_commit`` is lost on its way: the decision is
    durable in the primary's WAL, no datanode is told."""
    real = pkg.engine.Session._dn_2pc

    def dn_2pc(self, op, gid, nodes, **extra):
        if op == "2pc_commit":
            return []
        return real(self, op, gid, nodes, **extra)

    monkeypatch.setattr(pkg.engine.Session, "_dn_2pc", dn_2pc)


def _indoubt(pkg, d, monkeypatch):
    topo = topology(pkg, d, synchronous_commit="off")
    try:
        s = topo.primary.session()
        s.execute("create table t (k bigint, v bigint) "
                  "distribute by shard(k)")
        s.execute("insert into t values (1, 10), (2, 20)")
        pos = topo.primary.persistence.wal.position
        for i in range(2):
            wait_until(lambda i=i: (topo.dn_ping(i) or {}).get(
                "applied", 0) >= pos, what=f"dn{i} caught up")
        # dn1's stream dies: it votes, and never sees the commit frame
        topo.dns[1].standby.stop()
        with monkeypatch.context() as m:
            _drop_phase2(m, pkg)
            s.execute("insert into t values (3, 30), (4, 40), (5, 50), "
                      "(6, 60)")
        if pkg is PORT:
            assert s.last_2pc["nodes"] == [0, 1]
        pos = topo.primary.persistence.wal.position
        wait_until(lambda: (topo.dn_ping(0) or {}).get("applied", 0) >= pos,
                   what="dn0 caught up")
        in_doubt = [e["gid"] for e in topo.dns[1]._twophase_list()]
        assert in_doubt, "dn1 should be in doubt"
        topo.crash_primary()
        res = topo.failover(reason="test")
        sb1 = topo.dns[1].standby
        end = topo.active_cluster.persistence.wal.position
        wait_until(lambda: sb1.applied >= end, what="dn1 re-streamed")
        return {
            "ok": res["ok"], "promoted": res["promoted"],
            "in_doubt": len(in_doubt),
            "left": topo.dns[1]._twophase_list(),
            "resolved": [e["resolved"] for e in topo.events
                         if e["kind"] == "indoubt_resolved"],
            "kinds": kinds(topo),
            "new": topo.active_cluster.session().query(
                "select count(*), sum(v) from t"),
            "dn1": sb1.session().query("select count(*), sum(v) from t"),
        }
    finally:
        topo.stop()


def test_indoubt_commit_reaches_recorded_decision_across_failover(
        tmp_path, monkeypatch):
    """An implicit 2PC whose phase-2 messages were all lost, and whose
    frame never reached one datanode, is driven to the promoted WAL's
    recorded COMMIT by the failover's resolver, exactly once."""
    ref, port = both(_indoubt, tmp_path, monkeypatch)
    for r in (ref, port):
        # dn1's vote is retired either by the resolver or, first, by the
        # re-pointed stream bringing its frame: both are the recorded
        # commit, applied once
        (rs,) = r.pop("resolved")
        assert [o for _g, o in rs] in ([], ["committed"])
    assert port == ref
    assert port["ok"] and port["promoted"] == 0 and port["left"] == []
    assert port["new"] == port["dn1"] == [(6, 210)]


def _resolve(pkg, d, monkeypatch):
    c, s, sender, dns = _ladder_cluster(pkg, d)
    try:
        for dn in dns:
            dn.standby.stop()  # no frame reaches the datanodes any more
        # a vote journaled by hand whose commit no WAL holds
        c.dn_channels[0].rpc({"op": "2pc_prepare", "gid": "orphan_gid",
                              "gxid": 999999})
        with monkeypatch.context() as m:
            _drop_phase2(m, pkg)
            s.execute("insert into t values " + ",".join(
                f"({k}, 1)" for k in range(1000, 1008)))
        votes = [len(ch.rpc({"op": "2pc_list"})["gids"])
                 for ch in c.dn_channels.values()]
        res = c.resolve_indoubt()
        return {
            "votes": votes,
            "outcomes": sorted(("orphan" if g == "orphan_gid" else "commit",
                                o) for g, o in res),
            "left": [ch.rpc({"op": "2pc_list"})["gids"]
                     for ch in c.dn_channels.values()],
            # each datanode's replica, with the journal applied
            "replicas": [ch.rpc({"op": "query", "sql":
                                 "select count(*), sum(v) from t"})["rows"]
                         for ch in c.dn_channels.values()],
        }
    finally:
        _ladder_teardown(c, sender, dns)


def test_resolve_indoubt_follows_the_wal_decision(tmp_path, monkeypatch):
    """``resolve_indoubt``: a journaled vote whose commit record is in
    the coordinator's WAL commits (its write set applied on the
    datanode), one with no record is presumed aborted."""
    ref, port = both(_resolve, tmp_path, monkeypatch)
    assert port == ref
    assert port["votes"] == [2, 1]
    assert port["outcomes"] == [("commit", "committed"),
                                ("orphan", "aborted")]
    assert port["left"] == [[], []]
    want = [[40 + 8, sum(i * 7 for i in range(40)) + 8]]
    assert port["replicas"] == [want, want]


# -- tests/test_replication.py:72 --------------------------------------------
def _promote_writable(pkg, d):
    pri = pkg.Cluster(num_datanodes=2, shard_groups=32,
                      data_dir=os.path.join(d, "pri"), **pkg.kw)
    sender = pkg.repl.WalSender(pri.persistence)
    sb = pkg.repl.StandbyCluster(os.path.join(d, "sb"), 2, 32, **pkg.kw)
    try:
        s = pri.session()
        s.execute("create table t (k bigint) distribute by shard(k)")
        s.execute("insert into t values (1)")
        sb.start_replication(sender.host, sender.port)
        assert sb.wait_caught_up(pri.persistence)
        ns = sb.promote().session()
        ns.execute("insert into t values (2)")
        return [sb.cluster.read_only, sb.cluster.node_generation,
                ns.query("select k from t order by k")]
    finally:
        sender.stop()
        sb.stop()
        sb.cluster.close()
        pri.close()


def test_promote_standby_becomes_writable(tmp_path):
    """tests/test_replication.py's promotion, without its PREPARE
    TRANSACTION (explicit 2PC is not ported)."""
    ref, port = both(_promote_writable, tmp_path)
    assert port == ref == [False, 1, [(1,), (2,)]]


# -- the retry and failover ladder (reference executor/dist.py) ----------
def _ladder_cluster(pkg, d):
    """A durable coordinator with two in-process datanode servers."""
    c = pkg.Cluster(num_datanodes=2, shard_groups=16, data_dir=d, **pkg.kw)
    sender = pkg.repl.WalSender(c.persistence, poll_s=0.01)
    dns = [pkg.DNServer(os.path.join(d, f"dn{i}"), sender.host,
                        sender.port, 2, 16, **pkg.kw).start()
           for i in range(2)]
    for i, dn in enumerate(dns):
        c.attach_datanode(i, "127.0.0.1", dn.port, pool_size=2,
                          rpc_timeout=30)
    s = c.session()
    s.execute("set enable_fused_execution = off")
    s.execute("create table t (k bigint, v bigint) distribute by shard(k)")
    s.execute("insert into t values " + ",".join(
        f"({i}, {i * 7})" for i in range(40)))
    pos = c.persistence.wal.position
    for dn in dns:
        wait_until(lambda dn=dn: dn.standby.applied >= pos,
                   what="datanode caught up")
    return c, s, sender, dns


def _ladder_teardown(c, sender, dns):
    for node in list(c.dn_channels):
        c.detach_datanode(node)
    for dn in dns:
        dn.stop()
    sender.stop()
    c.close()


def _dies_mid_read(pkg, d):
    c, s, sender, dns = _ladder_cluster(pkg, d)
    try:
        dn = dns[0]
        real = dn._exec_fragment

        def die(msg):
            # the datanode's process dies while it runs the fragment:
            # no reply, the listener gone
            if pkg is REF:
                from opentenbase_tpu.fault import FaultDropConnection

                dn._simulate_crash()
                raise FaultDropConnection("datanode died mid-fragment")
            dn.stop()
            return real(msg)

        dn._exec_fragment = die
        s.execute("set fragment_retries = 1")
        s.execute("set fragment_retry_backoff_ms = 5")
        got = s.query("select count(*), sum(v) from t")
        ex = s.last_executor if pkg is PORT else None
        healed = [i for i in (ex.instrumentation if ex else [])
                  if i.get("failover")]
        return got, c.frag_heal_stats, healed
    finally:
        _ladder_teardown(c, sender, dns)


def test_a_datanode_dying_mid_read_is_retried_then_failed_over(tmp_path):
    """A remote read fragment whose datanode dies mid-fragment is retried
    (``fragment_retries``) and then runs on the coordinator's own
    stores, with the reference's retry counts."""
    (ref_rows, ref_stats, _), (rows, stats, healed) = both(
        _dies_mid_read, tmp_path)
    assert rows == ref_rows == [(40, sum(i * 7 for i in range(40)))]
    assert stats == ref_stats == {"retries": 1, "failovers": 1}
    (h,) = healed
    assert h["node"] == 0 and h["failover"] == "local" and h["retries"] == 1
    assert h["remote"] is False


def _fenced_not_retried(pkg, d):
    c, s, sender, dns = _ladder_cluster(pkg, d)
    try:
        # a promotion behind the coordinator's back: the datanodes
        # follow generation 1
        for ch in c.dn_channels.values():
            ch.rpc({"op": "ping", "hgen": 1})
        with pytest.raises(pkg.SQLError) as ei:
            s.query("select count(*) from t")
        return [ei.value.sqlstate, c.ha_demoted, dict(c.frag_heal_stats)]
    finally:
        _ladder_teardown(c, sender, dns)


def test_a_fenced_refusal_is_never_retried(tmp_path):
    """``ChannelFenced`` skips the ladder: no retry, no failover to the
    (stale) local stores; the coordinator demotes with 72000."""
    ref, port = both(_fenced_not_retried, tmp_path)
    assert port == ref == ["72000", True, {"retries": 0, "failovers": 0}]


# -- config.py ----------------------------------------------------------------
def test_conf_file_refusals_and_session_defaults(tmp_path):
    """``_check_lease_budget`` refuses the same conf in both packages;
    the settings the port acts on become its sessions' defaults, as the
    reference's; a setting it does not act on is refused by name."""
    from opentenbase_tpu import config as ref_config
    from opentenbase_tpu_torch import NotPorted
    from opentenbase_tpu_torch import config as port_config

    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "opentenbase.conf").write_text(
        "lease_ttl_ms = 3000\nfailover_detect_ms = 1000\n"
        "failover_beats = 3\n")
    msgs = []
    for cfg in (ref_config, port_config):
        with pytest.raises(cfg.GucError) as ei:
            cfg.load_conf(str(bad))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "must exceed lease_ttl_ms" in msgs[1]
    with pytest.raises(port_config.GucError):
        PORT.Cluster(2, 16, data_dir=str(bad), device="cpu")
    good = tmp_path / "good"
    good.mkdir()
    (good / "opentenbase.conf").write_text(
        "# the HA test's settings\n" + "".join(
            f"{k} = {v}\n" for k, v in HA_CONF.items())
        + "lease_ttl_ms = '1s'\ncommit_siblings = 9\n")
    got = []
    for pkg in (REF, PORT):
        os.makedirs(good / pkg.name, exist_ok=True)
        with open(good / pkg.name / "opentenbase.conf", "w") as f:
            f.write((good / "opentenbase.conf").read_text())
        c = pkg.Cluster(2, 16, data_dir=str(good / pkg.name), **pkg.kw)
        try:
            s = c.session()
            keys = ("enable_fused_execution", "synchronous_commit",
                    "statement_timeout", "fragment_retries",
                    "fragment_retry_backoff_ms", "commit_siblings")
            s.execute("set statement_timeout = 5")
            s.execute("reset statement_timeout")  # back to the conf's
            got.append(([s.gucs[k] for k in keys], c.conf_gucs))
        finally:
            c.close()
    assert got[0] == got[1]
    assert got[1][0] == [False, "on", 8000, 1, 5, 9]
    ignored = tmp_path / "ignored"
    ignored.mkdir()
    (ignored / "opentenbase.conf").write_text("trace_queries = on\n")
    ref_engine.Cluster(2, 16, data_dir=str(ignored)).close()
    with pytest.raises(NotPorted, match="trace_queries"):
        PORT.Cluster(2, 16, data_dir=str(ignored), device="cpu")


def test_ping_reports_role_and_generation(tmp_path):
    """The coordinator answers the failure detector's ping before auth:
    its role and generation, as the reference's does; a promoted
    datanode's ping says so."""
    got = []
    for pkg in (REF, PORT):
        topo = topology(pkg, str(tmp_path / pkg.name))
        try:
            p = topo.probe_primary()
            row = [p["role"], p["generation"]]
            topo.crash_primary()
            assert topo.probe_primary() is None
            res = topo.failover(reason="test")
            dn = topo.dn_ping(res["promoted"])
            row += [dn["role"], dn["generation"], dn["promoted"],
                    dn["coordinator_port"] == res["port"],
                    topo.probe_primary()["role"]]
            got.append(row)
        finally:
            topo.stop()
    assert got[0] == got[1] == ["coordinator", 0, "coordinator", 1, True,
                                True, "coordinator"]


def test_topology_runs_where_it_is_told(tmp_path):
    """HATopology's nodes run on the device it is given; with none and
    no CUDA it refuses, as Cluster does."""
    import torch

    topo = topology(PORT, str(tmp_path / "cpu"))
    try:
        assert topo.primary.device.type == "cpu"
        assert all(dn.device.type == "cpu" for dn in topo.dns)
    finally:
        topo.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_ha.HATopology(str(tmp_path / "none"), 2, 16)


def test_rejoined_standby_runs_on_the_given_device(tmp_path):
    """rejoin_standby builds its standby on the device it is given."""
    import torch

    promoted, sender2, _ = _diverge_and_promote(PORT, str(tmp_path / "d"))
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                port_repl.rejoin_standby(str(tmp_path / "d" / "pri"),
                                         sender2.host, sender2.port, 2, 16)
        sb = port_repl.rejoin_standby(str(tmp_path / "d" / "pri"),
                                      sender2.host, sender2.port, 2, 16,
                                      device="cpu")
        try:
            assert sb.cluster.device.type == "cpu"
        finally:
            sb.close()
    finally:
        sender2.stop()
        promoted.close()


def test_serving_lease_grants_and_gates(tmp_path):
    """With a lease configured, the coordinator holds it through its
    datanodes' grants and serves; a fenced renewal demotes it."""
    conf = {"lease_ttl_ms": 600, "lease_skew_ms": 50}
    got = []
    for pkg in (REF, PORT):
        topo = topology(pkg, str(tmp_path / pkg.name), **conf)
        try:
            lease = topo.lease
            row = [lease.valid(), lease.remaining_ms() > 0]
            s = topo.primary.session()
            s.execute("create table t (k bigint) distribute by shard(k)")
            # the datanodes follow a newer generation: the next renewal
            # is fenced and the coordinator demotes for good
            for i in range(2):
                topo._dn_rpc(i, {"op": "ping", "hgen": 1})
            lease.renew()
            with pytest.raises(pkg.SQLError) as ei:
                s.execute("select count(*) from t")
            row += [lease.valid(), topo.primary.ha_demoted,
                    ei.value.sqlstate]
            got.append(row)
        finally:
            topo.stop()
    assert got[0] == got[1] == [True, True, False, True, "72000"]


def _revive_and_rejoin(pkg, d):
    topo = topology(pkg, d)
    try:
        rc = pkg.ha.RoutingClient(topo)
        rc.execute("create table t (k bigint, v bigint) "
                   "distribute by shard(k)")
        rc.execute("insert into t values (1, 10), (2, 20), (3, 30)")
        topo.crash_primary()
        for dn in topo.dns:  # the stream cut at both ends, as above
            dn.standby.stop()
        # the dead timeline: a commit on the crashed primary alone
        s_old = topo.primary.session()
        for node in list(topo.primary.dn_channels):
            topo.primary.detach_datanode(node)
        s_old.execute("set synchronous_commit = local")
        s_old.execute("insert into t values (66, 660)")
        assert topo.failover(reason="test")["ok"]
        rc.close()
        rc = pkg.ha.RoutingClient(topo)
        rc.execute("insert into t values (4, 40)")
        topo.revive_ex_primary()
        sb = topo.rejoin_ex_primary()
        end = topo.active_cluster.persistence.wal.position
        wait_until(lambda: sb.applied >= end, what="the rejoined standby")
        rows = sb.session().query("select k, v from t order by k")
        rc.close()
        return {"rows": rows, "read_only": sb.cluster.read_only,
                "generation": sb.cluster.node_generation,
                "same": rows == topo.active_cluster.session().query(
                    "select k, v from t order by k"),
                "kinds": kinds(topo)}
    finally:
        topo.stop()


def test_ex_primary_rejoins_as_the_new_standby(tmp_path):
    """HATopology's whole cycle: failover, the ex-primary revived, then
    rewound and rejoined as a read-only standby of the promoted node,
    its dead-timeline commit gone and its rows the promoted node's."""
    ref, port = both(_revive_and_rejoin, tmp_path)
    assert port == ref
    assert port["rows"] == [(1, 10), (2, 20), (3, 30), (4, 40)]
    assert port["read_only"] and port["generation"] == 1 and port["same"]
    assert port["kinds"][-2:] == ["ex_primary_revived",
                                  "ex_primary_rejoined"]

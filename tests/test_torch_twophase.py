"""Explicit two-phase commit on the port held against the reference:
PREPARE TRANSACTION, COMMIT PREPARED and ROLLBACK PREPARED, their 'T' /
'C' / 'R' WAL records and the checkpoint's prepared state (the shapes of
tests/test_persistence.py:120 and :146), the reservation a PREPARE holds
over the wire (tests/test_net.py:217, :240), the datanode processes'
votes (tests/test_dn_process.py:247), clean2pc (tests/test_gtm_ha.py:118,
:143), resolve_indoubt's outcomes and its min_age_s gate, each package
recovering the other's prepared data directory, a hot standby replaying
and promoting a prepared transaction, and Q6 on K1's plain version at
hybrid-magnitude timestamps between PREPARE and COMMIT PREPARED. Every
answer equals the reference's (tolerance: none)."""

from __future__ import annotations

import time

import numpy as np
import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.net.client import WireError as RefWireError
from opentenbase_tpu.net.client import connect_tcp as ref_connect
from opentenbase_tpu.net.server import ClusterServer as RefServer
from opentenbase_tpu_torch import NotPorted
from opentenbase_tpu_torch.engine import Cluster, Session, SQLError
from opentenbase_tpu_torch.net.client import WireError, connect_tcp
from opentenbase_tpu_torch.net.server import ClusterServer
from opentenbase_tpu_torch.storage.table import RESERVED_TS
from test_torch_dn import remote_query, topology_impl, wait_applied


def _pair(tmp_path, durable=True):
    """A reference and a port cluster, each with a data directory of its
    own."""
    rd, pd = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = RefCluster(num_datanodes=2, shard_groups=32,
                     data_dir=rd if durable else None)
    port = Cluster(num_datanodes=2, shard_groups=32,
                   data_dir=pd if durable else None, device="cpu")
    return ref, port, rd, pd


def _recover(pkg, d):
    if pkg == "ref":
        return RefCluster.recover(d, num_datanodes=2, shard_groups=32)
    return Cluster.recover(d, num_datanodes=2, shard_groups=32,
                           device="cpu")


def _prepared(c) -> list:
    return sorted(getattr(c, "_prepared", {}))


def test_prepared_txn_crash_then_commit(tmp_path):
    """tests/test_persistence.py:120: an in-doubt transaction survives a
    crash (no close) and is still decided; the decision is durable."""
    ref, port, rd, pd = _pair(tmp_path)

    def before(c):
        s = c.session()
        s.execute("create table t (k bigint, v text) distribute by shard(k)")
        s.execute("insert into t values (1,'base')")
        s.execute("begin")
        s.execute("insert into t values (2,'indoubt'),(3,'indoubt2')")
        s.execute("delete from t where k = 1")
        s.execute("prepare transaction 'g1'")

    for c in (ref, port):
        before(c)
    got = {}
    for pkg, d in (("ref", rd), ("port", pd)):
        r = _recover(pkg, d)
        rs = r.session()
        out = [rs.query("select k from t order by k"), _prepared(r),
               sorted(p.gid for p in r.gts.prepared_txns())]
        rs.execute("commit prepared 'g1'")
        out.append(rs.query("select k, v from t order by k"))
        r2 = _recover(pkg, d)
        out.append(r2.session().query("select k, v from t order by k"))
        got[pkg] = out
        if pkg == "port":
            r.close()
            r2.close()
    assert got["port"] == got["ref"] == [
        [(1,)], ["g1"], ["g1"], [(2, "indoubt"), (3, "indoubt2")],
        [(2, "indoubt"), (3, "indoubt2")]]
    port.close()


def test_prepared_txn_checkpoint_then_rollback(tmp_path):
    """tests/test_persistence.py:146: a checkpoint taken while a
    transaction is in doubt carries its rows by gid, so it stays
    decidable after recovery."""
    ref, port, rd, pd = _pair(tmp_path)
    for c in (ref, port):
        s = c.session()
        s.execute("create table t (k bigint) distribute by shard(k)")
        s.execute("insert into t values (1)")
        s.execute("begin")
        s.execute("insert into t values (7),(8)")
        s.execute("delete from t where k = 1")
        s.execute("prepare transaction 'g2'")
        c.persistence.checkpoint()
    got = {}
    for pkg, d in (("ref", rd), ("port", pd)):
        r = _recover(pkg, d)
        rs = r.session()
        out = [rs.query("select k from t order by k"), _prepared(r)]
        rs.execute("rollback prepared 'g2'")
        out.append(rs.query("select k from t order by k"))
        out.append(_recover(pkg, d).session().query(
            "select k from t order by k"))
        got[pkg] = out
    assert got["port"] == got["ref"] == [[(1,)], ["g2"], [(1,)], [(1,)]]
    port.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_recovers_the_others_prepared_directory(
        tmp_path, writer, reader):
    """A data directory holding a prepared transaction (with a checkpoint
    in its history and one after it), a decided one, and a sequence,
    written by one package, recovered by the other: the same rows, the
    same parked gid, the decision and the sequence's next value as the
    writer's own recovery gives."""
    d = str(tmp_path / "d")
    if writer == "ref":
        w = RefCluster(num_datanodes=2, shard_groups=32, data_dir=d)
    else:
        w = Cluster(num_datanodes=2, shard_groups=32, data_dir=d,
                    device="cpu")
    s = w.session()
    s.execute("create table t (k bigint, v text) distribute by shard(k)")
    s.execute("insert into t values (1,'a'),(2,'b'),(3,'c')")
    s.execute("create sequence sq start 10")
    s.execute("insert into t values (nextval('sq'), 'seq')")
    s.execute("begin")
    s.execute("insert into t values (4,'p1')")
    s.execute("prepare transaction 'early'")
    w.persistence.checkpoint()
    s.execute("begin")
    s.execute("delete from t where k = 2")
    s.execute("insert into t values (5,'p2')")
    s.execute("prepare transaction 'late'")
    s.execute("commit prepared 'early'")
    if writer == "port":
        w.close()
    got = {}
    for pkg in (writer, reader):
        r = _recover(pkg, d)
        rs = r.session()
        got[pkg] = [rs.query("select k, v from t order by k"), _prepared(r)]
        got[pkg].append(rs.query("select nextval('sq')")[0][0] > 10)
        if pkg == "port":
            r.close()
    assert got[reader] == got[writer]
    assert got[reader][:2] == [
        [(1, "a"), (2, "b"), (3, "c"), (4, "p1"), (10, "seq")], ["late"]]
    # the reader decides the writer's transaction
    r = _recover(reader, d)
    rs = r.session()
    rs.execute("commit prepared 'late'")
    assert rs.query("select k from t order by k") == [
        (1,), (3,), (4,), (5,), (10,)]
    if reader == "port":
        r.close()


def _serve(pkg):
    if pkg == "ref":
        srv = RefServer(RefCluster(num_datanodes=2, shard_groups=32)).start()
        return srv, ref_connect, RefWireError
    srv = ClusterServer(Cluster(num_datanodes=2, shard_groups=32,
                                device="cpu")).start()
    return srv, connect_tcp, WireError


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_prepare_reserves_rows_commit_prepared_never_fails(pkg):
    """tests/test_net.py:217: a PREPARE is a commit vote; a later writer
    loses against its reservation, COMMIT PREPARED never fails."""
    srv, connect, err = _serve(pkg)
    try:
        with connect(srv.host, srv.port) as a, connect(srv.host,
                                                       srv.port) as b:
            a.execute("create table t (k bigint, v bigint) "
                      "distribute by shard(k)")
            a.execute("insert into t values (1, 0)")
            a.execute("begin")
            a.execute("update t set v = 10 where k = 1")
            a.execute("prepare transaction 'vote1'")
            assert b.query("select v from t where k = 1") == [(0,)]
            b.execute("begin")
            with pytest.raises(err, match="serialize"):
                b.execute("update t set v = 20 where k = 1")
            b.execute("rollback")
            a.execute("commit prepared 'vote1'")
            assert b.query("select v from t where k = 1") == [(10,)]
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_rollback_prepared_releases_reservation(pkg):
    """tests/test_net.py:240."""
    srv, connect, _err = _serve(pkg)
    try:
        with connect(srv.host, srv.port) as a, connect(srv.host,
                                                       srv.port) as b:
            a.execute("create table t (k bigint, v bigint) "
                      "distribute by shard(k)")
            a.execute("insert into t values (1, 0)")
            a.execute("begin")
            a.execute("update t set v = 10 where k = 1")
            a.execute("prepare transaction 'vote2'")
            a.execute("rollback prepared 'vote2'")
            b.execute("begin")
            b.execute("update t set v = 20 where k = 1")
            b.execute("commit")
            assert b.query("select v from t where k = 1") == [(20,)]
    finally:
        srv.stop()


def test_statement_errors_match_the_reference(tmp_path):
    ref, port, _rd, _pd = _pair(tmp_path, durable=False)
    outs = []
    for c in (ref, port):
        s = c.session()
        s.execute("create table t (k bigint) distribute by shard(k)")
        out = []
        for sql in ("prepare transaction 'x'", "commit prepared 'nope'",
                    "rollback prepared 'nope'"):
            try:
                s.execute(sql)
                out.append("ok")
            except Exception as e:
                out.append(str(e))
        outs.append(out)
    assert outs[0] == outs[1] == [
        "there is no transaction in progress",
        'prepared transaction "nope" does not exist',
        'prepared transaction "nope" does not exist']


def test_clean2pc_matches_the_reference(tmp_path):
    """tests/test_gtm_ha.py:118 and :143 on both packages: a stale
    prepared transaction is rolled back (durably), a fresh one left; the
    background cleaner does the same."""
    ref, port, rd, pd = _pair(tmp_path)
    got = {}
    for pkg, c, d in (("ref", ref, rd), ("port", port, pd)):
        s = c.session()
        s.execute("create table t (k bigint) distribute by shard(k)")
        for gid, k in (("stale", 1), ("fresh", 2), ("bg", 3)):
            s.execute("begin")
            s.execute(f"insert into t values ({k})")
            s.execute(f"prepare transaction '{gid}'")
        c._prepared["stale"].prepared_at -= 1000
        out = [c.clean_2pc(max_age_s=300),
               sorted(p.gid for p in c.gts.prepared_txns())]
        c._prepared["bg"].prepared_at -= 1000
        stop = c.start_clean2pc(interval_s=0.05, max_age_s=300)
        try:
            for _ in range(200):
                if "bg" not in c._prepared:
                    break
                time.sleep(0.02)
        finally:
            stop()
        out.append(sorted(p.gid for p in c.gts.prepared_txns()))
        s.execute("commit prepared 'fresh'")
        out.append(s.query("select k from t order by k"))
        out.append(_recover(pkg, d).session().query(
            "select k from t order by k"))
        got[pkg] = out
    assert got["port"] == got["ref"] == [
        ["stale"], ["bg", "fresh"], ["fresh"], [(2,)], [(2,)]]
    port.close()


def test_resolve_indoubt_in_process_matches_the_reference(tmp_path):
    """Without datanode processes the registry is the only candidate: an
    explicit prepare awaits its operator; an implicit gid the GTM lists
    with no decision is presumed aborted at min_age_s 0 and left to
    clean_2pc under the background gate. Through pg_resolve_indoubt()
    too."""
    ref, port, _rd, _pd = _pair(tmp_path)
    got = {}
    for pkg, c in (("ref", ref), ("port", port)):
        s = c.session()
        s.execute("create table t (k bigint) distribute by shard(k)")
        s.execute("begin")
        s.execute("insert into t values (1)")
        s.execute("prepare transaction 'op'")
        info = c.gts.begin()
        c.gts.prepare(info.gxid, f"__implicit_{info.gxid}", (0, 1))
        gated = c.resolve_indoubt(min_age_s=60.0)
        now = s.query("select pg_resolve_indoubt()")
        got[pkg] = [gated,
                    [("implicit" if g.startswith("__implicit_") else g, o)
                     for g, o in now],
                    sorted(p.gid for p in c.gts.prepared_txns())]
    assert got["port"] == got["ref"] == [
        [("op", "awaiting_operator")],
        [("implicit", "aborted"), ("op", "awaiting_operator")], ["op"]]
    port.close()


def test_admin_functions(tmp_path):
    """pg_resolve_indoubt, pg_sleep, pg_stat_reset and the failpoint
    functions run and answer as the reference's; the admin functions
    whose subsystem is not ported are refused by name; a hot standby
    refuses pg_resolve_indoubt."""
    from opentenbase_tpu.engine import Cluster as RefCluster

    c = Cluster(num_datanodes=2, shard_groups=32, device="cpu")
    s = c.session()
    rs = RefCluster(num_datanodes=2, shard_groups=32).session()
    assert s.execute("select pg_resolve_indoubt(0)").columns == [
        "gid", "outcome"]
    for fn in ("pg_sleep(0)", "pg_stat_reset()", "pg_resolve_indoubt()"):
        got, want = s.execute(f"select {fn}"), rs.execute(f"select {fn}")
        assert (got.columns, got.rows) == (want.columns, want.rows), fn
    with pytest.raises(NotPorted, match="pg_clean_execute"):
        s.execute("select pg_clean_execute()")
    # the failpoint functions (fault/) answer as the reference's: arming
    # refused without fault_injection, clearing never gated
    errs = []
    for sess in (s, rs):
        with pytest.raises(Exception) as ei:
            sess.execute("select pg_fault_inject('a', 'b')")
        errs.append((str(ei.value), ei.value.sqlstate))
    assert errs[0] == errs[1] and errs[0][1] == "55000"
    got, want = (x.execute("select pg_fault_clear('a')") for x in (s, rs))
    assert (got.columns, got.rows) == (want.columns, want.rows) == (
        ["cleared"], [(0,)])
    c.read_only = True
    with pytest.raises(SQLError, match="read-only") as ei:
        s.execute("select pg_resolve_indoubt()")
    assert ei.value.sqlstate == "25006"
    with pytest.raises(SQLError, match="read-only"):
        s.execute("prepare transaction 'x'")


def test_hot_standby_replays_and_promotes_a_prepared_transaction(tmp_path):
    """The reference's standby and the port's follow their primaries'
    walsenders through PREPARE, COMMIT PREPARED and ROLLBACK PREPARED
    (nothing of a prepared transaction is visible before its 'C'); a
    transaction still prepared when the standby is promoted is parked
    there, listed by the promoted GTM, and COMMIT PREPARED decides it."""
    from opentenbase_tpu.storage.replication import (
        StandbyCluster as RefStandby,
    )
    from opentenbase_tpu.storage.replication import WalSender as RefSender
    from opentenbase_tpu_torch.storage.replication import (
        StandbyCluster,
        WalSender,
    )

    def run(pkg):
        base = tmp_path / pkg
        if pkg == "ref":
            c = RefCluster(num_datanodes=2, shard_groups=32,
                           data_dir=str(base / "p"))
            sender = RefSender(c.persistence)
            sb = RefStandby(str(base / "s"), 2, 32)
        else:
            c = Cluster(num_datanodes=2, shard_groups=32,
                        data_dir=str(base / "p"), device="cpu")
            sender = WalSender(c.persistence)
            sb = StandbyCluster(str(base / "s"), 2, 32, device="cpu")
        try:
            sb.start_replication(sender.host, sender.port)
            s = c.session()
            s.execute("create table t (k bigint) distribute by shard(k)")
            s.execute("insert into t values (1),(2),(3)")
            out = []
            for k, (gid, decide) in enumerate((
                    ("gc", "commit"), ("gr", "rollback"), ("open", None)),
                    start=1):
                s.execute("begin")
                s.execute(f"insert into t values ({10 + k})")
                s.execute(f"delete from t where k = {k}")
                s.execute(f"prepare transaction '{gid}'")
                assert sb.wait_caught_up(c.persistence)
                out.append(sb.session().query("select k from t order by k"))
                if decide is not None:
                    s.execute(f"{decide} prepared '{gid}'")
                    assert sb.wait_caught_up(c.persistence)
                    out.append(sb.session().query(
                        "select k from t order by k"))
            new = sb.promote()
            ns = new.session()
            out.append([_prepared(new),
                        sorted(p.gid for p in new.gts.prepared_txns())])
            out.append(ns.query("select k from t order by k"))
            ns.execute("commit prepared 'open'")
            out.append(ns.query("select k from t order by k"))
            return out
        finally:
            sender.stop()
            if pkg == "port":
                sb.close()
                c.close()

    assert run("port") == run("ref")


def test_explicit_2pc_journal_and_orphan_sweep(tmp_path):
    """tests/test_dn_process.py:247 against the port's datanode
    processes: PREPARE TRANSACTION journals a vote on the datanodes it
    wrote to, COMMIT PREPARED retires it, the rows read back through the
    datanodes as the reference reads them; an orphan vote is swept."""
    gen = topology_impl(tmp_path)
    c, s, rs, _procs, _sender = next(gen)
    try:
        vals = ",".join(f"({i}, 0.20, 'p')" for i in range(7000, 7040))
        for sess in (s, rs):
            sess.execute("begin")
            sess.execute(f"insert into t values {vals}")
            sess.execute("prepare transaction 'gid_dn_test'")
        gids = {n: ch.rpc({"op": "2pc_list"})["gids"]
                for n, ch in c.dn_channels.items()}
        assert gids == {0: ["gid_dn_test"], 1: ["gid_dn_test"]}, gids
        q = "select count(*), sum(k) from t where k >= 7000"
        assert remote_query(s, q) == [(0, None)]
        for sess in (s, rs):
            sess.execute("commit prepared 'gid_dn_test'")
        assert all(ch.rpc({"op": "2pc_list"})["gids"] == []
                   for ch in c.dn_channels.values())
        wait_applied(c)
        rs.execute("set enable_fused_execution = off")
        assert remote_query(s, q) == rs.query(q) == [(40, 280780)]
        c.dn_channels[0].rpc({"op": "2pc_prepare", "gid": "orphan_gid",
                              "gxid": 999999})
        assert c.clean_2pc(max_age_s=0.0) == ["dn0:orphan_gid"]
    finally:
        gen.close()


def test_resolve_indoubt_outcomes_with_datanodes(tmp_path, monkeypatch):
    """resolve_indoubt's three outcomes against datanode votes: a gid the
    WAL committed whose phase 2 was lost is committed, a vote with no
    decision presumed aborted, an explicit prepare left to its operator;
    the min_age_s gate keeps the background resolver off young votes
    without a decision. No failpoint: phase 2 is lost by skipping its
    message."""
    gen = topology_impl(tmp_path)
    c, s, _rs, _procs, _sender = next(gen)
    try:
        def lines(k0):
            return ",".join(f"({k}, 1.00, 'r')" for k in range(k0, k0 + 20))

        s.execute("begin")
        s.execute(f"insert into t values {lines(8000)}")
        s.execute("prepare transaction 'lost2'")
        orig = Session._dn_2pc

        def lose_phase2(self, op, gid, nodes, **extra):
            if op == "2pc_commit":
                return []
            return orig(self, op, gid, nodes, **extra)

        monkeypatch.setattr(Session, "_dn_2pc", lose_phase2)
        s.execute("commit prepared 'lost2'")
        monkeypatch.setattr(Session, "_dn_2pc", orig)
        votes = {n: ch.rpc({"op": "2pc_list"})["gids"]
                 for n, ch in c.dn_channels.items()}
        assert votes == {0: ["lost2"], 1: ["lost2"]}, votes
        c.dn_channels[1].rpc({"op": "2pc_prepare", "gid": "undecided",
                              "gxid": 999998})
        s.execute("begin")
        s.execute(f"insert into t values {lines(9000)}")
        s.execute("prepare transaction 'by_hand'")
        # the background gate: the decided gid goes ahead, the young
        # undecided vote waits
        assert dict(c.resolve_indoubt(min_age_s=3600.0)) == {
            "lost2": "committed", "by_hand": "awaiting_operator"}
        assert dict(c.resolve_indoubt(min_age_s=0.0)) == {
            "undecided": "aborted", "by_hand": "awaiting_operator"}
        left = {n: ch.rpc({"op": "2pc_list"})["gids"]
                for n, ch in c.dn_channels.items()}
        assert left == {0: ["by_hand"], 1: ["by_hand"]}, left
        s.execute("rollback prepared 'by_hand'")
        assert remote_query(
            s, "select count(*) from t where k >= 8000") == [(20,)]
        stop = c.start_indoubt_resolver(interval_s=0.05, min_age_s=0.0)
        try:
            c.dn_channels[0].rpc({"op": "2pc_prepare", "gid": "bg_gid",
                                  "gxid": 999997})
            for _ in range(200):
                if not c.dn_channels[0].rpc({"op": "2pc_list"})["gids"]:
                    break
                time.sleep(0.02)
            assert c.dn_channels[0].rpc({"op": "2pc_list"})["gids"] == []
        finally:
            stop()
    finally:
        gen.close()


# -- K1's plain version at hybrid-magnitude timestamps ------------------------

DDL = ("create table lineitem (l_orderkey bigint, l_quantity numeric(10,2), "
       "l_extendedprice numeric(12,2), l_discount numeric(4,2), "
       "l_shipdate date) distribute by shard(l_orderkey)")
Q6 = ("select sum(l_extendedprice * l_discount), count(*) from lineitem "
      "where l_shipdate >= date '1994-01-01' "
      "and l_shipdate < date '1995-01-01' "
      "and l_discount between 0.05 and 0.07 and l_quantity < 24")


def _rows(rng, keys) -> list:
    return [(int(k), int(rng.integers(100, 5000)),
             int(rng.integers(90000, 10500000)), int(rng.integers(0, 11)),
             int(8036 + rng.integers(0, 2556))) for k in keys]


def _values(rows) -> str:
    def day(d):
        return str(np.datetime64("1970-01-01") + np.timedelta64(d, "D"))

    return ",".join(f"({k}, {q / 100:.2f}, {p / 100:.2f}, {d / 100:.2f}, "
                    f"'{day(sd)}')" for k, q, p, d, sd in rows)


def _q6_numpy(rows) -> list:
    a = np.array(rows, dtype=np.int64).reshape(-1, 5)
    m = ((a[:, 4] >= 8766) & (a[:, 4] < 9131) & (a[:, 3] >= 5)
         & (a[:, 3] <= 7) & (a[:, 1] < 2400))
    rev = int((a[m, 2] * a[m, 3]).sum())
    return [(rev / 10**4 if m.any() else None, int(m.sum()))]


def test_q6_on_k1_plain_between_prepare_and_commit_prepared():
    """K1's route (its plain version on the CPU) over planes whose
    stamps are hybrid GTS timestamps (about 2^60.7): between PREPARE and
    COMMIT PREPARED the deleted rows carry xmax RESERVED_TS and stay
    visible, the inserted ones PENDING and invisible; after the
    decision both move. Each answer equals numpy's and the reference's
    on the same statements."""
    rng = np.random.default_rng(14)
    base = _rows(rng, range(1, 3001))
    batch = _rows(rng, range(5001, 5601))
    # the DELETE takes the transaction's own new rows too
    gone = [r for r in base + batch if r[0] % 10 == 3]
    after = [r for r in base + batch if r[0] % 10 != 3]
    ref = RefCluster(num_datanodes=2, shard_groups=32)
    port = Cluster(num_datanodes=2, shard_groups=32, device="cpu")
    rs, ps = ref.session(), port.session()
    for s in (rs, ps):
        s.execute(DDL)
        s.execute("insert into lineitem values " + _values(base))
    want0, want1 = _q6_numpy(base), _q6_numpy(after)
    assert ps.query(Q6) == rs.query(Q6) == want0
    for s in (rs, ps):
        s.execute("begin")
        s.execute("insert into lineitem values " + _values(batch))
        s.execute("delete from lineitem where l_orderkey % 10 = 3")
        s.execute("prepare transaction 'q6_gid'")
    fx = port.fused_executor()
    assert ps.query(Q6) == rs.query(Q6) == want0
    assert fx.last_route == "scan_agg"
    stores = [port.stores[n]["lineitem"] for n in (0, 1)]
    xmin = np.concatenate([st.scan_view().xmin() for st in stores])
    xmax = np.concatenate([st.scan_view().xmax() for st in stores])
    live = xmin[xmin < RESERVED_TS]
    assert live.min() > 2**60 and int((xmax == RESERVED_TS).sum()) == len(
        gone)
    snap = port.clamped_snapshot()
    assert snap > live.max() and snap.bit_length() == 61
    for s in (rs, ps):
        s.execute("commit prepared 'q6_gid'")
    assert ps.query(Q6) == rs.query(Q6) == want1
    assert fx.last_route == "scan_agg"
    xmax = np.concatenate([st.scan_view().xmax() for st in stores])
    assert not (xmax == RESERVED_TS).any()
    assert ps.query("select count(*) from lineitem") == [(len(after),)]

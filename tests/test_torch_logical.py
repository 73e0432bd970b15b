"""Logical replication in the port (opentenbase_tpu_torch/storage/
logical.py, the publication and subscription DDL and the publisher's
admin functions in engine.py), held against the reference on
tests/test_logical_replication.py's cases: each case runs the same
script on the reference (a reference publisher behind its JSON server,
a reference subscriber) and on the port (both clusters on
``device="cpu"``), and the decoded frames, the subscriber's rows and
the views are compared. A subscriber is waited for by its own state
(its rows, its worker's confirmed LSN against the publisher's WAL end),
each wait with a deadline."""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest

from opentenbase_tpu import engine as ref_engine
from opentenbase_tpu.net import server as ref_server
from opentenbase_tpu_torch import engine as port_engine
from opentenbase_tpu_torch.net import server as port_server
from test_torch_wlm import wait_until

REF = SimpleNamespace(name="ref", engine=ref_engine,
                      SQLError=ref_engine.SQLError, server=ref_server, kw={})
PORT = SimpleNamespace(name="port", engine=port_engine,
                       SQLError=port_engine.SQLError, server=port_server,
                       kw={"device": "cpu"})

T_PK = "create table t (k bigint primary key, v text) distribute by shard(k)"


class Pub:
    """A durable publisher and its JSON server, of one package."""

    def __init__(self, pkg, d):
        self.pkg = pkg
        self.c = pkg.engine.Cluster(num_datanodes=2, shard_groups=32,
                                    data_dir=os.path.join(d, "pub"),
                                    **pkg.kw)
        self.srv = pkg.server.ClusterServer(self.c).start()
        self.s = self.c.session()

    def conninfo(self) -> str:
        return f"host={self.srv.host} port={self.srv.port}"

    def close(self):
        try:
            self.srv.stop()
        finally:
            self.c.close()


def sub_cluster(pkg, d, nd=4, groups=64):
    """The subscriber shards its copy its own way."""
    return pkg.engine.Cluster(num_datanodes=nd, shard_groups=groups,
                              data_dir=os.path.join(d, "sub"), **pkg.kw)


def both(fn, tmp_path):
    """``fn(pkg, dir)`` on each package, each with a publisher (closed
    after); the outcomes must be equal."""
    out = []
    for pkg in (REF, PORT):
        d = str(tmp_path / pkg.name)
        pub = Pub(pkg, d)
        try:
            out.append(fn(pkg, d, pub))
        finally:
            pub.close()
    assert out[0] == out[1], out
    return out[1]


def caught_up(sc, name, pub) -> bool:
    """The subscription's worker confirmed the publisher's WAL end."""
    w = sc.subscriptions.get(name)
    return w is not None and w.lsn >= pub.c.persistence.wal.position


def frames(s, pub, lsn) -> list:
    return [json.loads(f) if f else None for _off, f in s.query(
        f"select pg_logical_slot_changes('{pub}', {lsn})")]


def test_publication_ddl_and_views(tmp_path):
    def run(pkg, d, pub):
        s = pub.s
        s.execute(T_PK)
        out = [s.execute("create publication p1 for table t").command]
        for sql in ("create publication p1 for all tables",
                    "create publication p2 for table missing"):
            try:
                s.execute(sql)
            except pkg.SQLError as e:
                out.append(str(e))
        out.append(s.query("select pubname, tables, nodes from "
                           "pg_publication"))
        out.append(s.query("select pg_publication_tables('p1')"))
        s.execute("drop publication p1")
        out.append(s.query("select count(*) from pg_publication"))
        return out

    out = both(run, tmp_path)
    assert out[-3:] == [[("p1", "t", "")], [("t",)], [(0,)]]


def test_slot_changes_decode_inserts_and_deletes(tmp_path):
    def run(pkg, d, pub):
        s = pub.s
        s.execute(T_PK)
        s.execute("create publication p for table t")
        lsn0 = s.query("select pg_current_wal_lsn()")[0][0]
        s.execute("insert into t values (1,'a'),(2,'b'),(3,'c')")
        s.execute("delete from t where k = 2")
        rows = s.query(f"select pg_logical_slot_changes('p', {lsn0})")
        f1, f2 = (json.loads(r[1]) for r in rows)
        ins = sorted((r["k"], r["v"]) for ch in f1["changes"]
                     if ch["op"] == "insert" for r in ch["rows"])
        dele = [(ch["op"], ch["rows"]) for ch in f2["changes"]]
        again = s.query(f"select pg_logical_slot_changes('p', {rows[0][0]})")
        return len(rows), ins, dele, len(again)

    assert both(run, tmp_path) == (
        2, [(1, "a"), (2, "b"), (3, "c")],
        [("delete", [{"k": 2, "v": "b"}])], 1)


def test_end_to_end_subscription(tmp_path):
    def run(pkg, d, pub):
        ps = pub.s
        ps.execute(T_PK)
        ps.execute("insert into t values (1,'one'),(2,'two')")
        ps.execute("create publication p for table t")
        sc = sub_cluster(pkg, d)
        try:
            ss = sc.session()
            ss.execute(T_PK)
            ss.execute(f"create subscription s1 connection "
                       f"'{pub.conninfo()}' publication p")
            wait_until(lambda: ss.query("select count(*) from t") == [(2,)],
                       30, "the initial sync")
            ps.execute("insert into t values (3,'three')")
            ps.execute("update t set v = 'TWO' where k = 2")
            ps.execute("delete from t where k = 1")
            wait_until(lambda: caught_up(sc, "s1", pub), 30, "the stream")
            rows = sorted(ss.query("select k, v from t"))
            sub = ss.query("select subname, publication, synced "
                           "from pg_subscription")
            ss.execute("drop subscription s1")
            return rows, sub, ss.query("select count(*) from pg_subscription")
        finally:
            sc.close()

    assert both(run, tmp_path) == (
        [(2, "TWO"), (3, "three")], [("s1", "p", True)], [(0,)])


def test_subscription_survives_publisher_restart(tmp_path):
    def run(pkg, d, pub):
        ps = pub.s
        ps.execute("create table t (k bigint primary key, v bigint) "
                   "distribute by shard(k)")
        ps.execute("create publication p for table t")
        sc = sub_cluster(pkg, d)
        srv2 = None
        try:
            ss = sc.session()
            ss.execute("create table t (k bigint primary key, v bigint) "
                       "distribute by shard(k)")
            ss.execute(f"create subscription s1 connection "
                       f"'{pub.conninfo()}' publication p "
                       "with (copy_data = off)")
            ps.execute("insert into t values (1, 10)")
            wait_until(lambda: ss.query("select count(*) from t") == [(1,)],
                       30, "the first row")
            port = pub.srv.port
            pub.srv.stop()
            wait_until(lambda: ss.query("select last_error from "
                                        "pg_subscription")[0][0] != "",
                       15, "the worker to see the publisher gone")
            srv2 = pkg.server.ClusterServer(pub.c, port=port).start()
            ps.execute("insert into t values (2, 20)")
            wait_until(lambda: ss.query("select count(*) from t") == [(2,)],
                       30, "the stream after the restart")
            return sorted(ss.query("select k, v from t"))
        finally:
            if srv2 is not None:
                srv2.stop()
            sc.close()

    assert both(run, tmp_path) == [(1, 10), (2, 20)]


@pytest.mark.parametrize("swap", [False, True], ids=["own", "swapped"])
def test_subscription_lsn_survives_recovery(tmp_path, swap):
    """The subscriber recovers from its own directory, or from the other
    package's, with its rows and its durable slot position."""
    subs = {}

    def run(pkg, d, pub):
        ps = pub.s
        ps.execute("create table t (k bigint primary key, v bigint) "
                   "distribute by shard(k)")
        ps.execute("create publication p for table t")
        sub_dir = os.path.join(d, "sub2")
        sc = pkg.engine.Cluster(num_datanodes=2, shard_groups=32,
                                data_dir=sub_dir, **pkg.kw)
        ss = sc.session()
        ss.execute("create table t (k bigint primary key, v bigint) "
                   "distribute by shard(k)")
        ss.execute(f"create subscription s1 connection '{pub.conninfo()}' "
                   "publication p with (copy_data = off)")
        ps.execute("insert into t values (1, 10),(2, 20)")
        wait_until(lambda: ss.query("select count(*) from t") == [(2,)],
                   30, "the rows")
        sc.close()
        subs[pkg.name] = sub_dir
        return True

    both(run, tmp_path)
    # each package recovers a subscriber directory and follows a fresh
    # publisher of its own package, at the recorded slot position
    out = []
    for pkg in (REF, PORT):
        src = subs[("port" if pkg is REF else "ref") if swap else pkg.name]
        rc = pkg.engine.Cluster.recover(src, num_datanodes=2,
                                        shard_groups=32, **pkg.kw)
        try:
            rs = rc.session()
            # the slot position is durable in the state table (the
            # worker reads it back once the publisher answers)
            out.append((rs.query("select count(*) from t"),
                        rs.query("select subname, lsn > 0, synced "
                                 "from otb_subscription_state")))
        finally:
            rc.close()
    assert out[0] == out[1] == ([(2,)], [("s1", True, 1)])


def test_subscription_lsn_recovery_goes_on_streaming(tmp_path):
    def run(pkg, d, pub):
        ps = pub.s
        ps.execute("create table t (k bigint primary key, v bigint) "
                   "distribute by shard(k)")
        ps.execute("create publication p for table t")
        sub_dir = os.path.join(d, "sub2")
        sc = pkg.engine.Cluster(num_datanodes=2, shard_groups=32,
                                data_dir=sub_dir, **pkg.kw)
        ss = sc.session()
        ss.execute("create table t (k bigint primary key, v bigint) "
                   "distribute by shard(k)")
        ss.execute(f"create subscription s1 connection '{pub.conninfo()}' "
                   "publication p with (copy_data = off)")
        ps.execute("insert into t values (1, 10),(2, 20)")
        wait_until(lambda: ss.query("select count(*) from t") == [(2,)],
                   30, "the rows")
        sc.close()
        rc = pkg.engine.Cluster.recover(sub_dir, num_datanodes=2,
                                        shard_groups=32, **pkg.kw)
        try:
            rs = rc.session()
            first = rs.query("select count(*) from t")
            ps.execute("insert into t values (3, 30)")
            wait_until(lambda: rs.query("select count(*) from t") == [(3,)],
                       30, "the stream after recovery")
            return first, sorted(rs.query("select k from t"))
        finally:
            rc.close()

    assert both(run, tmp_path) == ([(2,)], [(1,), (2,), (3,)])


def test_shard_filtered_publication(tmp_path):
    def run(pkg, d, pub):
        c, s = pub.c, pub.s
        s.execute("create table t (k bigint primary key) "
                  "distribute by shard(k)")
        s.execute("create publication p for table t on node (dn0)")
        lsn0 = s.query("select pg_current_wal_lsn()")[0][0]
        s.execute("insert into t values " + ",".join(
            f"({i})" for i in range(32)))
        got = sorted(r["k"] for fr in frames(s, "p", lsn0) if fr
                     for ch in fr["changes"] for r in ch["rows"])
        store = c.stores[c.nodes.get("dn0").mesh_index]["t"]
        want = sorted(int(v) for v in store.column_array("k")[:store.nrows])
        return got == want, 0 < len(got) < 32, got

    ok, strict, _got = both(run, tmp_path)
    assert ok and strict


def test_replicated_table_decodes_once(tmp_path):
    def run(pkg, d, pub):
        s = pub.s
        s.execute("create table r (k bigint) distribute by replication")
        s.execute("create publication p for table r")
        lsn0 = s.query("select pg_current_wal_lsn()")[0][0]
        s.execute("insert into r values (1),(2)")
        return sorted(r["k"] for fr in frames(s, "p", lsn0) if fr
                      for ch in fr["changes"] for r in ch["rows"])

    assert both(run, tmp_path) == [1, 2]


def test_insert_then_update_same_txn_replicates(tmp_path):
    def run(pkg, d, pub):
        ps = pub.s
        ps.execute(T_PK)
        ps.execute("create publication p for table t")
        sc = sub_cluster(pkg, d)
        try:
            ss = sc.session()
            ss.execute(T_PK)
            ss.execute(f"create subscription s1 connection "
                       f"'{pub.conninfo()}' publication p "
                       "with (copy_data = off)")
            ps.execute("begin")
            ps.execute("insert into t values (1, 'v1')")
            ps.execute("update t set v = 'v2' where k = 1")
            ps.execute("commit")
            wait_until(lambda: ss.query("select k, v from t") == [(1, "v2")],
                       30, "the update")
            ps.execute("insert into t values (2, 'x')")
            wait_until(lambda: ss.query("select count(*) from t") == [(2,)],
                       30, "the next row")
            return sorted(ss.query("select k, v from t"))
        finally:
            sc.close()

    assert both(run, tmp_path) == [(1, "v2"), (2, "x")]


def test_slot_fast_forwards_past_unpublished_activity(tmp_path):
    def run(pkg, d, pub):
        s = pub.s
        s.execute("create table pub_t (k bigint) distribute by shard(k)")
        s.execute("create table priv_t (k bigint) distribute by shard(k)")
        s.execute("create publication p for table pub_t")
        lsn0 = s.query("select pg_current_wal_lsn()")[0][0]
        s.execute("insert into priv_t values (1),(2),(3)")
        rows = s.query(f"select pg_logical_slot_changes('p', {lsn0})")
        again = s.query(f"select pg_logical_slot_changes('p', {rows[0][0]})")
        return len(rows), rows[0][1], rows[0][0] > lsn0, again

    assert both(run, tmp_path) == (1, "", True, [])


def test_initial_sync_consistent_lsn(tmp_path):
    def run(pkg, d, pub):
        ps = pub.s
        ps.execute("create table t (k bigint primary key, v bigint) "
                   "distribute by shard(k)")
        ps.execute("insert into t values (1,1),(2,2),(3,3)")
        ps.execute("create publication p for table t")
        sc = sub_cluster(pkg, d)
        try:
            ss = sc.session()
            ss.execute("create table t (k bigint primary key, v bigint) "
                       "distribute by shard(k)")
            ss.execute(f"create subscription s1 connection "
                       f"'{pub.conninfo()}' publication p")
            wait_until(lambda: ss.query("select count(*) from t") == [(3,)],
                       30, "the initial sync")
            ps.execute("insert into t values (4,4)")
            wait_until(lambda: caught_up(sc, "s1", pub), 30, "the stream")
            return sorted(ss.query("select k from t"))
        finally:
            sc.close()

    assert both(run, tmp_path) == [(1,), (2,), (3,), (4,)]


def test_delete_with_null_text_identity(tmp_path):
    def run(pkg, d, pub):
        ps = pub.s
        ps.execute("create table t (k bigint, v text) distribute by shard(k)")
        ps.execute("create publication p for table t")
        sc = sub_cluster(pkg, d)
        try:
            ss = sc.session()
            ss.execute("create table t (k bigint, v text) "
                       "distribute by shard(k)")
            ss.execute(f"create subscription s1 connection "
                       f"'{pub.conninfo()}' publication p "
                       "with (copy_data = off)")
            ps.execute("insert into t (k) values (1)")
            wait_until(lambda: ss.query("select count(*) from t") == [(1,)],
                       30, "the row")
            ps.execute("delete from t where k = 1")
            wait_until(lambda: caught_up(sc, "s1", pub), 30, "the delete")
            return ss.query("select count(*) from t")
        finally:
            sc.close()

    assert both(run, tmp_path) == [(0,)]


def test_copy_data_off_skips_history(tmp_path):
    def run(pkg, d, pub):
        ps = pub.s
        ps.execute("create table t (k bigint primary key) "
                   "distribute by shard(k)")
        ps.execute("insert into t values (1),(2),(3)")
        ps.execute("create publication p for table t")
        sc = sub_cluster(pkg, d)
        try:
            ss = sc.session()
            ss.execute("create table t (k bigint primary key) "
                       "distribute by shard(k)")
            ss.execute(f"create subscription s1 connection "
                       f"'{pub.conninfo()}' publication p "
                       "with (copy_data = off)")
            ps.execute("insert into t values (4)")
            # the worker has confirmed past everything: no late history
            wait_until(lambda: caught_up(sc, "s1", pub), 30, "the stream")
            return ss.query("select k from t")
        finally:
            sc.close()

    assert both(run, tmp_path) == [(4,)]


def test_node_filtered_initial_sync(tmp_path):
    def run(pkg, d, pub):
        c, ps = pub.c, pub.s
        ps.execute("create table t (k bigint primary key) "
                   "distribute by shard(k)")
        ps.execute("insert into t values " + ",".join(
            f"({i})" for i in range(32)))
        ps.execute("create publication p for table t on node (dn0)")
        store = c.stores[c.nodes.get("dn0").mesh_index]["t"]
        want = sorted(int(v) for v in store.column_array("k")[:store.nrows])
        sc = sub_cluster(pkg, d)
        try:
            ss = sc.session()
            ss.execute("create table t (k bigint primary key) "
                       "distribute by shard(k)")
            ss.execute(f"create subscription s1 connection "
                       f"'{pub.conninfo()}' publication p")
            wait_until(lambda: caught_up(sc, "s1", pub), 30, "the sync")
            return sorted(k for (k,) in ss.query("select k from t")) == want
        finally:
            sc.close()

    assert both(run, tmp_path) is True


def test_vacuum_respects_slot_horizon(tmp_path):
    def run(pkg, d, pub):
        s = pub.s
        s.execute("create table t (k bigint primary key) "
                  "distribute by shard(k)")
        s.execute("create publication p for table t")
        lsn0 = s.query("select pg_current_wal_lsn()")[0][0]
        s.execute("insert into t values (1),(2)")
        confirmed = s.query(
            f"select pg_logical_slot_changes('p', {lsn0})")[-1][0]
        s.execute("delete from t where k = 1")
        s.query(f"select pg_logical_slot_changes('p', {confirmed})")
        removed = s.execute("vacuum t").rowcount
        return removed, [
            r for fr in frames(s, "p", confirmed) if fr
            for ch in fr["changes"] if ch["op"] == "delete"
            for r in ch["rows"]]

    assert both(run, tmp_path) == (0, [{"k": 1}])


def test_publications_before_a_checkpoint_are_lost_in_both(tmp_path):
    """Kept from the reference (ROADMAP C): a checkpoint carries neither
    publications nor subscriptions, so a recovery from it has none of
    those created before it (the WAL records past it replay)."""
    out = []
    for pkg in (REF, PORT):
        d = str(tmp_path / pkg.name)
        c = pkg.engine.Cluster(num_datanodes=2, shard_groups=16,
                               data_dir=d, **pkg.kw)
        s = c.session()
        s.execute("create table t (k bigint) distribute by shard(k)")
        s.execute("create publication before_ckpt for table t")
        c.persistence.checkpoint()
        s.execute("create publication after_ckpt for table t")
        c.close()
        r = pkg.engine.Cluster.recover(d, num_datanodes=2, shard_groups=16,
                                       **pkg.kw)
        try:
            out.append(r.session().query(
                "select pubname from pg_publication"))
        finally:
            r.close()
    assert out[0] == out[1] == [("after_ckpt",)]

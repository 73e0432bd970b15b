"""Fault injection in the port (opentenbase_tpu_torch/fault/ and its sites)
held against the reference (opentenbase_tpu/fault/): each case runs the
same script on both packages, every cluster of the port on
``device="cpu"``, and compares what the script saw. The cases are
tests/test_fault_injection.py's nineteen, the registry's firing pattern
hit for hit, the failpoint cases of tests/test_ha.py,
tests/test_write_path.py and tests/test_delta_scan.py, and the list of
sites against the reference's.

The registries are per package and per process: an autouse fixture
clears both before and after each case. Where a reference case reads
``pg_stat_cluster_activity`` (ROADMAP A.7), the port's side reads the
same counters from ``Cluster.frag_heal_stats``. The fused route does not
demote a failed statement to the host route in the port (ROADMAP C):
``test_delta_scan_faults_fire_and_self_heal`` asserts that difference.
"""

from __future__ import annotations

import io
import os
import random
import re
import shutil
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

import opentenbase_tpu.dn.server as ref_dn
import opentenbase_tpu.fault as ref_fault
import opentenbase_tpu_torch.dn.server as port_dn
import opentenbase_tpu_torch.fault as port_fault
from opentenbase_tpu import engine as ref_engine
from opentenbase_tpu.gtm import client as ref_gtm_client
from opentenbase_tpu.gtm import gts as ref_gts
from opentenbase_tpu.gtm import server as ref_gtm_server
from opentenbase_tpu.gtm import standby as ref_gtm_standby
from opentenbase_tpu.net import client as ref_client
from opentenbase_tpu.net import pgwire as ref_pgwire
from opentenbase_tpu.net import pool as ref_pool
from opentenbase_tpu.net import server as ref_server
from opentenbase_tpu.storage import persist as ref_persist
from opentenbase_tpu.storage import replication as ref_repl
from opentenbase_tpu_torch import engine as port_engine
from opentenbase_tpu_torch.gtm import client as port_gtm_client
from opentenbase_tpu_torch.gtm import gts as port_gts
from opentenbase_tpu_torch.gtm import server as port_gtm_server
from opentenbase_tpu_torch.gtm import standby as port_gtm_standby
from opentenbase_tpu_torch.net import client as port_client
from opentenbase_tpu_torch.net import pgwire as port_pgwire
from opentenbase_tpu_torch.net import pool as port_pool
from opentenbase_tpu_torch.net import server as port_server
from opentenbase_tpu_torch.storage import persist as port_persist
from opentenbase_tpu_torch.storage import replication as port_repl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = SimpleNamespace(
    name="ref", fault=ref_fault, Cluster=ref_engine.Cluster, dn=ref_dn,
    repl=ref_repl, WAL=ref_persist.WAL, pool=ref_pool, client=ref_client,
    server=ref_server, pgwire=ref_pgwire, gtm_client=ref_gtm_client,
    gts=ref_gts, gtm_server=ref_gtm_server, gtm_standby=ref_gtm_standby,
    dn_module="opentenbase_tpu.dn.server", dn_args=[], kw={})
PORT = SimpleNamespace(
    name="port", fault=port_fault, Cluster=port_engine.Cluster, dn=port_dn,
    repl=port_repl, WAL=port_persist.WAL, pool=port_pool, client=port_client,
    server=port_server, pgwire=port_pgwire, gtm_client=port_gtm_client,
    gts=port_gts, gtm_server=port_gtm_server,
    gtm_standby=port_gtm_standby, dn_module="opentenbase_tpu_torch.dn.server",
    dn_args=["--device", "cpu"], kw={"device": "cpu"})
PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _clean_faults():
    """Both registries empty, their counters zeroed, no chaos seed and
    no matrix, before and after every case: a leaked arm cuts every
    later test of the process."""
    for pkg in PKGS:
        pkg.fault.clear()
        pkg.fault.reset_stats()
        pkg.fault.set_chaos_seed(None)
        pkg.fault.install_matrix(None)
    yield
    for pkg in PKGS:
        pkg.fault.clear()
        pkg.fault.reset_stats()
        pkg.fault.set_chaos_seed(None)
        pkg.fault.install_matrix(None)


def both(fn, *args):
    """``fn(pkg, *args)`` on the reference and on the port (a function
    given a directory works under its package's subdirectory)."""
    return fn(REF, *args), fn(PORT, *args)


def fires(pkg, site: str, n: int, ctxs=None) -> list:
    """The fire pattern of ``n`` hits of ``site`` (1 where it fired)."""
    out = []
    for i in range(n):
        ctx = ctxs[i % len(ctxs)] if ctxs else {}
        try:
            pkg.fault.FAULT(site, **ctx)
            out.append(0)
        except pkg.fault.FaultError:
            out.append(1)
    return out


# -- the registry ------------------------------------------------------------
def test_fault_off_is_noop_and_allocation_free():
    """With nothing armed a site is one dict lookup: no firing and no
    allocation, in both packages."""
    import gc

    for pkg in PKGS:
        FAULT = pkg.fault.FAULT
        assert FAULT("any/site") is None
        assert FAULT("any/site", node=3) is None
        for _ in range(1000):
            FAULT("exec/fragment", node=1)
        r = range(20000)
        gc.collect()
        before = sys.getallocatedblocks()
        for _ in r:
            FAULT("exec/fragment", node=1)
        after = sys.getallocatedblocks()
        assert after - before <= 8, (pkg.name, after - before)


def _triggers(pkg):
    pkg.fault.inject("s/once", "error", "once")
    once = fires(pkg, "s/once", 3)
    gone = "s/once" not in pkg.fault.armed()
    pkg.fault.inject("s/every", "error", "every(3)")
    every = fires(pkg, "s/every", 9)
    pkg.fault.inject("s/after", "error", "after(2)")
    after = fires(pkg, "s/after", 5)
    return once, gone, every, after


def test_trigger_once_every_after():
    ref, port = both(_triggers)
    assert port == ref
    assert port == ([1, 0, 0], True, [0, 0, 1] * 3, [0, 0, 1, 1, 1])


def _prob(pkg):
    def run(seed):
        pkg.fault.inject("s/prob", "error", f"prob(0.4; {seed})")
        out = fires(pkg, "s/prob", 200)
        pkg.fault.clear("s/prob")
        return out

    return run(42), run(42), run(43)


def test_prob_seed_is_deterministically_replayable():
    ref, port = both(_prob)
    assert port == ref
    a, b, c = port
    assert a == b and 0 < sum(a) < 200 and c != a


def _filters(pkg):
    pkg.fault.inject("s/filt", "error", "every(1), node=1")
    pattern = fires(pkg, "s/filt", 2, [{"node": 0}, {"node": 1}])
    rows = {r[0]: r for r in pkg.fault.stats()}
    return pattern, rows["s/filt"]


def test_context_filters_gate_firing():
    ref, port = both(_filters)
    assert port == ref
    pattern, row = port
    assert pattern == [0, 1] and row[4] == 1 and row[5] == 1


def _ctx_free(pkg):
    pkg.fault.inject("s/ctxfree", "error", "every(1), node=1")
    pattern = fires(pkg, "s/ctxfree", 2, [{}, {"other": "x"}])
    rows = {r[0]: r for r in pkg.fault.stats()}
    return pattern, rows["s/ctxfree"]


def test_context_filters_never_match_a_context_free_site():
    ref, port = both(_ctx_free)
    assert port == ref
    assert port[0] == [0, 0] and port[1][4] == 0


def _connect_retry(pkg):
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    try:
        pkg.fault.inject("net/client/connect", "drop_conn", "once")
        sock = pkg.client.connect_with_retry(
            "127.0.0.1", lsock.getsockname()[1], timeout=5, retries=2,
            backoff_s=0.01)
        sock.close()
        rows = {r[0]: r for r in pkg.fault.stats()}
        return (issubclass(pkg.fault.FaultDropConnection,
                           ConnectionResetError),
                rows["net/client/connect"][5])
    finally:
        lsock.close()


def test_drop_conn_at_connect_exercises_the_retry_ladder():
    """The injected reset is a ConnectionResetError, so the connect's
    retry ladder takes it like a peer's and connects on its retry."""
    ref, port = both(_connect_retry)
    assert port == ref == (True, 1)


def _bad_specs(pkg):
    out = []
    for action, spec in (("explode", ""), ("delay", ""),
                         ("error", "sometimes"), ("error", "every(0)")):
        try:
            pkg.fault.inject("s", action, spec)
            out.append("armed")
        except ValueError as e:
            out.append(str(e))
    return out


def test_bad_action_and_spec_are_rejected():
    ref, port = both(_bad_specs)
    assert port == ref
    assert "armed" not in port


def _guc_gate(pkg):
    c = pkg.Cluster(num_datanodes=2, shard_groups=16, **pkg.kw)
    s = c.session()
    try:
        s.execute("select pg_fault_inject('x/y', 'error')")
        refused = None
    except Exception as e:
        refused = (str(e), getattr(e, "sqlstate", None))
    s.execute("set fault_injection = on")
    armed = s.query("select pg_fault_inject('x/y', 'error', 'once')")
    present = "x/y" in pkg.fault.armed()
    cleared = c.session().query("select pg_fault_clear()")
    return refused, armed, present, cleared, pkg.fault.armed()


def test_guc_gates_sql_arming_but_not_clearing():
    ref, port = both(_guc_gate)
    assert port == ref
    refused, armed, present, cleared, left = port
    assert "fault_injection" in refused[0] and refused[1] == "55000"
    assert armed == [("x/y", 0)] and present and cleared == [(1,)]
    assert left == {}


# the same spec in both registries, hit for hit: (spec, contexts, hits)
REGISTRY_CASES = [
    ("once", None, 5),
    ("every(3)", None, 12),
    ("after(4)", None, 9),
    ("prob(0.4; 42)", None, 300),
    ("prob(0.25, 7)", None, 300),
    ("prob(0.5 1234)", None, 200),
    ("prob(0.6)", None, 200),
    ("every(2), node=1", [{"node": 0}, {"node": 1}, {}], 30),
    ("node=1, prob(0.5; 9)", [{"node": 1}, {"node": 2}], 200),
]


@pytest.mark.parametrize("spec,ctxs,n", REGISTRY_CASES,
                         ids=[c[0] for c in REGISTRY_CASES])
def test_registry_fires_on_the_references_hit_indices(spec, ctxs, n):
    """Each spec fires on the same hits in both registries, with the
    same describe() and counters; prob draws are seeded alike."""
    def run(pkg):
        f = pkg.fault.inject("s/x", "error", spec)
        pattern = fires(pkg, "s/x", n, ctxs)
        return pattern, f.describe(), f.action_str(), pkg.fault.stats()

    ref, port = both(run)
    assert port == ref


def _chaos_prob(pkg):
    pkg.fault.set_chaos_seed(7)
    pkg.fault.inject("s/chaos", "error", "prob(0.5)")
    a = fires(pkg, "s/chaos", 60)
    pkg.fault.clear()
    pkg.fault.set_chaos_seed(7)
    pkg.fault.inject("s/chaos", "error", "prob(0.5, 99)")
    b = fires(pkg, "s/chaos", 60)
    rng = pkg.fault.site_rng("s/chaos").random()
    pkg.fault.set_chaos_seed(None)
    return a, b, rng


def test_registry_under_a_chaos_seed_draws_the_references_stream():
    """Under a chaos seed every prob draw, an explicit seed's too, comes
    from the seed's per-site stream, the same in both packages."""
    ref, port = both(_chaos_prob)
    assert port == ref
    assert port[0] == port[1] and 0 < sum(port[0]) < 60


# -- in-process datanode topology (the registry shared by design) ------------
def _start_topology(pkg, d, rows=200):
    """A coordinator and two in-process DNServers following its WAL; the
    datanodes share the process's registry, so dn/* sites arm here."""
    c = pkg.Cluster(num_datanodes=2, shard_groups=32,
                    data_dir=os.path.join(d, "cn"), **pkg.kw)
    s = c.session()
    s.execute("set enable_fused_execution = off")
    s.execute("create table t (k bigint, v bigint) distribute by shard(k)")
    s.execute("insert into t values " + ",".join(
        f"({i}, {i * 10})" for i in range(rows)))
    sender = pkg.repl.WalSender(c.persistence)
    dns = []
    for node in (0, 1):
        dn = pkg.dn.DNServer(os.path.join(d, f"dn{node}"), sender.host,
                             sender.port, num_datanodes=2, shard_groups=32,
                             **pkg.kw).start()
        dns.append(dn)
        c.attach_datanode(node, "127.0.0.1", dn.port, pool_size=2,
                          rpc_timeout=60)
    return c, s, dns, sender


def _stop_topology(c, dns, sender):
    for node in (0, 1):
        try:
            c.detach_datanode(node)
        except Exception:
            pass
    for dn in dns:
        try:
            dn.stop()
        except Exception:
            pass
        try:
            dn.standby.close()
        except Exception:
            pass
    try:
        sender.stop()
    except Exception:
        pass
    c.close()


def _heal_counters(pkg, c, s):
    """(retries, failovers) of the session's fragments: the reference's
    pg_stat_cluster_activity row, the port's Cluster.frag_heal_stats
    (ROADMAP A.7 brings the view)."""
    if pkg is REF:
        act = {r[0]: r for r in s.query(
            "select session_id, frag_retries, frag_failovers "
            "from pg_stat_cluster_activity")}[s.session_id]
        return act[1], act[2]
    return c.frag_heal_stats["retries"], c.frag_heal_stats["failovers"]


def _crash_read(pkg, d):
    c, s, dns, sender = _start_topology(pkg, d)
    try:
        want = s.query("select count(*), sum(v) from t")
        s.execute("set fault_injection = on")
        s.execute("set fragment_retries = 1")
        s.execute("set fragment_retry_backoff_ms = 5")
        s.execute("select pg_fault_inject('dn/exec_fragment', "
                  "'crash_node', 'node=1, once')")
        got = s.query("select count(*), sum(v) from t")
        crashed = dns[1]._crashed
        retries, failovers = _heal_counters(pkg, c, s)
        faults = {(r[0], r[1]): r[2] for r in s.query(
            "select node, site, fired from pg_stat_faults")}
        text = "\n".join(r[0] for r in s.query(
            "explain analyze select count(*), sum(v) from t"))
        s.execute("select pg_fault_clear()")
        dns[1]._revive()
        again = s.query("select count(*), sum(v) from t")
        return {"got": got == want, "crashed": crashed,
                "healed": retries >= 1 and failovers >= 1,
                "cn_fired": faults[("cn", "dn/exec_fragment")] >= 1,
                "explain": ("failover=local" in text, "retries=" in text),
                "again": again == want, "want": want}
    finally:
        _stop_topology(c, dns, sender)


def test_read_fragment_retry_and_failover_under_crash_node(tmp_path):
    """A crash_node armed on datanode 1: the read completes through the
    retry and the failover to the coordinator's stores, EXPLAIN ANALYZE
    shows both, pg_stat_faults counts the firing; clear and revive and
    the node serves again."""
    ref = _crash_read(REF, str(tmp_path / "ref"))
    port = _crash_read(PORT, str(tmp_path / "port"))
    assert port == ref
    assert all(v is True or v == (True, True)
               for k, v in port.items() if k != "want")


def _cancel(pkg, d):
    c, s, dns, sender = _start_topology(pkg, d, rows=50)
    try:
        pkg.fault.inject("dn/exec_fragment", "delay(1500)", "node=0, once")
        s.execute("set statement_timeout = '300ms'")
        t0 = time.monotonic()
        try:
            s.query("select sum(v) from t")
            err = None
        except Exception as e:
            err = str(e)
        cut = time.monotonic() - t0 < 1.4
        deadline = time.time() + 5
        while (time.time() < deadline
               and dns[0].stats.get("fragments_cancelled", 0) < 1):
            time.sleep(0.05)
        st = (dns[0].stats.get("fragments_cancelled", 0) >= 1,
              dns[0].stats.get("cancel_requests", 0) >= 1)
        s.execute("set statement_timeout = 0")
        return (bool(err and "statement timeout" in err), cut, st,
                s.query("select count(*) from t"))
    finally:
        _stop_topology(c, dns, sender)


def test_cancel_fragment_stops_abandoned_dn_work(tmp_path):
    """The deadline cuts the RPC and the coordinator sends
    cancel_fragment: the datanode stops the delayed fragment at its next
    operator boundary."""
    ref = _cancel(REF, str(tmp_path / "ref"))
    port = _cancel(PORT, str(tmp_path / "port"))
    assert port == ref == (True, True, (True, True), [(50,)])


def test_cancel_reaches_the_parallel_block_workers(tmp_path):
    """The operator-boundary check rides into run_fragment_parallel's
    block workers: a cancelled token stops every block (the port's
    LocalExecutor polls it before each operator)."""
    from opentenbase_tpu_torch.executor import local as port_local
    from opentenbase_tpu_torch.plan import analyze_statement
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse

    c = port_engine.Cluster(num_datanodes=1, shard_groups=4, device="cpu")
    s = c.session()
    s.execute("create table t (k bigint, v bigint) distribute by shard(k)")
    s.execute("insert into t values " + ",".join(
        f"({i}, {i})" for i in range(4000)))
    q = "select sum(v), count(*) from t"
    dp = distribute_statement(optimize_statement(
        analyze_statement(parse(q)[0], c.catalog), c.catalog), c.catalog)
    frag = dp.root_fragments[0] if hasattr(dp, "root_fragments") else None
    plan = (frag or dp.fragments[0]).root
    polls = []

    class Cancelled(Exception):
        pass

    def check():
        polls.append(1)
        raise Cancelled()

    old = os.environ.get("OTB_DN_PARALLEL_MIN_ROWS")
    os.environ["OTB_DN_PARALLEL_MIN_ROWS"] = "100"
    try:
        with pytest.raises(Cancelled):
            port_local.run_fragment_parallel(
                c.catalog, c.stores[0], c.gts.snapshot_ts(), plan, {}, [],
                4, device="cpu", cancel_check=check)
        assert polls  # every block worker polled before its operators
        out = port_local.run_fragment_parallel(
            c.catalog, c.stores[0], c.gts.snapshot_ts(), plan, {}, [], 4,
            device="cpu", cancel_check=lambda: None)
        assert out is not None
    finally:
        if old is None:
            os.environ.pop("OTB_DN_PARALLEL_MIN_ROWS", None)
        else:
            os.environ["OTB_DN_PARALLEL_MIN_ROWS"] = old


def _retryable_write(pkg, d):
    from test_pgwire import V3Client

    c, s, dns, sender = _start_topology(pkg, d, rows=8)
    srv = pkg.server.ClusterServer(c).start()
    pg = pkg.pgwire.PgWireServer(c).start()
    try:
        vals1 = ",".join(f"({k}, 1)" for k in range(1001, 1009))
        vals2 = ",".join(f"({k}, 2)" for k in range(2001, 2009))
        pkg.fault.inject("dn/2pc_prepare", "error", "once")
        cl = pkg.client.connect_tcp(srv.host, srv.port)
        try:
            cl.execute(f"insert into t values {vals1}")
            state = None
        except pkg.client.WireError as e:
            state = e.sqlstate
        cl.execute(f"insert into t values {vals1}")
        n1 = cl.query("select count(*) from t where k >= 1001 and "
                      "k <= 1008")
        cl.close()
        pkg.fault.inject("dn/2pc_prepare", "error", "once")
        v3 = V3Client(pg.host, pg.port)
        try:
            v3.query(f"insert into t values {vals2}")
            pg_err = None
        except RuntimeError as e:
            pg_err = "C08006" in str(e)
        _, rows, _ = v3.query("select count(*) from t where k >= 2001 "
                              "and k <= 2008")
        v3.close()
        return state, n1, pg_err, rows
    finally:
        for x in (pg, srv):
            try:
                x.stop()
            except Exception:
                pass
        _stop_topology(c, dns, sender)


def test_write_path_surfaces_retryable_sqlstate_both_wires(tmp_path):
    """A datanode failing its 2PC prepare aborts the statement whole with
    SQLSTATE 08006 on both wires; the re-run inserts exactly once."""
    ref = _retryable_write(REF, str(tmp_path / "ref"))
    port = _retryable_write(PORT, str(tmp_path / "port"))
    assert port == ref == ("08006", [(8,)], True, [("0",)])


def _dn_gids(dn):
    return [e["gid"] for e in dn._twophase_list()]


def _indoubt(pkg, d):
    from test_pgwire import V3Client

    c, s, dns, sender = _start_topology(pkg, d, rows=8)
    srv = pkg.server.ClusterServer(c).start()
    pg = pkg.pgwire.PgWireServer(c).start()
    out = []
    try:
        base = s.query("select count(*) from t")[0][0]
        deadline = time.time() + 20
        while time.time() < deadline and any(
                dn.standby.applied < c.persistence.wal.position
                for dn in dns):
            time.sleep(0.02)
        sender.stop()
        time.sleep(0.1)
        batch = {n: ",".join(f"({k}, {n})" for k in range(n, n + 8))
                 for n in (3001, 3101, 3201)}
        # (a) killed before the commit record: presumed abort
        pkg.fault.inject("coord/2pc_after_prepare", "error", "once")
        with pytest.raises(pkg.fault.FaultError):
            c.session().execute(f"insert into t values {batch[3001]}")
        out.append(any(_dn_gids(dn) for dn in dns))
        cl = pkg.client.connect_tcp(srv.host, srv.port)
        out.append(sorted(o for _g, o in cl.query(
            "select pg_resolve_indoubt()")))
        out.append([_dn_gids(dn) for dn in dns])
        out.append([p for p in c.gts.prepared_txns() if p.gid])
        s2 = c.session()
        out.append(s2.query("select count(*) from t")[0][0] - base)
        # (b) killed after the commit record, before phase 2: commit
        pkg.fault.inject("coord/2pc_before_phase2", "error", "once")
        with pytest.raises(pkg.fault.FaultError):
            c.session().execute(f"insert into t values {batch[3101]}")
        out.append(any(_dn_gids(dn) for dn in dns))
        v3 = V3Client(pg.host, pg.port)
        _, rows, _ = v3.query("select pg_resolve_indoubt()")
        v3.close()
        out.append(sorted(r[1] for r in rows))
        out.append([_dn_gids(dn) for dn in dns])
        out.append(s2.query("select count(*) from t")[0][0] - base)
        # (c) phase 2 partly delivered: the straggler resolves to commit
        pkg.fault.inject("dn/2pc_commit", "error", "once")
        c.session().execute(f"insert into t values {batch[3201]}")
        out.append(any(_dn_gids(dn) for dn in dns))
        out.append(sorted(o for _g, o in cl.query(
            "select pg_resolve_indoubt()")))
        out.append([_dn_gids(dn) for dn in dns])
        out.append(s2.query("select count(*) from t")[0][0] - base)
        cl.close()
        st = dict(s2.query("select stat, value from pg_stat_2pc"))
        out.append((st["resolver_runs"] >= 3, st["resolved_abort"] >= 1,
                    st["resolved_commit"] >= 2))
        return out
    finally:
        for x in (pg, srv):
            try:
                x.stop()
            except Exception:
                pass
        _stop_topology(c, dns, sender)


def test_indoubt_resolution_all_three_outcomes(tmp_path):
    """A coordinator 'killed' between prepare and commit leaves no
    in-doubt gid after pg_resolve_indoubt(), for each decision: no
    commit record (abort), a durable record before phase 2 (commit), a
    phase 2 partly delivered (the straggler commits)."""
    ref = _indoubt(REF, str(tmp_path / "ref"))
    port = _indoubt(PORT, str(tmp_path / "port"))
    assert port == ref
    assert port[0] and port[1] and set(port[1]) == {"aborted"}
    assert port[4] == 0 and port[8] == 8 and port[12] == 16
    assert set(port[6]) == {"committed"} and port[-1] == (True, True, True)


def _age_gate(pkg, d):
    c, s, dns, sender = _start_topology(pkg, d, rows=8)
    try:
        dns[0]._twophase_prepare({"gid": "orphan_x", "gxid": 999})
        young = c.resolve_indoubt(min_age_s=3600)
        left = _dn_gids(dns[0])
        old = c.resolve_indoubt(min_age_s=0.0)
        stop = c.start_indoubt_resolver(interval_s=0.1, min_age_s=0.0)
        stop()
        return (("orphan_x", "aborted") in young, left,
                ("orphan_x", "aborted") in old, _dn_gids(dns[0]))
    finally:
        _stop_topology(c, dns, sender)


def test_background_resolver_age_gates_live_commits(tmp_path):
    ref = _age_gate(REF, str(tmp_path / "ref"))
    port = _age_gate(PORT, str(tmp_path / "port"))
    assert port == ref == (False, ["orphan_x"], True, [])


# -- torn WAL frames and the pool -------------------------------------------
def _reassembly(pkg, d):
    path = os.path.join(d, f"{pkg.name}.log")
    wal = pkg.WAL(path)
    rng = random.Random(11)
    for i in range(40):
        wal.append(b"D", {"op": "noop", "i": i,
                          "pad": "x" * rng.randint(0, 200)})
    wal.close()
    with open(path, "rb") as f:
        data = f.read()
    out = []
    for trial in range(25):
        trng = random.Random(trial)
        buf, got, pos = b"", [], 0
        while pos < len(data):
            cut = min(pos + trng.randint(1, 97), len(data))
            buf += data[pos:cut]
            pos = cut
            consumed = 0
            for _tag, header, _arr, off in pkg.WAL.read_stream(
                    io.BytesIO(buf)):
                got.append(header["i"])
                consumed = off
            buf = buf[consumed:]
        out.append((got, buf))
    return data, out


def test_torn_frame_reassembly_fuzz_unit(tmp_path):
    """Any split of the record stream yields every record once, in
    order, and the two packages write the same bytes."""
    ref, port = both(_reassembly, str(tmp_path))
    assert port == ref
    assert all(got == list(range(40)) and buf == b"" for got, buf in port[1])


def _wal_torn(pkg, d):
    d = os.path.join(d, pkg.name)
    c = pkg.Cluster(num_datanodes=2, shard_groups=16,
                    data_dir=os.path.join(d, "p"), **pkg.kw)
    s = c.session()
    s.execute("create table w (k bigint, txt text) distribute by shard(k)")
    pkg.fault.inject("repl/wal_stream", "wal_torn", "prob(1; 7)")
    sender = sb = None
    try:
        sender = pkg.repl.WalSender(c.persistence, poll_s=0.02)
        sb = pkg.repl.StandbyCluster(os.path.join(d, "sb"), 2, 16, **pkg.kw)
        sb.start_replication(sender.host, sender.port)
        for i in range(5):
            s.execute("insert into w values " + ",".join(
                f"({i * 50 + j}, 'val_{i}_{j}')" for j in range(50)))
        caught = sb.wait_caught_up(c.persistence, timeout_s=30)
        want = sorted(s.query("select k, txt from w"))
        got = sorted(sb.session().query("select k, txt from w"))
        hits = {r[0]: r for r in pkg.fault.stats()}
        return caught, got == want, len(got), hits["repl/wal_stream"][5] >= 1
    finally:
        pkg.fault.clear()
        if sb is not None:
            sb.stop()
            if pkg is PORT:
                sb.close()
        if sender is not None:
            sender.stop()
        c.close()


def test_wal_torn_failpoint_streams_correctly(tmp_path):
    """wal_torn on every outgoing chunk: the standby still replicates
    bit for bit."""
    ref, port = both(_wal_torn, str(tmp_path))
    assert port == ref == (True, True, 250, True)


def _pool_poison(pkg, d):
    d = os.path.join(d, pkg.name)
    c = pkg.Cluster(num_datanodes=2, shard_groups=16,
                    data_dir=os.path.join(d, "cn"), **pkg.kw)
    sender = pkg.repl.WalSender(c.persistence)
    dn = pkg.dn.DNServer(os.path.join(d, "dn"), sender.host, sender.port,
                         2, 16, **pkg.kw).start()
    pool = pkg.pool.ChannelPool("127.0.0.1", dn.port, size=1)
    out = []
    try:
        out.append(pool.rpc({"op": "ping"})["ok"])
        with pytest.raises(TypeError):
            pool.rpc({"op": "ping", "bad": object()})
        out.append(pool._total)
        out.append(pool.rpc({"op": "ping"})["ok"])
        out.append(pool.stats["opened"])
        pkg.fault.inject("net/pool/rpc_recv", "error", "once")
        with pytest.raises(pkg.fault.FaultError):
            pool.rpc({"op": "ping"})
        out.append(pool._total)
        resp = pool.rpc({"op": "2pc_list"})
        out.append(resp.get("gids"))
        out.append(pool.stats["discarded"])
        out.append(pool._total)
        return out
    finally:
        pool.close()
        dn.stop()
        if pkg is PORT:
            dn.standby.close()
        sender.stop()
        c.close()


def test_pool_slot_survives_poisoned_message(tmp_path):
    """An unserializable request frees its slot and leaves the channel
    clean; a fault between send and recv discards the channel, and the
    next call reads its own reply."""
    ref, port = both(_pool_poison, str(tmp_path))
    assert port == ref == [True, 1, True, 1, 0, [], 1, 1]


# -- the GTM ---------------------------------------------------------------
def _gtm_failover(pkg):
    prim = pkg.gts.GTSServer()
    fe1 = pkg.gtm_server.GTSFrontend(prim).start()
    link = pkg.gtm_standby.ReplicationLink(prim)
    sb = link.add_standby()
    cli = pkg.gtm_client.NativeGTS(fe1.host, fe1.port)
    try:
        info = cli.begin()
        ts1 = cli.get_gts()
        fe1.stop()
        promoted = sb.promote()
        fe2 = pkg.gtm_server.GTSFrontend(promoted).start()
        try:
            cli.set_standby(fe2.host, fe2.port)
            ts2 = cli.get_gts()
            cts = cli.commit(info.gxid)
            return (cli.failovers, ts2 > ts1, cts > ts2, cli.ping())
        finally:
            fe2.stop()
    finally:
        cli.close()


def test_gtm_client_fails_over_to_promoted_standby_mid_txn():
    """A transaction begun on the lost primary commits through the
    promoted standby the client was told of."""
    ref, port = both(_gtm_failover)
    assert port == ref == (1, True, True, True)


def _gtm_grant(pkg):
    gts = pkg.gts.GTSServer()
    fe = pkg.gtm_server.GTSFrontend(gts).start()
    cli = pkg.gtm_client.NativeGTS(fe.host, fe.port)
    try:
        t1 = cli.get_gts()
        pkg.fault.inject("gtm/grant", "drop_conn", "once")
        t2 = cli.get_gts()
        rows = {r[0]: r for r in pkg.fault.stats()}
        return t2 > t1, cli.failovers, rows["gtm/grant"][5]
    finally:
        cli.close()
        fe.stop()


def test_gtm_grant_failpoint_drops_backend_and_client_survives():
    """gtm/grant's drop severs one exchange; the client reconnects to
    the same live primary and retries."""
    ref, port = both(_gtm_grant)
    assert port == ref == (True, 0, 1)


def _forwarding(pkg, d):
    c = pkg.Cluster(num_datanodes=2, shard_groups=16,
                    data_dir=os.path.join(d, "cn"), **pkg.kw)
    s = c.session()
    s.execute("set enable_fused_execution = off")
    s.execute("create table t (k bigint, v bigint) distribute by shard(k)")
    s.execute("insert into t values (1,1),(2,2),(3,3),(4,4)")
    sender = pkg.repl.WalSender(c.persistence)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    try:
        for node in (0, 1):
            p = subprocess.Popen(
                [sys.executable, "-m", pkg.dn_module, "--data-dir",
                 os.path.join(d, f"dn{node}"), "--wal-host", sender.host,
                 "--wal-port", str(sender.port), "--num-datanodes", "2",
                 "--shard-groups", "16", *pkg.dn_args],
                stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
            procs.append(p)
            line = p.stdout.readline().strip()
            assert line.startswith("READY "), line
            c.attach_datanode(node, "127.0.0.1", int(line.split()[1]),
                              pool_size=2, rpc_timeout=60)
        s.execute("set fault_injection = on")
        armed = s.query("select pg_fault_inject('dn/exec_fragment', "
                        "'delay(1)', 'every(1)')")
        total = s.query("select sum(v) from t")
        rows = s.query("select node, site, fired from pg_stat_faults "
                       "where site = 'dn/exec_fragment' order by node")
        by_node = {r[0]: r[2] for r in rows}
        cleared = s.query("select pg_fault_clear()")[0][0]
        return (armed, total, by_node.get("dn0", 0) + by_node.get("dn1", 0)
                >= 2, by_node.get("cn"), cleared)
    finally:
        for node in (0, 1):
            try:
                c.detach_datanode(node)
            except Exception:
                pass
        for p in procs:
            if p.poll() is None:
                p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        sender.stop()
        c.close()


def test_fault_arm_forwards_to_dn_processes_and_stats_aggregate(tmp_path):
    """pg_fault_inject forwards fault_arm to real datanode processes and
    pg_stat_faults aggregates each process's counters; pg_fault_clear
    clears the coordinator's and both processes' arms."""
    ref = _forwarding(REF, str(tmp_path / "ref"))
    port = _forwarding(PORT, str(tmp_path / "port"))
    assert port == ref
    assert port[0] == [("dn/exec_fragment", 2)] and port[1] == [(10,)]
    assert port[2] is True and port[3] == 0 and port[4] >= 2


# -- the failpoint cases of other reference files -----------------------------
def _compaction_crash(pkg, d):
    d = os.path.join(d, pkg.name)
    out = []
    for site in ("storage/compaction_start", "storage/compaction_end"):
        cd = os.path.join(d, f"comp_{site[-5:]}")
        c = pkg.Cluster(num_datanodes=2, shard_groups=16, data_dir=cd,
                        **pkg.kw)
        s = c.session()
        s.execute("create table t (k bigint, v bigint) "
                  "distribute by shard(k)")
        s.execute("insert into t values " + ",".join(
            f"({i}, {i})" for i in range(400)))
        want = sorted(s.query("select k, v from t"))
        pkg.fault.inject(site, "error", "once")
        try:
            with pytest.raises(Exception):
                c.compact_deltas()
        finally:
            pkg.fault.clear()
        served = sorted(s.query("select k, v from t")) == want
        crash = cd + "_crash"
        shutil.copytree(cd, crash)
        c.close()
        r = pkg.Cluster.recover(crash, num_datanodes=2, shard_groups=16,
                                **pkg.kw)
        out.append((served, sorted(r.session().query(
            "select k, v from t")) == want, len(want)))
        r.close()
    return out


def test_compaction_crash_mid_fold_recovers(tmp_path):
    """tests/test_write_path.py's case: a compaction pass dying at either
    failpoint loses nothing, before or after recovery."""
    ref, port = both(_compaction_crash, str(tmp_path))
    assert port == ref == [(True, True, 400)] * 2


def _lagging_ack(pkg, d):
    d = os.path.join(d, pkg.name)
    c = pkg.Cluster(num_datanodes=2, shard_groups=16,
                    data_dir=os.path.join(d, "cn"), **pkg.kw)
    s = c.session()
    s.execute("create table t (k bigint, v bigint) distribute by shard(k)")
    s.execute("insert into t values (1, 10), (2, 20)")
    sender = pkg.repl.WalSender(c.persistence, poll_s=0.005)
    sbs = []
    try:
        for i in range(2):
            sb = pkg.repl.StandbyCluster(os.path.join(d, f"sb{i}"), 2, 16,
                                         **pkg.kw)
            sb.start_replication(sender.host, sender.port)
            sbs.append(sb)
        for sb in sbs:
            assert sb.wait_caught_up(c.persistence, timeout_s=30)
        s.execute("set synchronous_commit = remote_write")
        pkg.fault.inject("repl/ack_recv", "delay(300)", "prob(1.0)")
        t0 = time.monotonic()
        s.execute("insert into t values (3, 30)")
        took = time.monotonic() - t0
        pkg.fault.clear()
        fired = {r[0]: r[5] for r in pkg.fault.stats()}["repl/ack_recv"]
        return (s.query("select v from t where k = 3"), took < 8.0,
                fired >= 1)
    finally:
        pkg.fault.clear()
        for sb in sbs:
            sb.stop()
            if pkg is PORT:
                sb.close()
        sender.stop()
        c.close()


def test_remote_write_tolerates_one_lagging_standby_ack(tmp_path):
    """tests/test_write_path.py's case: with repl/ack_recv delaying every
    standby's acks, a remote_write commit waits for them and completes
    (the pipelined wait, not a timeout)."""
    ref, port = both(_lagging_ack, str(tmp_path))
    assert port == ref == ([(30,)], True, True)


def _chaos_rng_streams(pkg):
    pkg.fault.set_chaos_seed(99)
    s1 = [pkg.fault.chaos_rng("fault/x").random() for _ in range(5)]
    s2 = [pkg.fault.chaos_rng("fault/y").random() for _ in range(5)]
    pkg.fault.set_chaos_seed(99)
    again = ([pkg.fault.chaos_rng("fault/x").random() for _ in range(5)],
             [pkg.fault.chaos_rng("fault/y").random() for _ in range(5)])
    pkg.fault.set_chaos_seed(None)
    off = pkg.fault.chaos_rng("fault/x")
    runs = []
    for _ in range(2):
        pkg.fault.set_chaos_seed(7)
        pkg.fault.inject("test/site", "error", "prob(0.5)")
        runs.append(fires(pkg, "test/site", 20))
        pkg.fault.clear()
    pkg.fault.set_chaos_seed(None)
    return s1, s2, again, off, runs


def test_chaos_schedule_replay_determinism():
    """tests/test_ha.py's registry half: per-name chaos streams replay
    alike after a re-arm of the seed, differ by name, vanish without a
    seed, and the test/site prob draws come from the seed's stream,
    the reference's draws exactly."""
    ref, port = both(_chaos_rng_streams)
    assert port == ref
    s1, s2, again, off, runs = port
    assert again == (s1, s2) and s1 != s2 and off is None
    assert runs[0] == runs[1] and 1 in runs[0] and 0 in runs[0]


def _delta_scan_faults(pkg):
    c = pkg.Cluster(num_datanodes=2, shard_groups=16, **pkg.kw)
    s = c.session()
    s.execute("create table t (k bigint, v bigint) distribute by shard(k)")
    s.execute("insert into t values (1, 1), (2, 2)")
    s.query("select count(*) from t")  # warm
    s.execute("insert into t values (3, 3)")
    out = {}
    try:
        pkg.fault.inject("fused/delta_tail_upload", "error", "once")
        try:
            out["faulted_fused"] = s.query("select count(*) from t")
        except pkg.fault.FaultError as e:
            out["faulted_fused"] = f"FaultError: {e}"
        out["fired_upload"] = {r[0]: r[5] for r in pkg.fault.stats()}.get(
            "fused/delta_tail_upload", 0)
        out["rerun_fused"] = s.query("select count(*) from t")
        s.execute("set enable_fused_execution = off")
        pkg.fault.inject("storage/delta_scan", "error", "once")
        s.execute("insert into t values (4, 4)")
        try:
            s.query("select count(*) from t")
            out["faulted_host"] = "answered"
        except pkg.fault.FaultError:
            out["faulted_host"] = "FaultError"
    finally:
        pkg.fault.clear()
    out["rerun_host"] = s.query("select count(*) from t")
    s.execute("set enable_fused_execution = on")
    out["fused_after"] = s.query("select count(*) from t")
    c.close()
    return out


def test_delta_scan_faults_fire_and_self_heal():
    """tests/test_delta_scan.py's case. storage/delta_scan fails a host
    scan in both packages and the rerun is exact. fused/delta_tail_upload
    fails the refresh in both; the reference demotes the statement to
    its host route and answers, the port lets the error through (its
    fused route never demotes a failure, ROADMAP C), and the next
    statement repeats the same refresh exactly."""
    ref, port = both(_delta_scan_faults)
    assert ref["faulted_fused"] == [(3,)]
    assert port["faulted_fused"] == ("FaultError: fault injected at "
                                     "'fused/delta_tail_upload'")
    for k in ("fired_upload", "rerun_fused", "faulted_host", "rerun_host",
              "fused_after"):
        assert port[k] == ref[k], k
    assert port["fired_upload"] == 1 and port["rerun_fused"] == [(3,)]
    assert port["faulted_host"] == "FaultError"
    assert port["rerun_host"] == port["fused_after"] == [(4,)]


# -- every site ------------------------------------------------------------
_SITE = re.compile(r'(?:FAULT|_failpoint)\(\s*f?"([a-z0-9_]+/[a-z0-9_/{}:]+)"')

# a reference site in a module the port has that waits for a subsystem
# the port brings later (ROADMAP A)
WAITING = {"gtm/client/probe": "A.7: the trace envelope's capability probe"}


def _sites(pkg_dir: str) -> dict:
    """site -> [module] of every literal FAULT / _failpoint site."""
    out: dict = {}
    for d, _sub, files in os.walk(pkg_dir):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            rel = os.path.relpath(path, pkg_dir)
            with open(path) as fh:
                for site in _SITE.findall(fh.read()):
                    out.setdefault(site, []).append(rel)
    return out


def test_every_reference_site_of_a_ported_module_exists_in_the_port():
    """Each reference failpoint whose module the port has is in the port
    under the same name, in the module of the same name; the others
    wait with their modules (ROADMAP A.8, A.9)."""
    ref = _sites(os.path.join(ROOT, "opentenbase_tpu"))
    port = _sites(os.path.join(ROOT, "opentenbase_tpu_torch"))
    missing = []
    for site, mods in sorted(ref.items()):
        have = [m for m in mods
                if os.path.exists(os.path.join(ROOT, "opentenbase_tpu_torch",
                                               m))]
        if not have or site in WAITING:
            continue
        if site not in port or not set(have) <= set(port[site]):
            missing.append((site, have, port.get(site)))
    assert missing == []
    assert set(port) <= set(ref)
    # the waiting ones: their modules are absent, or named above
    waiting = sorted(s for s, mods in ref.items() if s not in port)
    assert waiting == sorted([
        "gtm/client/probe", "net/concentrator/accept",
        "net/concentrator/recv", "rebalance/copy", "rebalance/flip",
        "rebalance/journal",
        "serving/plan_cache_lookup", "serving/result_cache_lookup",
        "storage/rewind"])

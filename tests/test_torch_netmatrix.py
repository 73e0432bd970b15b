"""The connectivity matrix (opentenbase_tpu_torch/fault/partition.py) and
what the port's wire boundaries do under it, held against the reference
on the four cases of tests/test_partition_chaos.py that need no result
cache: directed cuts and wildcards, a gray link against a bounded call,
the lease budget asserted when the conf loads, and a write whose reply
is lost surfacing 08007 once. Each case runs the same script on both
packages (the port's topology on ``device="cpu"``) and compares what it
saw; the partition schedules themselves wait for the result cache
(ROADMAP A.9)."""

from __future__ import annotations

import os
import socket
import time
from types import SimpleNamespace

import pytest

import opentenbase_tpu.fault as ref_fault
import opentenbase_tpu_torch.fault as port_fault
from opentenbase_tpu import config as ref_config
from opentenbase_tpu import ha as ref_ha
from opentenbase_tpu.net import client as ref_client
from opentenbase_tpu_torch import config as port_config
from opentenbase_tpu_torch import ha as port_ha
from opentenbase_tpu_torch.net import client as port_client

LEASE_CONF = {
    "enable_fused_execution": "off",
    "synchronous_commit": "on",
    "failover_detect_ms": 900,
    "failover_beats": 3,
    "lease_ttl_ms": 0,
    "lease_skew_ms": 100,
    "fragment_retries": 1,
    "fragment_retry_backoff_ms": 5,
    "statement_timeout": 5000,
}

REF = SimpleNamespace(name="ref", fault=ref_fault, config=ref_config,
                      ha=ref_ha, client=ref_client, kw={})
PORT = SimpleNamespace(name="port", fault=port_fault, config=port_config,
                       ha=port_ha, client=port_client, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _clean_faults_and_matrix():
    for pkg in (REF, PORT):
        pkg.fault.clear()
        pkg.fault.set_chaos_seed(None)
        pkg.fault.install_matrix(None)
    yield
    for pkg in (REF, PORT):
        pkg.fault.clear()
        pkg.fault.reset_stats()
        pkg.fault.set_chaos_seed(None)
        pkg.fault.install_matrix(None)


def both(fn, *args):
    return fn(REF, *args), fn(PORT, *args)


def _until(pred, timeout_s: float, step_s: float = 0.02) -> bool:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step_s)
    return bool(pred())


def _cuts(pkg):
    f = pkg.fault
    m = f.NetMatrix()
    m.register_endpoint("cn0", 7001, 7002)
    m.register_endpoint("dn0", 7003)
    m.register_endpoint("dn1", 7004)
    m.cut("monitor", "cn0")
    out = [m.is_cut("monitor", "cn0"), m.is_cut("cn0", "monitor"),
           m.is_cut("client", "cn0")]
    m.cut("cn0", "*")
    out += [m.is_cut("cn0", "dn0"), m.is_cut("cn0", "dn1"),
            m.is_cut("dn0", "dn1"), m.partitioned_peers("cn0"),
            m.heal("monitor", "cn0"), m.is_cut("monitor", "cn0"),
            m.is_cut("cn0", "dn0"), m.heal_all(), m.is_cut("cn0", "dn0")]
    m2 = f.NetMatrix()
    m2.register_endpoint("dn0", 7003)
    m2.cut("cn0", "dn0")
    f.install_matrix(m2)
    with f.net_actor("cn0"):
        try:
            f.NET_CHECK("127.0.0.1", 7003)
            out.append("passed")
        except f.FaultDropConnection as e:
            out.append(str(e))
    with f.net_actor("client"):
        f.NET_CHECK("127.0.0.1", 7003)
    out += [f.current_actor(), m2.describe()]
    return out


def test_netmatrix_directed_cuts_and_wildcards():
    """Rules are directed and match (src, dst) > (src, *) > (*, dst) >
    (*, *); NET_CHECK consults the installed matrix under the caller's
    actor."""
    ref, port = both(_cuts)
    assert port == ref
    assert port[:6] == [True, False, False, True, True, False]
    assert port[6] == ["dn0", "dn1"]
    assert port[7:12] == [1, False, True, 1, False]
    assert "cn0->dn0" in port[12] and port[13] == "client"
    assert port[14]["stats"]["drops"] == 1


def _slow(pkg):
    f = pkg.fault
    m = f.NetMatrix()
    m.register_endpoint("cn0", 7001)
    m.slow_link("monitor", "cn0", 30)
    f.install_matrix(m)
    with f.net_actor("monitor"):
        t0 = time.monotonic()
        f.NET_CHECK("127.0.0.1", 7001, timeout_s=10.0)
        slept = time.monotonic() - t0 >= 0.025
        try:
            f.NET_CHECK("127.0.0.1", 7001, timeout_s=0.02)
            timed_out = False
        except socket.timeout:
            timed_out = True
    return slept, timed_out, m.slow_ms("monitor", "cn0"), m.slow_ms(
        "client", "cn0"), m.describe()["stats"]


def test_netmatrix_slow_link_times_out_bounded_calls():
    """A gray link delays below the caller's deadline and raises
    socket.timeout past it."""
    ref, port = both(_slow)
    assert port == ref
    assert port[:4] == (True, True, 30, 0) and port[4]["delays"] == 2


def _budget(pkg, d):
    d = os.path.join(d, pkg.name)
    os.makedirs(d)
    conf = os.path.join(d, "opentenbase.conf")
    out = []
    for text in ("failover_detect_ms = 200\nfailover_beats = 2\n"
                 "lease_ttl_ms = 600\nlease_skew_ms = 100\n",
                 "failover_detect_ms = 900\nfailover_beats = 3\n"
                 "lease_ttl_ms = 600\nlease_skew_ms = 100\n",
                 "failover_detect_ms = 200\nfailover_beats = 2\n"
                 "lease_ttl_ms = 0\n"):
        with open(conf, "w") as f:
            f.write(text)
        try:
            out.append(pkg.config.load_conf(d)["lease_ttl_ms"])
        except pkg.config.GucError as e:
            out.append("must exceed lease_ttl_ms" in str(e))
    return out


def test_lease_budget_config_assertion(tmp_path):
    """failover_detect_ms x failover_beats at or under lease_ttl_ms +
    lease_skew_ms is refused when the conf loads; leases off assert
    nothing."""
    ref, port = both(_budget, str(tmp_path))
    assert port == ref == [True, 600, 0]


def _indeterminate(pkg, d):
    topo = pkg.ha.HATopology(os.path.join(d, pkg.name), num_datanodes=2,
                             shard_groups=16, conf_gucs=dict(LEASE_CONF),
                             **pkg.kw)
    rc = None
    try:
        rc = pkg.client.connect_any([("127.0.0.1", topo.server.port)])
        rc.execute("create table w (k bigint, v bigint) "
                   "distribute by shard(k)")
        rc.execute("insert into w values (1, 10)")
        # the reply to the next statement is lost: the fault fires in
        # the client after its send, so the server still executes it
        pkg.fault.inject("net/client/recv", "drop_conn", "once")
        try:
            rc.execute("insert into w values (2, 20)")
            err = None
        except pkg.client.WireError as e:
            err = (e.sqlstate, "not retried" in str(e))
        landed = _until(lambda: (2,) in rc.query("select k from w"), 2.0)
        rows = rc.query("select k, v from w order by k")
        # a retry-safe statement is replayed after a silent reconnect
        n = rc.query("select count(*) from w")[0][0]
        pkg.fault.inject("net/client/recv", "drop_conn", "once")
        replayed = rc.query("select count(*) from w") == [(n,)]
        return (err, landed, rows.count((1, 10)), rows.count((2, 20)),
                len(rows) == len(set(rows)), replayed)
    finally:
        if rc is not None:
            rc.close()
        topo.stop()


def test_indeterminate_write_gets_08007_and_no_duplicate(tmp_path):
    """A connection lost after the INSERT was sent: the routed client
    surfaces 08007 and does not replay it, so the row the server
    committed is there exactly once; a read is replayed."""
    ref, port = both(_indeterminate, str(tmp_path))
    assert port == ref
    assert port == (("08007", True), True, 1, 1, True, True)

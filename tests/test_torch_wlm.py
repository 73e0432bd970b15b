"""Workload management in the port (opentenbase_tpu_torch/wlm/, the
session's admission in engine.py), held against the reference on
tests/test_wlm.py's cases: the same script runs on the reference and on
the port (every cluster on ``device="cpu"``), and the rows, SQLSTATEs
and ``pg_stat_wlm`` counters are compared. Left out:
``test_application_name_in_cluster_activity`` and the activity-view
half of ``test_errored_sessions_release_slots_and_close_deregisters``
(``pg_stat_cluster_activity`` comes with ROADMAP A.7). Concurrent
statements start in threads that are joined with a timeout; each next
step waits for the group state it needs (running, queued), never for a
fixed time."""

from __future__ import annotations

import socket
import struct
import threading
import time
from types import SimpleNamespace

import pytest

from opentenbase_tpu import engine as ref_engine
from opentenbase_tpu import sql as ref_sql
from opentenbase_tpu import wlm as ref_wlm
from opentenbase_tpu.net import client as ref_client
from opentenbase_tpu.net import pgwire as ref_pgwire
from opentenbase_tpu.net import pool as ref_pool
from opentenbase_tpu.net import server as ref_server
from opentenbase_tpu.wlm import estimate as ref_estimate
from opentenbase_tpu_torch import engine as port_engine
from opentenbase_tpu_torch import sql as port_sql
from opentenbase_tpu_torch import wlm as port_wlm
from opentenbase_tpu_torch.net import client as port_client
from opentenbase_tpu_torch.net import pgwire as port_pgwire
from opentenbase_tpu_torch.net import pool as port_pool
from opentenbase_tpu_torch.net import server as port_server
from opentenbase_tpu_torch.wlm import estimate as port_estimate

REF = SimpleNamespace(
    name="ref", engine=ref_engine, SQLError=ref_engine.SQLError,
    wlm=ref_wlm, estimate=ref_estimate, client=ref_client,
    server=ref_server, pgwire=ref_pgwire, pool=ref_pool,
    parse=ref_sql.parse, kw={})
PORT = SimpleNamespace(
    name="port", engine=port_engine, SQLError=port_engine.SQLError,
    wlm=port_wlm, estimate=port_estimate, client=port_client,
    server=port_server, pgwire=port_pgwire, pool=port_pool,
    parse=port_sql.parse, kw={"device": "cpu"})

JOIN_S = 30.0  # a thread's join deadline


def both(fn, *args):
    """``fn(pkg, *args)`` on the reference, then on the port."""
    return fn(REF, *args), fn(PORT, *args)


def same(fn, *args):
    """``fn``'s outcome on both packages, which must be equal."""
    want, got = both(fn, *args)
    assert got == want, (want, got)
    return got


def cluster(pkg, **kw):
    return pkg.engine.Cluster(num_datanodes=2, **kw, **pkg.kw)


def seeded(pkg):
    c = cluster(pkg)
    s = c.session()
    s.execute("create table wt (a int8, b int8) distribute by shard(a)")
    s.execute("insert into wt values (1, 10), (2, 20), (3, 30)")
    return c, s


def wait_until(pred, timeout_s: float = 10.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def outcome(fn):
    """"ok", or the SQLSTATE the statement failed with."""
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 - compared across packages
        return getattr(e, "sqlstate", None) or type(e).__name__


def group_stats(c, name):
    g = c.wlm.groups[name]
    st = dict(g.stats)
    st.pop("queue_wait_ms")
    return st, g.running, len(g.queue)


# -- the manager (tests/test_wlm.py:37-127) ---------------------------------


def test_parse_memory_units():
    def run(pkg):
        out = []
        for v in (1024, "64MB", "512kB", "1gb", "123", "lots", "-1MB", -5):
            try:
                out.append(pkg.wlm.parse_memory(v))
            except ValueError as e:
                out.append(str(e))
        return out

    assert same(run)[:5] == [1024, 64 * 1024 ** 2, 512 * 1024, 1024 ** 3,
                             123]


def test_alter_with_bad_option_leaves_group_untouched():
    def run(pkg):
        c = cluster(pkg)
        s = c.session()
        s.execute("create resource group ga with (concurrency=2)")
        st = outcome(lambda: s.execute(
            "alter resource group ga with (concurrency=5, warp=1)"))
        return st, c.wlm.groups["ga"].concurrency

    assert same(run) == ("22023", 2)


def test_manager_fifo_and_shed():
    def run(pkg):
        mgr = pkg.wlm.WorkloadManager()
        mgr.create_group("g", {"concurrency": 1, "queue_depth": 1})
        t1 = mgr.admit("g")
        got = []

        def waiter():
            t = mgr.admit("g", timeout_ms=5000)
            got.append(t)
            t.release()

        th = threading.Thread(target=waiter)
        th.start()
        wait_until(lambda: mgr.groups["g"].queue, what="a queued waiter")
        shed = outcome(lambda: mgr.admit("g"))
        t1.release()
        th.join(timeout=JOIN_S)
        g = mgr.groups["g"]
        return (shed, bool(got and got[0].released), g.stats["admitted"],
                g.stats["shed"], g.stats["queued"], g.running, len(g.queue))

    assert same(run) == ("53000", True, 2, 1, 1, 0, 0)


def test_manager_queue_timeout_is_57014():
    def run(pkg):
        mgr = pkg.wlm.WorkloadManager()
        mgr.create_group("g", {"concurrency": 1, "queue_depth": 4})
        t1 = mgr.admit("g")
        st = outcome(lambda: mgr.admit("g", timeout_ms=100))
        t1.release()
        return st, mgr.groups["g"].stats["timed_out"]

    assert same(run) == ("57014", 1)


def test_manager_release_idempotent_and_drop_rules():
    def run(pkg):
        mgr = pkg.wlm.WorkloadManager()
        mgr.create_group("g", {"concurrency": 2})
        t = mgr.admit("g")
        t.release()
        t.release()
        out = [mgr.groups["g"].running,
               outcome(lambda: mgr.drop_group(pkg.wlm.DEFAULT_GROUP))]
        mgr.bind_role("r1", "g")
        out.append(outcome(lambda: mgr.drop_group("g")))
        mgr.bind_role("r1", None)
        held = mgr.admit("g")
        out.append(outcome(lambda: mgr.drop_group("g")))
        held.release()
        mgr.drop_group("g")
        return out + ["g" in mgr.groups]

    assert same(run) == [0, "WlmConfigError", "WlmConfigError",
                         "WlmConfigError", False]


def test_queued_waiter_shed_when_alter_shrinks_memory_budget():
    def run(pkg):
        mgr = pkg.wlm.WorkloadManager()
        mgr.create_group("g", {"concurrency": 4, "memory_limit": 1024,
                               "queue_depth": 4})
        big = mgr.admit("g", est=900)
        result = {}

        def waiter():
            result["r"] = outcome(lambda: mgr.admit("g", est=500).release())

        th = threading.Thread(target=waiter)
        th.start()
        wait_until(lambda: mgr.groups["g"].queue, what="a queued waiter")
        mgr.alter_group("g", {"memory_limit": 100})
        th.join(timeout=JOIN_S)
        big.release()
        return result["r"], len(mgr.groups["g"].queue)

    assert same(run) == ("53200", 0)


# -- DDL and the views (tests/test_wlm.py:130-210, :766, :922-939) ----------


def test_resource_group_ddl_roundtrip():
    def run(pkg):
        s = cluster(pkg).session()
        out = [s.execute("create resource group rg1 with (concurrency=2, "
                         "memory_limit='64MB', queue_depth=4, priority=5)"
                         ).command]
        out.append(s.query("select group_name, concurrency, memory_limit, "
                           "queue_depth, priority from pg_stat_wlm "
                           "order by group_name"))
        for sql in ("create resource group rg1 with (concurrency=1)",
                    "create resource group rg2 with (warp_factor=9)",
                    "alter resource group rg1 with (concurrency=7)",
                    "alter role alice resource group rg1",
                    "drop resource group rg1",
                    "alter role alice no resource group",
                    "drop resource group rg1",
                    "drop resource group if exists rg1",
                    "drop resource group rg1",
                    "alter role bob resource group nope"):
            out.append(outcome(lambda: s.execute(sql)))
            out.append(s.query("select * from pg_resgroup_role"))
        out.append(s.query("select group_name, concurrency from pg_stat_wlm "
                           "order by group_name"))
        return out

    got = same(run)
    assert got[1] == [("default_group", 0, 0, 0, 0),
                      ("rg1", 2, 64 * 1024 ** 2, 4, 5)]


def test_unknown_resource_group_guc_rejected_at_admission():
    def run(pkg):
        _c, s = seeded(pkg)
        s.execute("set resource_group = missing")
        try:
            s.query("select count(*) from wt")
        except pkg.SQLError as e:
            return e.sqlstate, str(e)

    assert same(run) == ("42704", 'resource group "missing" does not exist')


def test_wlm_ddl_errors_carry_sqlstate():
    def run(pkg):
        s = cluster(pkg).session()
        out = [outcome(lambda: s.execute("drop resource group nosuch"))]
        s.execute("create resource group dup with (concurrency=1)")
        out.append(outcome(lambda: s.execute(
            "create resource group dup with (concurrency=1)")))
        out.append(outcome(lambda: s.execute(
            "create resource group bad with (warp_factor=9)")))
        return out

    assert same(run) == ["42704", "42710", "22023"]


def test_drop_role_removes_wlm_binding():
    def run(pkg):
        c = cluster(pkg)
        s = c.session()
        s.execute("create user carol with password 'pw'")
        s.execute("create resource group gc with (concurrency=1)")
        s.execute("alter role carol resource group gc")
        s.execute("drop user carol")
        bound = dict(c.wlm.role_bindings)
        return bound, s.execute("drop resource group gc").command

    assert same(run) == ({}, "DROP RESOURCE GROUP")


def test_pg_sleep_blocked_as_user_function_name():
    def run(pkg):
        s = cluster(pkg).session()
        return outcome(lambda: s.execute(
            "create function pg_sleep(x int8) returns int8 as 'select 1'"))

    want, got = both(run)
    assert want != "ok" and got != "ok"


def test_system_view_selects_bypass_admission():
    def run(pkg):
        c = cluster(pkg)
        s = c.session()
        s.execute("create resource group jam with (concurrency=1, "
                  "queue_depth=0)")
        s.execute("set resource_group = jam")
        held = c.wlm.admit("jam")
        try:
            rows = s.query("select group_name, running from pg_stat_wlm "
                           "where group_name = 'jam'")
            shed = outcome(lambda: s.query("select 1"))
        finally:
            held.release()
        return rows, shed, c.wlm.groups["jam"].stats["shed"]

    assert same(run) == ([("jam", 1)], "53000", 1)


# -- admission under concurrency (tests/test_wlm.py:212-270, :880) ----------


def run_sleepers(c, group, n, sleep_s, timeout=None):
    """``n`` sessions of ``group`` each run one pg_sleep, started one at
    a time: each next one once the previous is running or queued.
    Returns each one's outcome."""
    sessions = []
    for _ in range(n):
        s = c.session()
        s.execute(f"set resource_group = {group}")
        if timeout is not None:
            s.execute(f"set statement_timeout = '{timeout}'")
        sessions.append(s)
    out = [None] * n
    g = c.wlm.groups[group]

    def run(i):
        out[i] = outcome(lambda: sessions[i].execute(
            f"select pg_sleep({sleep_s})"))

    threads = []
    for i in range(n):
        seen = g.stats["admitted"] + g.stats["queued"] + g.stats["shed"]
        th = threading.Thread(target=run, args=(i,))
        th.start()
        threads.append(th)
        wait_until(lambda: g.stats["admitted"] + g.stats["queued"]
                   + g.stats["shed"] > seen, what="the statement's turn")
    for th in threads:
        th.join(timeout=JOIN_S)
    return out


def test_k_plus_one_queues_with_room():
    def run(pkg):
        c = cluster(pkg)
        c.session().execute("create resource group gk with "
                            "(concurrency=2, queue_depth=8)")
        return run_sleepers(c, "gk", 3, 0.3), group_stats(c, "gk")

    outs, (st, running, queued) = same(run)
    assert outs == ["ok", "ok", "ok"] and st["admitted"] == 3
    assert st["queued"] == 1 and st["shed"] == 0 and running == queued == 0


def test_k_plus_one_sheds_when_queue_full():
    def run(pkg):
        c = cluster(pkg)
        c.session().execute("create resource group small with "
                            "(concurrency=1, queue_depth=1)")
        return run_sleepers(c, "small", 3, 0.3), group_stats(c, "small")

    outs, (st, running, queued) = same(run)
    assert outs == ["ok", "ok", "53000"]
    assert (st["admitted"], st["shed"], running, queued) == (2, 1, 0, 0)


def test_queue_wait_bounded_by_statement_timeout():
    def run(pkg):
        c = cluster(pkg)
        c.session().execute("create resource group gt with "
                            "(concurrency=1, queue_depth=4)")
        runner, waiter = c.session(), c.session()
        for s in (runner, waiter):
            s.execute("set resource_group = gt")
        waiter.execute("set statement_timeout = '150ms'")
        th = threading.Thread(target=lambda: runner.execute(
            "select pg_sleep(0.6)"))
        th.start()
        wait_until(lambda: c.wlm.groups["gt"].running, what="the runner")
        t0 = time.monotonic()
        st = outcome(lambda: waiter.execute("select pg_sleep(0.1)"))
        fast = time.monotonic() - t0 < 1.0
        th.join(timeout=JOIN_S)
        return st, fast, group_stats(c, "gt")

    st, fast, (stats, running, queued) = same(run)
    assert (st, fast, stats["timed_out"], running, queued) == (
        "57014", True, 1, 0, 0)


def test_queue_wait_uses_remaining_statement_budget():
    def run(pkg):
        c = cluster(pkg)
        c.session().execute("create resource group gb with "
                            "(concurrency=1, queue_depth=4)")
        held = c.wlm.admit("gb")
        s = c.session()
        s.execute("set resource_group = gb")
        s._stmt_deadline = time.monotonic() + 0.15
        t0 = time.monotonic()
        st = outcome(lambda: s._execute_one(pkg.parse("select 1")[0]))
        fast = time.monotonic() - t0 < 1.0
        s._stmt_deadline = None
        held.release()
        return st, fast

    assert same(run) == ("57014", True)


def test_wlm_queue_timeout_guc_caps_wait():
    def run(pkg):
        c = cluster(pkg)
        c.session().execute("create resource group gq with "
                            "(concurrency=1, queue_depth=4)")
        held = c.wlm.admit("gq")
        s = c.session()
        s.execute("set resource_group = gq")
        s.execute("set wlm_queue_timeout = '100ms'")
        st = outcome(lambda: s.query("select 1"))
        held.release()
        return st, group_stats(c, "gq")

    assert same(run)[0] == "57014"


# -- memory budgets (tests/test_wlm.py:272-336) -----------------------------


def test_work_mem_floors_admission_estimate():
    def run(pkg):
        est = pkg.estimate.estimate_statement_memory
        out = [est(object(), None), est(object(), None, work_mem=10_000_000)]
        c, s = seeded(pkg)
        s.execute("analyze")
        for q in ("select count(*) from wt", "select a, b from wt",
                  "select a, sum(b) from wt group by a",
                  "insert into wt values (9, 9)"):
            out.append(est(pkg.parse(q)[0], c.catalog))
        s.execute("create resource group wm with "
                  "(concurrency=4, memory_limit='1MB', queue_depth=4)")
        s.execute("set resource_group = wm")
        s.execute("set work_mem = 16777216")
        out.append(outcome(lambda: s.query("select count(*) from wt")))
        s.execute("set work_mem = 1024")
        out.append(s.query("select count(*) from wt"))
        return out

    got = same(run)
    assert got[:2] == [64 * 1024, 10_000_000] and got[-2:] == [
        "53200", [(3,)]]


def test_memory_budget_shed_53200():
    def run(pkg):
        c, s = seeded(pkg)
        s.execute("create resource group tiny with "
                  "(concurrency=4, memory_limit='1kB', queue_depth=4)")
        s.execute("set resource_group = tiny")
        st = outcome(lambda: s.query("select a, b from wt"))
        s.execute("set resource_group = ''")
        rows = s.query("select group_name, shed from pg_stat_wlm "
                       "order by group_name")
        return st, rows

    assert same(run) == ("53200", [("default_group", 0), ("tiny", 1)])


def test_refresh_and_result_bytes_are_charged():
    """A REFRESH is charged by its defining query's plan; the host
    route notes the result's live-row bytes on the ticket
    (peak_result_bytes), the fused route notes none, as in the
    reference."""
    def run(pkg):
        c, s = seeded(pkg)
        s.execute("create resource group acc with (concurrency=4)")
        s.execute("set resource_group = acc")
        s.execute("set enable_fused_execution = off")
        s.query("select a, b from wt")
        host = c.wlm.groups["acc"].stats["peak_result_bytes"]
        s.execute("set enable_fused_execution = on")
        s.query("select a, b from wt where a > 1")
        return host, c.wlm.groups["acc"].stats["peak_result_bytes"]

    assert same(run) == (48, 48)


# -- session lifecycle (tests/test_wlm.py:338-392) --------------------------


def test_errored_sessions_release_slots_and_close_deregisters():
    def run(pkg):
        c, s = seeded(pkg)
        s.execute("create resource group small with "
                  "(concurrency=1, queue_depth=0)")
        holder, errored = c.session(), c.session()
        for x in (holder, errored):
            x.execute("set resource_group = small")
        th = threading.Thread(target=lambda: holder.execute(
            "select pg_sleep(0.3)"))
        th.start()
        g = c.wlm.groups["small"]
        wait_until(lambda: g.running, what="the holder")
        st = outcome(lambda: errored.query("select count(*) from wt"))
        during = (g.running, len(g.queue), errored.state,
                  errored._wlm_ticket is None)
        th.join(timeout=JOIN_S)
        errored.close()
        errored.close()  # twice is fine
        return st, during, g.running

    assert same(run) == ("53000", (1, 0, "idle", True), 0)


def test_wlm_error_mid_statement_releases_ticket():
    def run(pkg):
        c, s = seeded(pkg)
        s.execute("create resource group g1 with (concurrency=2)")
        s.execute("set resource_group = g1")
        ok = outcome(lambda: s.query("select no_such_col from wt"))
        return ok != "ok", c.wlm.groups["g1"].running, s._wlm_ticket

    assert same(run) == (True, 0, None)


# -- recovery of the group catalog (tests/test_wlm.py:394-443) --------------


@pytest.mark.parametrize("swap", [False, True], ids=["own", "swapped"])
def test_wal_crash_recovery_of_resource_groups(tmp_path, swap):
    def make(pkg, d):
        c = cluster(pkg, data_dir=d)
        s = c.session()
        s.execute("create resource group g1 with "
                  "(concurrency=3, memory_limit='32MB', queue_depth=2)")
        s.execute("alter role alice resource group g1")
        c.persistence.checkpoint()
        s.execute("create resource group g2 with (concurrency=1, "
                  "priority=9)")
        s.execute("alter resource group g1 with (concurrency=5)")
        s.execute("alter role bob resource group g2")
        s.execute("alter role alice no resource group")
        return c

    dirs = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    made = [make(REF, dirs["ref"]), make(PORT, dirs["port"])]

    def recover(pkg):
        d = dirs[("port" if pkg is REF else "ref") if swap else pkg.name]
        r = pkg.engine.Cluster.recover(d, num_datanodes=2, **pkg.kw)
        try:
            cfg = r.wlm.dump_state()
            rs = r.session()
            rs.execute("set resource_group = g2")
            rows = rs.query("select 1")
            return cfg, rows, r.wlm.groups["g2"].stats["admitted"]
        finally:
            r.close()

    try:
        cfg, rows, admitted = same(recover)
    finally:
        for c in made:
            c.close()
    assert cfg["roles"] == {"bob": "g2"} and rows == [(1,)] and admitted == 1
    assert cfg["groups"]["g1"] == {"concurrency": 5,
                                   "memory_limit": 32 * 1024 ** 2,
                                   "queue_depth": 2, "priority": 0}


def test_recovery_after_drop(tmp_path):
    def run(pkg):
        d = str(tmp_path / pkg.name)
        c = cluster(pkg, data_dir=d)
        s = c.session()
        s.execute("create resource group gone with (concurrency=1)")
        s.execute("create resource group kept with (concurrency=2)")
        c.persistence.checkpoint()
        s.execute("drop resource group gone")
        r = pkg.engine.Cluster.recover(d, num_datanodes=2, **pkg.kw)
        try:
            return sorted(r.wlm.groups), r.wlm.groups["kept"].concurrency
        finally:
            r.close()
            c.close()

    assert same(run) == (["default_group", "kept"], 2)


# -- the client's connect retries (tests/test_wlm.py:445-500, :647) ---------


def free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def test_connect_retry_exhausted_is_typed():
    def run(pkg):
        port = free_port()
        try:
            pkg.client.connect_with_retry("127.0.0.1", port, retries=2,
                                          backoff_s=0.01)
        except pkg.client.RetryExhausted as e:
            return (isinstance(e, pkg.client.WireError),
                    "3 attempt(s)" in str(e))

    assert same(run) == (True, True)


def test_connect_retry_succeeds_when_listener_appears():
    def run(pkg):
        port = free_port()
        lsock = socket.socket()
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ready = threading.Event()

        def listen_later():
            ready.wait(timeout=JOIN_S)
            lsock.bind(("127.0.0.1", port))
            lsock.listen(1)

        th = threading.Thread(target=listen_later)
        th.start()
        try:
            ready.set()
            sock = pkg.client.connect_with_retry("127.0.0.1", port,
                                                 retries=40, backoff_s=0.02)
            sock.close()
            return True
        finally:
            th.join(timeout=JOIN_S)
            lsock.close()

    assert same(run) is True


def test_pool_slot_recovered_after_connect_failure():
    def run(pkg):
        pool = pkg.pool.ChannelPool("127.0.0.1", free_port(), size=1)
        errs = [outcome(lambda: pool.acquire(timeout=0.2))
                for _ in range(3)]
        total = pool._total
        pool.close()
        return errs, total

    errs, total = same(run)
    assert total == 0 and len(errs) == 3


# -- the wire (tests/test_wlm.py:502-635, :781-878) -------------------------


def test_json_wire_reports_sqlstate_on_shed():
    def run(pkg):
        c, s = seeded(pkg)
        s.execute("create resource group tiny with "
                  "(concurrency=4, memory_limit='1kB', queue_depth=4)")
        with pkg.server.ClusterServer(c, port=0) as srv:
            cs = pkg.client.connect_tcp(srv.host, srv.port)
            try:
                cs.execute("set resource_group = tiny")
                return outcome(lambda: cs.query("select a, b from wt"))
            finally:
                cs.close()

    assert same(run) == "53200"


class V3:
    """A minimal PG v3 client (trust mode) that keeps SQLSTATEs."""

    def __init__(self, host, port, user):
        self.sock = socket.create_connection((host, port), timeout=30)
        body = struct.pack("!I", 196608)
        body += b"user\0" + user.encode() + b"\0\0"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        while True:
            tag, payload = self._recv()
            if tag == b"Z":
                break
            assert tag != b"E", payload

    def _read_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            assert chunk, "server closed connection"
            buf += chunk
        return buf

    def _recv(self):
        tag = self._read_exact(1)
        (ln,) = struct.unpack("!I", self._read_exact(4))
        return tag, self._read_exact(ln - 4)

    def query(self, sql):
        """("ok", rows) or ("error", sqlstate)."""
        body = sql.encode() + b"\0"
        self.sock.sendall(b"Q" + struct.pack("!I", len(body) + 4) + body)
        rows, err = [], None
        while True:
            tag, payload = self._recv()
            if tag == b"D":
                (ncols,) = struct.unpack_from("!H", payload, 0)
                off, vals = 2, []
                for _ in range(ncols):
                    (ln,) = struct.unpack_from("!i", payload, off)
                    off += 4
                    if ln == -1:
                        vals.append(None)
                    else:
                        vals.append(payload[off:off + ln].decode())
                        off += ln
                rows.append(tuple(vals))
            elif tag == b"E":
                fields = {part[:1].decode(): part[1:].decode()
                          for part in payload.split(b"\0") if part}
                err = fields.get("C", "?????")
            elif tag == b"Z":
                return ("error", err) if err else ("ok", rows)

    def close(self):
        try:
            self.sock.sendall(b"X" + struct.pack("!I", 4))
            self.sock.close()
        except OSError:
            pass


def test_e2e_pgwire_graceful_degradation():
    def run(pkg):
        c = cluster(pkg)
        admin = c.session()
        admin.execute("create resource group small with "
                      "(concurrency=1, queue_depth=1)")
        admin.execute("alter role app resource group small")
        srv = pkg.pgwire.PgWireServer(c, port=0).start()
        g = c.wlm.groups["small"]
        try:
            clients = [V3(srv.host, srv.port, "app") for _ in range(3)]
            results = [None] * 3

            def go(i):
                results[i] = clients[i].query("select pg_sleep(0.3)")

            threads = []
            for i in range(3):
                seen = g.stats["admitted"] + g.stats["queued"] + \
                    g.stats["shed"]
                th = threading.Thread(target=go, args=(i,))
                th.start()
                threads.append(th)
                wait_until(lambda: g.stats["admitted"] + g.stats["queued"]
                           + g.stats["shed"] > seen, what="the turn")
            for th in threads:
                th.join(timeout=JOIN_S)
            mon = V3(srv.host, srv.port, "monitor")
            counters = mon.query("select admitted, shed, queued from "
                                 "pg_stat_wlm where group_name = 'small'")
            mon.close()
            for cl in clients:
                cl.close()
            return [r[0] if r[0] == "ok" else r for r in results], counters
        finally:
            srv.stop()

    results, counters = same(run)
    assert results == ["ok", "ok", ("error", "53000")]
    assert counters == ("ok", [("2", "1", "1")])


def test_queued_waiter_does_not_block_exclusive_ddl():
    def run(pkg):
        c = cluster(pkg)
        c.session().execute("create resource group jam with "
                            "(concurrency=1, queue_depth=4)")
        g = c.wlm.groups["jam"]
        with pkg.server.ClusterServer(c, port=0) as srv:
            runner = pkg.client.connect_tcp(srv.host, srv.port)
            waiter = pkg.client.connect_tcp(srv.host, srv.port)
            for x in (runner, waiter):
                x.execute("set resource_group = jam")
            res = {}
            t1 = threading.Thread(target=lambda: res.update(
                runner=runner.query("select pg_sleep(0.25)")))
            t1.start()
            wait_until(lambda: g.running, what="the runner")
            t2 = threading.Thread(target=lambda: res.update(
                waiter=waiter.query("select pg_sleep(0.7)")))
            t2.start()
            wait_until(lambda: g.queue, what="the queued waiter")
            ddl = pkg.client.connect_tcp(srv.host, srv.port)
            t0 = time.monotonic()
            ddl.execute("alter resource group jam with (queue_depth=8)")
            # waited for the running statement only, never the queue
            fast = time.monotonic() - t0 < 0.8
            t1.join(timeout=JOIN_S)
            t2.join(timeout=JOIN_S)
            for x in (runner, waiter, ddl):
                x.close()
            return fast, sorted(res), g.queue_depth

    assert same(run) == (True, ["runner", "waiter"], 8)


def test_queued_writer_releases_table_mutex_for_other_groups():
    def run(pkg):
        c, s = seeded(pkg)
        s.execute("create resource group thr with "
                  "(concurrency=1, queue_depth=4)")
        g = c.wlm.groups["thr"]
        with pkg.server.ClusterServer(c, port=0) as srv:
            holder = pkg.client.connect_tcp(srv.host, srv.port)
            queued = pkg.client.connect_tcp(srv.host, srv.port)
            other = pkg.client.connect_tcp(srv.host, srv.port)
            for x in (holder, queued):
                x.execute("set resource_group = thr")
            res = {}
            th1 = threading.Thread(target=lambda: res.update(
                h=holder.query("select pg_sleep(0.5)")))
            th1.start()
            wait_until(lambda: g.running, what="the holder")
            th2 = threading.Thread(target=lambda: res.update(
                q=queued.execute("update wt set b = b + 1 where a = 1")))
            th2.start()
            wait_until(lambda: g.queue, what="the queued writer")
            t0 = time.monotonic()
            other.execute("update wt set b = b + 10 where a = 2")
            fast = time.monotonic() - t0 < 0.4
            th1.join(timeout=JOIN_S)
            th2.join(timeout=JOIN_S)
            for x in (holder, queued, other):
                x.close()
            return fast, sorted(res), s.query("select a, b from wt "
                                              "order by a")

    assert same(run) == (True, ["h", "q"], [(1, 11), (2, 30), (3, 30)])


# -- statement_timeout (tests/test_wlm.py:637-703, :904) --------------------


def test_set_statement_timeout_applies_within_same_string():
    def run(pkg):
        s = cluster(pkg).session()
        t0 = time.monotonic()
        st = outcome(lambda: s.execute(
            "set statement_timeout = '50ms'; select pg_sleep(10)"))
        return st, time.monotonic() - t0 < 5

    assert same(run) == ("57014", True)


def test_no_stale_deadline_for_extended_protocol_path():
    def run(pkg):
        s = cluster(pkg).session()
        s.execute("set statement_timeout = '50ms'")
        out = [outcome(lambda: s.execute("select pg_sleep(10)")),
               s._stmt_deadline]
        s.execute("set statement_timeout = 0")
        out.append(s._execute_one(pkg.parse("select pg_sleep(0.05)")[0])
                   .columns)
        s.execute("set statement_timeout = '50ms'")
        out.append(outcome(lambda: s._execute_one(
            pkg.parse("select pg_sleep(10)")[0])))
        return out

    assert same(run) == ["57014", None, ["pg_sleep"], "57014"]


def test_nested_statement_inherits_outer_deadline():
    def run(pkg):
        s = cluster(pkg).session()
        s._stmt_deadline = time.monotonic() + 0.05
        st = outcome(lambda: s.execute("select pg_sleep(10)"))
        s._stmt_deadline = None
        return st

    assert same(run) == "57014"


def test_expired_deadline_cancels_fused_and_explain_paths():
    """An expired deadline cancels the read path with 57014 (the port
    raises its executor's StatementTimeout there, the reference an
    SQLError: the SQLSTATE is the contract), and EXPLAIN ANALYZE runs
    under a live one."""
    def run(pkg):
        _c, s = seeded(pkg)
        s._stmt_deadline = time.monotonic() - 0.01
        st = outcome(lambda: s._run_select(
            pkg.parse("select sum(b) from wt")[0]))
        s._stmt_deadline = None
        s.execute("set statement_timeout = '60s'")
        r = s.execute("explain analyze select sum(b) from wt")
        return st, r.command, s.query("select sum(b) from wt")

    assert same(run) == ("57014", "EXPLAIN", [(60,)])

"""SET, RESET and SHOW in the port (config.py's GUCS, ``_x_setstmt``,
``_x_showstmt``), held against the reference: every setting the port
takes is SET, SHOWn, RESET and SHOWn again on a reference and a port
session with equal answers, through a conf file too; SHOW ALL lists the
reference's rows for those settings. The settings change what they
change in the reference: ``enable_delta_scan`` off folds on read
(tests/test_delta_scan.py's case), ``enable_bulk_insert_rewrite`` off
takes the general INSERT pipeline (tests/test_write_path.py's
differential), ``enable_pallas_scan`` and ``enable_pallas_join`` switch
K1's and K2's routes, ``join_mode`` forces the DAG's join formulation.
A setting whose subsystem is not ported is refused by name with its
ROADMAP item, in SET, SHOW and a conf file alike."""

import random

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster, NotPorted
from opentenbase_tpu_torch import config as port_config
from torch_pair import Pair, assert_same_rows

# (setting, a value to SET): the settings the port takes, with values
TAKEN = [
    ("enable_delta_scan", "off"),
    ("join_mode", "sortmerge"),
    ("join_mode", "radix"),
    ("enable_pallas_scan", "off"),
    ("enable_pallas_join", "off"),
    ("device_memory_limit", "1048576"),
    ("enable_bulk_insert_rewrite", "off"),
    ("enable_fast_query_shipping", "off"),
    ("search_path", "'public'"),
    ("application_name", "'psql'"),
    ("application_name", "'12'"),
    ("client_min_messages", "warning"),
    ("session_authorization", "'alice'"),
    ("role", "'bob'"),
    ("statement_timeout", "'2s'"),
    ("lock_timeout", "'150ms'"),
    ("synchronous_commit", "off"),
    ("fragment_retries", "4"),
    # workload management and the parallel workers (wlm/, dn/server.py)
    # and the matview rewrite, taken since their subsystems were ported
    ("work_mem", "16777216"),
    ("dn_parallel_workers", "2"),
    ("resource_group", "'batch'"),
    ("wlm_queue_timeout", "'100ms'"),
    ("enable_matview_rewrite", "off"),
    # fault injection (fault/), taken since the failpoints were ported
    ("fault_injection", "on"),
]
REFUSED = ["trace_queries", "enable_plan_cache", "enable_result_cache",
           "expected_device_platform", "read_routing",
           "gtm_standby_addr", "autovacuum", "log_min_messages",
           "rebalance_rate_limit"]


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    p.both("create table t (k bigint, v bigint) distribute by shard(k)")
    p.both("insert into t values " + ",".join(
        f"({i}, {i * 3})" for i in range(40)))
    yield p
    p.close()


@pytest.mark.parametrize("name,value", TAKEN)
def test_set_show_reset_each_setting(pair, name, value):
    pair.both(f"set {name} = {value}")
    assert pair.both(f"show {name}").columns == [name]
    pair.both(f"reset {name}")
    pair.both(f"show {name}")
    pair.both(f"set {name} to default")
    pair.both(f"show {name}")


def test_show_all_is_the_references_for_the_settings_taken(pair):
    want = dict(pair.rs.query("show all"))
    got = pair.ps.query("show all")
    assert got == sorted(got)
    assert got and all(want[k] == v for k, v in got)
    names = {k for k, _ in got}
    assert {n for n, _ in TAKEN} - {"enable_pallas_scan",
                                    "enable_pallas_join",
                                    "session_authorization",
                                    "role"} <= names
    assert not names & set(port_config.NOT_ACTED_ON)


@pytest.mark.parametrize("name", REFUSED)
def test_settings_still_to_come_refused_by_name(pair, name):
    item = port_config.NOT_ACTED_ON[name]
    with pytest.raises(NotPorted, match=f"SET {name} .ROADMAP {item}"):
        pair.ps.execute(f"set {name} = 1")
    with pytest.raises(NotPorted, match=f"SHOW {name}"):
        pair.ps.execute(f"show {name}")
    pair.rs.execute(f"show {name}")  # the reference's takes them


def test_invalid_values_fail_as_the_references(pair):
    for sql, match in (
            ("set join_mode = hash", "must be one of"),
            ("set enable_delta_scan = maybe", "invalid boolean"),
            ("set device_memory_limit = 'lots'", "invalid integer"),
            ("set statement_timeout = 'soon'", "invalid duration"),
            ("set client_min_messages = loud", "must be one of"),
            ("set nope = 1", "unrecognized configuration parameter"),
            ("reset nope", "unrecognized configuration parameter")):
        pair.raises(sql, match)
    pair.both("set ext.custom = 7")
    pair.both("show ext.custom")


def test_role_and_session_authorization_change_the_user(pair):
    rs, ps = pair.sessions()
    for s in (rs, ps):
        s.execute("set session_authorization = 'alice'")
    assert rs.user == ps.user == "alice"
    for s in (rs, ps):
        s.execute("set role = on")
    assert rs.user == ps.user == "on"  # the raw spelling is the identity
    for s in (rs, ps):
        s.execute("reset role")
    assert rs.user == ps.user == "otb"


def test_conf_file_settings_are_session_defaults(tmp_path):
    conf = {"enable_delta_scan": "off", "join_mode": "sortmerge",
            "application_name": "'etl'", "enable_pallas_scan": "on",
            "device_memory_limit": "4096", "search_path": "public"}
    p = Pair(data_dir=str(tmp_path), conf=conf)
    try:
        assert p.rc.conf_gucs == p.pc.conf_gucs
        for name in conf:
            p.both(f"show {name}")
            p.both(f"set {name} = default")
            p.both(f"show {name}")  # RESET: back to the conf's value
        want = dict(p.rs.query("show all"))
        assert all(want[k] == v for k, v in p.ps.query("show all"))
    finally:
        p.close()


def test_conf_file_refuses_a_setting_still_to_come(tmp_path):
    (tmp_path / "opentenbase.conf").write_text("enable_plan_cache = on\n")
    with pytest.raises(NotPorted, match="enable_plan_cache .ROADMAP A.9"):
        Cluster(2, 16, data_dir=str(tmp_path), device="cpu")


def _wal(s) -> dict:
    return dict(s.query("select stat, value from pg_stat_wal"))


@pytest.mark.parametrize("fused", ["on", "off"])
def test_enable_delta_scan_off_restores_fold_on_read(fused):
    """tests/test_delta_scan.py's case on both packages, on each route:
    with the setting off the read folds (host scans and the device
    cache alike)."""
    out = []
    for c in (RefCluster(num_datanodes=2, shard_groups=16),
              Cluster(num_datanodes=2, shard_groups=16, device="cpu")):
        c.conf_gucs["enable_delta_scan"] = False
        s = c.session()
        s.execute(f"set enable_fused_execution = {fused}")
        s.execute("create table t (k bigint, v bigint) "
                  "distribute by shard(k)")
        s.execute("insert into t values " + ",".join(
            f"({i},{i})" for i in range(300)))
        got = s.query("select count(*), sum(v) from t")
        wal = _wal(s)
        out.append((got, wal["pending_delta_rows"],
                    wal["deltas_absorbed"] > 0))
        c.close()
    assert out[0] == out[1] == ([(300, sum(range(300)))], 0, True)


def test_enable_delta_scan_on_leaves_deltas_parked():
    p = Pair()
    try:
        p.both("create table t (k bigint, v bigint) distribute by shard(k)")
        p.both("insert into t values " + ",".join(
            f"({i},{i})" for i in range(300)))
        p.query("select count(*), sum(v) from t")
        ref, port = _wal(p.rs), _wal(p.ps)
        assert port["pending_delta_rows"] == ref["pending_delta_rows"] == 300
        assert port["deltas_absorbed"] == ref["deltas_absorbed"] == 0
        # DML row location folds too with the setting off
        for s in (p.rs, p.ps):
            s.execute("set enable_delta_scan = off")
        p.both("update t set v = v + 1 where k < 10")
        assert _wal(p.ps)["pending_delta_rows"] == _wal(
            p.rs)["pending_delta_rows"]
        p.query("select count(*), sum(v) from t")
    finally:
        p.close()


def _random_insert_statements(seed: int) -> list[str]:
    """tests/test_write_path.py's generator, as it is."""
    rng = random.Random(seed)
    stmts = []
    k = 0
    for _ in range(25):
        n = rng.choice([1, 1, 2, 5, 17])
        rows = []
        for _ in range(n):
            k += 1
            v = rng.choice(
                [rng.randrange(-100, 100), "null", rng.random() * 10])
            w = rng.choice(["'a'", "'zeta'", "null", "''", "'it''s'"])
            b = rng.choice(["true", "false", "null"])
            dt = rng.choice(["'2024-01-02'", "'1999-12-31'", "null"])
            rows.append(f"({k}, {v}, {w}, {b}, {dt})")
        stmts.append("insert into dt values " + ",".join(rows))
    stmts.append("insert into dt (k, f) values (9001, 1.5), (9002, 2)")
    stmts.append("insert into dt values (9003, 3)")
    return stmts


@pytest.mark.parametrize("seed", [11, 23])
def test_bulk_insert_rewrite_differential(seed):
    """tests/test_write_path.py's differential on the port, each mode
    held against the reference's: the rewrite and the general pipeline
    give identical tables, and only the rewrite counts in pg_stat_wal."""
    results = {}
    for mode in ("on", "off"):
        p = Pair()
        try:
            for c in (p.rc, p.pc):
                c.conf_gucs["enable_fused_execution"] = False
                c.conf_gucs["enable_bulk_insert_rewrite"] = mode == "on"
            p.rs, p.ps = p.sessions()
            p.both("create table dt (k bigint, f float8, w text, b bool, "
                   "d date) distribute by shard(k)")
            p.both("prepare pi as insert into dt values ($1, $2, $3)")
            for stmt in _random_insert_statements(seed):
                p.both(stmt)
            for i in range(5):
                p.both(f"execute pi({20000 + i}, {i * 1.5}, 'p{i}')")
            results[mode] = sorted(p.ps.query("select k, f, w, b, d from dt"),
                                   key=lambda r: r[0])
            assert_same_rows(results[mode], sorted(
                p.rs.query("select k, f, w, b, d from dt"),
                key=lambda r: r[0]))
            rewrites = {_wal(s)["insert_rewrites"] for s in (p.rs, p.ps)}
            assert len(rewrites) == 1
            assert (rewrites.pop() > 0) == (mode == "on")
        finally:
            p.close()
    assert results["on"] == results["off"]


def _count_calls(monkeypatch, module, fn: str) -> list:
    calls = []
    real = getattr(module, fn)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, fn, counted)
    return calls


def test_enable_pallas_scan_switches_k1s_route(monkeypatch):
    from opentenbase_tpu_torch.ops import scan_agg as sa

    calls = _count_calls(monkeypatch, sa, "scan_agg")
    p = Pair()
    try:
        p.both("create table t (k bigint, v bigint, d numeric(10,2)) "
               "distribute by shard(k)")
        p.both("insert into t values " + ",".join(
            f"({i}, {i % 7}, {i}.25)" for i in range(200)))
        sql = "select sum(v), count(*), sum(d) from t where k > 20"
        fx = p.pc.fused_executor()
        for value, route, n in (("off", "program", 0), ("on", "scan_agg", 1),
                                ("default", "scan_agg", 1)):
            for s in (p.rs, p.ps):
                s.execute(f"set enable_pallas_scan = {value}")
            del calls[:]
            assert_same_rows(p.ps.query(sql), p.rs.query(sql), value)
            assert (fx.last_route, len(calls)) == (route, n), value
    finally:
        p.close()


SSB_LIKE = [
    "create table dd (d_datekey int, d_year int) distribute by replication",
    "insert into dd values " + ",".join(
        f"({19920101 + 100 * m + 4 * d}, {1992 + m // 12})"
        for m in range(24) for d in range(3)),
    "create table lo (lo_orderdate int, lo_revenue bigint, lo_discount int)"
    " distribute by roundrobin",
    "insert into lo values " + ",".join(
        f"({19920101 + 100 * (i % 24) + 4 * (i % 3)}, {i * 11}, {i % 10})"
        for i in range(600)),
]
SSB_Q = ("select sum(lo_revenue * lo_discount) from lo, dd "
         "where lo_orderdate = d_datekey and d_year = 1993 "
         "and lo_discount between 1 and 3 group by d_year")


@pytest.mark.parametrize("setting,value,modes,k2", [
    ("join_mode", "auto", ("fold", "radix"), 1),
    ("join_mode", "radix", ("fold", "radix"), 1),
    ("join_mode", "sortmerge", ("fold", "merge"), 0),
    ("enable_pallas_join", "off", ("fold", "merge"), 0),
])
def test_join_settings_switch_k2(monkeypatch, setting, value, modes, k2):
    """SSB flight 1's shape (a yyyymmdd date key: the fold trips and
    the radix table answers): ``join_mode`` and ``enable_pallas_join``
    decide whether K2 probes, and the answer stays the reference's."""
    from opentenbase_tpu_torch.executor import fused_dag
    from opentenbase_tpu_torch.ops import radix_probe as rp

    calls = _count_calls(monkeypatch, rp, "radix_probe")
    monkeypatch.setattr(fused_dag, "rp", rp)
    p = Pair()
    try:
        for sql in SSB_LIKE:
            p.both(sql)
        p.both("analyze")
        for s in (p.rs, p.ps):
            s.execute(f"set {setting} = {value}")
        assert_same_rows(p.ps.query(SSB_Q), p.rs.query(SSB_Q))
        fx = p.pc.fused_executor()
        assert p.ps.last_route == "fused" and p.ps._fused_via_dag
        assert tuple(sorted(set(fx._dag.last_join_modes) | {
            "fold"})) == tuple(sorted(modes))
        assert bool(calls) == bool(k2)
    finally:
        p.close()


def test_device_memory_limit_sizes_the_radix_budget(monkeypatch):
    from opentenbase_tpu_torch.executor import fused_dag

    seen = []
    real = fused_dag.batchplan.resolve_budget

    def spy(limit, env_name, default):
        seen.append(limit)
        return real(limit, env_name, default)

    monkeypatch.setattr(fused_dag.batchplan, "resolve_budget", spy)
    p = Pair()
    try:
        for sql in SSB_LIKE:
            p.both(sql)
        for s in (p.rs, p.ps):
            s.execute("set device_memory_limit = 123456789")
        assert_same_rows(p.ps.query(SSB_Q), p.rs.query(SSB_Q))
        assert seen and set(seen) == {123456789}
        del seen[:]
        for s in (p.rs, p.ps):
            s.execute("reset device_memory_limit")
        p.ps.query(SSB_Q.replace("1993", "1992"))
        assert seen and set(seen) == {0}
    finally:
        p.close()

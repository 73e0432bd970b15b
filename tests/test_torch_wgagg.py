"""The port's windowed gagg (wgagg) against the reference: a top-k plan
whose gagg sort operands pass the window budget streams its dominant
scan leaf in shard-row windows, each window leaving compact per-group
partials on the device for one merge program; a big build side is
hoisted (evaluated and key-sorted once) and read presorted by every
window.

Each case runs the reference's DAG runner on a one-device mesh and the
port's ``Session.query`` over identical rows (a reference
``Cluster(num_datanodes=1, shard_groups=16)``, carried into the port's
with ``carry.load_table``), with the window budget forced down through
``OTB_DAG_WINDOW_BUDGET`` as the reference's own tests do
(tests/test_dimfold.py:206, :270, :334). Both must take wgagg and return
the host executor's rows exactly. Also: a window capacity that doubles,
a join flag raised inside the windows, the refusals the reference makes
(full-range keys overflowing the raw-key sentinels, a TEXT group key,
two kept keys), the default budget staying in gagg, and bench.py's
SF100 Q3 shape (chip_smoke.SF100_Q3) at a small size with the hoist."""

import numpy as np
import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.executor import fused_dag as ref_fd
from opentenbase_tpu_torch import Cluster
from opentenbase_tpu_torch.executor import fused_dag
from opentenbase_tpu_torch.executor.fused_dag import DagUnsupported
from opentenbase_tpu_torch.ops.filter import bucket_size
from opentenbase_tpu_torch.plan import analyze_statement
from opentenbase_tpu_torch.plan.distribute import distribute_statement
from opentenbase_tpu_torch.plan.optimize import optimize_statement
from opentenbase_tpu_torch.sql import parse_one

from test_torch_dag_grouped import _carry, _ref_append, smoke
from test_torch_dag_topk import _mesh1, _values

BUDGET = "200000"  # bytes: forces the window path at a few thousand rows


def _pair1(ddl, inserts=(), tables=None):
    """A one-datanode reference cluster (16 shard groups, as the
    reference's wgagg tests) and a port cluster over the same rows: the
    reference takes ``inserts`` (SQL) or ``tables`` (numpy columns), and
    every table carries over."""
    ref = RefCluster(num_datanodes=1, shard_groups=16)
    rs = ref.session()
    port = Cluster(num_datanodes=1, shard_groups=16, device="cpu")
    ps = port.session()
    for stmt in ddl:
        rs.execute(stmt)
        ps.execute(stmt)
    for stmt in inserts:
        rs.execute(stmt)
    for name, arrays in (tables or {}).items():
        _ref_append(ref, name, arrays)
    for stmt in ddl:
        _carry(ref, port, stmt.split()[2])
    return rs, port, ps


def _host_rows(rs, sql):
    rs.execute("set enable_fused_execution = off")
    try:
        return rs.query(sql)
    finally:
        rs.execute("set enable_fused_execution = on")


def _wgagg(pair, sql, mode="wgagg"):
    """Both runners' answers equal to the host executor's, in ``mode``,
    with equal folded joins and join modes. Returns (rows, port runner,
    reference runner)."""
    rs, port, ps = pair
    want = _host_rows(rs, sql)
    ref_rows, ref = _mesh1(rs, sql)
    got = ps.query(sql)
    runner = port.fused_executor()._dag
    assert ref_rows == want
    assert got == want
    assert ps._fused_via_dag
    assert ref.last_mode == runner.last_mode == mode
    assert (runner.last_folded, runner.last_join_modes) == (
        ref.last_folded, ref.last_join_modes)
    return got, runner, ref


def _port_dag(pair, sql):
    """The port's DAG runner on ``sql`` alone (``Session.query`` would
    hand a plan it refuses to the fragment program)."""
    _rs, port, _ps = pair
    cat = port.catalog
    dp = distribute_statement(optimize_statement(
        analyze_statement(parse_one(sql), cat), cat), cat)
    return port.fused_executor().dag_output(dp, port.gts.snapshot_ts())


@pytest.fixture()
def budget(monkeypatch):
    monkeypatch.setenv("OTB_DAG_WINDOW_BUDGET", BUDGET)


@pytest.fixture(scope="module")
def dim_fact():
    """tests/test_dimfold.py:206's rows: a 64-row dense dimension and
    6000 fact rows."""
    rng = np.random.default_rng(7)
    nd, nf = 64, 6000
    ks = rng.integers(0, nd, nf)
    vs = rng.integers(1, 50, nf)
    return _pair1(
        ["create table dim (k bigint, cat bigint) distribute by replication",
         "create table f (fk bigint, v bigint) distribute by roundrobin"],
        ["insert into dim values " + ",".join(
            f"({i},{i % 7})" for i in range(nd)),
         "insert into f values " + ",".join(
             f"({int(k)},{int(v)})" for k, v in zip(ks, vs))])


def test_windowed_gagg_cross_window_groups(dim_fact, budget):
    """Groups cross the windows; ``cat`` is FD-dropped (a function of
    the join key) and rides the windows as a carried key."""
    got, runner, _ref = _wgagg(
        dim_fact, "select fk, cat, sum(v), count(*) from f, dim where "
        "fk = k group by fk, cat order by 3 desc, fk limit 9")
    assert len(got) == 9
    nwin, width, cap = runner.last_windows
    assert nwin > 1 and width * nwin >= 6000
    assert runner.last_hoisted is False  # 64 build rows: per window


def test_windowed_gagg_minmax_and_carried_order(budget):
    """min/max partials (negative values, a NULL) merge across windows;
    ORDER BY an FD-dropped key reads the carried column
    (tests/test_dimfold.py:270)."""
    rng = np.random.default_rng(9)
    vals = [f"({int(kk)},{int(v)})" for kk, v in zip(
        rng.integers(0, 48, 5000), rng.integers(-900, 900, 5000))]
    vals.append("(3, null)")
    pair = _pair1(
        ["create table dim (k bigint, cat bigint) distribute by replication",
         "create table f (fk bigint, v bigint) distribute by roundrobin"],
        ["insert into dim values " + ",".join(
            f"({i},{(i * 3) % 11})" for i in range(48)),
         "insert into f values " + ",".join(vals)])
    got, runner, ref = _wgagg(
        pair, "select fk, cat, min(v), max(v), sum(v) from f, dim "
        "where fk = k group by fk, cat order by 5 desc, cat, fk limit 11")
    assert len(got) == 11
    # negative sums broke the cumsum run base: both reran robust
    assert runner._robust_on and ref._robust_on


def test_windowed_gagg_hoisted_build_prep(budget, monkeypatch):
    """A big window-invariant build side (orders folded with its segment
    dimension) is evaluated and key-sorted once in a prep program, and
    every window reads it presorted; the top join still folds
    (tests/test_dimfold.py:334)."""
    monkeypatch.setattr(ref_fd.DagRunner, "HOIST_MIN_ROWS", 100)
    monkeypatch.setattr(fused_dag.DagRunner, "HOIST_MIN_ROWS", 100)
    rng = np.random.default_rng(13)
    ng, no, nf = 32, 600, 7000
    pair = _pair1(
        ["create table seg (g bigint, cat bigint) distribute by replication",
         "create table ord (ok bigint, gk bigint, od bigint) "
         "distribute by replication",
         "create table f (fk bigint, v bigint) distribute by roundrobin"],
        ["insert into seg values " + ",".join(
            f"({i},{i % 5})" for i in range(ng)),
         "insert into ord values " + ",".join(
             f"({i},{int(g)},{int(d)})" for i, g, d in zip(
                 range(no), rng.integers(0, ng, no), rng.integers(0, 99, no))),
         "insert into f values " + ",".join(
             f"({int(k)},{int(v)})" for k, v in zip(
                 rng.integers(0, no + 40, nf), rng.integers(1, 60, nf)))])
    got, runner, ref = _wgagg(
        pair, "select fk, od, cat, sum(v), count(*) from f, ord, seg "
        "where fk = ok and gk = g and cat < 4 "
        "group by fk, od, cat order by 4 desc, fk limit 10")
    assert len(got) == 10
    for r in (runner, ref):
        assert [k[0] for k in r._programs if k[0] == "prep"] == ["prep"]
    assert runner.last_hoisted


def test_sf100_q3_shape_hoisted(budget, monkeypatch):
    """bench.py's SF100 leg at a small size (chip_smoke.make_sf100, one
    datanode): Q3's orders side (customer folded in) is hoisted, the
    top join folds with the prepped source swapped to the right, and
    the ten rows equal numpy's."""
    monkeypatch.setattr(ref_fd.DagRunner, "HOIST_MIN_ROWS", 100)
    monkeypatch.setattr(fused_dag.DagRunner, "HOIST_MIN_ROWS", 100)
    n = 4096 * 9
    tables = smoke.make_sf100(n, 5)
    pair = _pair1(smoke.SF100_DDL, tables=tables)
    got, runner, _ref = _wgagg(pair, smoke.SF100_Q3)
    assert got == smoke.expected_sf100_q3(tables)
    assert runner.last_hoisted and runner.last_join_modes == ("fold",)
    nwin, width, _cap = runner.last_windows
    assert nwin * width == bucket_size(n)
    # Q6 on the same rows goes through the scan-aggregate route
    rs, port, ps = pair
    assert ps.query(smoke.SF100_Q6) == _host_rows(rs, smoke.SF100_Q6) == \
        smoke.expected_sf100_q6(tables)
    assert port.fused_executor().last_route == "scan_agg"


@pytest.fixture(scope="module")
def many_keys():
    """1500 distinct keys over 6000 rows: each window holds far more
    groups than a small capacity."""
    rng = np.random.default_rng(21)
    n = 6000
    return _pair1(
        ["create table m (u bigint, w bigint) distribute by roundrobin"],
        [_values("m", [[int(x) for x in rng.integers(0, 1500, n)],
                       [int(x) for x in rng.integers(0, 100, n)]])])


def test_window_capacity_doubles(many_keys, budget, monkeypatch):
    """A first capacity below the groups of a window raises ``novf``:
    the capacity doubles (every window reruns) until it holds them, and
    the one that fit is remembered."""
    monkeypatch.setattr(fused_dag, "WGAGG_MIN_CAP", 1)
    _got, runner, _ref = _wgagg(
        many_keys, "select u, sum(w), count(*) from m group by u "
        "order by 2 desc, u limit 7")
    _nwin, width, cap = runner.last_windows
    assert runner.last_retries["cap"] >= 1
    assert width // 4 < cap <= width
    assert cap in runner._caps.values()


def test_default_budget_stays_gagg(many_keys):
    """Under the 6 GB default the same plan is one gagg on both."""
    _wgagg(many_keys, "select u, sum(w), count(*) from m group by u "
           "order by 2 desc, u limit 7", mode="gagg")


def test_join_flag_inside_the_windows(budget):
    """A dimension whose keys have gaps: the top join's fold flag rises
    in the windows, every window reruns with the fold off (the radix
    table answers), as in the reference."""
    rng = np.random.default_rng(5)
    pair = _pair1(
        ["create table dim (k bigint, cat bigint) distribute by replication",
         "create table f (fk bigint, v bigint) distribute by roundrobin"],
        ["insert into dim values " + ",".join(
            f"({3 * i},{i % 9})" for i in range(60)),
         "insert into f values " + ",".join(
             f"({int(k)},{int(v)})" for k, v in zip(
                 rng.integers(0, 200, 6000), rng.integers(1, 50, 6000)))])
    _got, runner, ref = _wgagg(
        pair, "select fk, cat, sum(v) from f, dim where fk = k "
        "group by fk, cat order by 3 desc, fk limit 5")
    assert runner.last_retries["flag"] >= 1
    assert runner.last_folded == ref.last_folded == frozenset()


def _refusal(pair, sql, reason):
    """Both runners refuse ``sql`` with the reference's reason: the
    reference's run returns None, the port's DAG raises."""
    rs, _port, _ps = pair
    rows, ref = _mesh1(rs, sql)
    assert rows is None and ref.unsupported[-1] == reason
    with pytest.raises(DagUnsupported, match=reason):
        _port_dag(pair, sql)


def test_full_range_keys_overflow_the_sentinels(budget):
    """Keys over the full signed 64-bit range (ClickBench's UserIDs)
    reach past the raw-key sentinels: ``ok`` clears, the robust rerun
    clears it again, and both refuse: the reference's host executor
    answers there."""
    hits = smoke.make_hits(3000, 600, 3)
    pair = _pair1((smoke.CLICKBENCH_DDL,), tables={"hits": hits})
    _refusal(pair, smoke.CLICKBENCH_Q, "wgagg ranking overflow")
    assert pair[1].fused_executor()._dag.last_retries["robust"] == 1


@pytest.fixture(scope="module")
def text_keys():
    rng = np.random.default_rng(8)
    n = 4000
    return _pair1(
        ["create table tk (s text, a bigint, b bigint, w bigint) "
         "distribute by roundrobin"],
        [_values("tk", [[f"s{int(x)}" for x in rng.integers(0, 40, n)],
                        [int(x) for x in rng.integers(0, 30, n)],
                        [int(x) for x in rng.integers(0, 30, n)],
                        [int(x) for x in rng.integers(0, 9, n)]])])


@pytest.mark.parametrize("sql,reason", [
    ("select s, sum(w) from tk group by s order by 2 desc limit 5",
     "wgagg text group key"),
    ("select a, b, sum(w) from tk group by a, b order by 3 desc limit 5",
     "wgagg needs one bare group key"),
], ids=["text_key", "two_kept_keys"])
def test_unsupported_group_keys_refused(text_keys, budget, sql, reason):
    _refusal(text_keys, sql, reason)
    # the session then answers on the fragment program, as the
    # reference's does on its fused fragment
    rs, _port, ps = text_keys
    assert ps.query(sql) == _host_rows(rs, sql)

"""Semi and anti joins in the port's fused DAG against the reference:
``EXISTS``, ``NOT EXISTS``, ``IN (subquery)`` and ``NOT IN`` become
existence probes (the analyzer's semi/anti joins), over identical rows in
a reference ``Cluster(num_datanodes=2)`` and a port ``Cluster(...,
device="cpu")`` (the reference takes SQL, the stored rows carry over).

Every answer equals the reference session's, and the port's mode, folds
and join modes equal those of the reference's DAG runner on a one-device
mesh. The shapes are the reference's own (tests/test_fused_dag.py: the
semi and anti joins, NULL keys in an anti join, the EXISTS pull-up's
subplan bookkeeping), IN and NOT IN with NULLs in the set, and TPC-H Q4
with its NOT EXISTS complement at a small scale, against numpy too. The
probe never reaches the radix kernel (K2): it has no flag slot, so the
radix table answers inner joins only."""

import numpy as np
import pytest

from opentenbase_tpu.plan.analyze import analyze_statement as ref_analyze
from opentenbase_tpu.sql.parser import parse as ref_parse
from opentenbase_tpu_torch.ops import radix_probe as rp
from opentenbase_tpu_torch.plan import analyze_statement
from opentenbase_tpu_torch.sql import parse

from test_torch_dag_grouped import _pair, smoke
from test_torch_dag_topk import _mesh1, _sql_pair

SEED = 9


def _same(pair, sql, mode):
    """The port's answer against the reference session's and its
    one-device runner's, in ``mode``: the rows."""
    rs, port, ps = pair
    got = ps.query(sql)
    want = rs.query(sql)
    ref_rows, ref = _mesh1(rs, sql)
    assert got == want == ref_rows
    assert ps._fused_via_dag
    runner = port.fused_executor()._dag
    assert (runner.last_mode, runner.last_folded, runner.last_join_modes) \
        == (ref.last_mode, ref.last_folded, ref.last_join_modes)
    assert runner.last_mode == mode
    return got


@pytest.fixture(scope="module")
def tpch():
    """tests/test_fused_dag.py's tables (customer, orders, lineitem
    sharded by their keys, the same seeded rows), on 2 datanodes."""
    rng = np.random.default_rng(SEED)
    nc, no, nl = 200, 800, 3000
    ddl = [
        "create table customer (c_custkey bigint, c_mktsegment text) "
        "distribute by shard(c_custkey)",
        "create table orders (o_orderkey bigint, o_custkey bigint, "
        "o_orderdate date, o_shippriority int) "
        "distribute by shard(o_orderkey)",
        "create table lineitem (l_orderkey bigint, l_extendedprice "
        "numeric(12,2), l_discount numeric(4,2), l_shipdate date) "
        "distribute by shard(l_orderkey)",
    ]
    inserts = [
        "insert into customer values " + ",".join(
            f"({k},'{seg}')" for k, seg in zip(
                range(1, nc + 1),
                rng.choice(["BUILDING", "AUTOMOBILE", "MACHINERY"], nc))),
        "insert into orders values " + ",".join(
            f"({ok},{ck},'{d}',{pr})" for ok, ck, d, pr in zip(
                range(1, no + 1), rng.integers(1, nc + 1, no),
                np.datetime64("1994-06-01") + rng.integers(0, 600, no),
                rng.integers(0, 3, no))),
        "insert into lineitem values " + ",".join(
            f"({ok},{p:.2f},0.0{dd},'{d}')" for ok, p, dd, d in zip(
                rng.integers(1, no + 1, nl),
                rng.uniform(900, 90000, nl).round(2),
                rng.integers(0, 9, nl),
                np.datetime64("1994-06-01") + rng.integers(0, 700, nl))),
    ]
    return _sql_pair(ddl, inserts)


@pytest.mark.parametrize("sql", [
    "select count(*) from orders where o_orderkey in "
    "(select l_orderkey from lineitem where l_extendedprice > 50000)",
    "select count(*) from orders where not exists "
    "(select 1 from lineitem where l_orderkey = o_orderkey)",
], ids=["semi", "anti"])
def test_semi_and_anti_joins(tpch, sql):
    """tests/test_fused_dag.py:113: a scalar count over each probe."""
    got = _same(tpch, sql, "scalar")
    assert got[0][0] > 0


def test_grouped_over_a_semi_join(tpch):
    _same(tpch, "select o_shippriority, count(*) from orders where exists "
          "(select 1 from lineitem where l_orderkey = o_orderkey "
          "and l_discount > 0.05) group by o_shippriority "
          "order by o_shippriority", "grouped")


def test_semi_join_under_an_inner_join(tpch):
    """The probe's left side carries its columns into a join above it."""
    _same(tpch, "select c_mktsegment, count(*), sum(o_shippriority) "
          "from customer, orders where c_custkey = o_custkey and exists "
          "(select 1 from lineitem where l_orderkey = o_orderkey "
          "and l_shipdate > date '1995-06-01') "
          "group by c_mktsegment order by c_mktsegment", "grouped")


@pytest.fixture(scope="module")
def nulls():
    """tests/test_fused_dag.py:127's tables: NULL join keys on both
    sides."""
    return _sql_pair(
        ["create table nl (k bigint, v bigint) distribute by shard(v)",
         "create table nr (k bigint, w bigint) distribute by shard(w)"],
        ["insert into nl values (null, 1), (1, 2), (2, 3)",
         "insert into nr values (null, 10), (1, 20), (3, 30)"])


def test_null_keys_never_match_and_survive_the_anti_join(nulls):
    assert _same(nulls, "select sum(v + w) from nl, nr where nl.k = nr.k",
                 "scalar") == [(22,)]
    # an anti join keeps its NULL-key probe rows: NULL and k = 2
    assert _same(nulls, "select count(*) from nl where not exists "
                 "(select 1 from nr where nr.k = nl.k)", "scalar") == [(2,)]
    assert _same(nulls, "select count(*) from nl where exists "
                 "(select 1 from nr where nr.k = nl.k)", "scalar") == [(1,)]


@pytest.mark.parametrize("sql", [
    "select count(*), sum(v) from nl where k in (select k from nr)",
    # NULL in the set: held to the reference's anti join, whatever SQL's
    # three-valued NOT IN would answer
    "select count(*), sum(v) from nl where k not in (select k from nr)",
    "select count(*) from nl where k not in "
    "(select k from nr where w > 10)",
], ids=["in", "not_in_null_in_set", "not_in"])
def test_in_and_not_in(nulls, sql):
    _same(nulls, sql, "scalar")


@pytest.fixture(scope="module")
def o2l2():
    """tests/test_fused_dag.py:229's tables."""
    return _sql_pair(
        ["create table o2 (ok bigint) distribute by shard(ok)",
         "create table l2 (lk bigint, p bigint) distribute by shard(lk)"],
        ["insert into o2 values (1),(2)",
         "insert into l2 values (1, 5),(9, 1)"])


@pytest.mark.parametrize("sql,subplans", [
    # uncorrelated EXISTS (:229): the count rewrite's subplan and its
    # inner min, the abandoned pull-up trial rolled back
    ("select count(*) from o2 where exists "
     "(select 1 from l2 where p > (select min(p) from l2))", 2),
    # correlated EXISTS with an inner scalar subquery (:243): pulled up,
    # the inner subplan registered once
    ("select count(*) from o2 where exists "
     "(select 1 from l2 where lk = ok and p > (select min(p) from l2))", 1),
], ids=["uncorrelated", "correlated"])
def test_exists_pullup_subplans(o2l2, sql, subplans):
    """The analyzers register the same subplans; a plan with subplans
    (scalar subqueries) is the host executor's, in the reference and in
    the port, and both answer alike. The correlated query with the
    scalar subquery's value written in is the pull-up alone: a semi
    join, answered on the device."""
    rs, port, ps = o2l2
    ref_sp = ref_analyze(ref_parse(sql)[0], rs.cluster.catalog)
    sp = analyze_statement(parse(sql)[0], port.catalog)
    assert len(sp.subplans) == len(ref_sp.subplans) == subplans
    assert ps.query(sql) == rs.query(sql)
    assert ps.last_route == "host"
    assert _same(o2l2, "select count(*) from o2 where exists "
                 "(select 1 from l2 where lk = ok and p > 1)",
                 "scalar") == [(1,)]


@pytest.fixture(scope="module")
def q4_tables():
    tables = smoke.make_q3_spec(0.002, SEED)
    return tables, _pair(tables, smoke.Q3_SPEC_DDL)


@pytest.mark.parametrize("which", ["q4", "not_exists"])
def test_tpch_q4(q4_tables, monkeypatch, which):
    """TPC-H Q4 (a grouped count over a semi join) and its complement (a
    scalar count over an anti join), equal to numpy, the reference and
    its one-device runner's mode; the radix kernel is never asked."""
    tables, pair = q4_tables
    calls = []
    real = rp.radix_probe

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(rp, "radix_probe", counting)
    q4, anti = smoke.expected_q4(tables["orders"], tables["lineitem"])
    sql, want, mode = {"q4": (smoke.Q4, q4, "grouped"),
                       "not_exists": (smoke.Q4_ANTI, anti, "scalar")}[which]
    assert _same(pair, sql, mode) == want
    assert len(want) == (5 if which == "q4" else 1) and want[0][-1] > 0
    assert calls == []

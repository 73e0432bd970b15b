"""Join rows in the port's fused DAG against the reference: a final
fragment with no aggregate ships its rows (the ``rows`` mode, compacted
on the device to a row capacity that regrows), or ranks them on the
device and ships k (``rows_topk``) under ``ORDER BY ... LIMIT``; the
coordinator re-applies DISTINCT, ORDER BY and LIMIT over what arrives.

Identical rows live in a reference ``Cluster(num_datanodes=2)`` and a
port ``Cluster(..., device="cpu")``. Every answer equals the reference
session's, and the port's mode, folds and join modes equal those of the
reference's DAG runner on a one-device mesh, run fresh per query (the
port's runner is fresh too where the join modes are compared). Shapes:
tests/test_fused_dag.py:103 and :582, DISTINCT over join rows, NULL sort
keys both ways, OFFSET, k = 1024 against 1025, a ranking key whose
range passes 2^62 (every row shipped unranked, as the reference), the
row capacity's regrowth, repeated column names, and the bare scan the
DAG declines."""

import numpy as np
import pytest

from opentenbase_tpu.executor import fused_dag as ref_fd
from opentenbase_tpu_torch.executor import fused_dag
from opentenbase_tpu_torch.executor.fused_dag import DagUnsupported

from test_torch_dag_topk import _mesh1, _sql_pair
from test_torch_wgagg import _port_dag
from test_torch_semi_anti import tpch  # noqa: F401 (the module fixture)

SEED = 21


def _fresh(pair):
    """The pair with the port's runner state dropped (as a first query
    sees it), for join-mode comparisons against a fresh reference
    runner."""
    port = pair[1]
    port.fused_executor()._dag = None
    return pair


def _same(pair, sql, mode, fresh=True):
    """The port's rows against the reference session's and its fresh
    one-device runner's, in ``mode``; returns (rows, port runner,
    reference runner)."""
    rs, port, ps = _fresh(pair) if fresh else pair
    got = ps.query(sql)
    want = rs.query(sql)
    ref_rows, ref = _mesh1(rs, sql)
    if "order by" in sql:
        assert got == want == ref_rows
    else:  # no order: the rows as a multiset
        assert sorted(got, key=repr) == sorted(want, key=repr) \
            == sorted(ref_rows, key=repr)
    assert ps._fused_via_dag
    runner = port.fused_executor()._dag
    assert (runner.last_mode, runner.last_folded, runner.last_join_modes) \
        == (ref.last_mode, ref.last_folded, ref.last_join_modes)
    assert runner.last_mode == mode
    return got, runner, ref


def test_join_rows_without_aggregate(tpch):  # noqa: F811
    """tests/test_fused_dag.py:103 (the coordinator sorts)."""
    got, _r, _ref = _same(
        tpch, "select o_orderkey, l_extendedprice from orders, lineitem "
        "where o_orderkey = l_orderkey and l_extendedprice < 2000 "
        "order by o_orderkey, l_extendedprice", "rows")
    assert len(got) > 0


def test_rows_unordered_with_text_and_dates(tpch):  # noqa: F811
    _same(tpch, "select c_mktsegment, o_orderdate, o_orderkey "
          "from customer, orders where c_custkey = o_custkey "
          "and o_shippriority = 1", "rows")


def test_rows_topk_mode(tpch):  # noqa: F811
    """tests/test_fused_dag.py:582: seven rows ranked on the device."""
    got, _r, _ref = _same(
        tpch, "select o_orderkey, l_extendedprice from orders, lineitem "
        "where o_orderkey = l_orderkey "
        "order by l_extendedprice desc limit 7", "rows_topk")
    assert len(got) == 7


@pytest.mark.parametrize("sql", [
    "select distinct o_shippriority from orders, lineitem "
    "where o_orderkey = l_orderkey and l_discount > 0.05",
    "select distinct c_mktsegment, o_shippriority from customer, orders "
    "where c_custkey = o_custkey order by c_mktsegment, o_shippriority",
], ids=["one_column", "text_ordered"])
def test_distinct_over_join_rows(tpch, sql):  # noqa: F811
    """DISTINCT in the final fragment is stripped; the coordinator's
    Distinct applies it over the shipped rows."""
    got, _r, _ref = _same(tpch, sql, "rows")
    assert len(got) == len(set(got)) > 1


@pytest.fixture(scope="module")
def keyed():
    """f (k, s, w) with NULL and repeated sort keys, joined to a small
    dimension d (k, g); ``big`` spans more than 2^62."""
    rng = np.random.default_rng(SEED)
    n = 1500
    fk = rng.integers(0, 40, n)
    s = [None if x < 0 else int(x) for x in rng.integers(-40, 400, n)]
    big = [-(2**62) if i % 2 else 2**62 - 1 for i in range(n)]
    rows = ",".join(
        f"({int(k)}, {'null' if v is None else v}, {i}, {b})"
        for i, (k, v, b) in enumerate(zip(fk, s, big)))
    return _sql_pair(
        ["create table d (k bigint, g int) distribute by replication",
         "create table f (k bigint, s bigint, w int, big bigint) "
         "distribute by roundrobin"],
        ["insert into d values " + ",".join(
            f"({i}, {i % 7})" for i in range(0, 40, 2)),
         "insert into f values " + rows])


_KEYED = ("select f.w, f.s, d.g from f, d where f.k = d.k "
          "order by {order} limit {limit}")


@pytest.mark.parametrize("order,limit", [
    ("s, w", 10), ("s desc, w", 10), ("s nulls first, w", 12),
    ("s desc nulls last, w", 12), ("g, s desc, w", 25),
    ("s, w", "5 offset 7"), ("w desc", 1024), ("w", 1025),
], ids=["asc", "desc", "nulls_first", "desc_nulls_last", "three_keys",
        "offset", "k_at_the_cap", "k_past_the_cap"])
def test_rows_topk_orders(keyed, order, limit):
    """NULL sort keys at either end, OFFSET (k = limit + offset), and k
    = 1024 ranked against 1025 shipped unranked (rows)."""
    got, _r, _ref = _same(keyed, _KEYED.format(order=order, limit=limit),
                          "rows" if limit == 1025 else "rows_topk")
    assert len(got) > 0


def test_ranking_overflow_ships_every_row(keyed):
    """A ranking key spanning more than 2^62: the packed key overflows,
    both runners remember it and ship every row to the coordinator."""
    got, runner, ref = _same(
        keyed, "select f.w, f.big from f, d where f.k = d.k "
        "order by big, w limit 9", "rows")
    assert len(got) == 9
    assert len(runner._topk_off) == len(ref._topk_off) == 1


def test_row_capacity_regrows(keyed, monkeypatch):
    """More rows than the first capacity: the run regrows to their
    bucketed count and runs again, as the reference; the capacity that
    fit is remembered, so a repeat runs once."""
    monkeypatch.setattr(fused_dag, "OPTIMISTIC_GROUP_CAP", 64)
    monkeypatch.setattr(ref_fd, "OPTIMISTIC_GROUP_CAP", 64)
    sql = "select f.w, f.s from f, d where f.k = d.k"
    got, runner, ref = _same(keyed, sql, "rows")
    assert len(got) > 64
    assert list(runner._caps.values()) == list(ref._caps.values())
    runs = []
    real = runner._compile_rows

    def counting(*a, **kw):
        runs.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(runner, "_compile_rows", counting)
    assert sorted(keyed[2].query(sql)) == sorted(got)
    assert runs == []  # the remembered capacity's program, cached


@pytest.mark.parametrize("sql", [
    "select a.k, b.k, v, w from a, b where a.k = b.k order by v",
    "select a.k, b.k from a, b where a.k = b.k order by a.k, b.k limit 3",
], ids=["rows", "rows_topk"])
def test_repeated_column_names_keep_their_columns(sql):
    """Join rows whose schema names a column twice (``a.k, b.k``): the
    port ships every column, and answers as the reference's host
    executor does. The reference's fused path keeps one column per name
    (three columns for the first query, an IndexError for the second)."""
    rs, _port, ps = _sql_pair(
        ["create table a (k bigint, v int) distribute by roundrobin",
         "create table b (k bigint, w int) distribute by replication"],
        ["insert into a values (1, 10), (2, 20), (3, 30), (1, 11)",
         "insert into b values (1, 100), (2, 200)"])
    rs.execute("set enable_fused_execution = off")
    want = rs.query(sql)
    assert ps.query(sql) == want
    assert len(want[0]) == (4 if "v, w" in sql else 2)


def test_bare_scan_declines_where_join_rows_answer():
    """A bare scan chain is the host executor's in the reference (its
    one-device runner declines with "trivial scan"); the port's DAG
    declines with the same reason and its session answers through the
    host executor, as the reference's. The same table's rows through a
    join answer in rows mode."""
    rs, port, ps = _sql_pair(
        ["create table t (a int, b int) distribute by roundrobin",
         "create table u (b int, c int) distribute by replication"],
        ["insert into t values (1, 2), (3, 4), (5, 4)",
         "insert into u values (4, 7)"])
    sql = "select a from t where b > 2"
    rows, ref = _mesh1(rs, sql)
    assert rows is None and ref.unsupported[-1] == "trivial scan"
    with pytest.raises(DagUnsupported, match="trivial scan"):
        _port_dag((rs, port, ps), sql)
    assert sorted(ps.query(sql)) == sorted(rs.query(sql)) == [(3,), (5,)]
    assert ps.last_route == "host"
    got, _r, _ref = _same((rs, port, ps), "select a, c from t, u "
                          "where t.b = u.b order by a", "rows")
    assert got == [(3, 7), (5, 7)]

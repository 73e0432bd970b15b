"""Window functions on the port's host executor against the reference
session, on tests/test_window.py's shapes: the same DDL and rows in a
reference ``Cluster`` and a port ``Cluster(device="cpu")`` of two
datanodes, each query's rows compared exactly (``rel 1e-6`` for a float
average): row_number, rank, dense_rank, whole-partition and running
aggregates (peers share the frame end), min/max running, lag/lead with
offsets, TEXT arguments and keys by collation, NULL partition and order
keys, ROWS frames, the desugared DISTINCT ON, and the analyzer's
refusals (raised by both packages)."""

import math

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster

SETUP = [
    "create table emp (id bigint, dept text, sal bigint) "
    "distribute by shard(id)",
    "insert into emp values (1,'eng',100),(2,'eng',200),(3,'eng',200),"
    "(4,'eng',300),(5,'ops',50),(6,'ops',70),(7,'sales',90)",
    "create table w1 (p bigint, o bigint, x bigint) distribute by shard(p)",
    "insert into w1 values (1,1,-5),(2,1,3),(2,2,-10),(2,3,4)",
    "create table w2 (k bigint, price decimal(10,2)) distribute by shard(k)",
    "insert into w2 values (1,1.50),(2,2.50)",
    "create table w3 (k bigint, nm text) distribute by shard(k)",
    "insert into w3 values (1,'zeta'),(2,'alpha'),(3,'mid')",
    "create table w4 (k bigint, g bigint, x bigint) distribute by shard(k)",
    "insert into w4 values (1,0,10),(2,null,20),(3,0,30),(4,null,40)",
    "create table t (k bigint, g bigint, v bigint) distribute by roundrobin",
    "insert into t values (1,0,10),(2,0,20),(3,0,30),(4,1,5),(5,1,7),"
    "(6,1,null)",
]

QUERIES = {
    "row_number": "select id, row_number() over (partition by dept order "
                  "by sal, id) from emp order by id",
    "rank_dense_rank": "select id, rank() over (partition by dept order by "
                       "sal), dense_rank() over (partition by dept order by "
                       "sal) from emp order by id",
    "partition_whole": "select id, sum(sal) over (partition by dept), "
                       "count(*) over (partition by dept), avg(sal) over "
                       "(partition by dept) from emp order by id",
    "running_sum_peers": "select id, sum(sal) over (partition by dept order "
                         "by sal) from emp order by id",
    "global_no_partition": "select id, sum(sal) over (), row_number() over "
                           "(order by id) from emp order by id",
    "min_max_running": "select id, min(sal) over (partition by dept order "
                       "by id), max(sal) over (partition by dept order by "
                       "id) from emp order by id",
    "lag_lead": "select id, lag(sal) over (partition by dept order by id), "
                "lead(sal) over (partition by dept order by id) from emp "
                "order by id",
    "lag_2": "select id, lag(sal, 2) over (order by id) from emp order by id",
    "text_arg": "select id, lag(dept) over (order by id) from emp "
                "where id <= 5 order by id",
    "where_and_mixed_items": "select dept, sal * 2, rank() over (order by "
                             "sal desc) from emp where dept = 'eng' "
                             "order by sal desc, id",
    "running_sum_negative": "select p, o, sum(x) over (partition by p "
                            "order by o) from w1 order by p, o",
    "avg_decimal_unscaled": "select avg(price) over () from w2",
    "order_by_text_collation": "select nm, row_number() over (order by nm) "
                               "from w3 order by k",
    "min_max_text": "select min(nm) over (), max(nm) over () from w3",
    "null_partition_keys": "select k, count(*) over (partition by g) from "
                           "w4 order by k",
    "null_order_keys": "select k, row_number() over (order by g, k) from w4 "
                       "order by k",
    "rows_sum": "select k, sum(v) over (partition by g order by k rows "
                "between 1 preceding and current row) from t order by k",
    "rows_min": "select k, min(v) over (partition by g order by k rows "
                "between 1 preceding and 1 following) from t order by k",
    "rows_max_unbounded": "select k, max(v) over (partition by g order by k "
                          "rows between current row and unbounded "
                          "following) from t order by k",
    "rows_count_shorthand": "select k, count(v) over (order by k rows 2 "
                            "preceding) from t order by k",
    "rows_avg": "select k, avg(v) over (partition by g order by k rows "
                "between 1 preceding and current row) from t order by k",
    "distinct_on": "select distinct on (dept) dept, sal from emp "
                   "order by dept, sal",
    "distinct_on_desc": "select distinct on (dept) dept, id, sal from emp "
                        "order by dept, sal desc, id",
    "rank_limit": "select id, sal, rank() over (partition by dept order by "
                  "sal desc) as r from emp order by r, id limit 4",
}

REFUSED = {
    "rank_without_order": "select rank() over () from emp",
    "window_in_expression": "select 1 + row_number() over () from emp",
    "sum_over_text": "select sum(dept) over () from emp",
    "range_frame": "select sum(v) over (order by k range between 1 "
                   "preceding and current row) from t",
}


@pytest.fixture(scope="module")
def sessions():
    rs = RefCluster(num_datanodes=2, shard_groups=16).session()
    ps = Cluster(num_datanodes=2, shard_groups=16, device="cpu").session()
    for sql in SETUP:
        rs.execute(sql)
        ps.execute(sql)
    return rs, ps


def _same(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-6), (got, want)
            else:
                assert a == b, (got, want)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_window_matches_reference(sessions, name):
    rs, ps = sessions
    want = rs.query(QUERIES[name])
    _same(ps.query(QUERIES[name]), want)
    assert ps.last_route == "host"
    assert want


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_window_refusals_match_reference(sessions, name):
    rs, ps = sessions
    with pytest.raises(Exception) as want:
        rs.query(REFUSED[name])
    with pytest.raises(Exception) as got:
        ps.query(REFUSED[name])
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_each_customers_three_largest_orders():
    """chip_smoke's phase-10 window shape at a small size: rank() over
    each customer's orders by price, the top three kept, ties kept."""
    rs = RefCluster(num_datanodes=2, shard_groups=16).session()
    ps = Cluster(num_datanodes=2, shard_groups=16, device="cpu").session()
    rows = ",".join(f"({i}, {i % 17}, {(i * 7919) % 500}.{i % 100:02d})"
                    for i in range(1, 400))
    for s in (rs, ps):
        s.execute("create table o (o_orderkey bigint, o_custkey bigint, "
                  "o_totalprice numeric(12,2)) distribute by shard(o_orderkey)")
        s.execute(f"insert into o values {rows}")
    sql = ("select o_custkey, o_orderkey, o_totalprice, r from (select "
           "o_custkey, o_orderkey, o_totalprice, rank() over (partition by "
           "o_custkey order by o_totalprice desc) as r from o) x "
           "where r <= 3 order by o_custkey, r, o_orderkey limit 40")
    want = rs.query(sql)
    assert ps.query(sql) == want and len(want) == 40

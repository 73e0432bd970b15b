"""The port's host executor (executor/local.py) against the reference's
LocalExecutor, on tests/test_executor_local.py's shapes: the same tables
in a one-datanode catalog of each package, each SQL statement analyzed
by each package's planner and executed over its stores (subplans
first), and the rows compared — exactly for integers, decimals, text
and NULLs, ``rel 1e-6`` for a float average. Then the same file's
session-level shapes: FULL OUTER JOIN across shards and against a
replicated side, min/max over TEXT by collation (1 and 2 datanodes,
fused on and off), and the shapes the port still refuses by name
(extract and the other scalar functions, ``||``, RETURNING,
``UPDATE ... FROM`` / ``DELETE ... USING``)."""

import math

import pytest

from opentenbase_tpu import types as rt
from opentenbase_tpu.catalog.catalog import Catalog as RefCatalog
from opentenbase_tpu.catalog.distribution import (
    DistributionSpec as RefDist,
)
from opentenbase_tpu.catalog.distribution import DistStrategy as RefStrat
from opentenbase_tpu.catalog.nodes import NodeDef as RefNodeDef
from opentenbase_tpu.catalog.nodes import NodeManager as RefNodes
from opentenbase_tpu.catalog.nodes import NodeRole as RefRole
from opentenbase_tpu.catalog.shardmap import ShardMap as RefShardMap
from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.executor.local import LocalExecutor as RefLocal
from opentenbase_tpu.plan import analyze_statement as ref_analyze
from opentenbase_tpu.plan.optimize import prune_columns as ref_prune
from opentenbase_tpu.sql import parse_one as ref_parse
from opentenbase_tpu.storage.table import ColumnBatch as RefBatch
from opentenbase_tpu.storage.table import ShardStore as RefStore
from opentenbase_tpu_torch import Cluster, NotPorted
from opentenbase_tpu_torch import types as pt
from opentenbase_tpu_torch.catalog.catalog import Catalog
from opentenbase_tpu_torch.catalog.distribution import (
    DistributionSpec,
    DistStrategy,
)
from opentenbase_tpu_torch.catalog.nodes import NodeDef, NodeManager, NodeRole
from opentenbase_tpu_torch.catalog.shardmap import ShardMap
from opentenbase_tpu_torch.executor.local import LocalExecutor
from opentenbase_tpu_torch.plan import analyze_statement
from opentenbase_tpu_torch.plan.optimize import prune_columns
from opentenbase_tpu_torch.sql import parse_one
from opentenbase_tpu_torch.storage.table import ColumnBatch, ShardStore


def _tables(T):
    return {
        "item": (
            {"id": T.INT8, "qty": T.decimal(12, 2), "price": T.decimal(12, 2),
             "flag": T.TEXT, "ship": T.DATE},
            [(1, 10.00, 5.50, "A", "2024-01-05"),
             (2, 3.25, 2.00, "B", "2024-02-10"),
             (3, 7.00, 1.25, "A", "2024-01-20"),
             (4, None, 9.99, "C", "2024-03-01"),
             (5, 2.50, None, "B", "2024-02-28"),
             (6, 4.00, 3.00, None, "2024-03-15")],
        ),
        "customer": (
            {"c_id": T.INT8, "c_name": T.TEXT, "c_nation": T.TEXT},
            [(1, "alice", "FR"), (2, "bob", "DE"), (3, "carol", "FR"),
             (4, "dave", None)],
        ),
        "orders": (
            {"o_id": T.INT8, "o_cust": T.INT8, "o_total": T.decimal(12, 2)},
            [(100, 1, 10.00), (101, 1, 20.00), (102, 2, 5.00),
             (103, 3, 7.50), (104, None, 1.00), (105, 9, 2.00)],
        ),
    }


def _db(T, NM, ND, NR, SM, Cat, Dist, Strat, Store, Batch):
    nm = NM()
    nm.create_node(ND("dn0", NR.DATANODE))
    sm = SM(64)
    sm.initialize(nm.datanode_indices())
    cat = Cat(nm, sm)
    stores = {}
    for name, (schema, rows) in _tables(T).items():
        meta = cat.create_table(name, schema, Dist(Strat.ROUNDROBIN))
        store = Store(meta.schema, meta.dictionaries)
        data = {c: [r[i] for r in rows] for i, c in enumerate(schema)}
        store.append_batch(
            Batch.from_pydict(data, meta.schema, meta.dictionaries),
            xmin_ts=1)
        stores[name] = store
    return cat, stores


@pytest.fixture(scope="module")
def dbs():
    ref = _db(rt, RefNodes, RefNodeDef, RefRole, RefShardMap, RefCatalog,
              RefDist, RefStrat, RefStore, RefBatch)
    port = _db(pt, NodeManager, NodeDef, NodeRole, ShardMap, Catalog,
               DistributionSpec, DistStrategy, ShardStore, ColumnBatch)
    return ref, port


def _run_both(dbs, sql):
    (rcat, rstores), (pcat, pstores) = dbs
    want = RefLocal(rcat, rstores).execute(
        ref_prune(ref_analyze(ref_parse(sql), rcat))).to_rows()
    got = LocalExecutor(pcat, stores=pstores, device="cpu").execute(
        prune_columns(analyze_statement(parse_one(sql), pcat))).to_rows()
    return got, want


def _same(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                assert math.isclose(a, b, rel_tol=1e-6), (got, want)
            else:
                assert a == b, (got, want)


# tests/test_executor_local.py's queries, by that file's test names
QUERIES = {
    "scan_all": "select id from item",
    "filter_arith": "select id, qty * price from item where qty * price > 8",
    "filter_nulls_excluded": "select id from item where qty > 0 and "
                             "price > 0",
    "is_null": "select id from item where qty is null",
    "is_not_null": "select id from item where flag is not null order by id",
    "text_equality": "select id from item where flag = 'A' order by id",
    "text_in": "select id from item where flag in ('A','C') order by id",
    "like": "select c_id from customer where c_name like '%a%' order by c_id",
    "date_compare": "select id from item where ship >= date '2024-02-01' "
                    "order by id",
    "scalar_aggs": "select count(*), count(qty), sum(qty), min(price), "
                   "max(price), avg(price) from item",
    "group_by": "select flag, count(*), sum(qty) from item group by flag "
                "order by flag",
    "group_by_having": "select flag, count(*) from item group by flag "
                       "having count(*) > 1 order by flag",
    "order_by_desc_limit": "select id, price from item order by price desc "
                           "limit 2",
    "order_by_desc_limit_not_null": "select id, price from item where price "
                                    "is not null order by price desc limit 2",
    "order_by_nulls": "select id from item order by price",
    "order_by_nulls_desc": "select id from item order by price desc",
    "limit_offset": "select id from item order by id limit 2 offset 3",
    "inner_join": "select c_name, o_total from customer join orders on "
                  "c_id = o_cust order by c_name, o_total",
    "left_join": "select c_name, o_id from customer left join orders on "
                 "c_id = o_cust order by c_name, o_id",
    "right_join": "select c_name, o_id from customer right join orders on "
                  "c_id = o_cust order by o_id",
    "join_group": "select c_nation, sum(o_total) from customer join orders "
                  "on c_id = o_cust group by c_nation order by c_nation",
    "semi_join_in_subquery": "select c_id from customer where c_id in "
                             "(select o_cust from orders) order by c_id",
    "anti_join_not_exists": "select c_id from customer where not exists "
                            "(select 1 from orders where o_cust = c_id) "
                            "order by c_id",
    "scalar_subquery": "select id from item where price > (select "
                       "avg(price) from item) order by id",
    "case_expr": "select id, case when qty > 5 then 'big' when qty > 3 then "
                 "'mid' else 'small' end from item order by id",
    "distinct": "select distinct c_nation from customer order by c_nation",
    "count_distinct": "select count(distinct c_nation) from customer",
    "grouped_count_distinct": "select flag, count(distinct qty) from item "
                              "group by flag order by flag",
    "union_all": "select c_id from customer union all select o_cust from "
                 "orders order by 1",
    "union_all_text": "select c_name from customer union all select flag "
                      "from item order by 1",
    "no_from": "select 1 + 2",
    "decimal_division": "select id, price / qty from item where id = 1",
    "coalesce": "select id, coalesce(qty, 0) from item order by id",
    "text_min_max": "select min(c_name), max(c_name) from customer",
    "full_join": "select c_id, o_id from customer full join orders on "
                 "c_id = o_cust order by 1 nulls last, 2",
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_local_executor_matches_reference(dbs, name):
    got, want = _run_both(dbs, QUERIES[name])
    if "order by" in QUERIES[name] or len(want) <= 1:
        _same(got, want)
    else:
        _same(sorted(got, key=repr), sorted(want, key=repr))
    assert want or name == "is_null"


@pytest.mark.parametrize("mode", ["radix", "sortmerge"])
def test_join_modes_agree(dbs, mode, monkeypatch):
    """The radix table and the encode + sort-merge answer alike, and the
    executor names which answered."""
    monkeypatch.setenv("OTB_JOIN_MODE", mode)
    sql = QUERIES["left_join"]
    got, want = _run_both(dbs, sql)
    _same(got, want)
    _pcat, pstores = dbs[1]
    ex = LocalExecutor(dbs[1][0], stores=pstores, device="cpu")
    ex.execute(prune_columns(analyze_statement(parse_one(sql), dbs[1][0])))
    assert ex.last_join_mode == ("radix" if mode == "radix" else "merge")
    assert ex.join_modes == (["radix"] if mode == "radix"
                             else ["merge(OTB_JOIN_MODE)"])


def _radix_plan(passes):
    def plan(build_rows, probe_rows, budget, **kw):
        from opentenbase_tpu_torch.plan.batchplan import RadixPlan
        return None if passes is None else RadixPlan(1, 128, passes, 0)
    return plan


def _overflowing(real):
    def counts(*a, **k):
        import torch
        bo, lo, cnt, tot, _ovf = real(*a, **k)
        return bo, lo, cnt, tot, torch.tensor(True)
    return counts


@pytest.mark.parametrize("case", ["keys", "full", "passes", "no_plan",
                                  "overflow"])
def test_join_modes_name_the_radix_decline(dbs, case, monkeypatch):
    """A join the radix table declines answers by the encode + sort-merge
    as the reference's does, and ``join_modes`` records why: several
    keys, a FULL join, a plan of more than one pass, no plan within the
    budget, a bucket that overflowed at 4x its size."""
    from opentenbase_tpu_torch.ops import join as join_ops
    from opentenbase_tpu_torch.plan import batchplan

    sql = ("select c_name, o_id from customer full join orders on "
           "c_id = o_cust" if case == "full" else
           "select c_name, o_id from customer join orders on c_id = o_cust"
           " and c_id = o_cust - 0" if case == "keys" else QUERIES["left_join"])
    want = {"keys": "merge(keys=2)", "full": "merge(full join)",
            "passes": "merge(passes=2)", "no_plan": "merge(no plan)",
            "overflow": "merge(overflow)"}[case]
    if case in ("passes", "no_plan"):
        monkeypatch.setattr(batchplan, "plan_radix_join",
                            _radix_plan(2 if case == "passes" else None))
    if case == "overflow":
        monkeypatch.setattr(join_ops, "radix_match_counts",
                            _overflowing(join_ops.radix_match_counts))
    got, ref = _run_both(dbs, sql)
    _same(sorted(got, key=repr), sorted(ref, key=repr))
    pcat, pstores = dbs[1]
    ex = LocalExecutor(pcat, stores=pstores, device="cpu")
    ex.execute(prune_columns(analyze_statement(parse_one(sql), pcat)))
    assert ex.join_modes == [want] and ex.last_join_mode == "merge"


def test_more_than_one_row_from_a_scalar_subquery(dbs):
    sql = "select id from item where price > (select price from item)"
    with pytest.raises(RuntimeError, match="more than one row"):
        _run_both(dbs, sql)


def _sessions(ndn):
    return (RefCluster(num_datanodes=ndn, shard_groups=16).session(),
            Cluster(num_datanodes=ndn, shard_groups=16,
                    device="cpu").session())


def _both(rs, ps, sql):
    want = rs.query(sql)
    assert ps.query(sql) == want, sql
    return want


def test_full_outer_join():
    """tests/test_executor_local.py's FULL OUTER JOIN across shards, with
    a replicated side, duplicate keys and NULL join keys."""
    rs, ps = _sessions(2)
    for s in (rs, ps):
        s.execute("create table fa (k bigint, x text) distribute by shard(k)")
        s.execute("create table fb (k bigint, y bigint) "
                  "distribute by shard(k)")
        s.execute("insert into fa values (1,'a1'), (2,'a2'), (3,'a3'), "
                  "(null,'an')")
        s.execute("insert into fb values (2,20), (3,30), (3,31), (4,40)")
        s.execute("create table fr (k bigint, z bigint) "
                  "distribute by replication")
        s.execute("insert into fr values (3, 300), (9, 900)")
        s.execute("create table fc (u bigint, v bigint) "
                  "distribute by shard(u)")
        s.execute("insert into fc values (10, 2), (11, 7)")
    for fused in ("on", "off"):
        ps.execute(f"set enable_fused_execution = {fused}")
        assert _both(rs, ps, "select fa.k, fa.x, fb.k, fb.y from fa full "
                     "join fb on fa.k = fb.k order by 1 nulls last, "
                     "4 nulls first")[-1] == (None, None, 4, 40)
        assert _both(rs, ps, "select count(*) from fa full join fb "
                     "on fa.k = fb.k") == [(6,)]
        _both(rs, ps, "select fa.k, fr.k, fr.z from fa full join fr on "
              "fa.k = fr.k order by 1 nulls last, 2 nulls last")
        _both(rs, ps, "select fa.k, fc.u from fa full join fc on "
              "fa.k = fc.v order by 1 nulls last, 2 nulls last")
        _both(rs, ps, "select fa.k, count(*) from fa full join fb on "
              "fa.k = fb.k group by fa.k order by 1 nulls last")
        assert ps.last_route == "host"


@pytest.mark.parametrize("ndn", [1, 2])
def test_text_min_max_collation_order(ndn):
    rs, ps = _sessions(ndn)
    for s in (rs, ps):
        s.execute("create table u (k bigint, g bigint, nm text) "
                  "distribute by shard(k)")
        s.execute("insert into u values (1,0,'z'),(2,1,'a'),(3,0,'m'),"
                  "(4,1,'b'),(5,0,null)")
    for fused in ("off", "on"):
        for s in (rs, ps):
            s.execute(f"set enable_fused_execution = {fused}")
        assert _both(rs, ps, "select min(nm), max(nm) from u") == [("a", "z")]
        assert _both(rs, ps, "select g, min(nm), max(nm) from u group by g "
                     "order by g") == [(0, "m", "z"), (1, "a", "b")]


@pytest.mark.parametrize("sql,shape", [
    # once refused; answered now, as the reference answers them (the
    # cases keep their earlier names)
    pytest.param("select extract(year from ship), count(*) from item "
                 "group by extract(year from ship)", [(2024, 1)],
                 id="extract_year"),
    pytest.param("select nm || '!' from cc", [("ada!",)], id="concat"),
    # the same, since the DML slice (the returned rows; u2 is empty, so
    # the joins change nothing: tests/test_torch_dml_from.py holds them)
    pytest.param("insert into cc values (9, 'x', 1) returning k",
                 [(9,)], id="insert_returning"),
    pytest.param("update cc set v = 1 returning k", [(1,)],
                 id="update_returning"),
    pytest.param("update cc set v = u2.w from u2 where cc.k = u2.k",
                 [], id="update_from"),
    pytest.param("delete from cc using u2 where cc.k = u2.k",
                 [], id="delete_using"),
])
def test_still_refused_by_name(sql, shape):
    ps = Cluster(num_datanodes=2, shard_groups=16, device="cpu").session()
    ps.execute("create table item (id bigint, ship date) "
               "distribute by shard(id)")
    ps.execute("create table cc (k bigint, nm text, v bigint) "
               "distribute by shard(k)")
    ps.execute("create table u2 (k bigint, w bigint) distribute by shard(k)")
    ps.execute("insert into item values (1, '2024-01-05')")
    ps.execute("insert into cc values (1, 'ada', 10)")
    for fused in ("on", "off"):
        ps.execute(f"set enable_fused_execution = {fused}")
        if isinstance(shape, list):
            assert ps.query(sql) == shape
            continue
        with pytest.raises(NotPorted, match=shape):
            ps.execute(sql)


def test_set_takes_only_enable_fused_execution():
    ps = Cluster(num_datanodes=1, device="cpu").session()
    ps.execute("set enable_fused_execution = off")
    assert ps.gucs["enable_fused_execution"] is False
    ps.execute("reset enable_fused_execution")
    assert ps.gucs["enable_fused_execution"] is True  # back to its default
    with pytest.raises(NotPorted, match="SET trace_queries"):
        ps.execute("set trace_queries = on")

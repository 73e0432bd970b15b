"""The port's fused DAG in its device top-k modes against the reference:
``ORDER BY ... LIMIT k`` plans the reference ranks on the device and
ships k rows for (gagg, gsort, grouped_topk), over identical seeded rows
in a reference ``Cluster(num_datanodes=2)`` and a port
``Cluster(..., device="cpu")`` loaded through ``carry.load_table``.

Every case holds the port's ``Session.query`` tuples equal to the
reference session's, and the port's final-fragment mode, folded joins
and join-mode notes equal to those of the reference's DAG runner on a
one-device mesh (the suite's reference runs on 8 virtual devices, where
groups are not whole on one device and its modes differ). Exact
equality throughout: the results are integers and scaled decimals.

The cases mirror the reference's own (tests/test_fused_dag.py and
tests/test_dimfold.py): TPC-H Q3 through gsort (the spec's sparse order
keys, and dense keys with folds pinned off) and through gagg over two
chain folds (bench.py's dense keys); gagg with no join (ClickBench's
shape, its full-range UserIDs too) and ORDER BY a group key decoded out
of the packing; count(*) via gsort and the gagg fold; min/max with
negative values and ORDER BY min; the retry ladder (narrow -> wide ->
robust -> unranked); a join residual, also where every row of a group
fails it; grouped_topk on a FLOAT8 key; ties at the k-th row; NULL sort
keys; OFFSET; k = 1024 against 1025; wgagg past the window budget, and
gseg. Also the ranking helpers against the
reference's jnp functions on the same arrays."""

import numpy as np
import pytest

import jax.numpy as jnp
from opentenbase_tpu.executor import fused_dag as ref_fd
from opentenbase_tpu_torch.executor import fused_dag

from test_torch_dag_grouped import _carry, _pair, smoke

import jax
import torch
from opentenbase_tpu.executor.fused import FusedExecutor as RefFused
from opentenbase_tpu.executor.local import LocalExecutor as RefLocal
from opentenbase_tpu.plan.analyze import analyze_statement
from opentenbase_tpu.plan.distribute import distribute_statement
from opentenbase_tpu.plan.optimize import optimize_statement
from opentenbase_tpu.sql.parser import parse
from opentenbase_tpu_torch import Cluster

SEED = 7


def _mesh1(rs, sql):
    """The reference's DAG runner on a one-device mesh, fresh (as on a
    first query): (rows, runner)."""
    c = rs.cluster
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:1]), ("dn",))
    runner = ref_fd.DagRunner(RefFused(c.catalog, c.stores, mesh=mesh1))
    dp = distribute_statement(
        optimize_statement(analyze_statement(parse(sql)[0], c.catalog),
                           c.catalog),
        c.catalog,
    )
    snap = c.gts.snapshot_ts()
    res = runner.run(dp, snap, rs._dicts_view(), [])
    if res is None:
        return None, runner
    idx, batch = res
    rows = RefLocal(c.catalog, {}, snap, remote_inputs={idx: batch},
                    subquery_values=[]).run_plan(dp.root).to_rows()
    return rows, runner


def _both(pair, sql, mode, monkeypatch=None, no_folds=False):
    """The port's answer and runner state against the reference session's
    answer and its one-device runner's; ``mode`` is the mode both must
    take. Returns (rows, port runner, reference runner)."""
    rs, port, ps = pair
    if no_folds:
        monkeypatch.setattr(fused_dag, "DIMFOLD_MAX_BUILD", 0)
        monkeypatch.setattr(ref_fd, "DIMFOLD_MAX_BUILD", 0)
    got = ps.query(sql)
    runner = port.fused_executor()._dag
    ref_rows, ref_runner = _mesh1(rs, sql)
    want = rs.query(sql)
    assert got == want
    assert ref_rows == want
    assert ps._fused_via_dag
    assert (runner.last_mode, runner.last_folded, runner.last_join_modes) \
        == (ref_runner.last_mode, ref_runner.last_folded,
            ref_runner.last_join_modes)
    assert runner.last_mode == mode
    return got, runner, ref_runner


def _retries(pair, sql, mode, monkeypatch=None, no_folds=False):
    """``_both``, and which retry dicts gained a key for this query in
    the port's runner (shared by the module's cases) and hold one in the
    reference's (fresh): ({name: bool}, {name: bool})."""
    names = ("_narrow_off", "_robust_on", "_topk_off")
    dag = pair[1].fused_executor()._dag
    before = {k: set(getattr(dag, k)) if dag else set() for k in names}
    _g, runner, ref = _both(pair, sql, mode, monkeypatch, no_folds)
    return ({k: bool(set(getattr(runner, k)) - before[k]) for k in names},
            {k: bool(getattr(ref, k)) for k in names})


def _sql_pair(ddl, inserts):
    """A reference and a port cluster over the same rows: the reference
    takes ``inserts`` (SQL, so NULLs ride along), then every table's
    stored rows carry over to the port."""
    from opentenbase_tpu.engine import Cluster as RefCluster

    ref = RefCluster(num_datanodes=2, shard_groups=256)
    rs = ref.session()
    port = Cluster(num_datanodes=2, device="cpu")
    ps = port.session()
    for stmt in ddl:
        rs.execute(stmt)
        ps.execute(stmt)
    for stmt in inserts:
        rs.execute(stmt)
    for stmt in ddl:
        _carry(ref, port, stmt.split()[2])
    return rs, port, ps


def _values(table, cols):
    """An INSERT of numpy columns; None-valued entries are NULLs."""
    rows = []
    for vals in zip(*cols):
        rows.append("(" + ", ".join(
            "null" if v is None else (f"'{v}'" if isinstance(v, str)
                                      else repr(v)) for v in vals) + ")")
    return f"insert into {table} values " + ", ".join(rows)


# ---------------------------------------------------------------------------
# TPC-H Q3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def q3_spec():
    tables = smoke.make_q3_spec(0.001, SEED)
    return tables, _pair(tables, smoke.Q3_SPEC_DDL)


@pytest.fixture(scope="module")
def q3_dense():
    """bench.py's Q3 layout: lineitem (its generator) with dense order
    keys, orders and customer from make_q3_dims."""
    n = 2400
    li = smoke.make_lineitem(n, SEED)
    orders, customer = smoke.make_q3_dims(n, SEED + 1)
    tables = {"lineitem": li, "orders": orders, "customer": customer}
    ddl = (smoke.LINEITEM_DDL,) + smoke.Q3_DENSE_DDL
    return tables, _pair(tables, ddl)


def test_q3_spec_sparse_keys_gsort(q3_spec):
    """The spec's sparse order keys trip the dense fold's flag on the top
    join: the top join goes to the co-sort (customer still folds into
    orders), ten rows equal to numpy."""
    tables, pair = q3_spec
    got, runner, _ = _both(pair, smoke.Q3_SPEC, "gsort")
    assert runner.last_join_modes == ("fold",)
    assert len(runner.last_folded) == 1
    assert got == smoke.expected_q3(tables["lineitem"], tables["orders"],
                                    tables["customer"], "BUILDING")
    assert len(got) == 10


def test_q3_dense_chain_folds_into_gagg(q3_dense):
    """Dense keys: customer folds into orders and orders into lineitem,
    the grouping FD-reduces to l_orderkey, and one gagg sort answers."""
    tables, pair = q3_dense
    got, runner, _ = _both(pair, smoke.Q3_DENSE, "gagg")
    assert len(runner.last_folded) == 2
    assert got == smoke.expected_q3(tables["lineitem"], tables["orders"],
                                    tables["customer"], 0)
    assert len(got) == 10


def test_q3_dense_gsort_with_folds_off(q3_dense, monkeypatch):
    tables, pair = q3_dense
    got, _r, _ = _both(pair, smoke.Q3_DENSE, "gsort", monkeypatch,
                       no_folds=True)
    assert got == smoke.expected_q3(tables["lineitem"], tables["orders"],
                                    tables["customer"], 0)


_OL = ("select o_orderkey, count(*), sum(l_extendedprice), o_orderdate "
       "from orders, lineitem where o_orderkey = l_orderkey "
       "group by o_orderkey, o_orderdate order by 2 desc, o_orderkey "
       "limit 6")


def test_count_star_via_gsort_and_gagg_fold(q3_dense, monkeypatch):
    _t, pair = q3_dense
    _both(pair, _OL, "gagg")
    _both(pair, _OL, "gsort", monkeypatch, no_folds=True)


@pytest.mark.parametrize("sql", [
    "select o_orderkey, min(l_extendedprice), max(l_extendedprice), "
    "sum(l_extendedprice), o_orderdate from orders, lineitem "
    "where o_orderkey = l_orderkey group by o_orderkey, o_orderdate "
    "order by 4 desc, o_orderkey limit 8",
    "select o_orderkey, min(l_shipdate) from orders, lineitem "
    "where o_orderkey = l_orderkey group by o_orderkey "
    "order by 2, o_orderkey limit 6",
], ids=["min_max", "order_by_min"])
def test_gsort_min_max(q3_dense, monkeypatch, sql):
    _t, pair = q3_dense
    _both(pair, sql, "gsort", monkeypatch, no_folds=True)
    monkeypatch.undo()
    _both(pair, sql, "gagg")


def test_gsort_residual(q3_dense, monkeypatch):
    """A join residual over both sides rides the co-sort."""
    _t, pair = q3_dense
    sql = ("select o_orderkey, count(*), sum(l_extendedprice), "
           "min(l_extendedprice), o_orderdate "
           "from orders join lineitem on o_orderkey = l_orderkey "
           "and l_shipdate > o_orderdate "
           "group by o_orderkey, o_orderdate "
           "order by 3 desc, o_orderkey limit 8")
    _both(pair, sql, "gsort", monkeypatch, no_folds=True)


# ---------------------------------------------------------------------------
# joins of small hand-made tables: residual, negatives, narrow, gseg
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_joins():
    big = 2**40
    ddl = [
        "create table rk (k bigint, cutoff bigint) distribute by shard(k)",
        "create table rv (g bigint, v bigint) distribute by shard(g)",
        "create table negd (g bigint, v bigint) distribute by shard(g)",
        "create table negk (k bigint, tag int) distribute by shard(k)",
        "create table wk (k bigint, pr int) distribute by shard(k)",
        "create table wl (lk bigint, amt bigint) distribute by shard(lk)",
        "create table ordf (of_key bigint, of_f float8, of_p int) "
        "distribute by roundrobin",
        "create table linf (lf_key bigint, lf_v bigint) "
        "distribute by roundrobin",
    ]
    rng = np.random.default_rng(SEED + 2)
    inserts = [
        "insert into rk values (1, 100), (2, 0), (3, 50)",
        "insert into rv values (1, 10), (1, 20), (2, 1), (2, 2), (3, 60), "
        "(3, 40)",
        "insert into negd values (1, -5), (1, 10), (2, -7), (2, -9), "
        "(3, 4), (3, 0), (3, -1)",
        "insert into negk values (1, 0), (2, 1), (3, 0)",
        "insert into wk values " + ",".join(
            f"({big + i}, {i % 3})" for i in range(50)),
        "insert into wl values " + ",".join(
            f"({big + (i % 50)}, {i})" for i in range(400)),
        _values("ordf", [list(range(1, 41)),
                         [float(x) for x in rng.integers(0, 5, 40) * 0.5],
                         [int(x) for x in rng.integers(0, 9, 40)]]),
        _values("linf", [[int(x) for x in rng.integers(1, 41, 300)],
                         [int(x) for x in rng.integers(1, 100, 300)]]),
    ]
    return _sql_pair(ddl, inserts)


def test_gsort_residual_all_fail_group_vanishes(small_joins, monkeypatch):
    """A group whose every probe row fails the residual emits nothing."""
    sql = ("select rk.k, count(*), sum(rv.v) from rk "
           "join rv on rk.k = rv.g and rv.v > rk.cutoff "
           "group by rk.k order by rk.k limit 5")
    got, _r, _ = _both(small_joins, sql, "gsort", monkeypatch,
                       no_folds=True)
    assert got == [(2, 2, 3), (3, 1, 60)]


def test_gsort_min_max_negative_values(small_joins, monkeypatch):
    sql = ("select negk.k, min(negd.v), max(negd.v) from negk, negd "
           "where negk.k = negd.g group by negk.k order by negk.k limit 3")
    got, _r, _ = _both(small_joins, sql, "gsort", monkeypatch,
                       no_folds=True)
    assert got == [(1, -5, 10), (2, -9, -7), (3, -1, 4)]


def test_gsort_negative_sums_ship_unranked(small_joins, monkeypatch):
    """gsort has no robust program: negative sums clear ``ok`` on the
    narrow and the wide run, and the plan ships every group unranked."""
    sql = ("select negd.g, sum(negd.v) from negk, negd "
           "where negk.k = negd.g group by negd.g order by 2 desc limit 2")
    port, ref = _retries(small_joins, sql, "grouped", monkeypatch,
                         no_folds=True)
    assert port == ref == {"_narrow_off": True, "_robust_on": False,
                           "_topk_off": True}
    assert small_joins[2].query(sql) == [(1, 5), (3, 3)]


def test_gsort_narrow_overflow_retries_wide(small_joins, monkeypatch):
    """Keys past 2^29 trip the narrow program's flag; the wide program
    answers, still in gsort."""
    sql = ("select wl.lk, sum(wl.amt), wk.pr from wk, wl "
           "where wk.k = wl.lk group by wl.lk, wk.pr "
           "order by 2 desc limit 5")
    port, ref = _retries(small_joins, sql, "gsort", monkeypatch,
                         no_folds=True)
    assert port == ref == {"_narrow_off": True, "_robust_on": False,
                           "_topk_off": False}


def test_gseg_matches_reference(small_joins):
    """Grouped by the build key and a FLOAT8 build column (gagg does not
    apply) with an aggregate over the build side (gsort does not apply):
    the reference and the port run gseg, a segment reduction over the
    top join's build rows, ranked on the device."""
    got, _runner, _ref = _both(
        small_joins, "select of_key, of_f, sum(of_p), count(*), "
        "max(lf_key), min(lf_v), count(lf_v) from ordf, linf "
        "where of_key = lf_key "
        "group by of_key, of_f order by 3 desc, of_key limit 4", "gseg")
    assert len(got) == 4


# ---------------------------------------------------------------------------
# one table: gagg, grouped_topk, the retry ladder, ties, NULLs, OFFSET
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_table():
    rng = np.random.default_rng(SEED + 3)
    n = 600
    g = [None if x < 0 else int(x) for x in rng.integers(-3, 60, n)]
    k = [int(x) for x in rng.integers(0, 12, n)]
    # v: negative values, and NULL for every row of k = 11
    v = [None if kk == 11 or x < -400 else int(x)
         for kk, x in zip(k, rng.integers(-500, 500, n))]
    w = [int(x) for x in rng.integers(0, 1000, n)]
    f = [float(x) for x in rng.choice([-1.5, -0.0, 0.0, 2.25, 7.0], n)]
    # b: group k = 0 holds -2^62 only, the others 0 and 2^62 - 1, so
    # max(b) over the groups spreads over 2^63
    b = [-(2**62) if kk == 0 else int(x)
         for kk, x in zip(k, rng.choice([0, 2**62 - 1], n))]
    # ties: groups 0..9 with counts 5, 5, 5, 5, 4, 4, 3, ... (shuffled)
    counts = [5, 5, 5, 5, 4, 4, 3, 3, 2, 1]
    tg = [int(x) for x in rng.permutation(np.repeat(
        [90, 30, 70, 10, 50, 20, 80, 40, 60, 0], counts))]
    wide = [(i % 40) * 2**26 for i in range(400)]
    many = [int(x) for x in rng.integers(0, 1500, 3000)]
    ddl = [
        "create table t (g bigint, k int, v bigint, w bigint, f float8, "
        "b bigint) distribute by roundrobin",
        "create table ties (tg int) distribute by roundrobin",
        "create table wide (w_key bigint, w_val bigint) "
        "distribute by roundrobin",
        "create table many (u bigint) distribute by roundrobin",
    ]
    inserts = [
        _values("t", [g, k, v, w, f, b]),
        _values("ties", [tg]),
        _values("wide", [wide, list(range(400))]),
        _values("many", [many]),
    ]
    return _sql_pair(ddl, inserts)


def test_gagg_clickbench_shape(one_table):
    _both(one_table,
          "select g, count(*), sum(w) from t group by g "
          "order by 2 desc, 3 desc limit 8", "gagg")


def test_gagg_order_by_group_key_decodes_packing(one_table):
    """ORDER BY the (NULL-able) group key reads the key values decoded
    out of the sorted packed key."""
    got, _r, _ = _both(one_table, "select g, sum(w) from t group by g "
                       "order by g limit 8", "gagg")
    assert got[0][0] == 0


def test_gagg_min_max_negative(one_table):
    _both(one_table, "select k, min(v), max(v), count(*) from t "
          "group by k order by 2, k limit 5", "gagg")


def test_gagg_negative_sums_robust_retry(one_table):
    """Negative sums break the cumsum run base: narrow -> wide ->
    robust (segmented add scans), still ranked in gagg."""
    port, ref = _retries(one_table, "select k, sum(v) from t group by k "
                         "order by 2 desc limit 3", "gagg")
    assert port == ref == {"_narrow_off": True, "_robust_on": True,
                           "_topk_off": False}


def test_gagg_narrow_overflow_retries_wide(one_table):
    port, ref = _retries(one_table, "select w_key, sum(w_val) from wide "
                         "group by w_key order by 2 desc limit 5", "gagg")
    assert port == ref == {"_narrow_off": True, "_robust_on": False,
                           "_topk_off": False}


def test_ranking_range_overflow_ships_unranked(one_table):
    """An ORDER BY value spread of 2^63: every rung of the ladder fails,
    and the groups ship unranked in the grouped mode; a repeat goes
    there at once."""
    sql = "select k, max(b) from t group by k order by 2 desc, k limit 3"
    port_new, ref_has = _retries(one_table, sql, "grouped")
    assert port_new == ref_has == {"_narrow_off": True, "_robust_on": True,
                                   "_topk_off": True}
    rs, port, ps = one_table
    runner = port.fused_executor()._dag
    n_programs = len(runner._programs)
    assert ps.query(sql) == rs.query(sql)
    assert runner.last_mode == "grouped"
    assert len(runner._programs) == n_programs


def test_grouped_topk_float_key(one_table):
    """A FLOAT8 group key (-0.0 and 0.0 one group): gagg does not apply,
    the grouped mode ranks its groups."""
    got, _r, _ = _both(one_table, "select f, sum(w) from t group by f "
                       "order by 2 desc limit 3", "grouped_topk")
    assert len(got) == 3


@pytest.mark.parametrize("sql,mode", [
    ("select tg, count(*) from ties group by tg order by 2 desc limit 3",
     "gagg"),
    ("select tg, count(*) from ties group by tg order by 2 desc limit 5",
     "gagg"),
    ("select tg, count(*) from ties group by tg order by 2 limit 7",
     "gagg"),
], ids=["k3", "k5", "k7_asc"])
def test_ties_at_the_kth_row(one_table, sql, mode):
    """Equal counts across the k-th row: the device keeps the groups of
    the lowest packed keys (the lowest tg), in (count, tg) order."""
    got, _r, _ = _both(one_table, sql, mode)
    rows = {90: 5, 30: 5, 70: 5, 10: 5, 50: 4, 20: 4, 80: 3, 40: 3, 60: 2,
            0: 1}
    desc = "desc" in sql
    order = sorted(rows, key=lambda g: (-rows[g] if desc else rows[g], g))
    k = len(got)
    assert got == [(g, rows[g]) for g in order[:k]]


def test_ties_grouped_topk(one_table):
    """grouped_topk breaks ties by group position (the float key's
    group order)."""
    _both(one_table, "select f, count(*) from t group by f "
          "order by 2 desc limit 2", "grouped_topk")


@pytest.mark.parametrize("order", [
    "g", "g desc", "g nulls first", "g desc nulls last",
    "2", "2 desc", "2 nulls first", "2 desc nulls last",
])
def test_null_sort_keys(one_table, order):
    """NULL group keys (g) and NULL sums (every v of k = 11 is NULL)
    under ASC/DESC and explicit NULLS FIRST/LAST."""
    col = "g" if order[0] == "g" else "k"
    got, _r, _ = _both(one_table, f"select {col}, sum(v) from t "
                       f"group by {col} order by {order} limit 4", "gagg")
    assert any(None in row for row in got) == (
        "first" in order or order in ("g desc", "2 desc"))


def test_offset(one_table):
    got, _r, _ = _both(one_table, "select g, sum(w) from t group by g "
                       "order by 2 desc limit 3 offset 2", "gagg")
    assert len(got) == 3


@pytest.mark.parametrize("k,mode", [(1024, "gagg"), (1025, "grouped")])
def test_k_1024_ranked_1025_not(one_table, k, mode):
    got, _r, _ = _both(one_table, f"select u, count(*) from many group by u "
                       f"order by 2 desc, 1 limit {k}", mode)
    assert len(got) == min(k, 1500) and len(got) > 1000


def test_wgagg_not_ported(one_table, monkeypatch):
    """Past the window budget the reference streams the probe in windows
    (wgagg), and so does the port, with the reference's answer (the
    name dates from before the mode was ported; tests/test_torch_wgagg.py
    holds the mode in depth)."""
    monkeypatch.setenv("OTB_DAG_WINDOW_BUDGET", "100000")
    sql = "select u, count(*) from many group by u order by 2 desc limit 5"
    _got, runner, _ref = _both(one_table, sql, "wgagg")
    assert runner.last_windows[0] > 1


def test_clickbench_full_range_userids():
    """ClickBench's query over UserIDs drawn across the signed 64-bit
    range (make_hits at a small size): the packed key's range passes
    2^62, so every rung of gagg's ladder fails and the reference ships
    every group unranked in the grouped mode, with one sort per key
    part; the port takes the same route, equal to numpy."""
    hits = smoke.make_hits(3000, int(3000 * smoke.HITS_DISTINCT_SHARE),
                           SEED)
    pair = _pair({"hits": hits}, (smoke.CLICKBENCH_DDL,))
    got, runner, ref = _both(pair, smoke.CLICKBENCH_Q, "grouped")
    assert got == smoke.expected_clickbench(hits)
    for r in (runner, ref):
        assert r._narrow_off and r._robust_on and r._topk_off
        assert list(r._packing.values()) == [False]


# ---------------------------------------------------------------------------
# the ranking helpers against the reference's jnp functions
# ---------------------------------------------------------------------------


def _arrays(seed, n):
    rng = np.random.default_rng(seed)
    d = rng.integers(-50, 50, n).astype(np.int64)
    v = rng.random(n) > 0.2
    live = rng.random(n) > 0.3
    return d, v, live


@pytest.mark.parametrize("desc,nf", [(False, None), (True, None),
                                     (False, True), (True, False)])
@pytest.mark.parametrize("with_nulls", [False, True])
def test_rank_encode_matches_reference(desc, nf, with_nulls):
    d, v, live = _arrays(1, 500)
    vv = v if with_nulls else None
    want = ref_fd._rank_encode(
        jnp.asarray(d), None if vv is None else jnp.asarray(vv), desc, nf,
        jnp.asarray(live))
    got = fused_dag._rank_encode(
        torch.from_numpy(d), None if vv is None else torch.from_numpy(vv),
        desc, nf, torch.from_numpy(live))
    x_w, r_w, rf_w, ok_w = (np.asarray(a) for a in want)
    x_g, r_g, rf_g, ok_g = got
    m = live if vv is None else live  # dead rows hold garbage in both
    assert np.array_equal(x_g.numpy()[m], x_w[m])
    assert int(r_g) == int(r_w) and float(rf_g) == float(rf_w)
    assert bool(ok_g) == bool(ok_w)


@pytest.mark.parametrize("spread", [100, 2**40, 2**62])
def test_pack_sort_cols_matches_reference(spread):
    rng = np.random.default_rng(2)
    n = 400
    a = rng.integers(-spread // 2, spread // 2, n, dtype=np.int64)
    b = rng.integers(0, 7, n).astype(np.int64)
    bv = rng.random(n) > 0.1
    live = rng.random(n) > 0.2
    specs = ((0, True, None), (1, False, True))
    want_p, want_ok = ref_fd._pack_sort_cols(
        [(jnp.asarray(a), None), (jnp.asarray(b), jnp.asarray(bv))], specs,
        jnp.asarray(live))
    got_p, got_ok = fused_dag._pack_sort_cols(
        [(torch.from_numpy(a), None),
         (torch.from_numpy(b), torch.from_numpy(bv))], specs,
        torch.from_numpy(live))
    assert bool(got_ok) == bool(want_ok) == (spread < 2**62)
    if bool(want_ok):
        assert np.array_equal(got_p.numpy()[live], np.asarray(want_p)[live])


@pytest.mark.parametrize("n,k", [(5000, 10), (20000, 1024), (37, 64),
                                 (9000, 1)])
def test_topk_idx_matches_reference_with_ties(n, k):
    """Few distinct keys, so ties cross the k-th row: the indices and
    their order must equal the reference's chunked arg-min exactly."""
    rng = np.random.default_rng(n + k)
    packed = rng.integers(0, 12, n).astype(np.int64)
    live = rng.random(n) > 0.4
    wi, wv = ref_fd._topk_idx(jnp.asarray(packed), jnp.asarray(live), k)
    gi, gv = fused_dag._topk_idx(torch.from_numpy(packed),
                                 torch.from_numpy(live), k)
    wv = np.asarray(wv)
    assert np.array_equal(gv.numpy(), wv)
    assert np.array_equal(gi.numpy()[wv], np.asarray(wi)[wv])


@pytest.mark.parametrize("op", ["min", "max", "add", "first"])
def test_seg_scan_matches_reference(op):
    """Random runs: 'add' and 'first' equal the reference's forward scan
    everywhere; 'min' and 'max' equal it at run ends (forward) and run
    starts (reverse), the positions the programs read."""
    rng = np.random.default_rng(3)
    n = 3000
    x = rng.integers(-10**6, 10**6, n).astype(np.int64)
    start = rng.random(n) < 0.1
    start[0] = True
    end = np.append(start[1:], True)
    jop = {"min": jnp.minimum, "max": jnp.maximum, "add": jnp.add,
           "first": lambda a, _b: a}[op]
    want = np.asarray(ref_fd._seg_scan(jnp.asarray(x), jnp.asarray(start),
                                       jop))
    runs = fused_dag._runs(torch.from_numpy(start))
    got = fused_dag._seg_scan(torch.from_numpy(x), runs, op).numpy()
    at = end if op in ("min", "max") else np.ones(n, bool)
    assert np.array_equal(got[at], want[at])
    if op in ("min", "max"):
        want_r = np.asarray(ref_fd._seg_scan(
            jnp.asarray(x), jnp.asarray(end), jop, reverse=True))
        assert np.array_equal(got[start], want_r[start])

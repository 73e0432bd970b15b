"""The fragment program (opentenbase_tpu_torch/executor/fused.py) and the
coordinator's expressions, held against the reference on the CPU.

Both packages hold the same rows (INSERT VALUES on both sides, or rows
appended to the reference's stores and carried across with
``carry.load_table``); the reference runs with ``enable_pallas_scan =
on`` (its Pallas scan-aggregate kernel in interpret mode), as
tests/test_torch_slice.py does. Every query must return the reference's
rows through ``Session.query`` and take the reference's route — K1 where
the certifier takes the fragment, else the fragment program — and the
same rung of its ladder (hash at 64 slots, hash at 1024, sort), read
off the reference's fused executor on a ONE-device mesh (the port's
program flattens every shard into one row axis, the reference's
one-device form; the suite's 8-device mesh hashes each shard apart).

Integer, decimal and computed-FLOAT8 results (``avg``: float32 in both
packages) compare exactly. A sum over a raw FLOAT8 column is summed in
another order by each package, so those columns compare with a relative
tolerance of 1e-12 (``RTOL``)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.executor.fused import FusedExecutor as RefFused
from opentenbase_tpu.ops import agg as ref_agg
from opentenbase_tpu.ops import filter as ref_filter
from opentenbase_tpu.plan.analyze import analyze_statement
from opentenbase_tpu.plan.distribute import distribute_statement
from opentenbase_tpu.plan.optimize import optimize_statement
from opentenbase_tpu.sql.parser import parse
from opentenbase_tpu.storage.column import Column as RefColumn
from opentenbase_tpu.storage.table import ColumnBatch as RefBatch
from opentenbase_tpu_torch import Cluster, carry
from opentenbase_tpu_torch.executor.fused import FusedUnsupported
from opentenbase_tpu_torch.ops import agg as port_agg
from opentenbase_tpu_torch.ops import filter as port_filter
from opentenbase_tpu_torch.ops import scan_agg as sa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)  # numpy only at import: the generators

RTOL = 1e-12  # raw FLOAT8 sums only; everything else is exact
SEED = 5


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------


def _pair(ddl=(), inserts=()):
    """A reference session (Pallas on) and a port session with the same
    DDL and INSERT VALUES."""
    ref = RefCluster(num_datanodes=2, shard_groups=256)
    rs = ref.session()
    rs.execute("set enable_pallas_scan = on")
    port = Cluster(num_datanodes=2, device="cpu")
    ps = port.session()
    for stmt in tuple(ddl) + tuple(inserts):
        rs.execute(stmt)
        ps.execute(stmt)
    return rs, ps


def _ref_append(cluster, table, arrays) -> None:
    """Rows split over the datanodes at one commit (bench.py's
    _bulk_append), TEXT coded into the table's dictionaries."""
    meta = cluster.catalog.get(table)
    arrays = {k: smoke.encode_text(meta, k, arrays[k]) for k in meta.schema}
    n = len(next(iter(arrays.values())))
    nn = len(meta.node_indices)
    ts = cluster.gts.get_gts()
    for i, node in enumerate(meta.node_indices):
        sl = slice(i * n // nn, (i + 1) * n // nn)
        cols = {k: RefColumn(meta.schema[k], arrays[k][sl], None,
                             meta.dictionaries.get(k)) for k in meta.schema}
        cluster.stores[node][table].append_batch(
            RefBatch(cols, sl.stop - sl.start), ts)


def _carry(rs, ps, table) -> None:
    """The reference's stored rows of ``table`` and its dictionaries,
    handed to the port."""
    meta = rs.cluster.catalog.get(table)
    cols, xmins, xmaxs = {}, {}, {}
    for node in meta.node_indices:
        v = rs.cluster.stores[node][table].scan_view()
        cols[node] = {name: (np.array(v.col(name)), v.validity(name))
                      for name in meta.schema}
        xmins[node] = np.array(v.xmin())
        xmaxs[node] = np.array(v.xmax())
    dicts = {k: list(d.values) for k, d in meta.dictionaries.items()}
    carry.load_table(ps.cluster, table, cols, xmins, xmaxs, dicts)


def _loaded(ddl, tables: dict):
    rs, ps = _pair(ddl)
    for name, arrays in tables.items():
        _ref_append(rs.cluster, name, arrays)
        _carry(rs, ps, name)
    return rs, ps


def _ref_route(rs, sql):
    """The route and rung of the reference's fused executor on a
    one-device mesh for ``sql``'s single fragment: ("scan_agg", None)
    when its Pallas kernel answered, else ("program", rung)."""
    c = rs.cluster
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:1]), ("dn",))
    fx = RefFused(c.catalog, c.stores, mesh=mesh1)
    rungs = []
    compile_ = fx._compile

    def record(m, meta, dtab, cap, has_valid, grouping="hash", win=None):
        rungs.append((grouping, cap))
        return compile_(m, meta, dtab, cap, has_valid, grouping, win=win)

    fx._compile = record
    dp = distribute_statement(optimize_statement(
        analyze_statement(parse(sql)[0], c.catalog), c.catalog), c.catalog)
    (frag,) = dp.fragments
    out = fx.fragment_output(frag, c.gts.snapshot_ts(), rs._dicts_view(),
                             [], use_pallas=True)
    assert out is not None, "the reference did not fuse the fragment"
    if not rungs:
        return ("scan_agg", None)
    if not frag.root.group_exprs:
        return ("program", ("scalar", None))
    return ("program", rungs[-1])


def _same_rows(got, want, approx=()):
    """Rows equal; columns in ``approx`` (raw FLOAT8 sums) within RTOL."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (got, want)
        for j, (a, b) in enumerate(zip(g, w)):
            if j in approx and b is not None:
                assert a == pytest.approx(b, rel=RTOL, abs=0), (got, want)
            else:
                assert a == b and type(a) is type(b), (j, got, want)


def _both(rs, ps, sql, approx=()):
    """The port's rows and route against the reference's: (rows,
    route)."""
    want = rs.query(sql)
    got = ps.query(sql)
    _same_rows(got, want, approx)
    fx = ps.cluster.fused_executor()
    route = (fx.last_route, fx.last_rung)
    assert not ps._fused_via_dag
    assert route == _ref_route(rs, sql)
    return got, route


# ---------------------------------------------------------------------------
# tests/test_fused.py: the four QUERIES
# ---------------------------------------------------------------------------

FUSED_DDL = (
    "create table li (flag text, status text, qty numeric(10,2), "
    "price numeric(12,2), disc numeric(4,2), ship date) "
    "distribute by roundrobin",
)
# tests/test_fused.py QUERIES
FUSED_QUERIES = [
    "select sum(price * disc), count(*) from li "
    "where ship >= date '1994-06-01' and ship < date '1995-06-01' "
    "and disc between 0.02 and 0.08 and qty < 30",
    "select flag, status, count(*), sum(qty), avg(price), min(disc), "
    "max(disc) from li where ship <= date '1996-09-01' "
    "group by flag, status order by flag, status",
    "select status, count(*) from li where flag = 'A' group by status "
    "order by status",
    "select sum(qty) from li where qty < 0",
]
FUSED_ROUTES = [
    ("scan_agg", None), ("program", ("hash", 64)),
    ("program", ("hash", 64)), ("scan_agg", None),
]


def _fused_rows(n=4000, seed=3):
    """tests/test_fused.py's rows."""
    rng = np.random.default_rng(seed)
    return ",".join(
        f"('{f}','{st}',{q:.2f},{p:.2f},{d:.2f},'{dt}')"
        for f, st, q, p, d, dt in zip(
            rng.choice(["A", "N", "R"], n),
            rng.choice(["F", "O"], n),
            rng.uniform(1, 50, n).round(2),
            rng.uniform(9, 1000, n).round(2),
            rng.uniform(0, 0.1, n).round(2),
            np.datetime64("1994-01-01") + rng.integers(0, 1000, n),
        )
    )


@pytest.fixture(scope="module")
def fused_li():
    return _pair(FUSED_DDL, ("insert into li values " + _fused_rows(),))


@pytest.mark.parametrize("qi", range(len(FUSED_QUERIES)))
def test_fused_queries_match_reference(fused_li, qi):
    rs, ps = fused_li
    got, route = _both(rs, ps, FUSED_QUERIES[qi])
    assert route == FUSED_ROUTES[qi]
    if qi != 3:
        assert got and got[0][-1] is not None


def _port_fragment(ps, sql):
    """The port's fragment program (K1's route first) on ``sql``'s one
    fragment."""
    from opentenbase_tpu_torch.plan import analyze_statement as p_analyze
    from opentenbase_tpu_torch.plan.distribute import (
        distribute_statement as p_distribute,
    )
    from opentenbase_tpu_torch.plan.optimize import (
        optimize_statement as p_optimize,
    )
    from opentenbase_tpu_torch.sql import parse as p_parse

    cat = ps.cluster.catalog
    dplan = p_distribute(p_optimize(p_analyze(p_parse(sql)[0], cat), cat),
                         cat)
    return ps.cluster.fused_executor().fragment_output(
        dplan.fragments[0], ps.cluster.gts.clamped_snapshot())


def test_text_min_max_is_not_ported(fused_li):
    """The reference's program declines min/max over TEXT (codes follow
    insertion order) and its host executor answers. The port's program
    declines alike (``FusedUnsupported``, once a NotPorted) and its host
    executor answers the same rows."""
    rs, ps = fused_li
    sql = "select min(flag), max(status) from li"
    assert rs.query(sql) == [("A", "O")]
    with pytest.raises(FusedUnsupported, match="TEXT"):
        _port_fragment(ps, sql)
    assert ps.query(sql) == [("A", "O")]
    assert ps.last_route == "host"


# ---------------------------------------------------------------------------
# tests/test_pallas_scan.py:232-318: the grouped kernel and its fallbacks
# ---------------------------------------------------------------------------

PALLAS_DDL = (
    "create table li (l_returnflag text, l_linestatus text, "
    "l_quantity numeric(10,2), l_extendedprice numeric(12,2), "
    "l_discount numeric(4,2), l_shipdate date) distribute by roundrobin",
    "create table gt (k int, v numeric(10,2)) distribute by roundrobin",
    "create table wide (k bigint, v bigint) distribute by roundrobin",
    "create table bigk (k bigint, v bigint) distribute by roundrobin",
    "create table yr (y int, v numeric(10,2)) distribute by roundrobin",
    "create table cn (a bigint) distribute by roundrobin",
)


def _pallas_inserts():
    rng = np.random.default_rng(11)
    n = 5000
    li = ",".join(
        f"('{f}','{st}',{q:.2f},{p:.2f},0.0{d},'{dt}')"
        for f, st, q, p, d, dt in zip(
            rng.choice(["A", "N", "R"], n),
            rng.choice(["F", "O"], n),
            rng.uniform(1, 50, n).round(2),
            rng.uniform(900, 9000, n).round(2),
            rng.integers(0, 9, n),
            np.datetime64("1994-01-01") + rng.integers(0, 1500, n),
        )
    )
    return (
        "insert into li values " + li,
        "insert into gt values (-2, 1.00), (-2, 2.50), (0, 4.00), "
        "(3, 1.25), (3, 0.25), (3, 1.00)",
        "insert into wide values " + ",".join(
            f"({k * 1000}, {k})" for k in range(40)),
        "insert into bigk values (16777216, 1), (16777217, 2)",
        "insert into yr values " + ",".join(
            f"({1992 + (i % 7)}, {i}.25)" for i in range(50)),
        "insert into cn values (0), (1), (2), (0)",
    )


PALLAS_CASES = {
    # the grouped kernel on TPC-H Q1's shape
    "q1_grouped_kernel": (
        "select l_returnflag, l_linestatus, sum(l_quantity), "
        "sum(l_extendedprice), sum(l_extendedprice * l_discount), count(*) "
        "from li where l_shipdate <= date '1997-09-02' "
        "group by l_returnflag, l_linestatus "
        "order by l_returnflag, l_linestatus", ("scan_agg", None)),
    "negative_int_keys": (
        "select k, sum(v), count(*) from gt group by k order by k",
        ("scan_agg", None)),
    "large_domain_falls_back": (
        "select k, sum(v) from wide group by k order by k",
        ("program", ("hash", 1024))),  # 40 keys collide in 64 slots
    "key_beyond_f32_falls_back": (
        "select k, sum(v) from bigk group by k order by k",
        ("program", ("hash", 64))),
    "offset_domain": (
        "select y, sum(v), count(*) from yr group by y order by y",
        ("scan_agg", None)),
    "count_nullif": ("select count(nullif(a, 0)) from cn",
                     ("program", ("scalar", None))),
    "count_col_and_star": ("select count(a), count(*) from cn",
                           ("scan_agg", None)),
}


@pytest.fixture(scope="module")
def pallas_tables():
    return _pair(PALLAS_DDL, _pallas_inserts())


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_pallas_scan_cases_match_reference(pallas_tables, case):
    rs, ps = pallas_tables
    sql, route = PALLAS_CASES[case]
    got, seen = _both(rs, ps, sql)
    assert seen == route
    if case == "q1_grouped_kernel":
        assert len(got) == 6
    if case == "negative_int_keys":
        assert got == [(-2, 3.5, 2), (0, 4.0, 1), (3, 2.5, 3)]
    if case == "key_beyond_f32_falls_back":
        assert got == [(16777216, 1), (16777217, 2)]
    if case == "count_nullif":
        assert got == [(2,)]


# ---------------------------------------------------------------------------
# tests/test_fused.py:105: a literal change binds the new literal
# ---------------------------------------------------------------------------


def test_literal_change_binds_the_new_literal():
    """Each call binds its own literals (the reference's round-4
    regression: 'who = 1' returned the count for 'who = 7' from a cached
    program). Through K1 and through the fragment program (min and a
    grouped min keep the fragment off the kernel)."""
    rs, ps = _pair(
        ("create table lit (k bigint, who bigint) distribute by shard(k)",),
        ("insert into lit values " + ",".join(
            f"({j},7)" for j in range(40)),
         "insert into lit values " + ",".join(
            f"({100 + j},1)" for j in range(12))))
    checks = [
        ("select count(*) from lit where who = 7", [(40,)]),
        ("select count(*) from lit where who = 1", [(12,)]),
        ("select count(*) from lit where who = 7", [(40,)]),
        ("select sum(k) from lit where who = 1", [(sum(range(100, 112)),)]),
        ("select who, count(*) from lit where k < 100 group by who "
         "order by who", [(7, 40)]),
        ("select who, count(*) from lit where k < 1000 group by who "
         "order by who", [(1, 12), (7, 40)]),
        ("select min(k), max(k) from lit where who = 7", [(0, 39)]),
        ("select min(k), max(k) from lit where who = 1", [(100, 111)]),
        ("select min(k), max(k) from lit where who = 7", [(0, 39)]),
        ("select who, min(k) from lit where k > 5 group by who "
         "order by who", [(1, 100), (7, 6)]),
        ("select who, min(k) from lit where k > 105 group by who "
         "order by who", [(1, 106)]),
    ]
    for sql, want in checks:
        assert rs.query(sql) == want
        assert ps.query(sql) == want, sql
    assert ps.cluster.fused_executor().last_route == "program"


# ---------------------------------------------------------------------------
# the shapes users hit: spec TPC-H Q1, ClickBench's scalar queries, and
# the probe's single-table aggregates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch():
    tables = smoke.make_q3_spec(0.001, SEED)
    rs, ps = _loaded(smoke.Q3_SPEC_DDL[2:], {"lineitem": tables["lineitem"]})
    return tables["lineitem"], rs, ps


def test_tpch_q1_as_the_spec_writes_it(tpch):
    """Three avgs and sum_charge: K1's certifier rejects the triple
    product, the program's first hash rung answers, the coordinator
    finishes the avgs in float32; equal to chip_smoke's numpy."""
    li, rs, ps = tpch
    before = sa.scan_agg.launches
    got, route = _both(rs, ps, smoke.Q1_SPEC)
    assert route == smoke.FRAGMENT_ROUTES["TPC-H Q1 (spec)"]
    assert got == smoke.expected_q1_spec(li)
    assert [r[:2] for r in got] == [("A", "F"), ("N", "F"), ("N", "O"),
                                    ("R", "F")]
    assert sa.scan_agg.launches == before  # the CPU launches nothing


def test_tpch_q1_without_the_avgs(tpch):
    _li, rs, ps = tpch
    sql = smoke.Q1_SPEC.replace(
        "avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price, "
        "avg(l_discount) as avg_disc, ", "")
    assert sql != smoke.Q1_SPEC
    _got, route = _both(rs, ps, sql)
    assert route == ("program", ("hash", 64))


@pytest.fixture(scope="module")
def hits():
    hits = smoke.make_hits(20_000, int(20_000 * smoke.HITS_DISTINCT_SHARE),
                           SEED)
    rs, ps = _loaded((smoke.CLICKBENCH_DDL,), {"hits": hits})
    return hits, rs, ps


@pytest.mark.parametrize("q", sorted(smoke.CLICKBENCH_SCALAR_Q))
def test_clickbench_scalar_queries(hits, q):
    arrays, rs, ps = hits
    got, route = _both(rs, ps, smoke.CLICKBENCH_SCALAR_Q[q])
    assert route == smoke.FRAGMENT_ROUTES[q]
    assert got == smoke.expected_clickbench_scalar(arrays, q)


PROBE_DDL = (
    "create table li (ok bigint, q numeric(10,2), p numeric(12,2), "
    "d numeric(4,2), tx numeric(4,2), sd date, rf text, ls text, "
    "x double precision, adv int) distribute by roundrobin",
)


def _probe_rows(n=300, seed=1):
    rng = np.random.default_rng(seed)
    return "insert into li values " + ",".join(
        f"({i}, {rng.integers(1, 51)}.00, {rng.uniform(900, 9000):.2f}, "
        f"0.0{rng.integers(0, 9)}, 0.0{rng.integers(0, 9)}, "
        f"'199{rng.integers(2, 9)}-0{rng.integers(1, 9)}-"
        f"1{rng.integers(0, 9)}', '{rng.choice(['A', 'N', 'R'])}', "
        f"'{rng.choice(['F', 'O'])}', {rng.uniform(0, 10):.6f}, "
        f"{0 if rng.random() < 0.5 else int(rng.integers(1, 40))})"
        for i in range(n))


# single-table aggregates that K1 rejects, and an avg K1 feeds: (sql,
# route, raw FLOAT8 columns)
PROBE = {
    "q1_spec": (smoke.Q1_SPEC.replace("lineitem", "li").replace(
        "l_returnflag", "rf").replace("l_linestatus", "ls").replace(
        "l_quantity", "q").replace("l_extendedprice", "p").replace(
        "l_discount", "d").replace("l_tax", "tx").replace("l_shipdate", "sd"),
        ("program", ("hash", 64)), ()),
    "q1_spec_no_avg": (
        "select rf, ls, sum(p*(1-d)*(1+tx)), count(*) from li "
        "group by rf, ls order by rf, ls", ("program", ("hash", 64)), ()),
    "min_max_date": ("select min(sd), max(sd) from li",
                     ("program", ("scalar", None)), ()),
    "sum_float8": ("select sum(x) from li", ("program", ("scalar", None)),
                   (0,)),
    "group_over_16": (
        "select adv, count(*) from li where adv <> 0 group by adv "
        "order by 2 desc, 1", ("program", ("hash", 64)), ()),
    "computed_key": (
        "select ok % 40, count(*) from li group by ok % 40 order by 1",
        ("program", ("hash", 64)), ()),
    "avg_after_kernel": ("select sum(adv), count(*), avg(q) from li",
                         ("scan_agg", None), ()),
}


@pytest.fixture(scope="module")
def probe():
    return _pair(PROBE_DDL, (_probe_rows(),))


@pytest.mark.parametrize("case", sorted(PROBE))
def test_probe_shapes_match_reference(probe, case):
    rs, ps = probe
    sql, route, approx = PROBE[case]
    got, seen = _both(rs, ps, sql, approx)
    assert seen == route
    assert got and got[0][0] is not None


# ---------------------------------------------------------------------------
# NULL-able int, decimal and FLOAT8 columns, with empty groups
# ---------------------------------------------------------------------------

NULL_DDL = (
    "create table nl (g int, i bigint, dc numeric(10,2), "
    "x double precision) distribute by roundrobin",
)


def _null_rows(n=400, seed=9):
    """Group 4 holds only NULL values; every column has NULLs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = int(rng.integers(0, 5))

        def val(s):
            return "null" if g == 4 or rng.random() < 0.25 else s

        out.append(f"({g}, {val(int(rng.integers(-50, 50)))}, "
                   f"{val(f'{rng.uniform(-99, 99):.2f}')}, "
                   f"{val(f'{rng.uniform(-5, 5):.6f}')})")
    out.append("(null, 3, 1.25, 0.5)")
    return "insert into nl values " + ",".join(out)


NULL_CASES = {
    "grouped": (
        "select g, sum(i), avg(i), count(i), sum(dc), avg(dc), min(dc), "
        "max(i), count(*) from nl group by g order by g",
        ("program", ("hash", 64)), ()),
    "grouped_float8": (
        "select g, sum(x), min(x), max(x), count(x) from nl group by g "
        "order by g", ("program", ("hash", 64)), (1,)),
    "scalar": ("select sum(i), avg(dc), min(x), count(dc), count(*) from nl",
               ("program", ("scalar", None)), ()),
    "is_null_filter": ("select g, count(*) from nl where i is null "
                       "group by g order by g", ("program", ("hash", 64)),
                       ()),
    "empty_scalar": ("select sum(i), avg(dc), max(x), count(*) from nl "
                     "where g = 4 and i is not null",
                     ("program", ("scalar", None)), ()),
    "case_and_division": (
        "select g, sum(case when i > 0 then i else 0 end), "
        "sum(i / (g - 2)), count(i % (g - 1)) from nl group by g "
        "order by g", ("program", ("hash", 64)), ()),
}


@pytest.fixture(scope="module")
def nulls():
    return _pair(NULL_DDL, (_null_rows(),))


@pytest.mark.parametrize("case", sorted(NULL_CASES))
def test_nullable_columns_and_empty_groups(nulls, case):
    rs, ps = nulls
    sql, route, approx = NULL_CASES[case]
    got, seen = _both(rs, ps, sql, approx)
    assert seen == route
    if case == "grouped":
        g4 = [r for r in got if r[0] == 4]
        assert g4 and g4[0][1:8] == (None, None, 0, None, None, None, None)
    if case == "empty_scalar":
        assert got == [(None, None, None, 0)]


# ---------------------------------------------------------------------------
# the ladder: a forced collision climbs to hash-1024, then to sort
# ---------------------------------------------------------------------------


def _slots(keys, cap):
    k = torch.from_numpy(np.asarray(keys, dtype=np.int64))
    return port_agg.hash_slot_ids([(k, None)], None, cap)[0].tolist()


def _no_collision_at(cap, want, start=0):
    """``want`` bigint keys whose slots at ``cap`` are all distinct."""
    keys, used = [], set()
    k = start
    while len(keys) < want:
        s = _slots([k], cap)[0]
        if s not in used:
            used.add(s)
            keys.append(k)
        k += 1
    return keys


def _ladder_keys():
    hash1024 = _no_collision_at(1024, 80)  # > 64 keys: 64 slots collide
    # small consecutive integers fill distinct low slots (the mix is a
    # bijection on the low bits there): spread keys do collide
    sort = [int(k) for k in np.random.default_rng(SEED).integers(
        -(2**40), 2**40, 300)]
    assert len(set(_slots(sort, 1024))) < len(sort)  # they collide at 1024
    return {"hash1024": hash1024, "sort": sort}


LADDER_DDL = (
    "create table lh (k bigint, v bigint) distribute by roundrobin",
    "create table ls (k bigint, v bigint) distribute by roundrobin",
    "create table lf (k double precision, v bigint) "
    "distribute by roundrobin",
    "create table lo (k bigint, v bigint) distribute by roundrobin",
)


@pytest.fixture(scope="module")
def ladder():
    keys = _ladder_keys()
    rows = []
    for table, ks in (("lh", keys["hash1024"]), ("ls", keys["sort"]),
                      ("lf", [k / 8 - 3 for k in range(100)])):
        rows.append(f"insert into {table} values " + ",".join(
            f"({k}, {i % 7})" for i, k in enumerate(ks + ks[::3])))
    rows.append("insert into lo values " + ",".join(
        f"({k}, 1)" for k in range(1100)))
    return _pair(LADDER_DDL, rows)


LADDER_CASES = {
    # integer keys and sums: the reference's one-hot reduce
    "hash1024": ("select k, sum(v), count(*) from lh group by k order by k",
                 ("program", ("hash", 1024))),
    "sort": ("select k, sum(v), count(*) from ls group by k order by k",
             ("program", ("sort", 1024))),
    # min/max, and float keys: the reference's segment reduce
    "hash1024_min_max": ("select k, min(v), max(v) from lh group by k "
                         "order by k", ("program", ("hash", 1024))),
    "float_keys": ("select k, count(*), max(v) from lf group by k "
                   "order by k", ("program", ("sort", 1024))),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_collision_climbs_the_ladder(ladder, case):
    rs, ps = ladder
    sql, route = LADDER_CASES[case]
    got, seen = _both(rs, ps, sql)
    assert seen == route
    assert len(got) > 64


def test_sort_rung_past_its_capacity_is_not_ported(ladder):
    """1100 groups overflow the sort rung's 1024: the reference hands the
    query to its host executor, and so does the port (its program
    raises ``FusedUnsupported``, once a NotPorted)."""
    rs, ps = ladder
    sql = "select k, count(*) from lo group by k"
    want = rs.query(sql)
    assert len(want) == 1100
    with pytest.raises(FusedUnsupported, match="capacity"):
        _port_fragment(ps, sql)
    assert sorted(ps.query(sql)) == sorted(want)
    assert ps.last_route == "host"


# ---------------------------------------------------------------------------
# ops/agg hash grouping and ops/filter compaction against the reference
# ---------------------------------------------------------------------------


def _key_sets():
    rng = np.random.default_rng(SEED)
    i64 = np.array([0, 1, -1, 2**62, -(2**63), 2**63 - 1, 12345678901,
                    -7, 42, 1 << 40], np.int64)
    i32 = rng.integers(-(2**31), 2**31 - 1, 64).astype(np.int32)
    f64 = np.array([0.0, -0.0, np.nan, -np.nan, 1.5, -1.5, np.inf, -np.inf,
                    1e300, 5e-324, 0.1, 0.30000000000000004])
    f32 = np.array([0.0, -0.0, np.nan, 1.5, 3.25e38, -2.0], np.float32)
    valid = rng.random(64) > 0.3
    return {
        "int64": [(i64, None)],
        "int32": [(i32, None)],
        "bool": [(rng.random(16) > 0.5, None)],
        "float64": [(f64, None)],
        "float32": [(f32, None)],
        "int32_nullable": [(i32, valid)],
        "two_keys": [(i32, valid), (i32[::-1].astype(np.int64), None)],
        "float64_and_int": [(np.repeat(f64, 2)[:16], None),
                            (np.arange(16, dtype=np.int32), None)],
    }


def _ref_keys(keys):
    return [(jnp.asarray(d), None if v is None else jnp.asarray(v))
            for d, v in keys]


def _port_keys(keys):
    return [(torch.from_numpy(np.array(d)),
             None if v is None else torch.from_numpy(np.array(v)))
            for d, v in keys]


@pytest.mark.parametrize("cap", [64, 1024])
@pytest.mark.parametrize("name", sorted(_key_sets()))
def test_hash_slots_pinned_to_the_reference(name, cap):
    """The same keys take the same slots in both packages (the FNV mix's
    wrapping int64 products and arithmetic shift), rows outside the mask
    the overflow slot; ngroups and the collision flag agree."""
    keys = _key_sets()[name]
    n = len(keys[0][0])
    mask = np.ones(n, bool)
    mask[::5] = False
    want, _p, _v = ref_agg._hash_slot_ids(_ref_keys(keys),
                                          jnp.asarray(mask), cap)
    got, _p, _v = port_agg.hash_slot_ids(_port_keys(keys),
                                         torch.from_numpy(mask), cap)
    assert got.tolist() == np.asarray(want).tolist()
    _s, wn, wc = ref_agg._hash_slots_impl(_ref_keys(keys),
                                          jnp.asarray(mask), cap)
    _s, gn, gc = port_agg.hash_slots(_port_keys(keys),
                                     torch.from_numpy(mask), cap)
    assert (int(gn), bool(gc)) == (int(wn), bool(wc))


def test_hash_slots_of_fixed_keys():
    """A handful of slots written down, so a change to the mix shows
    even where both packages changed together."""
    assert _slots([0, 1, 2, 3, -1, 2**40], 64) == [
        np.asarray(ref_agg._hash_slot_ids(
            [(jnp.asarray(np.array([k], np.int64)), None)], None, 64)[0]
        ).tolist()[0] for k in (0, 1, 2, 3, -1, 2**40)]
    codes = np.array(smoke.ADV_ENGINES, np.int32)
    slots = port_agg.hash_slot_ids(
        [(torch.from_numpy(codes), None)], None, 64)[0].tolist()
    assert len(set(slots)) == len(codes)  # ClickBench Q7: hash-64 holds


@pytest.mark.parametrize("collide", [False, True])
def test_hash_reduce_matches_mxu_reduce(collide):
    """The hash rung's reduction (``hash_slots`` + ``group_reduce``):
    sums and counts per slot, exact in int64, the slots' keys and the
    collision flag, against the reference's one-hot matmul reduce."""
    rng = np.random.default_rng(17)
    n, cap = 5000, 64
    if collide:  # 90 keys in 64 slots
        groups = rng.integers(-10**6, 10**6, 90)
    else:  # 30 keys whose slots (and the NULL key's) are all distinct
        null_slot = port_agg.hash_slot_ids(
            [(torch.zeros(1, dtype=torch.int64),
              torch.zeros(1, dtype=torch.bool))], None, cap)[0].item()
        groups = [k for k in _no_collision_at(cap, 31, -10**6)
                  if _slots([k], cap)[0] != null_slot][:30]
        groups = np.asarray(groups)
    kd = groups[rng.integers(0, len(groups), n)]
    kv = rng.random(n) > 0.1
    vd = rng.integers(-(2**40), 2**40, n)
    vv = rng.random(n) > 0.2
    mask = rng.random(n) > 0.25
    specs = ("sum", "count", "count_star", "sum")
    keys = [(kd, kv)]
    vals = [(vd, vv), (vd, vv), None, (kd.astype(np.int32), None)]
    rslot, _p, _v = ref_agg._hash_slot_ids(_ref_keys(keys),
                                           jnp.asarray(mask), cap)
    want = ref_agg._mxu_group_reduce_impl(
        _ref_keys(keys), [None if x is None else _ref_keys([x])[0]
                          for x in vals], rslot, cap, specs)
    pslot, gn, gc = port_agg.hash_slots(_port_keys(keys),
                                        torch.from_numpy(mask), cap)
    gk, gv, gg = port_agg.group_reduce(
        _port_keys(keys), [None if x is None else _port_keys([x])[0]
                           for x in vals], torch.arange(n), pslot, cap,
        specs)
    wk, wv, wg, wn, wc = want
    assert bool(gc) == bool(wc) == collide
    assert int(gn) == int(wn)
    g = np.asarray(wg)
    assert gg.numpy().tolist() == g.tolist()
    if collide:
        return
    for (a, av), (b, bv) in zip(gk + gv, list(wk) + list(wv)):
        bv = np.asarray(bv) & g
        assert av.numpy()[g].tolist() == bv[g].tolist()
        assert a.numpy()[bv].tolist() == np.asarray(b)[bv].tolist()


# keys (B, NULL) and (B, 0) differ in one validity bit; under the FNV mix
# such a pair shares a slot about once in 10^8 keys: this B (found by a
# search over the int32 range) is one
_NULL_ZERO_B = 112641393


def _null_and_zero_keys(n):
    b = torch.full((n,), _NULL_ZERO_B, dtype=torch.int32)
    return [(b, None), (torch.zeros(n, dtype=torch.int32),
                        torch.arange(n) % 2 == 1)]


def test_null_and_zero_keys_in_one_slot_collide():
    """A NULL key and a 0 key differ only in their validity bit: in one
    slot they are a collision. (The reference's one-hot reduce compares
    the NULL payloads, zeroed, and misses it: ROADMAP C.)"""
    keys = _null_and_zero_keys(4)
    s64 = port_agg.hash_slot_ids(keys, None, 64)[0].tolist()
    s1024 = port_agg.hash_slot_ids(keys, None, 1024)[0].tolist()
    assert len(set(s64)) == 1 and len(set(s1024)) == 2
    _s, _n, collision = port_agg.hash_slots(keys, None, 64)
    assert bool(collision)
    _s, ngroups, collision = port_agg.hash_slots(keys, None, 1024)
    assert not bool(collision) and int(ngroups) == 2


@pytest.fixture(scope="module")
def null_and_zero():
    rows = [f"({_NULL_ZERO_B}, null, {i})" for i in range(3)]
    rows += [f"({_NULL_ZERO_B}, 0, {10 + i})" for i in range(2)]
    return _pair(("create table nz (b int, a int, c int) "
                  "distribute by roundrobin",),
                 ("insert into nz values " + ",".join(rows),))


@pytest.mark.parametrize("agg", ["count(*)", "min(c)"])
def test_null_and_zero_keys_climb_to_hash_1024(null_and_zero, agg):
    """Two groups, (B, NULL) and (B, 0), sharing a slot at 64 slots: the
    program climbs to 1024 and returns both. With min the reference's
    exact representative check climbs too and the two packages agree;
    with count(*) the reference's one-hot reduce merges the groups, so
    the rows are held to SQL's answer."""
    rs, ps = null_and_zero
    sql = f"select b, a, {agg} from nz group by b, a order by a"
    if agg == "min(c)":
        got, seen = _both(rs, ps, sql)
        assert got == [(_NULL_ZERO_B, 0, 10), (_NULL_ZERO_B, None, 0)]
    else:
        got = ps.query(sql)
        fx = ps.cluster.fused_executor()
        seen = (fx.last_route, fx.last_rung)
        assert got == [(_NULL_ZERO_B, 0, 2), (_NULL_ZERO_B, None, 3)]
    assert seen == ("program", ("hash", 1024))


def test_compact_and_gather_match_reference():
    rng = np.random.default_rng(23)
    mask = rng.random(40) > 0.6
    d = rng.integers(0, 100, 40)
    v = rng.random(40) > 0.2
    k = int(mask.sum())
    idx, _valid = port_filter.compact_indices(torch.from_numpy(mask))
    ridx, rvalid = ref_filter.compact_indices(jnp.asarray(mask), k)
    assert idx.tolist() == np.asarray(ridx).tolist()
    (gd, gv), (hd, hv), (cd, cv) = port_filter.gather_cols(
        [(torch.from_numpy(d), torch.from_numpy(v)),
         (torch.from_numpy(d), None),
         (torch.tensor(7), torch.tensor(True))], idx)
    (wd, wv), (xd, xv) = ref_filter.gather_cols(
        [(jnp.asarray(d), jnp.asarray(v)), (jnp.asarray(d), None)],
        ridx, rvalid)
    assert gd.tolist() == np.asarray(wd).tolist()
    assert gv.tolist() == np.asarray(wv).tolist()
    assert hd.tolist() == np.asarray(xd).tolist()
    # every gathered row is real: a mask-less column stays mask-less
    assert hv is None and np.asarray(xv).all()
    assert cd.tolist() == [7] * k and cv.tolist() == [True] * k

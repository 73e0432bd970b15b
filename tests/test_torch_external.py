"""Device-resident external tables (``DeviceCache.register_external``)
and the chunk trigger of the port's fused fragment, against the
reference (opentenbase_tpu/executor/fused.py:262, :1108, :1215).

bench.py's SF100 leg registers its tables on the device with stub stores
(``chip_smoke.register_sf100``); here the same tables at a few thousand
rows, made by ``chip_smoke.make_sf100``, answer Q6 through the
scan-aggregate kernel's route and Q3 through the windowed gagg exactly
as the same rows in ordinary stores do, and as numpy does. The column
stats are taken over live rows only and equal the reference's
registration of the same arrays, the footprint of a registered table is
its actual bytes, and a scan whose footprint passes
``OTB_SCAN_HBM_BUDGET`` streams in chunks exactly where the reference
streams it (an external table, with no host rows to stream, is refused
by name)."""

import jax
import numpy as np
import pytest
import torch

from opentenbase_tpu.executor import fused as ref_fused
from opentenbase_tpu.executor.fused import FusedExecutor as RefFused
from opentenbase_tpu.plan.analyze import analyze_statement as ref_analyze
from opentenbase_tpu.plan.distribute import (
    distribute_statement as ref_distribute,
)
from opentenbase_tpu.plan.optimize import optimize_statement as ref_optimize
from opentenbase_tpu.sql.parser import parse as ref_parse
from opentenbase_tpu_torch import Cluster
from opentenbase_tpu_torch.executor import fused, fused_dag

from test_torch_dag_grouped import smoke
from test_torch_wgagg import _pair1

N = 4096 * 3  # lineitem rows; orders N / 4, customer N / 40
SEED = 11


def _ext_cluster(tables):
    c = Cluster(num_datanodes=1, shard_groups=16, device="cpu")
    smoke.register_sf100(c, {
        t: {k: torch.from_numpy(a) for k, a in cols.items()}
        for t, cols in tables.items()})
    return c


@pytest.fixture(scope="module")
def sf100():
    """(tables, external cluster, the same rows in ordinary stores with
    the same stats)."""
    tables = smoke.make_sf100(N, SEED)
    ext = _ext_cluster(tables)
    plain = Cluster(num_datanodes=1, shard_groups=16, device="cpu")
    s = plain.session()
    for ddl in smoke.SF100_DDL:
        s.execute(ddl)
    for t, cols in tables.items():
        smoke.bulk_append(plain, t, cols)
        plain.catalog.get(t).stats = smoke.sf100_stats(N)[t]
    return tables, ext, plain


def test_external_q6_through_the_kernel_route(sf100):
    tables, ext, plain = sf100
    want = smoke.expected_sf100_q6(tables)
    for c in (ext, plain):
        assert c.session().query(smoke.SF100_Q6) == want
        assert c.fused_executor().last_route == "scan_agg"


def test_external_q3_through_wgagg(sf100, monkeypatch):
    """The window budget forced down and the hoist's row floor lowered:
    Q3 over the external tables streams lineitem in windows with the
    orders side hoisted, equal to the ordinary stores and to numpy."""
    monkeypatch.setenv("OTB_DAG_WINDOW_BUDGET", "200000")
    monkeypatch.setattr(fused_dag.DagRunner, "HOIST_MIN_ROWS", 100)
    tables, ext, plain = sf100
    want = smoke.expected_sf100_q3(tables)
    seen = []
    for c in (ext, plain):
        assert c.session().query(smoke.SF100_Q3) == want
        r = c.fused_executor()._dag
        seen.append((r.last_mode, r.last_hoisted, r.last_join_modes,
                     r.last_windows[:2]))
    nwin = seen[0][3][0]
    # the external table's exact N rows against the stores' bucket
    assert seen[0][3] == (nwin, N // nwin)
    assert seen[0][:3] == seen[1][:3] == ("wgagg", True, ("fold",))


def test_external_stats_over_live_rows_only():
    """Padding past each shard's rows holds extreme values: the range
    and |max| the certifier reads come from the live rows only, equal to
    the reference's registration of the same arrays."""
    rng = np.random.default_rng(3)
    S, rmax, nrows = 2, 1000, [700, 313]
    a = rng.integers(-50, 90, (S, rmax)).astype(np.int32)
    b = rng.integers(10**9, 2 * 10**9, (S, rmax)).astype(np.int64)
    for i, n in enumerate(nrows):
        a[i, n:] = np.iinfo(np.int32).min if i else np.iinfo(np.int32).max
        b[i, n:] = np.iinfo(np.int64).max
    live = np.arange(rmax)[None, :] < np.asarray(nrows)[:, None]
    cols = {"a": a, "b": b, "f": rng.random((S, rmax))}
    port = Cluster(num_datanodes=2, device="cpu")
    port.session().execute(
        "create table x (a int, b bigint, f float8) distribute by roundrobin")
    meta = port.catalog.get("x")
    dt = port.fused_executor().cache.register_external(
        "x", meta, meta.node_indices,
        {k: torch.from_numpy(v) for k, v in cols.items()}, nrows)
    assert dt.col_range["a"] == (int(a[live].min()), int(a[live].max()))
    assert dt.col_range["b"] == (int(b[live].min()), int(b[live].max()))
    assert dt.col_maxabs["b"] == float(b[live].max())
    assert dt.col_range["f"] is None and dt.col_maxabs["f"] is None
    assert dt.xmin.shape == dt.xmax.shape == (S, 1) and dt.rmax == rmax
    rs, _port, _ps = _pair1(
        ["create table x (a int, b bigint, f float8) "
         "distribute by roundrobin"])
    ref = RefFused(rs.cluster.catalog, rs.cluster.stores, mesh=_mesh1())
    rdt = ref.cache.register_external(
        "x", rs.cluster.catalog.get("x"), (0, 1), cols, nrows)
    assert rdt.col_range == dt.col_range
    assert rdt.col_maxabs == dt.col_maxabs


def _mesh1():
    return jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:1]), ("dn",))


def test_footprint_is_the_external_tables_bytes(sf100):
    """A registered table reports its resident bytes (exact rows,
    compact MVCC planes), not the padded estimate."""
    _tables, ext, _plain = sf100
    fx = ext.fused_executor()
    meta = ext.catalog.get("lineitem")
    cols = ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]
    resident, row_bytes, S, mx = fx._scan_footprint(meta, cols)
    assert (S, mx) == (1, N)
    assert row_bytes == 16 + 4 * 5
    assert resident == 4 * 4 * N + 2 * 8
    assert resident < S * N * row_bytes


def test_external_table_past_the_budget_refused(sf100, monkeypatch):
    """A budget one compact MVCC plane below the table's actual bytes:
    the scan streams, as in the reference, and a window needs host rows,
    which an external table has none of. The reference fails there (its
    window upload reads the stub store's rows: AttributeError); the port
    refuses by name before touching the cache, so the table stays
    resident and answers once the budget holds it again."""
    tables, ext, _plain = sf100
    monkeypatch.setattr(fused, "SCAN_HBM_BUDGET", 4 * 4 * N)
    rs = _ref_external(tables)
    monkeypatch.setattr(ref_fused, "SCAN_HBM_BUDGET", 4 * 4 * N)
    with pytest.raises(AttributeError, match="scan_view"):
        _ref_fragment(rs, smoke.SF100_Q6)
    with pytest.raises(KeyError, match="no host rows"):
        ext.session().query(smoke.SF100_Q6)
    monkeypatch.undo()
    assert ext.session().query(smoke.SF100_Q6) == \
        smoke.expected_sf100_q6(tables)


def _ref_external(tables):
    """The reference's one-datanode session over the same tables
    registered as external (bench.py's stub stores), and its one-device
    executor on ``session.fx1``."""
    from opentenbase_tpu.engine import Cluster as RefCluster

    ref = RefCluster(num_datanodes=1, shard_groups=16)
    rs = ref.session()
    for ddl in smoke.SF100_DDL:
        rs.execute(ddl)
    rs.fx1 = RefFused(ref.catalog, ref.stores, mesh=_mesh1())
    stats = smoke.sf100_stats(N)
    for t, cols in tables.items():
        meta = ref.catalog.get(t)
        node = meta.node_indices[0]
        rows = len(next(iter(cols.values())))
        ref.stores[node][t] = smoke.ExtStore(rows)
        meta.stats = stats[t]
        rs.fx1.cache.register_external(
            t, meta, (node,), {c: a.reshape(1, rows)
                               for c, a in cols.items()}, [rows])
    return rs


def _ref_fragment(rs, sql):
    c = rs.cluster
    dp = ref_distribute(ref_optimize(ref_analyze(ref_parse(sql)[0],
                                                 c.catalog), c.catalog),
                        c.catalog)
    return rs.fx1.fragment_output(dp.fragments[0], c.gts.snapshot_ts(),
                                  rs._dicts_view(), [], use_pallas=False)


@pytest.fixture(scope="module")
def stores_pair():
    rng = np.random.default_rng(5)
    n = 3000
    tables = {"t": {"a": rng.integers(0, 100, n).astype(np.int32),
                    "b": rng.integers(0, 10**6, n).astype(np.int64)}}
    return _pair1(["create table t (a int, b bigint) "
                   "distribute by roundrobin"], tables=tables)


SQL_T = "select sum(b), count(*) from t where a < 40"


def _ref_streams(rs, monkeypatch) -> bool:
    """Whether the reference's fused fragment streams SQL_T in chunks
    (its ``_fragment_chunked`` answers) on a one-device executor."""
    c = rs.cluster
    called = []

    def chunked(self, *a, **kw):
        called.append(True)
        return None

    monkeypatch.setattr(RefFused, "_fragment_chunked", chunked)
    fx = RefFused(c.catalog, c.stores, mesh=_mesh1())
    dp = ref_distribute(ref_optimize(ref_analyze(ref_parse(SQL_T)[0],
                                                 c.catalog), c.catalog),
                        c.catalog)
    fx.fragment_output(dp.fragments[0], c.gts.snapshot_ts(),
                       rs._dicts_view(), [], use_pallas=False)
    return bool(called)


@pytest.mark.parametrize("margin,streams", [(-1, True), (0, False)],
                         ids=["past_the_budget", "at_the_budget"])
def test_chunk_trigger_where_the_reference_streams(stores_pair, monkeypatch,
                                                   margin, streams):
    """The budget one byte below, then exactly at, the scan's padded
    footprint (both packages model it alike): the reference streams
    chunks past it, and so does the port (its chunked scans count one
    more), with the reference's answer either way."""
    rs, port, ps = stores_pair
    meta = port.catalog.get("t")
    fx = port.fused_executor()
    fx.cache._tables.clear()  # the padded estimate: nothing resident
    foot = fx._scan_footprint(meta, ["a", "b"])
    ref_foot = RefFused(rs.cluster.catalog, rs.cluster.stores,
                        mesh=_mesh1())._scan_footprint(
        rs.cluster.catalog.get("t"), ["a", "b"])
    assert foot == ref_foot
    budget = foot[0] + margin
    monkeypatch.setattr(fused, "SCAN_HBM_BUDGET", budget)
    monkeypatch.setattr(ref_fused, "SCAN_HBM_BUDGET", budget)
    assert _ref_streams(rs, monkeypatch) == streams
    before = fx.cache.stats["chunked_scans"]
    assert ps.query(SQL_T) == rs.query(SQL_T)
    assert fx.cache.stats["chunked_scans"] - before == int(streams)

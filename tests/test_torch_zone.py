"""Zone windows of the port's fragment program against the reference:
CREATE INDEX registers zone-map columns and builds every shard's block
min/max; a fragment-program scan whose predicate bounds such a column
reads only each shard's window of candidate blocks
(opentenbase_tpu/executor/fused.py:1310), and its answer never changes.

The shapes are tests/test_zone_maps.py's (:37, :55, :73, :82) over the
same ship-date-sorted table in a reference and a port cluster: the
pruned answer equals the full scan's and the reference's, the port's
``zone_stats`` move as the reference's one-device executor's do for the
same fragment, an UPDATE that moves a row into the window is seen, and an
unsorted column gets no window. The reference's kernel is off (its
``enable_pallas_scan``), and the port's kernel route is stepped over the
same way where a shape is K1's, since both packages skip zone windows on
the kernel route."""

import jax
import numpy as np
import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.executor.fused import FusedExecutor as RefFused
from opentenbase_tpu.plan.analyze import analyze_statement as ref_analyze
from opentenbase_tpu.plan.distribute import (
    distribute_statement as ref_distribute,
)
from opentenbase_tpu.plan.optimize import optimize_statement as ref_optimize
from opentenbase_tpu.sql.parser import parse as ref_parse
from opentenbase_tpu_torch import Cluster
from opentenbase_tpu_torch.executor import fused
from opentenbase_tpu_torch.executor.fused import FusedExecutor
from opentenbase_tpu_torch.storage.table import zone_candidate_blocks

Q = ("select count(*), sum(price) from zt "
     "where ship >= date '1994-01-01' and ship < date '1994-02-01'")
# a shape K1's certifier declines (min): the program route by itself
Q_MIN = ("select count(*), sum(price), min(price), max(k) from zt "
         "where ship >= date '1994-01-01' and ship < date '1994-02-01'")


@pytest.fixture()
def zt(monkeypatch):
    """tests/test_zone_maps.py's table (20 000 rows loaded in ship-date
    order, round robin over 2 datanodes) and its index, in both
    packages; the kernel route off in both."""
    n = 20000
    days = np.sort(8036 + (np.arange(n) * 2556 // n))
    base = np.datetime64("1970-01-01")
    rows = ",".join(f"({i}, '{base + int(d)}', {i % 997}.25)"
                    for i, d in enumerate(days))
    rs = RefCluster(num_datanodes=2, shard_groups=16).session()
    ps = Cluster(num_datanodes=2, shard_groups=16, device="cpu").session()
    for stmt in ("create table zt (k bigint, ship date, "
                 "price numeric(10,2)) distribute by roundrobin",
                 "insert into zt values " + rows,
                 "create index zt_ship on zt (ship)"):
        rs.execute(stmt)
        ps.execute(stmt)
    rs.execute("set enable_pallas_scan = off")
    monkeypatch.setattr(FusedExecutor, "_scan_agg", lambda *a: None)
    return rs, ps


def _host(rs, sql):
    rs.execute("set enable_fused_execution = off")
    try:
        return rs.query(sql)
    finally:
        rs.execute("set enable_fused_execution = on")


def _ref_zone_stats(rs, sql) -> dict:
    """The reference's zone_stats after its fragment for ``sql`` on a
    one-device executor."""
    c = rs.cluster
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:1]), ("dn",))
    fx = RefFused(c.catalog, c.stores, mesh=mesh1)
    dp = ref_distribute(ref_optimize(ref_analyze(ref_parse(sql)[0],
                                                 c.catalog), c.catalog),
                        c.catalog)
    fx.fragment_output(dp.fragments[0], c.gts.snapshot_ts(),
                       rs._dicts_view(), [], use_pallas=False)
    return dict(fx.zone_stats)


def _pruned(rs, ps, sql) -> list:
    """The port's rows for ``sql`` (equal to the reference host's and
    fused answers), and its zone_stats' move equal to the reference's."""
    fx = ps.cluster.fused_executor()
    before = dict(fx.zone_stats)
    got = ps.query(sql)
    assert got == _host(rs, sql) == rs.query(sql)
    assert fx.last_route == "program"
    moved = {k: fx.zone_stats[k] - before[k] for k in before}
    assert moved == _ref_zone_stats(rs, sql)
    return got, moved


@pytest.mark.parametrize("sql", [Q, Q_MIN], ids=["k1_shape", "min"])
def test_pruned_scan_matches_full_scan(zt, sql):
    """:37 and :82: the window prunes blocks, and the same query with
    the index's columns dropped (the full scan) answers the same."""
    rs, ps = zt
    got, moved = _pruned(rs, ps, sql)
    assert got[0][0] > 0
    assert moved["pruned_blocks"] > 0
    assert moved["total_blocks"] > moved["pruned_blocks"]
    meta = ps.cluster.catalog.get("zt")
    saved = set(meta.zone_cols)
    meta.zone_cols.clear()
    fx = ps.cluster.fused_executor()
    before = dict(fx.zone_stats)
    assert ps.query(sql) == got
    assert fx.zone_stats == before
    meta.zone_cols.update(saved)


def test_pruning_engages_on_every_shard(zt):
    """:55: both shards' windows leave blocks out (the reference's host
    executor prunes the same table; here the device window does)."""
    rs, ps = zt
    fx = ps.cluster.fused_executor()
    meta = ps.cluster.catalog.get("zt")
    m = fused._match_partial_fragment(_fragment_root(ps, Q))
    dtab = fx.cache.get("zt", meta, ps.cluster.stores, meta.node_indices,
                        columns=m.scan.columns)
    starts, width = fx._zone_window(m, meta, dtab)
    assert width < dtab.rmax
    assert all(0 <= s <= dtab.rmax - width for s in starts)
    for n in meta.node_indices:  # each shard leaves blocks out
        store = ps.cluster.stores[n]["zt"]
        cand = zone_candidate_blocks(store, {"ship": (8766, 8796)})
        assert 0 < cand.sum() < len(cand)


def _fragment_root(ps, sql):
    from opentenbase_tpu_torch.plan import analyze_statement
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse

    cat = ps.cluster.catalog
    dp = distribute_statement(
        optimize_statement(analyze_statement(parse(sql)[0], cat), cat), cat)
    return dp.fragments[0].root


def test_update_invalidates_zone_maps(zt):
    """:73: a row moved into the window from far outside it is counted
    (the zone maps rebuild from the store's new version)."""
    rs, ps = zt
    before, _m = _pruned(rs, ps, Q_MIN)
    for s in (rs, ps):
        s.execute("update zt set ship = date '1994-01-15' where k = 0")
    after, _m = _pruned(rs, ps, Q_MIN)
    assert after[0][0] == before[0][0] + 1


def test_unsorted_column_gets_no_window(zt):
    """:82's second query: an index on a column whose blocks all span
    its range leaves nothing to prune, and the answer is the full
    scan's."""
    rs, ps = zt
    for s in (rs, ps):
        s.execute("create index zt_price on zt (price)")
    sql = "select sum(price), min(k) from zt where price between 5 and 90"
    got, moved = _pruned(rs, ps, sql)
    assert moved == {"pruned_blocks": 0, "total_blocks": 0}
    assert got[0][0] is not None

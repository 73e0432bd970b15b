"""The chunked scan of the port's fused fragment against the reference: a
scan whose resident footprint passes ``SCAN_HBM_BUDGET`` streams
shard-row windows (``DeviceCache.get_window``) through the fragment
program, and the windows' partials merge exactly at the coordinator
(opentenbase_tpu/executor/fused.py:1253, :338).

The budget is monkeypatched in both packages, as tests/test_chunked_scan.py
does. Each answer equals the reference session's with the kernel off
(the reference's fused path streams the same scan), and the windows the
port ran equal those of the reference's fragment on a one-device
executor (its 8-device suite mesh pads the shards and sizes windows
apart). The kernel (K1) never launches on a chunked scan, even where its
certifier takes the fragment, and only the latest window stays
resident."""

import jax
import numpy as np
import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.executor import fused as ref_fused
from opentenbase_tpu.executor.fused import FusedExecutor as RefFused
from opentenbase_tpu.plan.analyze import analyze_statement as ref_analyze
from opentenbase_tpu.plan.distribute import (
    distribute_statement as ref_distribute,
)
from opentenbase_tpu.plan.optimize import optimize_statement as ref_optimize
from opentenbase_tpu.sql.parser import parse as ref_parse
from opentenbase_tpu_torch import Cluster
from opentenbase_tpu_torch.executor import fused
from opentenbase_tpu_torch.ops import scan_agg as sa

BUDGET = 200_000


@pytest.fixture()
def small_budget(monkeypatch):
    monkeypatch.setattr(ref_fused, "SCAN_HBM_BUDGET", BUDGET)
    monkeypatch.setattr(fused, "SCAN_HBM_BUDGET", BUDGET)


@pytest.fixture()
def k1_calls(monkeypatch):
    """Every call of K1's wrapper (the CPU path launches nothing, so the
    launch counter cannot tell)."""
    calls = []
    real = sa.scan_agg

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(sa, "scan_agg", counting)
    return calls


def _pair(ddl, inserts):
    """The same statements in a reference and a port cluster (2
    datanodes, 16 shard groups), the reference's kernel off."""
    rs = RefCluster(num_datanodes=2, shard_groups=16).session()
    ps = Cluster(num_datanodes=2, shard_groups=16, device="cpu").session()
    for stmt in [*ddl, *inserts]:
        rs.execute(stmt)
        ps.execute(stmt)
    rs.execute("set enable_pallas_scan = off")
    return rs, ps


def _ref_windows(rs, sql) -> tuple:
    """(chunked scans, windows) of the reference's fragment for ``sql``
    on a one-device executor."""
    c = rs.cluster
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:1]), ("dn",))
    fx = RefFused(c.catalog, c.stores, mesh=mesh1)
    dp = ref_distribute(ref_optimize(ref_analyze(ref_parse(sql)[0],
                                                 c.catalog), c.catalog),
                        c.catalog)
    fx.fragment_output(dp.fragments[0], c.gts.snapshot_ts(),
                       rs._dicts_view(), [], use_pallas=False)
    return (fx.cache.stats.get("chunked_scans", 0),
            fx.cache.stats.get("scan_chunks", 0))


def _streams(rs, ps, sql) -> list:
    """The port's rows for ``sql``, held to the reference session's, to
    one chunked scan and to the reference's window count."""
    stats = ps.cluster.fused_executor().cache.stats
    before = (stats["chunked_scans"], stats["scan_chunks"])
    got = ps.query(sql)
    assert got == rs.query(sql)
    moved = (stats["chunked_scans"] - before[0],
             stats["scan_chunks"] - before[1])
    assert moved == _ref_windows(rs, sql)
    assert moved[0] == 1 and moved[1] >= 2
    return got


@pytest.fixture()
def big(small_budget):
    n = 30_000
    rng = np.random.default_rng(3)
    rows = ",".join(f"({i}, {i % 1000}.50, {int(g)})"
                    for i, g in zip(range(n), rng.integers(0, 5, n)))
    return _pair(["create table big (k bigint, v numeric(10,2), g int) "
                  "distribute by roundrobin"],
                 ["insert into big values " + rows])


@pytest.mark.parametrize("sql", [
    "select count(*), sum(v) from big where k >= 7",
    "select g, count(*), sum(v) from big group by g order by g",
    "select g, min(v), max(k), avg(v) from big where k % 3 = 1 "
    "group by g order by g",
], ids=["scalar", "grouped", "min_max_avg"])
def test_chunked_scan_agg_matches(big, k1_calls, sql):
    """tests/test_chunked_scan.py:20: the scalar and grouped partials of
    every window merge exactly; the first two shapes are K1's (its
    certifier takes them), yet the chunked scan never launches it."""
    rs, ps = big
    got = _streams(rs, ps, sql)
    assert got and got[0][0] is not None
    assert k1_calls == []
    assert ps.cluster.fused_executor().last_route == "program"


def test_only_the_latest_window_stays_resident(big):
    rs, ps = big
    cache = ps.cluster.fused_executor().cache
    ps.query("select count(*), sum(v) from big where k >= 7")
    keys = [k for k in cache._tables if k[0] == "big"]
    assert len(keys) == 1 and keys[0][2] == "win"
    start, width = keys[0][3], keys[0][4]
    nrows = max(st.nrows for st in
                (ps.cluster.stores[n]["big"] for n in (0, 1)))
    assert start < nrows <= start + width and start > 0


def test_chunked_sees_writes_and_deletes(small_budget):
    """tests/test_chunked_scan.py:51: a DELETE and an INSERT between
    chunked scans, each window read at the current snapshot."""
    n = 20_000
    rs, ps = _pair(["create table big2 (k bigint, v bigint) "
                    "distribute by roundrobin"],
                   ["insert into big2 values "
                    + ",".join(f"({i}, 1)" for i in range(n))])
    sql = "select sum(v), count(*) from big2"
    assert _streams(rs, ps, sql) == [(n, n)]
    for stmt in ("delete from big2 where k < 100",
                 "insert into big2 values (999999, 5)"):
        rs.execute(stmt)
        ps.execute(stmt)
    assert _streams(rs, ps, sql) == [(n - 100 + 5, n - 99)]


def test_under_the_budget_no_window(big, monkeypatch):
    """At a budget above the footprint the scan stays resident whole and
    K1's route answers, as before."""
    rs, ps = big
    monkeypatch.setattr(fused, "SCAN_HBM_BUDGET", 10**12)
    sql = "select count(*), sum(v) from big where k >= 7"
    stats = ps.cluster.fused_executor().cache.stats
    before = stats["chunked_scans"]
    assert ps.query(sql) == rs.query(sql)
    assert stats["chunked_scans"] == before
    assert ps.cluster.fused_executor().last_route == "scan_agg"

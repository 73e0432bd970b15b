"""The port's fused DAG against the reference: SSB query flight 1 (Q1.1,
Q1.2, Q1.3) over identical seeded lineorder and DATE rows in a reference
``Cluster(num_datanodes=2)`` and a port ``Cluster(..., device="cpu")``
loaded through ``carry.load_table``. ``Session.query`` must return
identical tuples, equal to numpy over the same arrays (exact: integer
sums). DATE is placed both by replication and round robin; further
dimensions drive the fold route (dense keys) and the retry ladder
(duplicate keys: radix -> sort-merge -> flipped build side).

The reference here runs on the suite's 8 virtual devices, with
exchanges; the port runs the one-device form. Join-mode notes are
compared against the reference's DAG runner on a one-device mesh."""

import importlib.util
import os

import jax
import numpy as np
import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.executor.fused import FusedExecutor as RefFused
from opentenbase_tpu.executor.fused_dag import DagRunner as RefDagRunner
from opentenbase_tpu.executor.local import LocalExecutor as RefLocal
from opentenbase_tpu.plan.analyze import analyze_statement
from opentenbase_tpu.plan.distribute import distribute_statement
from opentenbase_tpu.plan.optimize import optimize_statement
from opentenbase_tpu.sql.parser import parse
from opentenbase_tpu.storage.column import Column as RefColumn
from opentenbase_tpu.storage.table import ColumnBatch as RefBatch
from opentenbase_tpu_torch import Cluster, NotPorted, carry
from opentenbase_tpu_torch.ops import radix_probe as rp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
)
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)  # numpy only at import: the generators

ROWS = 30_000
SEED = 1


def _ref_append(cluster, table, arrays) -> None:
    """bench.py's _bulk_append on the reference cluster."""
    meta = cluster.catalog.get(table)
    n = len(next(iter(arrays.values())))
    nn = len(meta.node_indices)
    ts = cluster.gts.get_gts()
    for i, node in enumerate(meta.node_indices):
        sl = (
            slice(0, n) if meta.dist.is_replicated
            else slice(i * n // nn, (i + 1) * n // nn)
        )
        cols = {k: RefColumn(meta.schema[k], arrays[k][sl])
                for k in meta.schema}
        cluster.stores[node][table].append_batch(
            RefBatch(cols, sl.stop - sl.start), ts
        )


def _carry(ref, port, table) -> None:
    """Hand the reference's stored rows of ``table`` (every node, every
    replica) to the port as numpy arrays."""
    meta = ref.catalog.get(table)
    cols, xmins, xmaxs = {}, {}, {}
    for node in meta.node_indices:
        v = ref.stores[node][table].scan_view()
        cols[node] = {
            name: (np.array(v.col(name)), v.validity(name))
            for name in meta.schema
        }
        xmins[node] = np.array(v.xmin())
        xmaxs[node] = np.array(v.xmax())
    carry.load_table(port, table, cols, xmins, xmaxs)


def _pair(tables: dict, ddl: list):
    """(reference session, port cluster, port session) holding the same
    rows of ``tables`` (name -> arrays), created by ``ddl``."""
    ref = RefCluster(num_datanodes=2, shard_groups=256)
    rs = ref.session()
    port = Cluster(num_datanodes=2, device="cpu")
    ps = port.session()
    for stmt in ddl:
        rs.execute(stmt)
        ps.execute(stmt)
    for name, arrays in tables.items():
        _ref_append(ref, name, arrays)
        _carry(ref, port, name)
    return rs, port, ps


@pytest.fixture(scope="module", params=["replication", "roundrobin"])
def ssb(request):
    dd = smoke.make_date_dim()
    lo = smoke.make_lineorder(ROWS, dd, SEED)
    ddl = [smoke.SSB_DDL[0],
           smoke.SSB_DDL[1].replace("replication", request.param)]
    rs, port, ps = _pair({"lineorder": lo, "date_dim": dd}, ddl)
    return request.param, lo, dd, rs, port, ps


def _runner(port):
    return port.fused_executor()._dag


@pytest.mark.parametrize("q", sorted(smoke.SSB_Q))
def test_ssb_flight1_matches_reference(ssb, q):
    _dist, lo, dd, rs, port, ps = ssb
    sql = smoke.SSB_Q[q]
    want = rs.query(sql)
    n0 = rp.radix_probe.launches
    got = ps.query(sql)
    assert got == want == smoke.expected_ssb(lo, dd, q)
    assert want[0][0] is not None
    assert "radix" in _runner(port).last_join_modes
    assert _runner(port).last_mode == "scalar"
    assert rp.radix_probe.launches == n0, "the CPU launches no kernel"
    # the repeat skips the doomed fold: the retry state is remembered
    assert ps.query(sql) == want
    assert _runner(port).last_join_modes == ("radix",)


def _mesh1_modes(rs, sql):
    """The reference's DAG runner on a one-device mesh: its answer and
    join-mode notes for ``sql`` (a fresh runner, as on a first query)."""
    c = rs.cluster
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:1]), ("dn",))
    runner = RefDagRunner(RefFused(c.catalog, c.stores, mesh=mesh1))
    dp = distribute_statement(
        optimize_statement(analyze_statement(parse(sql)[0], c.catalog),
                           c.catalog),
        c.catalog,
    )
    snap = c.gts.snapshot_ts()
    idx, batch = runner.run(dp, snap, rs._dicts_view(), [])
    rows = RefLocal(c.catalog, {}, snap, remote_inputs={idx: batch},
                    subquery_values=[]).run_plan(dp.root).to_rows()
    return rows, runner.last_join_modes


def test_join_modes_match_one_device_reference(ssb):
    _dist, _lo, _dd, rs, port, ps = ssb
    sql = smoke.SSB_Q["Q1.1"].replace("1993", "1995")  # a fresh plan key
    want_rows, want_modes = _mesh1_modes(rs, sql)
    assert ps.query(sql) == want_rows
    assert _runner(port).last_join_modes == want_modes == ("fold", "radix")


def test_filter_nothing_passes_is_null(ssb):
    _dist, _lo, _dd, rs, _port, ps = ssb
    sql = smoke.SSB_Q["Q1.1"].replace("1993", "2001")
    assert ps.query(sql) == rs.query(sql) == [(None,)]


def test_min_max_count_over_the_join(ssb):
    _dist, _lo, _dd, rs, _port, ps = ssb
    sql = (
        "select min(lo_quantity), max(lo_extendedprice), count(*), "
        "sum(lo_discount), min(d_weeknuminyear) from lineorder, date_dim "
        "where lo_orderdate = d_datekey and d_year = 1995 "
        "and lo_discount < 4"
    )
    want = rs.query(sql)
    assert ps.query(sql) == want
    assert want[0][2] > 0


def test_single_table_aggregate_over_date_dim(ssb):
    """Round robin: K1's route answers. Replication: the aggregate runs
    whole on one node and ships final rows, so K1's route declines it
    and it reaches the DAG's rows mode — where the reference's DAG
    declines it too, for its host executor — which is not ported."""
    dist, _lo, _dd, rs, _port, ps = ssb
    sql = "select sum(d_year) from date_dim where d_year > 1995"
    if dist == "replication":
        with pytest.raises(NotPorted, match="rows mode"):
            ps.query(sql)
    else:
        assert ps.query(sql) == rs.query(sql)


@pytest.mark.parametrize("case", ["top-k", "rows"])
def test_grouped_join_is_not_ported(ssb, case):
    """What the DAG still refuses: join rows under ORDER BY ... LIMIT,
    which the reference ranks on the device (rows_topk), and a join with
    no aggregate (rows mode). The grouped join runs, ranked or not
    (tests/test_torch_dag_grouped.py, tests/test_torch_dag_topk.py)."""
    _dist, _lo, _dd, _rs, _port, ps = ssb
    sql, match = {
        "top-k": ("select lo_quantity, d_year from lineorder, date_dim "
                  "where lo_orderdate = d_datekey "
                  "order by lo_quantity limit 10", "rows_topk mode"),
        "rows": ("select lo_quantity, d_year from lineorder, date_dim "
                 "where lo_orderdate = d_datekey", "rows mode"),
    }[case]
    with pytest.raises(NotPorted, match=match):
        ps.query(sql)


@pytest.fixture(scope="module")
def dims():
    """lineorder beside two more dimensions: ``qdim`` keyed by quantity
    (1..50, dense: the fold route) and ``dupdim`` whose keys are
    DATE keys, each twice (the retry ladder)."""
    dd = smoke.make_date_dim()
    lo = smoke.make_lineorder(ROWS, dd, SEED + 1)
    rng = np.random.default_rng(SEED + 2)
    keys = np.arange(1, 51, dtype=np.int32)
    qdim = {"q_key": keys, "q_band": (keys // 10).astype(np.int32)}
    picked = rng.choice(dd["d_datekey"], 40, replace=False)
    dupdim = {"x_key": np.repeat(picked, 2).astype(np.int32),
              "x_w": rng.integers(1, 9, 80).astype(np.int32)}
    ddl = list(smoke.SSB_DDL) + [
        "create table qdim (q_key int, q_band int) distribute by "
        "replication",
        "create table dupdim (x_key int, x_w int) distribute by roundrobin",
    ]
    return _pair(
        {"lineorder": lo, "date_dim": dd, "qdim": qdim, "dupdim": dupdim},
        ddl,
    )


def test_dense_dimension_folds(dims):
    rs, port, ps = dims
    sql = ("select sum(lo_extendedprice), count(*) from lineorder, qdim "
           "where lo_quantity = q_key and q_band = 2")
    want = rs.query(sql)
    assert ps.query(sql) == want and want[0][1] > 0
    assert _runner(port).last_join_modes == ("fold",)
    assert _runner(port).last_folded == frozenset({0})
    assert _mesh1_modes(rs, sql) == (want, ("fold",))


def test_duplicate_build_keys_degrade_to_sortmerge(dims):
    """Every dupdim key is doubled: the fold and the radix table flag,
    sort-merge flags duplicates too, and the flipped build side (DATE,
    unique) answers."""
    rs, port, ps = dims
    sql = ("select count(*), sum(x_w), sum(d_year) from date_dim, dupdim "
           "where d_datekey = x_key")
    want = rs.query(sql)
    got = ps.query(sql)
    assert got == want and want[0][0] == 80
    runner = _runner(port)
    assert runner.last_join_modes == ("fold", "merge", "radix")
    skey = next(iter(runner._radix_off))
    assert runner._radix_off[skey] == {0} and runner._fold_off[skey] == {0}
    assert runner._orientations[skey] == ("L",)
    assert _mesh1_modes(rs, sql) == (want, ("fold", "merge", "radix"))


def test_insert_writes_every_replica():
    port = Cluster(num_datanodes=2, device="cpu")
    s = port.session()
    s.execute("create table r (k int, v bigint) distribute by replication")
    s.execute("insert into r values (1, 10), (2, 20), (3, null)")
    meta = port.catalog.get("r")
    assert [port.stores[n]["r"].nrows for n in meta.node_indices] == [3, 3]
    # a join reads one replica: no row of r counts twice
    s.execute("create table f (k int, w int) distribute by roundrobin")
    s.execute("insert into f values (1, 1), (1, 2), (2, 3), (3, 4), (4, 5)")
    assert s.query(
        "select sum(v), sum(w), count(*) from f, r where f.k = r.k"
    ) == [(40, 10, 4)]

"""The port's first slice end to end, held against the reference:
identical seeded lineitem rows in a reference ``Cluster(num_datanodes=2)``
(with ``enable_pallas_scan = on``, so the reference runs its Pallas
scan-aggregate kernel in interpret mode) and in the port's
``Cluster(..., device="cpu")``, loaded through ``carry.load_table``.
``Session.query`` must return identical tuples (exact equality: both
sides compute exact scaled-integer sums)."""

import numpy as np
import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.storage.column import Column as RefColumn
from opentenbase_tpu.storage.table import ColumnBatch as RefBatch
from opentenbase_tpu_torch import Cluster, carry
from opentenbase_tpu_torch.ops import scan_agg as sa

ROWS = 20_000

DDL = (
    "create table lineitem (l_orderkey bigint, l_quantity numeric(10,2), "
    "l_extendedprice numeric(12,2), l_discount numeric(4,2), "
    "l_shipdate date, l_returnflag int, l_linestatus int) "
    "distribute by roundrobin"
)
Q6 = (
    "select sum(l_extendedprice * l_discount) from lineitem "
    "where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' "
    "and l_discount between 0.05 and 0.07 and l_quantity < 24"
)
Q6_COUNT = Q6.replace(
    "select sum(l_extendedprice * l_discount)",
    "select sum(l_extendedprice * l_discount), count(*)",
)
Q1 = (
    "select l_returnflag, l_linestatus, sum(l_quantity), "
    "sum(l_extendedprice), sum(l_extendedprice * l_discount), "
    "count(*) from lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)
QUERIES = {"q6": Q6, "q6_count": Q6_COUNT, "q1": Q1}


def make_lineitem(n: int, seed: int):
    """bench.py's lineitem generator."""
    rng = np.random.default_rng(seed)
    n_orders = max(n // 4, 1)
    return {
        "l_orderkey": rng.integers(1, n_orders + 1, n).astype(np.int64),
        "l_quantity": (rng.uniform(1, 51, n) * 100).astype(np.int64),
        "l_extendedprice": (rng.uniform(900, 105000, n)).astype(np.int64),
        "l_discount": rng.integers(0, 11, n).astype(np.int64),
        "l_shipdate": (8036 + rng.integers(0, 2556, n)).astype(np.int32),
        "l_returnflag": rng.integers(0, 3, n).astype(np.int32),
        "l_linestatus": rng.integers(0, 2, n).astype(np.int32),
    }


def ref_append(cluster, arrays, lo, hi) -> None:
    """Append rows [lo, hi) split over the datanodes at one commit
    timestamp (bench.py's _bulk_append)."""
    meta = cluster.catalog.get("lineitem")
    commit_ts = cluster.gts.get_gts()
    nodes = meta.node_indices
    for i, node in enumerate(nodes):
        a = lo + i * (hi - lo) // len(nodes)
        b = lo + (i + 1) * (hi - lo) // len(nodes)
        cols = {
            name: RefColumn(meta.schema[name], arrays[name][a:b])
            for name in meta.schema
        }
        cluster.stores[node]["lineitem"].append_batch(
            RefBatch(cols, b - a), commit_ts
        )


def carry_over(ref, table="lineitem", device="cpu") -> Cluster:
    """A port cluster holding exactly the reference's stored rows: the
    arrays are read out of the reference stores here and handed over as
    numpy, so the port never sees a reference object."""
    port = Cluster(num_datanodes=2, device=device)
    port.session().execute(DDL)
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
    return port


def _ref_cluster():
    ref = RefCluster(num_datanodes=2, shard_groups=256)
    s = ref.session()
    s.execute(DDL)
    s.execute("set enable_pallas_scan = on")
    return ref, s


def _assert_ref_used_kernel(ref):
    fx = ref.fused_executor()
    assert any(
        isinstance(k, tuple) and k[0] == "pallas" and v is not False
        for k, v in fx._programs.items()
    ), "the reference did not run its Pallas kernel"
    assert not fx.pallas_fallbacks


@pytest.fixture(scope="module")
def one_commit():
    ref, rs = _ref_cluster()
    ref_append(ref, make_lineitem(ROWS, 42), 0, ROWS)
    port = carry_over(ref)
    return ref, rs, port, port.session()


@pytest.fixture(scope="module")
def two_commits():
    """Rows committed at two timestamps plus a committed delete: the
    port's device cache must take the full [S, Rmax] MVCC planes."""
    ref, rs = _ref_cluster()
    arrays = make_lineitem(ROWS, 43)
    ref_append(ref, arrays, 0, ROWS // 2)
    ref_append(ref, arrays, ROWS // 2, ROWS)
    rs.execute("delete from lineitem where l_orderkey < 300")
    port = carry_over(ref)
    return ref, rs, port, port.session()


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_slice_matches_reference(one_commit, q):
    ref, rs, port, ps_ = one_commit
    want = rs.query(QUERIES[q])
    _assert_ref_used_kernel(ref)
    got = ps_.query(QUERIES[q])
    assert got == want
    assert want and all(v is not None for v in want[0])
    (dtab,) = port.fused_executor().cache._tables.values()
    assert tuple(dtab.xmin.shape) == (2, 1)  # compact MVCC planes


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_slice_two_commit_timestamps_full_mvcc(two_commits, q):
    ref, rs, port, ps_ = two_commits
    want = rs.query(QUERIES[q])
    _assert_ref_used_kernel(ref)
    assert ps_.query(QUERIES[q]) == want
    (dtab,) = port.fused_executor().cache._tables.values()
    assert dtab.xmin.shape[1] == dtab.rmax > 1  # full MVCC planes


def test_insert_values_matches_reference():
    """DDL and INSERT ... VALUES through SQL on both sides (the shape of
    tests/test_pallas_scan.py's q6 fixture), then Q6 with a count."""
    ref, rs = _ref_cluster()
    port = Cluster(num_datanodes=2, device="cpu")
    ps_ = port.session()
    ps_.execute(DDL)
    rng = np.random.default_rng(3)
    rows = ",".join(
        f"({k}, {rng.uniform(1, 50):.2f}, {rng.uniform(900, 99000):.2f}, "
        f"0.0{rng.integers(0, 9)}, "
        f"'199{rng.integers(3, 6)}-0{rng.integers(1, 9)}-1{rng.integers(0, 9)}',"
        f" {rng.integers(0, 3)}, {rng.integers(0, 2)})"
        for k in range(2000)
    )
    for s in (rs, ps_):
        assert s.execute("insert into lineitem values " + rows).rowcount == 2000
    assert ps_.query(Q6_COUNT) == rs.query(Q6_COUNT)
    assert ps_.query(Q1) == rs.query(Q1)


def test_kernel_path_taken(one_commit):
    """Each query compiles one scan-aggregate program; the CPU run takes
    the kernel's plain version (no launch)."""
    _ref, _rs, port, ps_ = one_commit
    before = sa.scan_agg.launches
    ps_.query(Q6)
    fx = port.fused_executor()
    assert any(k[0] == "scan_agg" for k in fx._programs)
    assert sa.scan_agg.launches == before


def test_topk_plan_tries_the_dag_first(one_commit):
    """The reference's route order: a Limit(Sort(...)) coordinator plan
    goes to the fused DAG before K1's route, even for one fragment that
    K1's certifier would take. This small-domain grouped top-k runs in
    the DAG's gagg mode in the reference (on a one-device mesh) and in
    the port, with the same answer."""
    import jax

    from opentenbase_tpu.executor.fused import FusedExecutor as RefFused
    from opentenbase_tpu.executor.fused_dag import DagRunner as RefDag
    from opentenbase_tpu.plan.analyze import analyze_statement
    from opentenbase_tpu.plan.distribute import distribute_statement
    from opentenbase_tpu.plan.optimize import optimize_statement
    from opentenbase_tpu.sql.parser import parse

    ref, rs, port, ps_ = one_commit
    sql = ("select l_returnflag, sum(l_quantity) from lineitem "
           "group by l_returnflag order by 2 desc limit 2")
    want = rs.query(sql)
    assert rs._fused_via_dag
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:1]), ("dn",))
    runner = RefDag(RefFused(ref.catalog, ref.stores, mesh=mesh1))
    dp = distribute_statement(optimize_statement(
        analyze_statement(parse(sql)[0], ref.catalog), ref.catalog),
        ref.catalog)
    assert len(dp.fragments) == 1
    runner.run(dp, ref.gts.snapshot_ts(), rs._dicts_view(), [])
    assert ps_.query(sql) == want
    dag = port.fused_executor()._dag
    assert dag is not None, "the port never reached the fused DAG"
    assert dag.last_mode == runner.last_mode == "gagg"
    assert ps_._fused_via_dag
    # without the LIMIT the single fragment stays on K1's route
    ps_.query(sql.replace(" limit 2", ""))
    assert not ps_._fused_via_dag


@pytest.mark.parametrize(
    "sql",
    [
        # a join
        "select count(*) from lineitem a, lineitem b "
        "where a.l_orderkey = b.l_orderkey",
        # a scalar subquery (the coordinator's subplans)
        "select count(*) from lineitem "
        "where l_quantity < (select avg(l_quantity) from lineitem)",
        # a non-aggregate scan
        "select l_orderkey from lineitem where l_quantity < 2",
        # a statement outside the slice once: UPDATE runs since the
        # write path was ported, its RETURNING form since the DML slice
        # (the case keeps its earlier name)
        pytest.param("update lineitem set l_quantity = 1 "
                     "returning l_orderkey",
                     id="update lineitem set l_quantity = 1"),
    ],
)
def test_outside_the_slice_raises_not_ported(one_commit, sql):
    """Outside the fused slice. The join, the scalar subquery and the
    bare scan were refused once and are answered now by the host
    executor, as the reference's answers them (the cases keep their
    names); UPDATE ... RETURNING returns the reference's rows."""
    _ref, rs, _port, ps_ = one_commit
    assert sorted(ps_.query(sql)) == sorted(rs.query(sql))
    if not sql.startswith("update"):
        assert ps_.last_route == "host"


def test_text_and_nullable_columns_not_ported():
    """A NULL-able scan column and a TEXT predicate keep the fragment off
    the kernel's route (the reference's certifier takes neither); they
    once raised NotPorted here, and now run through the fragment
    program, as the reference's XLA-fused program runs them."""
    port = Cluster(num_datanodes=2, device="cpu")
    s = port.session()
    s.execute("create table t (a int, b bigint, c text) "
              "distribute by roundrobin")
    s.execute("insert into t (a, b) values (1, 2), (3, null)")
    before = sa.scan_agg.launches
    assert s.query("select sum(b), count(b), count(*) from t") == [(2, 1, 2)]
    fx = port.fused_executor()
    assert fx.last_route == "program" and fx.last_rung == ("scalar", None)
    s.execute("create table u (a int, c text) distribute by roundrobin")
    s.execute("insert into u values (1, 'x'), (2, 'y')")
    assert s.query("select count(*) from u where c = 'x'") == [(1,)]
    assert fx.last_route == "program"
    assert sa.scan_agg.launches == before


def test_wide_product_runs_in_the_fragment_program(one_commit):
    """An aggregate the certifier rejects (wide * wide) once raised
    NotPorted; the reference runs it through its XLA-fused program, and
    the port through its fragment program, with the same answer."""
    _ref, rs, port, ps_ = one_commit
    sql = "select sum(l_extendedprice * l_extendedprice) from lineitem"
    assert ps_.query(sql) == rs.query(sql)
    assert port.fused_executor().last_route == "program"

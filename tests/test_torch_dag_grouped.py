"""The port's fused DAG in its grouped mode against the reference: SSB
query flights 2-4 (Q2.1-Q4.3, as published) over identical seeded
lineorder, DATE, PART, SUPPLIER and CUSTOMER rows, with dictionary-coded
TEXT attributes, in a reference ``Cluster(num_datanodes=2)`` and a port
``Cluster(..., device="cpu")`` loaded through ``carry.load_table``.
``Session.query`` must return identical tuples, equal to numpy over the
same arrays (exact: integer sums, strings in Python's order).

The fact table is cut to 40 000 rows so the reference's CPU run stays
short; the dimensions are SSB's at SF 0.1, in the spec's proportions to
one another (part 20 000, supplier 200, customer 3 000), so that most
queries' filters still pass some rows. The mode and join-mode notes are
held against the reference's DAG runner on a one-device mesh, where it
runs the grouped mode (the suite's reference runs on 8 virtual devices).

Also covered: the group capacity's regrowth (the optimistic capacity
lowered in the test), the retry with one sort per key part when the
packed key's range passes 2^62, and a plan grouped by the shard key of
a sharded table (the absorbed projection)."""

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
from opentenbase_tpu_torch import Cluster, carry
from opentenbase_tpu_torch.executor import fused_dag
from opentenbase_tpu_torch.ops.filter import bucket_size

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
)
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)  # numpy only at import: the generators

ROWS = 40_000
DIM_SF = 0.1
SEED = 4


def _ref_append(cluster, table, arrays) -> None:
    """bench.py's _bulk_append on the reference cluster, TEXT columns
    coded into the table's dictionaries in order of first appearance; a
    sharded table's rows go where its locator routes their keys."""
    meta = cluster.catalog.get(table)
    arrays = {k: smoke.encode_text(meta, k, arrays[k]) for k in meta.schema}
    n = len(next(iter(arrays.values())))
    nn = len(meta.node_indices)
    cols = {k: RefColumn(meta.schema[k], arrays[k], None,
                         meta.dictionaries.get(k)) for k in meta.schema}
    batch = RefBatch(cols, n)
    if meta.dist.key_columns:
        routes = meta.locator.route_insert(
            {k: cols[k] for k in meta.dist.key_columns}, n)
        rows = {node: np.nonzero(routes == node)[0]
                for node in meta.node_indices}
    else:
        rows = {node: np.arange(n) if meta.dist.is_replicated
                else np.arange(i * n // nn, (i + 1) * n // nn)
                for i, node in enumerate(meta.node_indices)}
    ts = cluster.gts.get_gts()
    for node, idx in rows.items():
        cluster.stores[node][table].append_batch(batch.take(idx), ts)


def _carry(ref, port, table) -> None:
    """Hand the reference's stored rows of ``table`` (every node, every
    replica) and its TEXT dictionaries to the port."""
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
    dicts = {k: list(d.values) for k, d in meta.dictionaries.items()}
    carry.load_table(port, table, cols, xmins, xmaxs, dicts)


def _pair(tables: dict, ddl):
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


@pytest.fixture(scope="module")
def ssb():
    dims = smoke.ssb_dim_rows(DIM_SF)
    dd = smoke.make_date_dim()
    tables = {
        "lineorder": smoke.make_lineorder(ROWS, dd, SEED, dims),
        "date_dim": dd,
        "part": smoke.make_part(dims["part"], SEED + 1),
        "supplier": smoke.make_supplier(dims["supplier"], SEED + 2),
        "customer": smoke.make_customer(dims["customer"], SEED + 3),
    }
    rs, port, ps = _pair(tables, smoke.SSB_FULL_DDL)
    return tables, rs, port, ps


def _runner(port):
    return port.fused_executor()._dag


def _mesh1(rs, sql):
    """The reference's DAG runner on a one-device mesh: its answer, mode
    and join-mode notes for ``sql`` (a fresh runner, as on a first
    query)."""
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
    return rows, runner.last_mode, runner.last_join_modes


@pytest.mark.parametrize("q", sorted(smoke.SSB_GROUPED_Q))
def test_ssb_flights_2_to_4_match_reference(ssb, q):
    tables, rs, port, ps = ssb
    sql = smoke.SSB_GROUPED_Q[q]
    got = ps.query(sql)
    runner = _runner(port)
    mode, join_modes = runner.last_mode, runner.last_join_modes
    want = smoke.expected_ssb_grouped(tables, q)
    assert got == want
    assert rs.query(sql) == want
    assert (got, mode, join_modes) == _mesh1(rs, sql)
    assert mode == "grouped" and join_modes == ("fold", "radix")
    # a repeat skips the doomed fold of DATE (the other dimensions still
    # fold) and starts at the capacity that fit
    assert ps.query(sql) == want
    assert runner.last_join_modes == ("fold", "radix")
    skey = next(k for k in runner._fold_off if len(runner._fold_off[k]))
    assert skey in runner._orientations


def test_most_answers_are_not_empty(ssb):
    """The scale is large enough that the parity above compares groups,
    not empty answers, for all but the most selective queries."""
    tables, *_ = ssb
    sizes = {q: len(smoke.expected_ssb_grouped(tables, q))
             for q in smoke.SSB_GROUPED_Q}
    assert sum(1 for n in sizes.values() if n) >= 8, sizes


def test_group_capacity_regrows(ssb, monkeypatch):
    """A capacity below the group count: the run finds more groups than
    fit, reruns once at the bucketed count, and remembers it, so a
    repeat compiles nothing new."""
    tables, rs, port, ps = ssb
    monkeypatch.setattr(fused_dag, "OPTIMISTIC_GROUP_CAP", 4)
    sql = smoke.SSB_GROUPED_Q["Q2.1"].replace("AMERICA", "AFRICA")
    want = rs.query(sql)
    assert len(want) > 4
    runner = _runner(port)
    before = set(runner._programs)
    assert ps.query(sql) == want
    caps = {k[6] for k in set(runner._programs) - before}
    assert caps == {4, bucket_size(len(want) + 1)}
    assert bucket_size(len(want) + 1) in runner._caps.values()
    n_programs = len(runner._programs)
    assert ps.query(sql) == want
    assert len(runner._programs) == n_programs


@pytest.fixture(scope="module")
def wide():
    """A fact table whose two BIGINT group keys span 2^40 each (their
    packed range passes 2^62), beside a small dense dimension, and a
    fact table sharded by its key."""
    rng = np.random.default_rng(SEED + 9)
    n = 3000
    fact = {
        "f_dim": rng.integers(1, 21, n).astype(np.int32),
        "f_a": rng.choice([-(2**40), 0, 2**40], n).astype(np.int64),
        "f_b": rng.choice([-(2**40), 7, 2**40], n).astype(np.int64),
        "f_v": rng.integers(-50, 50, n).astype(np.int32),
    }
    dim = {"g_key": np.arange(1, 21, dtype=np.int32),
           "g_tag": np.array([f"t{i % 3}" for i in range(20)])}
    sharded = {"h_key": rng.integers(0, 40, n).astype(np.int32),
               "h_dim": rng.integers(1, 21, n).astype(np.int32),
               "h_v": rng.integers(0, 1000, n).astype(np.int64)}
    ddl = [
        "create table wfact (f_dim int, f_a bigint, f_b bigint, f_v int) "
        "distribute by roundrobin",
        "create table wdim (g_key int, g_tag text) distribute by "
        "replication",
        "create table hfact (h_key int, h_dim int, h_v bigint) "
        "distribute by shard(h_key)",
    ]
    return _pair({"wfact": fact, "wdim": dim, "hfact": sharded}, ddl)


def test_packed_range_overflow_retries_per_key(wide):
    rs, port, ps = wide
    sql = ("select f_a, f_b, g_tag, sum(f_v), count(*), min(f_v), "
           "max(f_v) from wfact, wdim where f_dim = g_key "
           "group by f_a, f_b, g_tag order by f_a, f_b, g_tag")
    want = rs.query(sql)
    assert len(want) == 27
    assert ps.query(sql) == want
    runner = _runner(port)
    assert runner.last_mode == "grouped"
    assert list(runner._packing.values()) == [False]
    assert _mesh1(rs, sql)[:2] == (want, "grouped")


def test_grouped_by_shard_key_ships_complete_groups(wide):
    """Grouping by the shard key makes each node's groups complete: the
    final fragment projects the aggregate and the coordinator merges
    nothing; the DAG absorbs the projection and re-applies it."""
    rs, port, ps = wide
    sql = ("select g_tag, h_key, sum(h_v) as s from hfact, wdim "
           "where h_dim = g_key group by h_key, g_tag "
           "order by h_key, g_tag")
    cat = port.catalog
    from opentenbase_tpu_torch.plan import analyze_statement as p_an
    from opentenbase_tpu_torch.plan.distribute import (
        distribute_statement as p_dist)
    from opentenbase_tpu_torch.plan.optimize import (
        optimize_statement as p_opt)
    from opentenbase_tpu_torch.sql import parse_one
    dp = p_dist(p_opt(p_an(parse_one(sql), cat), cat), cat)
    root = dp.fragments[-1].root
    while type(root).__name__ in ("Sort", "Limit"):
        root = root.child
    assert type(root).__name__ == "Project"
    assert type(root.child).__name__ == "Aggregate"
    want = rs.query(sql)
    assert len(want) > 40
    assert ps.query(sql) == want
    assert _runner(port).last_mode == "grouped"
    assert _mesh1(rs, sql)[:2] == (want, "grouped")

"""Within-fragment parallel workers in the port (executor/local.py
``run_fragment_parallel``, ``LocalExecutor.scan_block``; dn/server.py's
``parallel`` branch), held against the serial plan and the reference:
tests/test_dn_process.py::test_parallel_fragment_matches_serial with
two datanode processes started with a tiny ``OTB_DN_PARALLEL_MIN_ROWS``
(set through the environment, as the reference's test sets it), and
the block merge in process over FLOAT8, DECIMAL, integer and NULL
groups: integer and DECIMAL sums and counts exact, FLOAT8 sums to a
relative 1e-6 (the blocks change the order of summation)."""

import numpy as np
import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.executor import local as ref_local
from opentenbase_tpu.plan import analyze_statement as ref_analyze
from opentenbase_tpu.plan.distribute import (
    distribute_statement as ref_distribute,
)
from opentenbase_tpu.plan.optimize import optimize_statement as ref_optimize
from opentenbase_tpu.sql import parse as ref_parse
from opentenbase_tpu_torch.engine import Cluster
from opentenbase_tpu_torch.executor import local as port_local
from opentenbase_tpu_torch.executor.dist import DistExecutor
from opentenbase_tpu_torch.plan import analyze_statement
from opentenbase_tpu_torch.plan.distribute import distribute_statement
from opentenbase_tpu_torch.plan.optimize import optimize_statement
from opentenbase_tpu_torch.sql import parse
from test_torch_dn import ref_query, topology_impl
from torch_pair import FLOAT8_REL, assert_same_rows

DN_QS = [
    "select count(*), sum(v), min(v), max(v) from t where k < 400",
    "select tag, count(*), sum(v) from t group by tag order by tag",
]


def _dplan(c, q):
    return distribute_statement(optimize_statement(
        analyze_statement(parse(q)[0], c.catalog), c.catalog), c.catalog)


@pytest.fixture()
def par_topology(tmp_path, monkeypatch):
    # the datanode processes inherit it: block workers engage on
    # test-sized tables
    monkeypatch.setenv("OTB_DN_PARALLEL_MIN_ROWS", "50")
    yield from topology_impl(tmp_path)


def test_parallel_fragment_matches_serial(par_topology):
    c, s, rs, _procs, _sender = par_topology
    s.execute("set enable_fused_execution = off")

    def counts():
        return [ch.rpc({"op": "ping"})["dml_stats"].get(
            "parallel_fragments", 0) for ch in c.dn_channels.values()]

    for q in DN_QS:
        want = ref_query(rs, q)
        dp = _dplan(c, q)
        got = {}
        for k in (1, 4):
            n0 = counts()
            ex = DistExecutor(c.catalog, c.stores, c.gts.snapshot_ts(),
                              device="cpu", dn_channels=c.dn_channels,
                              min_lsn=c.persistence.wal.position,
                              parallel_workers=k)
            got[k] = sorted(ex.run(dp).to_rows())
            assert all(i.get("remote") for i in ex.instrumentation)
            rose = [b - a for a, b in zip(n0, counts())]
            # one parallel fragment a datanode at 4 workers, none at 1
            assert rose == ([1, 1] if k == 4 else [0, 0]), (q, k, rose)
        assert got[1] == got[4] == sorted(want), (q, got, want)
    # the session's setting rides every remote fragment
    s.execute("set dn_parallel_workers = 4")
    n0 = counts()
    assert s.query(DN_QS[1]) == ref_query(rs, DN_QS[1])
    assert [b - a for a, b in zip(n0, counts())] == [1, 1]
    s.execute("set dn_parallel_workers = 1")
    n0 = counts()
    assert s.query(DN_QS[1]) == ref_query(rs, DN_QS[1])
    assert counts() == n0


ROWS = 1200
X_DDL = ("create table x (k bigint, g text, i int, d numeric(12,2), "
         "f float8) distribute by shard(k)")


def x_rows() -> list[str]:
    rng = np.random.default_rng(19)
    out = []
    for k in range(ROWS):
        g = rng.choice(["'a'", "'b'", "'c'", "null"])
        i = "null" if rng.random() < 0.1 else str(int(rng.integers(-50, 50)))
        d = f"{int(rng.integers(-99999, 99999)) / 100:.2f}"
        f = "null" if rng.random() < 0.05 else repr(float(rng.normal(0, 1e3)))
        out.append(f"({k}, {g}, {i}, {d}, {f})")
    return out


@pytest.fixture(scope="module")
def loaded():
    rc = RefCluster(num_datanodes=1, shard_groups=16)
    pc = Cluster(num_datanodes=1, shard_groups=16, device="cpu")
    rows = x_rows()
    for c in (rc, pc):
        s = c.session()
        s.execute(X_DDL)
        s.execute("insert into x values " + ",".join(rows))
        s.execute("delete from x where k % 97 = 3")  # dead rows in blocks
    yield rc, pc
    rc.close()
    pc.close()


BLOCK_QS = [
    # NULL groups, DECIMAL and integer sums exact, FLOAT8 to 1e-6
    "select g, count(*), count(i), sum(i), sum(d), min(d), max(f), "
    "sum(f) from x group by g",
    "select count(*), sum(d), sum(f), min(i), max(i) from x where i > -20",
    "select i, count(*), sum(d) from x where f > 0 group by i",
]


def _fragment(c, q, ref=False):
    if ref:
        dp = ref_distribute(ref_optimize(
            ref_analyze(ref_parse(q)[0], c.catalog), c.catalog), c.catalog)
    else:
        dp = _dplan(c, q)
    return dp.fragments[0].root


@pytest.mark.parametrize("q", BLOCK_QS)
def test_block_merge_matches_serial_and_reference(loaded, monkeypatch, q):
    monkeypatch.setenv("OTB_DN_PARALLEL_MIN_ROWS", "200")
    rc, pc = loaded
    node = pc.catalog.get("x").node_indices[0]
    plan = _fragment(pc, q)
    snap = pc.gts.snapshot_ts()
    par = port_local.run_fragment_parallel(
        pc.catalog, pc.stores[node], snap, plan, {}, [], 4, device="cpu")
    assert par is not None
    serial = port_local.LocalExecutor(
        pc.catalog, {}, stores=pc.stores[node], snapshot_ts=snap,
        device="cpu").run_plan(plan)
    rplan = _fragment(rc, q, ref=True)
    rnode = rc.catalog.get("x").node_indices[0]
    ref = ref_local.run_fragment_parallel(
        rc.catalog, rc.stores[rnode], rc.gts.snapshot_ts(), rplan, {}, [],
        4)
    assert ref is not None

    def key(r):
        return tuple((v is None, v) for v in r)

    got = sorted(par.to_rows(), key=key)
    assert_same_rows(got, sorted(serial.to_rows(), key=key), q, FLOAT8_REL)
    assert_same_rows(got, sorted(ref.to_rows(), key=key), q, FLOAT8_REL)
    # exact where the sum is not FLOAT8
    for col, oc in zip(zip(*got), plan.schema):
        if oc.type.id.name != "FLOAT8":
            assert list(col) == [r[plan.schema.index(oc)]
                                 for r in sorted(serial.to_rows(), key=key)]


def test_block_workers_upload_their_block_only(loaded, monkeypatch):
    """Each worker moves its own rows to the device: the blocks' uploads
    add up to one scan's, not K of them."""
    monkeypatch.setenv("OTB_DN_PARALLEL_MIN_ROWS", "200")
    _rc, pc = loaded
    node = pc.catalog.get("x").node_indices[0]
    plan = _fragment(pc, BLOCK_QS[1])
    snap = pc.gts.snapshot_ts()
    serial = port_local.LocalExecutor(pc.catalog, {}, stores=pc.stores[node],
                                      snapshot_ts=snap, device="cpu")
    serial.run_plan(plan)
    seen = []
    orig = port_local.LocalExecutor.run_plan

    def spy(self, root):
        out = orig(self, root)
        if self.scan_block is not None:
            seen.append((self.scan_block, self.h2d_bytes))
        return out

    monkeypatch.setattr(port_local.LocalExecutor, "run_plan", spy)
    assert port_local.run_fragment_parallel(
        pc.catalog, pc.stores[node], snap, plan, {}, [], 4,
        device="cpu") is not None
    assert len(seen) == 4
    blocks = sorted(b for b, _ in seen)
    assert blocks[0][0] == 0 and all(
        a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    assert sum(h for _, h in seen) < 2 * serial.h2d_bytes


def test_shapes_that_decline(loaded, monkeypatch):
    """The same fragments decline in both packages: DISTINCT does not
    merge block partials, a bare projection is no partial aggregate, a
    small table stays serial, a zone-prunable predicate keeps the pruned
    serial path (None); an avg reaches the fragment as its sum and
    count, which merge, and answers as the reference's."""
    monkeypatch.setenv("OTB_DN_PARALLEL_MIN_ROWS", "200")
    rc, pc = loaded
    node = pc.catalog.get("x").node_indices[0]
    snap = pc.gts.snapshot_ts()
    for q, declines in (("select g, avg(d) from x group by g", False),
                        ("select count(distinct g) from x", True),
                        ("select k, g from x where i > 3", True)):
        outs = []
        for c, mod, ref in ((pc, port_local, False), (rc, ref_local, True)):
            kw = {} if ref else {"device": "cpu"}
            outs.append(mod.run_fragment_parallel(
                c.catalog, c.stores[node], c.gts.snapshot_ts(),
                _fragment(c, q, ref), {}, [], 4, **kw))
        assert (outs[0] is None) is (outs[1] is None) is declines, q
        if not declines:
            assert sorted(outs[0].to_rows(), key=repr) == sorted(
                outs[1].to_rows(), key=repr)
    monkeypatch.setenv("OTB_DN_PARALLEL_MIN_ROWS", "1000000")
    assert port_local.run_fragment_parallel(
        pc.catalog, pc.stores[node], snap, _fragment(pc, BLOCK_QS[1]), {},
        [], 4, device="cpu") is None
    monkeypatch.setenv("OTB_DN_PARALLEL_MIN_ROWS", "200")
    ps = pc.session()
    ps.execute("create index x_k on x (k)")
    rs = rc.session()
    rs.execute("create index x_k on x (k)")
    q = "select count(*), sum(d) from x where k < 100"
    for c, mod, ref in ((pc, port_local, False), (rc, ref_local, True)):
        kw = {} if ref else {"device": "cpu"}
        assert mod.run_fragment_parallel(
            c.catalog, c.stores[node], c.gts.snapshot_ts(),
            _fragment(c, q, ref), {}, [], 4, **kw) is None, ref

"""The port's distributed loop (executor/dist.py) and the session's host
route, against the reference session on the CPU.

- ``DistExecutor`` at 1 and 2 datanodes through each motion (gather,
  broadcast, redistribute), its instrumentation, and its executors on
  the cluster's device;
- tests/test_differential.py's generator (seeds 11 and 29): every query
  with the fused route off and on, at 1 and 2 datanodes, in both
  packages — the port's four answers agree with each other and with the
  reference's;
- scalar subqueries, nested, and the more-than-one-row error;
- reads inside a writing transaction (INSERT, UPDATE, DELETE, each
  followed by a SELECT; then ROLLBACK);
- TPC-H Q13 and Q18 at a small scale factor (chip_smoke's generator,
  with the phase-10 columns) against the reference and numpy;
- the route: the host executor takes exactly the fused executors'
  declines, and an error of another kind inside the fused path reaches
  the caller.
"""

import math
import random

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster
from opentenbase_tpu_torch.executor.dist import DistExecutor
from opentenbase_tpu_torch.executor.fused import FusedExecutor

from test_differential import _mk, _norm, _queries
from test_torch_dag_grouped import _pair, smoke

DT = ("create table dt (k bigint, g bigint, v bigint, w text, d bigint) "
      "distribute by shard(k)")
DT2 = "create table dt2 (d2 bigint, x bigint) distribute by shard(d2)"
REP = "create table rep (d2 bigint, x bigint) distribute by replication"


def _load(s, rows):
    """tests/test_differential.py's _load on either package's session,
    plus a replicated table."""
    s.execute(DT)
    s.execute("insert into dt values " + ",".join(
        "({}, {}, {}, {}, {})".format(
            k, g, v, "null" if w is None else f"'{w}'", d)
        for k, g, v, w, d in rows))
    s.execute(DT2)
    s.execute("insert into dt2 values " + ",".join(
        f"({i % 8}, {i * 7 % 40})" for i in range(24)))
    s.execute(REP)
    s.execute("insert into rep values (1, 2), (3, 4), (5, 6)")
    s.execute("analyze")
    return s


def _sessions(ndn, seed=11):
    rows = _mk(seed)
    rs = _load(RefCluster(num_datanodes=ndn, shard_groups=16).session(),
               rows)
    ps = _load(Cluster(num_datanodes=ndn, shard_groups=16,
                       device="cpu").session(), rows)
    return rs, ps


@pytest.fixture(scope="module", params=[1, 2], ids=["1dn", "2dn"])
def pair(request):
    return _sessions(request.param)


MOTIONS = {
    "broadcast": "select a.g, count(*) from dt a join dt2 b on a.d = b.d2 "
                 "where b.x > 10 group by a.g order by a.g",
    "redistribute": "select count(*) from dt a join dt2 b on a.g = b.x",
    "gather": "select count(*), sum(a.v) from dt a join rep b "
              "on a.d = b.d2",
    "left_join": "select a.k, b.x from dt a left join dt2 b on a.d = b.d2 "
                 "where a.k < 9 order by 1, 2",
    "correlated": "select count(*) from dt a where a.v > "
                  "(select avg(b.v) from dt b where b.g = a.g)",
    "union_all": "select k, w from dt where k < 6 union all "
                 "select d2, 'dt2' from dt2 where x < 10 order by 1, 2",
}


@pytest.mark.parametrize("name", sorted(MOTIONS))
def test_motions_match_reference(pair, name):
    rs, ps = pair
    ps.execute("set enable_fused_execution = off")
    got = ps.query(MOTIONS[name])
    assert _norm(got) == _norm(rs.query(MOTIONS[name]))
    ex = ps.last_executor
    assert ps.last_route == "host" and isinstance(ex, DistExecutor)
    assert ex.device == ps.cluster.device
    kinds = {m["kind"] for m in ex.motion_stats.values()}
    ndn = len(ps.cluster.stores)
    if ndn == 2 and name in ("broadcast", "redistribute"):
        assert name in kinds
    assert "gather" in kinds
    for rec in ex.instrumentation:
        assert rec["rows"] >= 0 and rec["ms"] >= 0
    assert ex.h2d_bytes > 0
    ps.execute("reset enable_fused_execution")


@pytest.mark.parametrize("seed", [11, 29])
def test_differential_generator_agrees(seed):
    """Every query of the reference's differential generator: the port's
    fused on/off at 1 and 2 datanodes agree with each other and with the
    reference's, fused off and on (2 datanodes)."""
    rows = _mk(seed)
    queries = _queries(random.Random(seed * 13))
    ref = _load(RefCluster(num_datanodes=2, shard_groups=16).session(), rows)
    ports = [_load(Cluster(num_datanodes=n, shard_groups=16,
                           device="cpu").session(), rows) for n in (1, 2)]
    bad = []
    for q in queries:
        ref.execute("set enable_fused_execution = off")
        want = _norm(ref.query(q))
        ref.execute("set enable_fused_execution = on")
        assert _norm(ref.query(q)) == want, q
        for ps in ports:
            for fused in ("off", "on"):
                ps.execute(f"set enable_fused_execution = {fused}")
                got = _norm(ps.query(q))
                if got != want:
                    bad.append((q, len(ps.cluster.stores), fused, got[:3],
                                want[:3]))
    assert not bad, bad[:3]


def test_scalar_subqueries(pair):
    rs, ps = pair
    for sql in (
        "select count(*) from dt where v > (select avg(v) from dt)",
        # nested: the inner subplan registers first
        "select count(*) from dt where v > (select avg(v) from dt "
        "where g > (select min(g) from dt))",
        # two at one level, one of them NULL (no rows)
        "select (select max(v) from dt where g = 2), "
        "(select max(v) from dt where g = 99)",
        "select k from dt where v = (select max(v) from dt) order by k",
    ):
        assert ps.query(sql) == rs.query(sql), sql
        assert ps.last_route == "host"
    sql = "select count(*) from dt where v > (select v from dt)"
    with pytest.raises(Exception) as want:
        rs.query(sql)
    with pytest.raises(RuntimeError, match="more than one row") as got:
        ps.query(sql)
    assert str(got.value) == str(want.value)


def test_reads_inside_a_writing_transaction(pair):
    rs, ps = pair
    reads = ("select count(*), sum(v), min(w), max(w) from dt",
             "select g, count(*), sum(v) from dt group by g order by g",
             "select a.g, count(*) from dt a join dt2 b on a.d = b.d2 "
             "group by a.g order by a.g")
    for s in (rs, ps):
        s.execute("begin")
    for write in ("insert into dt values (10001, 2, 77, 'new', 3), "
                  "(10002, 5, -3, null, 1)",
                  "update dt set v = v + 1000 where g = 1",
                  "delete from dt where k < 40"):
        for s in (rs, ps):
            s.execute(write)
        for sql in reads:
            assert _norm(ps.query(sql)) == _norm(rs.query(sql)), (write, sql)
            assert ps.last_route == "host"
    for s in (rs, ps):
        s.execute("rollback")
    for sql in reads:
        assert _norm(ps.query(sql)) == _norm(rs.query(sql))
    # outside the transaction the fused route answers again
    ps.query(reads[1])
    assert ps.last_route == "fused"


@pytest.fixture(scope="module")
def tpch_small():
    tables = smoke.make_q3_spec(0.004, 17)
    return tables, _pair(tables, smoke.Q3_SPEC_DDL)


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert (math.isclose(a, b, rel_tol=1e-12)
                    if isinstance(b, float) else a == b), (g, w)


def test_q13_small(tpch_small):
    tables, (rs, _port, ps) = tpch_small
    want = smoke.expected_q13(tables["orders"], tables["customer"])
    assert want[0][0] == 0 or any(c == 0 for c, _n in want)
    got = ps.query(smoke.Q13)
    assert got == rs.query(smoke.Q13) == want
    assert ps.last_route == "host"
    assert "radix" in ps.last_executor.join_modes


def test_q18_small(tpch_small):
    tables, (rs, _port, ps) = tpch_small
    sql = smoke.Q18.format(quantity=200)
    want, tie = smoke.expected_q18(tables["lineitem"], tables["orders"],
                                   tables["customer"], 200)
    assert want and not tie
    got = ps.query(sql)
    _close(got, want)
    _close(rs.query(sql), want)
    assert ps.last_route == "host"


def test_bare_scan_and_window_small(tpch_small):
    tables, (rs, _port, ps) = tpch_small
    want = smoke.expected_bare_scan(tables["lineitem"])
    assert want
    assert sorted(ps.query(smoke.BARE_SCAN)) == sorted(
        rs.query(smoke.BARE_SCAN)) == want
    want = smoke.expected_top3(tables["orders"])
    assert ps.query(smoke.TOP3_ORDERS) == rs.query(smoke.TOP3_ORDERS) == want


def test_host_route_takes_only_the_fused_declines(monkeypatch):
    """A plan the fused executors take stays there; a RuntimeError raised
    inside the fused path propagates instead of falling to the host
    route (the reference demotes it; the port does not)."""
    rs, ps = _sessions(2)
    sql = "select g, count(*), sum(v) from dt group by g order by g"
    assert ps.query(sql) == rs.query(sql)
    assert ps.last_route == "fused" and ps.last_executor is None

    def boom(self, *a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(FusedExecutor, "fragment_output", boom)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ps.query(sql)
    ps.execute("set enable_fused_execution = off")
    assert ps.query(sql) == rs.query(sql)
    assert ps.last_route == "host"


@pytest.mark.parametrize("make", ["local", "dist"])
def test_executors_run_on_the_card_unless_asked(make, monkeypatch):
    """No device given means the first CUDA device, and no CUDA is an
    error, as for ``Cluster``: neither executor quietly runs on the
    CPU."""
    import torch

    from opentenbase_tpu_torch.executor.local import LocalExecutor

    cat = Cluster(num_datanodes=1, device="cpu").catalog
    build = {"local": lambda **k: LocalExecutor(cat, **k),
             "dist": lambda **k: DistExecutor(cat, {}, **k)}[make]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    assert build(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert build().device == torch.device("cuda", 0)


def test_fused_merge_runs_where_its_partial_rows_say(monkeypatch):
    """The fused route merges a few partial rows on the CPU and, from
    ``MERGE_DEVICE_ROWS`` on, on the cluster's device; either way the
    answer is the reference's."""
    import torch

    from opentenbase_tpu_torch import engine

    class Card:
        device = torch.device("cuda", 0)

    rows = engine.MERGE_DEVICE_ROWS
    assert engine.merge_device(Card, rows - 1) == torch.device("cpu")
    assert engine.merge_device(Card, rows) == Card.device
    rs, ps = _sessions(2)
    sql = "select g, count(*), sum(v) from dt group by g order by g"
    seen = []
    real = engine.merge_device

    def spy(cluster, nrows):
        seen.append(nrows)
        return real(cluster, nrows)

    monkeypatch.setattr(engine, "merge_device", spy)
    monkeypatch.setattr(engine, "MERGE_DEVICE_ROWS", 1)
    assert ps.query(sql) == rs.query(sql)
    assert ps.last_route == "fused" and seen and seen[-1] >= 1


@pytest.mark.parametrize("keys", [(0,), (1,), (2,), (0, 1), (1, 2, 3)],
                         ids=["int64", "text", "int32", "int64+text",
                              "text+int32+bool"])
def test_device_placement_hash_matches_the_host_formula(keys):
    """The redistribute slots computed on the device are the reference's
    placement hash bit for bit (``hash_batch_columns``, NULL as 0, TEXT
    through its dictionary's string hashes), so a row lands where the
    host formula would route it."""
    import numpy as np
    import torch

    from opentenbase_tpu.executor.dist import (
        hash_batch_columns as ref_hash,
    )
    from opentenbase_tpu.storage.column import Column as RefColumn
    from opentenbase_tpu.storage.column import Dictionary as RefDict
    from opentenbase_tpu.storage.table import ColumnBatch as RefBatch
    from opentenbase_tpu_torch.executor.dist import hash_batch_columns
    from opentenbase_tpu_torch.executor.local import LocalExecutor
    from opentenbase_tpu_torch.plan import logical as L
    from opentenbase_tpu_torch.storage.column import Column
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    from opentenbase_tpu import types as rt
    from opentenbase_tpu_torch import types as pt

    ps = Cluster(num_datanodes=1, device="cpu").session()
    ps.execute("create table h (a bigint, s text, c int, b bool)")
    ps.execute("insert into h values (1, 'x', 1, true), (2, 'y', 2, false),"
               " (3, 'zz', 3, true)")
    cat = ps.cluster.catalog
    dic = cat.get("h").dictionaries["s"]
    rng = np.random.default_rng(len(keys))
    n = 500
    data = [rng.integers(-(2**62), 2**62, n), rng.integers(0, 3, n)
            .astype(np.int32), rng.integers(-(2**31), 2**31 - 1, n)
            .astype(np.int32), rng.random(n) > 0.5]
    valid = [rng.random(n) > 0.2 for _ in data]
    types = [pt.INT8, pt.TEXT, pt.INT4, pt.BOOL]
    rtypes = [rt.INT8, rt.TEXT, rt.INT4, rt.BOOL]
    schema = tuple(L.OutCol(f"c{i}", ty, "h.s" if ty.is_text else None)
                   for i, ty in enumerate(types))
    ex = LocalExecutor(cat, device="cpu")
    got = ex._placement_hash(
        [(torch.from_numpy(d), torch.from_numpy(v))
         for d, v in zip(data, valid)], schema, keys).numpy()
    host = hash_batch_columns(ColumnBatch({
        f"c{i}": Column(ty, d, v, dic if ty.is_text else None)
        for i, (ty, d, v) in enumerate(zip(types, data, valid))}, n),
        list(keys))
    rdic = RefDict(list(dic.values))
    want = ref_hash(RefBatch({
        f"c{i}": RefColumn(ty, d, v, rdic if ty.is_text else None)
        for i, (ty, d, v) in enumerate(zip(rtypes, data, valid))}, n),
        list(keys))
    assert got.tolist() == host.astype(np.int64).tolist() \
        == np.asarray(want).astype(np.int64).tolist()


@pytest.mark.gpu
def test_host_route_on_the_card_matches_the_cpu():
    """The host route's executors run on the cluster's device: on the
    card they answer as on the CPU (joins, a window, a redistribute)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the host route runs on the card")
    rows = _mk(11)
    cpu = _load(Cluster(num_datanodes=2, shard_groups=16,
                        device="cpu").session(), rows)
    gpu = _load(Cluster(num_datanodes=2, shard_groups=16).session(), rows)
    for s in (cpu, gpu):
        s.execute("set enable_fused_execution = off")
    for sql in (*MOTIONS.values(),
                "select k, rank() over (partition by g order by v desc) "
                "from dt order by k"):
        assert _norm(gpu.query(sql)) == _norm(cpu.query(sql)), sql
        assert gpu.last_executor.device.type == "cuda"

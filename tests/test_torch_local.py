"""The port's coordinator merge (executor/local.py) on TEXT: dictionary
codes follow insertion order, not collation, so ORDER BY, min and max
must work on each code's rank in the sorted dictionary, as the
reference's LocalExecutor does (``_dict_ranks``). Every table here
inserts 'b' before 'a', so code order and string order disagree.

Each fault is held against the reference cluster holding the same rows,
on the coordinator plan the port's planner makes, fed per-shard partial
rows directly (so only the merge is under test); ORDER BY also through
the whole query, ``Session.query``."""

import numpy as np
import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster
from opentenbase_tpu_torch.executor.local import LocalExecutor
from opentenbase_tpu_torch.plan import analyze_statement
from opentenbase_tpu_torch.plan.distribute import distribute_statement
from opentenbase_tpu_torch.plan.optimize import optimize_statement
from opentenbase_tpu_torch.sql import parse_one
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import ColumnBatch

DDL = "create table t (k int, c text) distribute by roundrobin"
ROWS = "insert into t values (1, 'b'), (2, 'a'), (3, 'c'), (4, 'aa'), " \
       "(5, 'a'), (6, 'b')"


@pytest.fixture(scope="module")
def pair():
    """The reference holding the rows; a port cluster whose t.c
    dictionary was minted in the same order (the merge needs no rows)."""
    ref = RefCluster(num_datanodes=2, shard_groups=256)
    rs = ref.session()
    rs.execute(DDL)
    rs.execute(ROWS)
    port = Cluster(num_datanodes=2, device="cpu")
    port.session().execute(DDL)
    port.catalog.dictionary("t.c").encode(["b", "a", "c", "aa"])
    return port, rs


def _port_with_rows():
    port = Cluster(num_datanodes=2, device="cpu")
    ps = port.session()
    ps.execute(DDL)
    ps.execute(ROWS)
    assert port.catalog.dictionary("t.c").values == ["b", "a", "c", "aa"]
    return ps


def _plan(port, sql):
    cat = port.catalog
    return distribute_statement(
        optimize_statement(analyze_statement(parse_one(sql), cat), cat), cat)


def _executor(port, dplan, partials):
    """A coordinator over the gathered fragment's partial rows
    (``partials``: values per column of its schema, in order), each
    TEXT value coded through t.c's dictionary."""
    (frag,) = dplan.fragments
    dic = port.catalog.dictionary("t.c")
    cols = {}
    for oc, vals in zip(frag.root.schema, partials):
        if oc.type.is_text:
            data = np.asarray([dic.get_code(v) for v in vals], np.int32)
            cols[oc.name] = Column(oc.type, data, None, dic)
        else:
            cols[oc.name] = Column(oc.type, np.asarray(vals, np.int64))
    batch = ColumnBatch(cols, len(partials[0]))
    return LocalExecutor(port.catalog, {frag.index: batch})


def _merge(port, sql, partials):
    dplan = _plan(port, sql)
    return _executor(port, dplan, partials).run_plan(dplan.root).to_rows()


@pytest.mark.parametrize("desc", [False, True])
def test_order_by_text_ranks_by_collation(pair, desc):
    """Fault (a): the merge ranked TEXT by code ('b' < 'a' < 'c' <
    'aa' by insertion)."""
    port, rs = pair
    sql = "select c, count(*) from t group by c order by c" + (
        " desc" if desc else "")
    want = rs.query(sql)
    assert [r[0] for r in want] == (
        ["c", "b", "aa", "a"] if desc else ["a", "aa", "b", "c"])
    # per-shard partial groups, in code order as a shard would emit them
    got = _merge(port, sql, [["b", "a", "c", "aa", "a", "b"],
                             [1, 1, 1, 1, 1, 1]])
    assert got == want
    # the whole query: the kernel's route groups t.c's codes and the
    # coordinator orders them
    assert _port_with_rows().query(sql) == want


def test_min_max_text_reduce_by_rank(pair):
    """Fault (b): the merge reduced min/max over TEXT by code (min 'b',
    max 'aa' by insertion order; 'a' and 'c' by collation). Held at the
    merge's Aggregate, whose output codes index t.c."""
    port, rs = pair
    sql = "select min(c), max(c) from t"
    assert rs.query(sql) == [("a", "c")]
    dplan = _plan(port, sql)
    node = dplan.root
    while type(node).__name__ != "Aggregate":
        node = node.child
    # shard 0 holds b..aa, shard 1 a..c
    out = _executor(port, dplan, [["b", "a"], ["aa", "c"]]).eval(node)
    dic = port.catalog.dictionary("t.c")
    assert [dic.decode(int(d[0])) for d, _v in out.cols] == ["a", "c"]


def test_text_projected_into_another_dictionary(pair):
    """Fault (c): min/max of a column types as computed TEXT, whose
    output column names the literal pool; the merge's Project passed
    t.c's codes through unchanged, to be decoded in the pool. The
    reference translates each code by its string."""
    port, rs = pair
    sql = "select min(c), max(c) from t"
    assert _merge(port, sql, [["b", "a"], ["aa", "c"]]) == rs.query(sql)


# ---------------------------------------------------------------------------
# FLOAT8 in the merge: sums stay floating (fault C.1), NaN sorts last in
# both directions (fault C.2), NaN and -0.0 group keys fold (the merge's
# group ids follow the reference's float_key_parts)
# ---------------------------------------------------------------------------

F_DDL = ("create table f (k bigint, x double precision) "
         "distribute by roundrobin",
         "create table d (dk bigint, a bigint) distribute by replication")
F_ROWS = ("insert into f values (1, 0.5), (2, 0.25), (1, 1.5), (2, 2.0)",
          "insert into d values (1, 10), (2, 20)")
C1_QUERIES = {
    "join_scalar": "select sum(x) from f join d on k = dk",
    "join_grouped": ("select a, sum(x) from f join d on k = dk "
                     "group by a order by a"),
    "single_table_topk": ("select k, sum(x) from f group by k "
                          "order by 2 desc limit 2"),
}


def _sql_pair(ddl, rows):
    ref = RefCluster(num_datanodes=2, shard_groups=256)
    rs = ref.session()
    port = Cluster(num_datanodes=2, device="cpu")
    ps = port.session()
    for s in (rs, ps):
        for stmt in ddl + rows:
            s.execute(stmt)
    return rs, ps


def _ref_load(ref, table, per_node):
    """Append ``per_node`` (node position -> column -> (data, valid))
    to the reference's stores at one commit, then the same stored rows
    to a new port cluster through carry.load_table."""
    from opentenbase_tpu.storage.column import Column as RefColumn
    from opentenbase_tpu.storage.table import ColumnBatch as RefBatch

    meta = ref.catalog.get(table)
    ts = ref.gts.get_gts()
    for pos, cols in per_node.items():
        node = meta.node_indices[pos]
        n = len(next(iter(cols.values()))[0])
        ref.stores[node][table].append_batch(RefBatch({
            name: RefColumn(meta.schema[name], d, v)
            for name, (d, v) in cols.items()}, n), ts)


def _carry(ref, port, table):
    from opentenbase_tpu_torch import carry

    meta = ref.catalog.get(table)
    cols, xmins, xmaxs = {}, {}, {}
    for node in meta.node_indices:
        v = ref.stores[node][table].scan_view()
        cols[node] = {name: (np.array(v.col(name)), v.validity(name))
                      for name in meta.schema}
        xmins[node] = np.array(v.xmin())
        xmaxs[node] = np.array(v.xmax())
    carry.load_table(port, table, cols, xmins, xmaxs)


def _same(got, want):
    """Rows equal, NaN equal to NaN."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and b != b:
                assert isinstance(a, float) and a != a, (got, want)
            else:
                assert a == b and type(a) is type(b), (got, want)


@pytest.mark.parametrize("q", sorted(C1_QUERIES))
def test_float8_sums_stay_floating_in_the_merge(q):
    """Fault C.1: the merge summed every type in int64 (4.0 for 4.25)."""
    rs, ps = _sql_pair(F_DDL, F_ROWS)
    want = rs.query(C1_QUERIES[q])
    assert want == {
        "join_scalar": [(4.25,)],
        "join_grouped": [(10, 2.0), (20, 2.25)],
        "single_table_topk": [(2, 2.25), (1, 2.0)],
    }[q]
    _same(ps.query(C1_QUERIES[q]), want)


def test_float8_nan_sum_is_nan_in_the_merge():
    """Fault C.1 with a NaN in the summed column: NaN, not -9.2e18."""
    ref = RefCluster(num_datanodes=2, shard_groups=256)
    rs = ref.session()
    for stmt in F_DDL:
        rs.execute(stmt)
    rs.execute(F_ROWS[1])
    _ref_load(ref, "f", {
        0: {"k": (np.array([1, 2], np.int64), None),
            "x": (np.array([0.5, np.nan]), None)},
        1: {"k": (np.array([1, 2], np.int64), None),
            "x": (np.array([1.5, 2.0]), None)},
    })
    port = Cluster(num_datanodes=2, device="cpu")
    ps = port.session()
    for stmt in F_DDL:
        ps.execute(stmt)
    ps.execute(F_ROWS[1])
    _carry(ref, port, "f")
    for sql in (C1_QUERIES["join_scalar"], "select sum(x) from f"):
        want = rs.query(sql)
        assert want[0][0] != want[0][0]  # NaN
        _same(ps.query(sql), want)


@pytest.fixture(scope="module")
def nan_keys():
    """g over two datanodes: NaN, 1.0, 2.0 and NULL on one; NaN, 1.0,
    3.0 and NULL on the other (ROADMAP C.2's rows, with NULL keys)."""
    ref = RefCluster(num_datanodes=2, shard_groups=256)
    rs = ref.session()
    ddl = "create table g (g double precision, v bigint) " \
          "distribute by roundrobin"
    rs.execute(ddl)
    ok = np.array([True, True, True, False])
    _ref_load(ref, "g", {
        0: {"g": (np.array([np.nan, 1.0, 2.0, 0.0]), ok),
            "v": (np.arange(4, dtype=np.int64), None)},
        1: {"g": (np.array([np.nan, 1.0, 3.0, 7.0]), ok),
            "v": (np.arange(4, dtype=np.int64), None)},
    })
    port = Cluster(num_datanodes=2, device="cpu")
    port.session().execute(ddl)
    _carry(ref, port, "g")
    return rs, port.session()


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("nulls", ["", " nulls first", " nulls last"])
def test_nan_sorts_last_in_both_directions(nan_keys, desc, nulls):
    """Fault C.2: the merge ranked by np.unique and negated the rank for
    DESC, so NaN came first under DESC. The reference's stable argsort
    of -key keeps NaN last both ways; NULLs go where NULLS FIRST/LAST
    (or the direction's default) puts them. Each order runs as a top-k
    (the fused DAG ships the groups) and without a LIMIT (the fragment
    program does)."""
    rs, ps = nan_keys
    for limit in (" limit 10", ""):
        sql = ("select g, count(*) from g group by g order by g"
               + (" desc" if desc else "") + nulls + limit)
        want = rs.query(sql)
        vals = [r[0] for r in want]
        nan_at = [i for i, x in enumerate(vals) if x is not None and x != x]
        real = [x for x in vals if x is not None and x == x]
        assert len(nan_at) == 1 and real == sorted(real, reverse=desc)
        assert vals.index(None) in (0, len(vals) - 1)
        assert nan_at[0] == len(vals) - 1 - (vals.index(None) != 0)
        _same(ps.query(sql), want)


def test_nan_and_negative_zero_keys_fold_in_the_merge():
    """The merge's group ids compared float keys with ==, so two shards'
    NaN partial rows stayed two groups (and -0.0 met 0.0 only by luck
    of ==). A RemoteSource batch holding the NaN group's partial row
    twice, and 0.0 beside -0.0, merges as the reference's merge does."""
    from opentenbase_tpu.executor.local import LocalExecutor as RefLocal
    from opentenbase_tpu.plan.analyze import analyze_statement as ranalyze
    from opentenbase_tpu.plan.distribute import distribute_statement as rdist
    from opentenbase_tpu.plan.optimize import optimize_statement as ropt
    from opentenbase_tpu.sql.parser import parse as rparse
    from opentenbase_tpu.storage.column import Column as RefColumn
    from opentenbase_tpu.storage.table import ColumnBatch as RefBatch

    ddl = "create table h (g double precision, v bigint) " \
          "distribute by roundrobin"
    ref = RefCluster(num_datanodes=2, shard_groups=256)
    ref.session().execute(ddl)
    port = Cluster(num_datanodes=2, device="cpu")
    port.session().execute(ddl)
    sql = "select g, count(*), sum(v) from h group by g"
    keys = np.array([np.nan, 1.0, -0.0, np.nan, 0.0, 1.0])
    counts = np.array([1, 2, 3, 4, 5, 6], np.int64)
    sums = np.array([10, 20, 30, 40, 50, 60], np.int64)

    rplan = rdist(ropt(ranalyze(rparse(sql)[0], ref.catalog), ref.catalog),
                  ref.catalog)
    (rfrag,) = rplan.fragments
    rbatch = RefBatch({
        oc.name: RefColumn(oc.type, arr, np.ones(6, bool))
        for oc, arr in zip(rfrag.root.schema, (keys, counts, sums))}, 6)
    want = RefLocal(ref.catalog, {}, remote_inputs={rfrag.index: rbatch}
                    ).run_plan(rplan.root).to_rows()
    assert len(want) == 3  # NaN, 0.0 and 1.0

    pplan = _plan(port, sql)
    (pfrag,) = pplan.fragments
    pbatch = ColumnBatch({
        oc.name: Column(oc.type, arr, np.ones(6, bool))
        for oc, arr in zip(pfrag.root.schema, (keys, counts, sums))}, 6)
    got = LocalExecutor(port.catalog, {pfrag.index: pbatch}).run_plan(
        pplan.root).to_rows()
    _same(got, want)

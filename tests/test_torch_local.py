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

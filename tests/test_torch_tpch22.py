"""TPC-H's 22 queries through both packages on the same rows: a
reference ``Cluster`` and the port's ``Cluster(device="cpu")`` on 1 and
2 datanodes, with fused execution on and off, over the 8-table schema
with every column (``tests/tpch22.py``: a few hundred lineitems in
dbgen's shapes, loaded by the same INSERT statements). Wherever the
reference answers, the port answers with the same rows, exactly (the
reference's FLOAT8 arithmetic is float32 on its device, and the port
computes it alike); wherever the reference raises (Q17, Q20 and Q21 on
their correlated outer references, Q19's IndexError in the host join,
Q22's TEXT IN over a computed text value), the port raises too. Q15 also
runs in the spec's CREATE VIEW / query / DROP VIEW form."""

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster
from tpch22 import Q15_VIEW, TPCH, TPCH_DDL, tpch_inserts, tpch_rows

# the queries the reference refuses on this schema: both packages raise
REFUSED = {"Q17", "Q19", "Q20", "Q21", "Q22"}


@pytest.fixture(scope="module", params=[1, 2], ids=["1dn", "2dn"])
def pair(request):
    nd = request.param
    rs = RefCluster(num_datanodes=nd, shard_groups=16).session()
    ps = Cluster(num_datanodes=nd, shard_groups=16, device="cpu").session()
    for sql in TPCH_DDL + tpch_inserts(tpch_rows()):
        rs.execute(sql)
        ps.execute(sql)
    return rs, ps


def _both(pair, fused: str):
    rs, ps = pair
    for s in (rs, ps):
        s.execute(f"set enable_fused_execution = {fused}")
    return rs, ps


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("name", sorted(TPCH, key=lambda q: int(q[1:])))
def test_tpch_query_matches_reference(pair, name, fused):
    rs, ps = _both(pair, fused)
    sql = TPCH[name]
    if name in REFUSED:
        with pytest.raises(Exception):
            rs.query(sql)
        with pytest.raises(Exception):
            ps.query(sql)
        return
    want = rs.query(sql)
    assert ps.query(sql) == want
    if name in ("Q2", "Q3", "Q7", "Q8", "Q9", "Q15", "Q18"):
        assert want, f"{name} found no rows in the test data"


@pytest.mark.parametrize("fused", ["on", "off"])
def test_q15_view_form_matches_reference(pair, fused):
    """Q15 as the spec writes it: CREATE VIEW revenue0, the query, DROP
    VIEW; the same rows as its WITH form."""
    rs, ps = _both(pair, fused)
    got = [ps.execute(sql) for sql in Q15_VIEW]
    want = [rs.execute(sql) for sql in Q15_VIEW]
    assert [r.command for r in got] == [r.command for r in want]
    assert got[1].rows == want[1].rows == ps.query(TPCH["Q15"])
    assert "revenue0" not in ps.cluster.views


def test_q19_index_error_is_the_references():
    """Q19's OR of three conjunctions, each holding p_partkey =
    l_partkey, plans as a join with no equi-key; both packages' host
    joins then index an empty key list (ops/join.py encode_keys:
    ``build_keys[0]``). Logged under ROADMAP C as found in the
    reference; the port keeps its behaviour."""
    rs = RefCluster(num_datanodes=1, shard_groups=16).session()
    ps = Cluster(num_datanodes=1, shard_groups=16, device="cpu").session()
    for sql in TPCH_DDL:
        rs.execute(sql)
        ps.execute(sql)
    for s in (rs, ps):
        with pytest.raises(IndexError):
            s.query(TPCH["Q19"])

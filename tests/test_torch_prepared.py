"""PREPARE / EXECUTE / DEALLOCATE in the port (``Session._x_preparestmt``,
``_x_executestmt``, ``_x_deallocatestmt``), on tests/test_prepared_stmts.py's
cases: each runs on a reference and a port session with the same
statements, and answers, row counts and errors must be equal (the
partitioned table's case is tests/test_torch_partition.py's). Left out
with its subsystem: the pg_stat_statements check of
``test_review_regressions`` (A.7). A
prepared SELECT runs on a hot standby; a prepared write does not."""

import pytest

from opentenbase_tpu.engine import SQLError as RefSQLError
from opentenbase_tpu.storage import replication as ref_repl
from opentenbase_tpu_torch.engine import SQLError
from opentenbase_tpu_torch.storage import replication as port_repl
from torch_pair import Pair, make_clusters


@pytest.fixture()
def p():
    pair = Pair()
    pair.both("create table t (k bigint, v text) distribute by shard(k)")
    pair.both("insert into t values (1,'a'),(2,'b'),(3,'c')")
    yield pair
    pair.close()


@pytest.mark.parametrize("fused", ["on", "off"])
def test_prepare_execute_roundtrip(p, fused):
    p.set_fused(fused)
    p.both("prepare q1 as select v from t where k = $1")
    assert p.both("execute q1(2)").rows == [("b",)]
    assert p.both("execute q1(3)").rows == [("c",)]
    assert p.both("execute q1(99)").rows == []


def test_prepared_insert_and_negative_args(p):
    p.both("prepare ins as insert into t values ($1, $2)")
    assert p.both("execute ins(-5, 'neg')").rowcount == 1
    assert p.both("select v from t where k = -5").rows == [("neg",)]
    # the burst path binds copy-on-write: the template stays unbound
    assert p.ps.prepared_statements["ins"].values[0][0].index == 1
    for i in range(20):
        p.both(f"execute ins({100 + i}, 'b{i}')")
    p.query("select count(*), min(k), max(k) from t")


def test_prepare_lifecycle_errors(p):
    p.both("prepare q as select count(*) from t")
    p.raises("prepare q as select 1 is not null", "already exists")
    assert p.both("execute q").rows == [(3,)]
    p.both("deallocate q")
    p.raises("execute q", "does not exist")
    p.raises("deallocate q", "does not exist")
    p.both("prepare q2 as select 1 is not null")
    p.both("deallocate all")
    p.raises("execute q2", "does not exist")
    p.raises("prepare q3 as execute q2", "cannot prepare")


def test_missing_and_nonconst_params(p):
    p.both("prepare q as select v from t where k = $1")
    p.raises("execute q", "parameter")
    p.raises("execute q(k)", "constants")


def test_prepared_statement_per_session(p):
    p.both("prepare mine as select 1 is not null")
    rs, ps = p.sessions()
    p.raises("execute mine", "does not exist", sessions=(rs, ps))


def test_review_regressions(p):
    from opentenbase_tpu_torch.sql.parser import ParseError

    with pytest.raises(ParseError, match="unterminated"):
        p.ps.execute("prepare bad (bigint")
    p.both("prepare typed (numeric(10,2)) as select v from t where k = $1")
    assert p.both("execute typed(1)").rows == [("a",)]
    p.raises("execute typed(1, 2)", "wrong number")
    p.raises("execute typed(-'a')", "constants")


def test_repeated_execute_keeps_the_template(p):
    """A template reused across rewrites that mutate trees in place (views,
    WITH, IN lists) answers each EXECUTE from its own clone. The
    reference's fused route answers a WITH over a view from the first
    constant's program (here 2 rows for k >= 3, prepared or not), so the
    port's two routes are held to the reference's host route."""
    p.both("create view tv as select k, v from t where k > 1")
    p.both("prepare w as with x as (select k from tv where k >= $1) "
           "select count(*) from x")
    for s in (p.rs, p.ps):
        s.execute("set enable_fused_execution = off")
    args = (1, 2, 3, 2, 1)
    want = [p.rs.query(f"execute w({a})") for a in args]
    assert want == [[(2,)], [(2,)], [(1,)], [(2,)], [(2,)]]
    for fused in ("off", "on"):
        p.ps.execute(f"set enable_fused_execution = {fused}")
        assert [p.ps.query(f"execute w({a})") for a in args] == want
    p.rs.execute("set enable_fused_execution = on")
    stale = [p.rs.query(f"execute w({a})") for a in args]
    assert stale[2] == [(2,)]  # the reference's fused route, kept apart
    p.set_fused("on")
    p.both("prepare inl as select v from t where k in ($1, $2) order by v")
    assert p.both("execute inl(1, 3)").rows == [("a",), ("c",)]
    assert p.both("execute inl(2, 2)").rows == [("b",)]


def test_prepared_statements_in_a_transaction(p):
    p.both("prepare up as update t set v = $2 where k = $1")
    p.both("begin")
    assert p.both("execute up(2, 'z')").rowcount == 1
    p.both("select v from t order by k")
    p.both("rollback")
    assert p.both("select v from t order by k").rows == [
        ("a",), ("b",), ("c",)]


def test_prepared_select_on_hot_standby(tmp_path):
    rc, pc = make_clusters(2, 16, data_dir=str(tmp_path / "primary"))
    got = []
    for c, repl, err, sub in ((rc, ref_repl, RefSQLError, "ref"),
                              (pc, port_repl, SQLError, "port")):
        s = c.session()
        s.execute("create table t (k bigint) distribute by shard(k)")
        s.execute("insert into t values (1),(2)")
        sender = repl.WalSender(c.persistence)
        kw = {"device": "cpu"} if sub == "port" else {}
        sb = repl.StandbyCluster(str(tmp_path / f"sb_{sub}"),
                                 num_datanodes=2, shard_groups=16, **kw)
        try:
            sb.start_replication(sender.host, sender.port)
            assert sb.wait_caught_up(c.persistence)
            rs = sb.session()
            rs.execute("prepare q as select count(*) from t where k >= $1")
            rows = rs.query("execute q(1)")
            rs.execute("prepare w as insert into t values ($1)")
            with pytest.raises(err, match="read-only") as ei:
                rs.query("execute w(9)")
            got.append((rows, str(ei.value)))
        finally:
            sender.stop()
            sb.stop()
            c.close()
    assert got[0] == got[1] and got[1][0] == [(2,)]

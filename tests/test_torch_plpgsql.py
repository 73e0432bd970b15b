"""PL/pgSQL functions in the port (plan/plpgsql.py, the PL branch of
plan/functions.expand_calls, engine.py ``_pl_call``), held against the
reference on the eight ``test_plpgsql_*`` cases of
tests/test_sql_functions.py: the same statements go to a reference and
a port cluster (tests/torch_pair.py), with the fused route on and off,
and every answer, row count and error must be equal. A call runs its
body at rewrite time, atomically (a ``__pl__`` savepoint), at most 8
deep; EXPLAIN plans it as a NULL placeholder and runs nothing. A body's
``SELECT ... INTO`` takes the fused route in both packages (the call's
transaction has no writes yet). Over the wire the port classes a call
of a PL/pgSQL function exclusive: the reference classes it a read, and
its body's writes then race a writer of the same table (ROADMAP C)."""

import threading
import time

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.net.server import ClusterServer as RefServer
from opentenbase_tpu_torch import Cluster
from opentenbase_tpu_torch.engine import Session
from opentenbase_tpu_torch.net.client import connect_tcp
from opentenbase_tpu_torch.net.server import ClusterServer, classify
from torch_pair import Pair, make_clusters, recover_clusters

ACCT = ["create table acct (id bigint primary key, bal bigint) "
        "distribute by shard(id)",
        "insert into acct values (1,100),(2,200),(3,300)"]


@pytest.fixture(params=[1, 2], ids=["1dn", "2dn"])
def p(request):
    pair = Pair(nd=request.param, shard_groups=32)
    for sql in ACCT:
        pair.both(sql)
    yield pair
    pair.close()


def test_plpgsql_control_flow(p):
    p.both("create function fib(n bigint) returns bigint as '"
           "declare a bigint := 0; b bigint := 1; t bigint;"
           "begin"
           "  if n < 0 then return null; end if;"
           "  for i in 1 .. n loop"
           "    t := a + b; a := b; b := t;"
           "  end loop;"
           "  return a;"
           "end' language plpgsql")
    assert p.query("select fib(10)") == [(55,)]
    assert p.query("select fib(0)") == [(0,)]
    assert p.query("select fib(-1)") == [(None,)]
    p.both("create function collatz_steps(n bigint) returns bigint as '"
           "declare steps bigint := 0;"
           "begin"
           "  while n > 1 loop"
           "    if n % 2 = 0 then n := n / 2;"
           "    else n := 3 * n + 1; end if;"
           "    steps := steps + 1;"
           "  end loop;"
           "  return steps;"
           "end' language plpgsql")
    assert p.query("select collatz_steps(6)") == [(8,)]


TRANSFER = (
    "create function transfer(src bigint, dst bigint, amt bigint) "
    "returns bigint as '"
    "declare sbal bigint;"
    "begin"
    "  select bal into sbal from acct where id = src;"
    "  if sbal is null then"
    "    raise exception ''no such account: %'', src;"
    "  end if;"
    "  if sbal < amt then"
    "    raise exception ''insufficient funds'';"
    "  end if;"
    "  update acct set bal = bal - amt where id = src;"
    "  update acct set bal = bal + amt where id = dst;"
    "  select bal into sbal from acct where id = src;"
    "  return sbal;"
    "end' language plpgsql")


def test_plpgsql_sql_statements_and_into(p):
    p.both(TRANSFER)
    assert p.both("select transfer(1, 2, 40)").rows == [(60,)]
    assert p.query("select bal from acct order by id") == [
        (60,), (240,), (300,)]
    p.raises("select transfer(2, 1, 1000)", "insufficient funds")
    p.raises("select transfer(9, 1, 5)", "no such account: 9")
    assert p.query("select bal from acct order by id") == [
        (60,), (240,), (300,)]


@pytest.mark.parametrize("checkpoint", [False, True],
                         ids=["wal", "checkpoint"])
@pytest.mark.parametrize("swap", [False, True], ids=["own", "swapped"])
def test_plpgsql_survives_recovery(tmp_path, swap, checkpoint):
    rc, pc = make_clusters(nd=2, shard_groups=16, data_dir=str(tmp_path))
    pair = Pair(clusters=(rc, pc))
    if checkpoint:
        pair.both("create table t (k bigint) distribute by shard(k)")
        for c in (rc, pc):
            c.persistence.checkpoint()
    pair.both("create function tri(n bigint) returns bigint as '"
              "declare acc bigint := 0;"
              "begin for i in 1 .. n loop acc := acc + i; end loop;"
              "return acc; end' language plpgsql")
    assert pair.both("select tri(4)").rows == [(10,)]
    pair.close()
    after = Pair(clusters=recover_clusters(str(tmp_path), shard_groups=16,
                                           swap=swap))
    assert after.both("select tri(5)").rows == [(15,)]
    assert after.both("select prolang from pg_proc").rows == [("plpgsql",)]
    after.close()


def test_plpgsql_infinite_loop_bounded(p, monkeypatch):
    import opentenbase_tpu.plan.plpgsql as ref_pl
    import opentenbase_tpu_torch.plan.plpgsql as pl

    monkeypatch.setattr(ref_pl, "MAX_STEPS", 200)
    monkeypatch.setattr(pl, "MAX_STEPS", 200)
    p.both("create function spin() returns bigint as '"
           "begin while true loop end loop; return 0; end' "
           "language plpgsql")
    p.raises("select spin()", "exceeded")


def test_plpgsql_body_is_atomic(p):
    """A RAISE mid-body rolls back every statement the body ran, in an
    implicit transaction and inside an explicit one (which goes on)."""
    p.both("create function bad_transfer(src bigint, amt bigint) "
           "returns bigint as '"
           "begin"
           "  update acct set bal = bal - amt where id = src;"
           "  raise exception ''boom after debit'';"
           "end' language plpgsql")
    before = p.query("select bal from acct order by id")
    p.raises("select bad_transfer(1, 40)", "boom after debit")
    assert p.query("select bal from acct order by id") == before
    p.both("begin")
    p.both("update acct set bal = 7 where id = 3")
    p.raises("select bad_transfer(1, 40)", "boom after debit")
    p.both("commit")
    assert p.query("select bal from acct order by id") == [
        (100,), (200,), (7,)]


def test_plpgsql_notice_continues(p):
    p.both("create function noisy() returns bigint as '"
           "begin raise notice ''progress %'', 1; return 7; end' "
           "language plpgsql")
    assert p.query("select noisy()") == [(7,)]


def test_plpgsql_case_inside_if_condition(p):
    p.both("create function sgn(n bigint) returns bigint as '"
           "begin"
           "  if (case when n > 0 then 1 else 0 end) = 1 then"
           "    return 1;"
           "  end if;"
           "  if n = 0 then return 0; end if;"
           "  return -1;"
           "end' language plpgsql")
    assert p.query("select sgn(5)") == [(1,)]
    assert p.query("select sgn(0)") == [(0,)]
    assert p.query("select sgn(-2)") == [(-1,)]


def test_plpgsql_loop_control_and_for_query(p):
    """EXIT [WHEN], CONTINUE [WHEN], FOR var IN <query> LOOP."""
    p.both("create function first_big(th bigint) returns bigint as '"
           "declare found bigint := -1;"
           "begin"
           "  for b in select bal from acct order by id loop"
           "    continue when b < th;"
           "    found := b;"
           "    exit;"
           "  end loop;"
           "  return found;"
           "end' language plpgsql")
    assert p.query("select first_big(150)") == [(200,)]
    assert p.query("select first_big(1000)") == [(-1,)]
    p.both("create function count_until(lim bigint) returns bigint as '"
           "declare n bigint := 0;"
           "begin"
           "  while true loop"
           "    n := n + 1;"
           "    exit when n >= lim;"
           "  end loop;"
           "  return n;"
           "end' language plpgsql")
    assert p.query("select count_until(7)") == [(7,)]
    p.both("create function sum_evens(hi bigint) returns bigint as '"
           "declare acc bigint := 0;"
           "begin"
           "  for i in 1 .. hi loop"
           "    continue when i % 2 = 1;"
           "    acc := acc + i;"
           "  end loop;"
           "  return acc;"
           "end' language plpgsql")
    assert p.query("select sum_evens(10)") == [(30,)]
    p.both("create function badexit() returns bigint as '"
           "begin exit; return 1; end' language plpgsql")
    p.raises("select badexit()", "outside a loop")


# -- beyond tests/test_sql_functions.py ------------------------------------

def test_nesting_limit_and_explain_placeholder(p):
    """A call at most 8 deep; EXPLAIN plans a call as NULL and runs no
    body (the counter stays put)."""
    p.both("create function deep(n bigint) returns bigint as '"
           "declare r bigint; m bigint; begin if n = 0 then return 0; "
           "end if; m := n - 1; select deep(m) into r; return r + 1; end' "
           "language plpgsql")
    assert p.query("select deep(5)") == [(5,)]
    p.raises("select deep(20)", "recursion limit")
    p.both("create function debit(k bigint) returns bigint as '"
           "begin update acct set bal = bal - 1 where id = k; return 1; "
           "end' language plpgsql")
    p.both("explain select debit(1)")
    assert p.query("select bal from acct where id = 1") == [(100,)]
    p.raises("select debit(id) from acct", "constant arguments")


def _routes(s, ref: bool):
    """Record each dispatch's route on ``s``."""
    seen = []
    orig = s._execute_dplan

    def spy(*a, **k):
        out = orig(*a, **k)
        seen.append(out[1]["mode"] if ref else s.last_route)
        return out

    s._execute_dplan = spy
    return seen


def test_a_body_read_takes_the_fused_route(p):
    """The call opens a transaction; it has no writes when the body's
    SELECT ... INTO runs, so that read is the fused route's in both
    packages, and a read after the body's write is the host route's."""
    p.both("create function rich(th bigint) returns bigint as '"
           "declare r bigint;"
           "begin select sum(bal) into r from acct where bal > th;"
           " return r; end' language plpgsql")
    p.both("create function rich_after_write(th bigint) returns bigint as '"
           "declare r bigint;"
           "begin update acct set bal = bal + 1 where id = 1;"
           " select sum(bal) into r from acct where bal > th;"
           " return r; end' language plpgsql")
    ref_seen, port_seen = _routes(p.rs, True), _routes(p.ps, False)
    assert p.both("select rich(150)").rows == [(500,)]
    assert ref_seen[0] == port_seen[0] == "fused"
    del ref_seen[:], port_seen[:]
    assert p.both("select rich_after_write(50)").rows == [(601,)]
    assert ref_seen[0] == port_seen[0] == "host"


def test_wire_class_of_a_writing_call():
    """A SELECT calling a PL/pgSQL function is a read to the reference's
    wire server and exclusive to the port's; a SQL function calling one
    is too; a plain SELECT and a SQL function stay reads."""
    rc = RefCluster(num_datanodes=2, shard_groups=16)
    pc = Cluster(num_datanodes=2, shard_groups=16, device="cpu")
    ddl = ["create table t (id bigint primary key, src text) "
           "distribute by shard(id)",
           "create function ins(k bigint) returns bigint as "
           "'begin insert into t values (k, ''pl''); return k; end' "
           "language plpgsql",
           "create function wrap(k bigint) returns bigint as "
           "'select ins(k)'",
           "create function plus1(k bigint) returns bigint as "
           "'select k + 1'"]
    for c in (rc, pc):
        for sql in ddl:
            c.session().execute(sql)
    ref = RefServer(rc)
    rs, ps = rc.session(), pc.session()
    assert ref._classify("select ins(1)", rs)[0] == "read"
    assert classify(pc, "select ins(1)", ps) == ("excl", None)
    assert classify(pc, "select wrap(1)", ps) == ("excl", None)
    assert classify(pc, "insert into t values (ins(5), 'x')", ps) == (
        "excl", None)
    assert classify(pc, "select plus1(1)", ps) == ("read", None)
    assert classify(pc, "select count(*) from t", ps) == ("read", None)
    assert classify(pc, "insert into t values (1, 'x')", ps) == (
        "write", {"t"})
    rc.close()
    pc.close()


def test_two_clients_writing_through_a_call_and_directly(monkeypatch):
    """Two wire clients insert the same keys into a table with a primary
    key, one through a PL/pgSQL call and one directly, with the window
    between the key check and the append widened: the port serializes
    the call with the writer, so every key lands once. (The reference's
    server runs the call beside the writer: its duplicate keys are
    ROADMAP C's evidence.)"""
    orig = Session._check_unique_pk

    def slow_check(self, *a, **k):
        out = orig(self, *a, **k)
        time.sleep(0.002)
        return out

    monkeypatch.setattr(Session, "_check_unique_pk", slow_check)
    c = Cluster(num_datanodes=2, shard_groups=16, device="cpu")
    s0 = c.session()
    s0.execute("create table t (id bigint primary key, src text) "
               "distribute by shard(id)")
    s0.execute("create function ins(k bigint) returns bigint as "
               "'begin insert into t values (k, ''pl''); return k; end' "
               "language plpgsql")
    srv = ClusterServer(c).start()
    n = 40
    barrier = threading.Barrier(2, timeout=60)
    errors = {"pl": 0, "direct": 0}

    def client(kind):
        conn = connect_tcp(srv.host, srv.port, timeout=60)
        try:
            for k in range(n):
                barrier.wait()
                if kind == "direct":
                    time.sleep(0.001 * (k % 4))
                sql = (f"select ins({k})" if kind == "pl"
                       else f"insert into t values ({k}, 'direct')")
                try:
                    conn.execute(sql)
                except Exception:  # noqa: BLE001 - the losing writer
                    errors[kind] += 1
        finally:
            conn.close()

    ts = [threading.Thread(target=client, args=(kind,))
          for kind in ("pl", "direct")]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in ts)
        assert s0.query("select count(*) from t group by id "
                        "having count(*) > 1") == []
        assert s0.query("select count(*) from t") == [(n,)]
        assert errors["pl"] + errors["direct"] == n
    finally:
        srv.stop()
        c.close()

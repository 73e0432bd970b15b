"""SQL-language functions in the port (``plan/functions.py``, CREATE /
DROP FUNCTION ... LANGUAGE SQL), held against the reference on
tests/test_sql_functions.py's cases: the same statements go to a
reference ``Cluster(num_datanodes=2)`` and a port ``Cluster(...,
device="cpu")`` and every answer must be equal, exactly. An expression
body inlines as the expression, a table-reading body as a scalar
subquery (which the port's host route answers). pg_proc answers as
the reference's, PL/pgSQL functions listed (their bodies are
tests/test_torch_plpgsql.py's). (The fixture's table has no PRIMARY
KEY.)"""

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster


class Pair:
    def __init__(self):
        self.rs = RefCluster(num_datanodes=2, shard_groups=32).session()
        self.ps = Cluster(num_datanodes=2, shard_groups=32,
                          device="cpu").session()

    def both(self, sql: str):
        want = self.rs.execute(sql)
        got = self.ps.execute(sql)
        assert (got.command, got.rows, got.rowcount) == (
            want.command, want.rows, want.rowcount), sql
        return got.rows

    def raises(self, sql: str, match: str):
        for s in (self.rs, self.ps):
            with pytest.raises(Exception, match=match):
                s.execute(sql)


@pytest.fixture()
def p():
    pair = Pair()
    pair.both("create table acct (id bigint, bal bigint) "
              "distribute by shard(id)")
    pair.both("insert into acct values (1,100),(2,200),(3,300)")
    return pair


def test_expression_function_inlines(p):
    p.both("create function add_tax(amount bigint) returns bigint "
           "as 'select amount * 2' language sql")
    assert p.both("select add_tax(21)") == [(42,)]
    for fused in ("on", "off"):
        p.both(f"set enable_fused_execution = {fused}")
        assert p.both("select id from acct where add_tax(bal) > 300 "
                      "order by id") == [(2,), (3,)]


def test_positional_args(p):
    p.both("create function f(a bigint, b bigint) returns bigint "
           "as 'select $1 - $2'")
    assert p.both("select f(10, 3)") == [(7,)]


def test_table_reading_function_as_scalar_subquery(p):
    p.both("create function total_bal() returns bigint "
           "as 'select sum(bal) from acct'")
    assert p.both("select total_bal()") == [(600,)]
    assert p.both("select id from acct where bal * 6 = total_bal()") == [
        (1,)]
    assert p.ps.last_route == "host"


def test_function_calls_function(p):
    p.both("create function dbl(x bigint) returns bigint as 'select x * 2'")
    p.both("create function quad(x bigint) returns bigint "
           "as 'select dbl(dbl(x))'")
    assert p.both("select quad(3)") == [(12,)]
    assert p.both("select quad(bal) from acct order by id") == [
        (400,), (800,), (1200,)]


def test_or_replace_and_drop(p):
    p.both("create function g() returns bigint as 'select 1'")
    p.raises("create function g() returns bigint as 'select 2'",
             "already exists")
    p.both("create or replace function g() returns bigint as 'select 2'")
    assert p.both("select g()") == [(2,)]
    p.both("drop function g")
    p.raises("select g()", "unknown function")
    p.raises("drop function g", "does not exist")
    p.both("drop function if exists g")


def test_arity_and_body_validation(p):
    p.raises("create function bad() returns bigint as 'delete from acct'",
             "single SELECT")
    p.both("create function two(a bigint, b bigint) returns bigint "
           "as 'select a + b'")
    p.raises("select two(1)", "expects 2 arguments")


def test_recursion_guard(p):
    p.both("create function r1(x bigint) returns bigint as 'select x'")
    p.both("create or replace function r1(x bigint) returns bigint "
           "as 'select r1(x)'")
    p.raises("select r1(1)", "recursion limit")


def test_reserved_function_names(p):
    p.raises("create function nextval(x bigint) returns bigint "
             "as 'select x'", "reserved function name")
    p.raises("create function pg_sleep(x bigint) returns bigint "
             "as 'select x'", "reserved function name")


def test_function_in_dml_and_text(p):
    p.both("create function base() returns bigint as 'select 1000'")
    p.both("insert into acct values (4, base())")
    assert p.both("select bal from acct where id = 4") == [(1000,)]
    p.both("update acct set bal = base() * 2 where id = 4")
    assert p.both("select bal from acct where id = 4") == [(2000,)]
    p.both("create table people (k bigint, nm text) distribute by shard(k)")
    p.both("insert into people values (1, 'ada'), (2, null)")
    p.both("create function shout(s text) returns text "
           "as 'select upper(s) || ''!'''")
    assert p.both("select k, shout(nm) from people order by k") == [
        (1, "ADA!"), (2, None)]


def test_pg_proc_lists_sql_and_plpgsql_functions(p):
    """pg_proc lists the SQL and the PL/pgSQL functions as the
    reference's does (PL/pgSQL was refused by name before it was
    ported; tests/test_torch_plpgsql.py holds its bodies)."""
    p.both("create function h(a bigint) returns bigint as 'select a + 1'")
    assert ("h", "a bigint", "bigint", "sql") in p.both(
        "select proname, proargs, prorettype, prolang from pg_proc")
    p.both("select proname, prosrc from pg_proc order by proname")
    p.both("create function fib(n bigint) returns bigint as '"
           "declare a bigint := 0; begin return a; end' language plpgsql")
    assert ("fib", "n bigint", "bigint", "plpgsql") in p.both(
        "select proname, proargs, prorettype, prolang from pg_proc")
    assert p.both("select fib(3)") == [(0,)]


def test_functions_survive_recovery(tmp_path):
    d = str(tmp_path / "data")
    c = Cluster(num_datanodes=2, shard_groups=32, data_dir=d, device="cpu")
    s = c.session()
    s.execute("create table t (k bigint) distribute by shard(k)")
    s.execute("insert into t values (5)")
    s.execute("create function inc(x bigint) returns bigint "
              "as 'select x + 1'")
    s.execute("create function gone(x bigint) returns bigint "
              "as 'select x'")
    s.execute("drop function gone")
    c.close()
    rc = Cluster.recover(d, num_datanodes=2, shard_groups=32, device="cpu")
    assert rc.session().query("select inc(k) from t") == [(6,)]
    assert set(rc.functions) == {"inc"}
    rc.close()

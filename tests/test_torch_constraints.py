"""Column constraints and defaults (NOT NULL, PRIMARY KEY, DEFAULT),
INSERT ... ON CONFLICT and DISTRIBUTE BY HASH / MODULO in the port, held
against the reference on tests/test_constraints.py's cases (the
sequence cases are tests/test_torch_sequences.py's, the partitioned
table's tests/test_torch_partition.py's): the same statements go to a reference
and a port cluster (tests/torch_pair.py), reads with the fused route on
and off, every answer and error equal. Constraints survive a recovery
and a checkpoint, and each package recovers the other's data
directory."""

import pytest

from torch_pair import Pair, recover_clusters


@pytest.fixture()
def p():
    pair = Pair()
    yield pair
    pair.close()


def test_default_values_fill_absent_columns(p):
    p.both("create table t (k bigint, v text default 'none', "
           "n bigint default 7) distribute by shard(k)")
    p.both("insert into t (k) values (1)")
    p.both("insert into t values (2, 'given', 9)")
    p.both("insert into t (k, n) select k + 10, 1 from t")
    assert p.query("select k, v, n from t order by k") == [
        (1, "none", 7), (2, "given", 9), (11, "none", 1), (12, "none", 1)]


def test_not_null_enforced(p):
    p.both("create table t (k bigint not null, v text not null)"
           " distribute by shard(k)")
    p.raises("insert into t values (1, null)", "not-null")
    p.raises("insert into t (k) values (1)", "not-null")  # no default
    p.both("insert into t values (1, 'ok')")
    p.raises("update t set v = null where k = 1", "not-null")
    assert p.query("select v from t") == [("ok",)]


def test_primary_key_unique_when_colocated(p):
    p.both("create table t (k bigint primary key, v text) "
           "distribute by shard(k)")
    p.both("insert into t values (1,'a'),(2,'b')")
    p.raises("insert into t values (2,'again')", "duplicate key")
    p.raises("insert into t values (3,'x'),(3,'y')", "duplicate key")
    # a non-key column of an existing row is no conflict
    p.both("update t set v = 'b2' where k = 2")
    p.both("begin")
    p.both("delete from t where k = 1")
    p.both("insert into t values (1,'re')")
    p.both("commit")
    assert p.query("select v from t where k = 1") == [("re",)]
    assert p.query("select k, v from t order by k") == [(1, "re"),
                                                       (2, "b2")]


def test_pk_unique_on_replicated_table(p):
    p.both("create table r (k bigint primary key, v text) "
           "distribute by replication")
    p.both("insert into r values (1,'a')")
    p.raises("insert into r values (1,'b')", "duplicate key")


def test_pk_not_enforced_where_not_colocated(p):
    """A primary key that is not the distribution key is not enforced
    (a cross-node unique index is refused in the reference too)."""
    p.both("create table t (k bigint primary key, g bigint) "
           "distribute by shard(g)")
    p.both("insert into t values (1, 1), (1, 2)")
    assert p.query("select count(*) from t") == [(2,)]


def test_primary_key_implies_not_null(p):
    p.both("create table t (k bigint primary key, v text) "
           "distribute by shard(k)")
    p.raises("insert into t (v) values ('a')", "null value")
    p.both("insert into t values (0, 'zero')")
    assert p.query("select count(*) from t") == [(1,)]


def test_default_distribution_is_the_primary_key(p):
    p.both("create table t (v text, k bigint primary key)")
    for c in (p.rc, p.pc):
        meta = c.catalog.get("t")
        assert (meta.dist.strategy.value, meta.dist.key_columns) == (
            "shard", ("k",))


def test_bad_defaults_refused(p):
    p.raises("create table bad (k bigint, n bigint default 'x')"
             " distribute by shard(k)", "bad default|not valid")
    p.raises("create table bad (k bigint, n bigint default k)"
             " distribute by shard(k)", "must be a constant")


def test_failed_statement_atomic_in_explicit_txn(p):
    """A constraint failure mid-statement leaves no partial writes for
    COMMIT (xact.c's per-statement subtransaction)."""
    p.both("create table t (k bigint primary key, v text not null)"
           " distribute by shard(k)")
    p.both("insert into t values (1,'a'),(2,'b')")
    p.both("begin")
    p.raises("update t set v = null where k = 1", "not-null")
    p.raises("insert into t values (3,'c'),(2,'dup')", "duplicate key")
    p.both("commit")
    assert p.query("select k, v from t order by k") == [(1, "a"), (2, "b")]


def test_insert_on_conflict_upsert(p):
    """INSERT ... ON CONFLICT over the primary key arbiter: DO NOTHING
    drops conflicting proposed rows (duplicates within the statement
    too), DO UPDATE rewrites the existing row with excluded.*, column
    and constant assignments."""
    p.both("create table t (k bigint primary key, g bigint, v bigint) "
           "distribute by shard(k)")
    p.both("insert into t values (1,1,10),(2,1,20)")
    assert p.both("insert into t values (1,9,9),(3,3,30),(3,4,40) "
                  "on conflict do nothing").rowcount == 1
    assert p.query("select * from t order by k") == [
        (1, 1, 10), (2, 1, 20), (3, 3, 30)]
    assert p.both("insert into t values (1,5,55),(4,4,40) on conflict (k) "
                  "do update set v = excluded.v, g = excluded.g"
                  ).rowcount == 2
    assert p.query("select * from t order by k") == [
        (1, 5, 55), (2, 1, 20), (3, 3, 30), (4, 4, 40)]
    p.both("insert into t values (2,0,0) on conflict (k) "
           "do update set v = 999")
    p.both("insert into t values (3,0,0) on conflict (k) "
           "do update set v = g")
    assert p.query("select k, v from t where k in (2, 3) order by k") == [
        (2, 999), (3, 3)]
    p.raises("insert into t values (7,7,7),(7,8,8) on conflict (k) "
             "do update set v = excluded.v", "a second time")
    p.raises("insert into t values (9,9,9) on conflict (g) do nothing",
             "no unique")
    p.raises("insert into t values (1,1,1) on conflict (k) "
             "do update set v = v + 1", "supports excluded")
    # keys living on different datanodes each update
    assert p.both("insert into t select k, 0, k * 1000 from t "
                  "on conflict (k) do update set v = excluded.v"
                  ).rowcount == 4
    assert p.query("select k, v from t order by k") == [
        (1, 1000), (2, 2000), (3, 3000), (4, 4000)]
    r = p.both("insert into t values (4, 0, 7), (50, 0, 8) on conflict (k) "
               "do update set v = excluded.v returning k, v")
    assert sorted(r.rows) == [(4, 7), (50, 8)]
    p.raises("insert into t values (null, 0, 0) on conflict do nothing",
             "not-null")
    # targetless DO NOTHING without a primary key: a plain insert
    p.both("create table np (a bigint) distribute by shard(a)")
    p.both("insert into np values (1) on conflict do nothing")
    assert p.query("select count(*) from np") == [(1,)]
    before = p.query("select v from t where k = 2")
    p.both("begin")
    p.both("insert into t values (2,0,0) on conflict (k) do update set v = 1")
    assert p.query("select v from t where k = 2") == [(1,)]
    p.both("rollback")
    assert p.query("select v from t where k = 2") == before


def test_upsert_on_replicated_table(p):
    p.both("create table r (k bigint primary key, v text) "
           "distribute by replication")
    p.both("insert into r values (1,'a'),(2,'b')")
    assert p.both("insert into r values (2,'B'),(3,'c') on conflict (k) "
                  "do update set v = excluded.v").rowcount == 2
    assert p.query("select k, v from r order by k") == [
        (1, "a"), (2, "B"), (3, "c")]
    for c in (p.rc, p.pc):
        live = [len(c.stores[n]["r"].live_index(c.gts.snapshot_ts()))
                for n in c.catalog.get("r").node_indices]
        assert live == [3, 3]


@pytest.mark.parametrize("strategy", ["hash(k)", "modulo(k)"])
def test_hash_and_modulo_distribution(p, strategy):
    """DISTRIBUTE BY HASH / MODULO: rows route by the locator, point
    reads prune, joins and groups answer as the reference's."""
    p.both(f"create table h (k bigint primary key, g int, v bigint, "
           f"s text) distribute by {strategy}")
    p.both("create table d (g int, nm text) distribute by replication")
    p.both("insert into h values " + ",".join(
        f"({k}, {k % 5}, {k * 3 - 40}, "
        f"{'null' if k % 7 == 0 else repr('s%d' % (k % 4))})"
        for k in range(1, 80)))
    p.both("insert into d values (0,'zero'),(1,'one'),(2,'two'),(3,'three')")
    for c in (p.rc, p.pc):
        meta = c.catalog.get("h")
        per_node = [c.stores[n]["h"].nrows for n in meta.node_indices]
        assert sum(per_node) == 79 and min(per_node) > 0, per_node
    p.raises("insert into h values (5, 0, 0, 'x')", "duplicate key")
    for q in ("select count(*), sum(v), min(v), max(v) from h",
              "select g, count(*), sum(v) from h group by g order by g",
              "select s, count(*) from h group by s order by s nulls first",
              "select v from h where k = 33",
              "select nm, sum(v) from h join d on h.g = d.g group by nm "
              "order by nm"):
        p.query(q)
    p.both("update h set v = 0 where g = 3")
    p.both("delete from h where k > 70")
    p.query("select g, count(*), sum(v) from h group by g order by g")


@pytest.mark.parametrize("swap", [False, True], ids=["own", "other"])
@pytest.mark.parametrize("checkpoint", [False, True])
def test_constraints_survive_recovery(tmp_path, swap, checkpoint):
    """Constraints and defaults come back from the WAL's CREATE TABLE
    record and from a checkpoint, in either package's data directory."""
    d = str(tmp_path)
    p = Pair(data_dir=d)
    p.both("create table t (k bigint primary key, v text not null,"
           " n bigint default 5) distribute by hash(k)")
    p.both("insert into t (k, v) values (1, 'a')")
    if checkpoint:
        for c in (p.rc, p.pc):
            c.persistence.checkpoint()
    p.both("insert into t (k, v) values (3, 'c')")
    r = Pair(clusters=recover_clusters(d, swap=swap))
    assert r.query("select k, n from t order by k") == [(1, 5), (3, 5)]
    r.raises("insert into t values (1, 'dup', 1)", "duplicate key")
    r.raises("insert into t (k) values (2)", "not-null")
    r.both("insert into t (k, v) values (2, 'b')")  # the default applies
    assert r.query("select n from t where k = 2") == [(5,)]
    for c in (r.rc, r.pc):
        meta = c.catalog.get("t")
        assert (meta.dist.strategy.value, sorted(meta.not_null),
                meta.primary_key, meta.defaults) == (
            "hash", ["k", "v"], "k", {"n": 5})
    r.close()

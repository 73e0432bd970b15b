"""Foreign tables in the port (fdw.py, CREATE FOREIGN TABLE ... SERVER
file, ``LocalExecutor._foreign_store``), held against the reference on
tests/test_components.py's foreign-table cases: the same statements go
to a reference and a port cluster (tests/torch_pair.py), with the fused
route on and off, and every answer and error must be equal. A foreign
table is a replicated catalog entry on one node with no stores: its
scan reads the file on the host route (its rows cached by the file's
mtime and size), INSERT, UPDATE, DELETE and COPY FROM are refused, and
it survives recovery from the WAL and from a checkpoint, each package
from the other's data directory too. With datanode processes attached,
its fragments run on the coordinator."""

import time

import pytest

from opentenbase_tpu_torch import Cluster, carry
from opentenbase_tpu_torch import fdw
from torch_pair import Pair, make_clusters, recover_clusters


def _ext(path):
    return (f"create foreign table ext (id bigint, name text, "
            f"score numeric(4,2)) server file options "
            f"(filename '{path}', format 'csv', header 'true')")


@pytest.mark.parametrize("nd", [1, 2])
def test_foreign_table_scan_and_refresh(tmp_path, nd):
    path = tmp_path / "ext.csv"
    path.write_text("id,name,score\n1,ann,2.5\n2,bob,\n")
    p = Pair(nd=nd, shard_groups=16)
    p.both(_ext(path))
    assert p.query("select id, name, score from ext order by id") == [
        (1, "ann", 2.5), (2, "bob", None)]
    assert p.ps.last_route == "host"
    p.both("create table loc (id bigint, city text) distribute by shard(id)")
    p.both("insert into loc values (1, 'rome'), (2, 'oslo')")
    assert p.query("select ext.name, loc.city from ext, loc "
                   "where ext.id = loc.id order by ext.id") == [
        ("ann", "rome"), ("bob", "oslo")]
    assert p.query("select count(*), sum(score) from ext") == [(2, 2.5)]
    time.sleep(0.01)
    path.write_text("id,name,score\n7,zed,1.0\n")
    assert p.query("select id from ext") == [(7,)]
    p.close()


@pytest.mark.parametrize("swap", [False, True], ids=["own", "swapped"])
def test_foreign_table_survives_recovery(tmp_path, swap):
    path = tmp_path / "f.csv"
    path.write_text("1\n2\n")
    p = Pair(shard_groups=16, data_dir=str(tmp_path))
    p.both(f"create foreign table f (v bigint) server file "
           f"options (filename '{path}')")
    p.close()
    after = Pair(clusters=recover_clusters(str(tmp_path), shard_groups=16,
                                           swap=swap))
    assert after.query("select sum(v) from f") == [(3,)]
    after.close()


@pytest.mark.parametrize("swap", [False, True], ids=["own", "swapped"])
def test_foreign_table_survives_checkpoint(tmp_path, swap):
    path = tmp_path / "c.csv"
    path.write_text("5\n6\n")
    rc, pc = make_clusters(nd=2, shard_groups=16, data_dir=str(tmp_path))
    p = Pair(clusters=(rc, pc))
    p.both(f"create foreign table cf (v bigint) server file "
           f"options (filename '{path}')")
    for c in (rc, pc):
        c.persistence.checkpoint()
    p.close()
    r2, p2 = recover_clusters(str(tmp_path), shard_groups=16, swap=swap)
    for c in (r2, p2):
        assert c.catalog.get("cf").foreign == {"filename": str(path),
                                               "server": "file"}
        assert c.catalog.get("cf").node_indices == [0]
    after = Pair(clusters=(r2, p2))
    assert after.query("select sum(v) from cf") == [(11,)]
    after.close()


def test_dml_on_foreign_table_rejected(tmp_path):
    path = tmp_path / "d.csv"
    path.write_text("1\n")
    p = Pair(shard_groups=16)
    p.both(f"create foreign table df (v bigint) server file "
           f"options (filename '{path}')")
    for sql in ("insert into df values (9)", "update df set v = 9",
                "delete from df", "insert into df select 9",
                f"copy df from '{path}'"):
        p.raises(sql, "cannot change foreign table")
    p.both("create table src (k bigint) distribute by shard(k)")
    p.raises("update df set v = src.k from src where df.v = src.k",
             "cannot change foreign table")
    assert p.query("select v from df") == [(1,)]
    assert p.both(f"copy df to '{tmp_path / 'out.csv'}'").rowcount == 1
    p.close()


def test_sources_the_reference_refuses(tmp_path):
    """A dbgen .tbl line's trailing '|' counts as one more field and the
    scan fails, as the reference's does; so do an unknown server and a
    missing file, with the reference's messages."""
    tbl = tmp_path / "r.tbl"
    tbl.write_text("0|AFRICA|lar deposits|\n")
    p = Pair(shard_groups=16)
    p.both(f"create foreign table r (k bigint, n text, c text) server file "
           f"options (filename '{tbl}', delimiter '|')")
    p.raises("select * from r", "expected 3 fields, got 4")
    p.both(f"create foreign table r2 (k bigint, n text, c text) server file "
           f"options (filename '{tmp_path / 'absent'}')")
    p.raises("select * from r2", "cannot read")
    p.both("create foreign table r3 (k bigint) server s3 options "
           "(filename 'x')")
    p.raises("select * from r3", "unknown foreign server")
    p.raises("create foreign table r (k bigint) server file options "
             "(filename 'x')", "already exists")
    tbl.write_text("0|AFRICA|lar deposits\n1|AMERICA|hs use\n")
    assert p.query("select k, n from r order by k") == [
        (0, "AFRICA"), (1, "AMERICA")]
    p.close()


def test_foreign_store_caches_by_mtime_and_size(tmp_path):
    path = tmp_path / "m.csv"
    path.write_text("1\n2\n")
    c = Cluster(num_datanodes=2, shard_groups=16, device="cpu")
    c.session().execute(f"create foreign table m (v bigint) server file "
                        f"options (filename '{path}')")
    meta = c.catalog.get("m")
    first = fdw.foreign_store(meta)
    assert fdw.foreign_store(meta) is first
    path.write_text("1\n2\n3\n")
    again = fdw.foreign_store(meta)
    assert again is not first and again.nrows == 3
    c.close()


def test_carry_a_foreign_table(tmp_path):
    path = tmp_path / "carry.csv"
    path.write_text("1,x\n2,y\n")
    p = Pair(shard_groups=16)
    p.rs.execute(f"create foreign table cf (k bigint, s text) server file "
                 f"options (filename '{path}', format 'csv')")
    meta = p.rc.catalog.get("cf")
    carry.foreign_table(p.pc, "cf", {"k": "int8", "s": "text"},
                        meta.foreign["server"],
                        {k: v for k, v in meta.foreign.items()
                         if k != "server"})
    assert p.pc.catalog.get("cf").foreign == meta.foreign
    assert p.query("select k, s from cf order by k") == [(1, "x"), (2, "y")]
    p.close()


def test_datanode_processes_leave_the_source_to_the_coordinator(tmp_path):
    """With datanode processes attached, a foreign table's fragment runs
    on the coordinator, which reads the file; the other fragments still
    run in the processes. (The reference ships it to node 0's process,
    which reads the source, not stores, but encodes its TEXT into its own
    dictionaries: the coordinator then fails to decode the codes,
    IndexError, ROADMAP C.)"""
    from test_torch_dn import topology_impl

    path = tmp_path / "dn.csv"
    path.write_text("1,one\n3,three\n")
    gen = topology_impl(tmp_path)
    c, s, rs, _procs, _sender = next(gen)
    try:
        sql = (f"create foreign table dft (k bigint, name text) server file "
               f"options (filename '{path}', format 'csv')")
        s.execute(sql)
        rs.execute(sql)
        s.execute("set enable_fused_execution = off")
        rs.execute("set enable_fused_execution = off")
        q = "select k, name from dft order by k"
        assert s.query(q) == rs.query(q) == [(1, "one"), (3, "three")]
        assert not any(i.get("remote")
                       for i in s.last_executor.instrumentation)
        q = ("select t.k, dft.name from t join dft on t.k = dft.k "
             "order by t.k")
        assert s.query(q) == rs.query(q) == [(1, "one"), (3, "three")]
        s.query("select count(*) from t")
        assert all(i.get("remote") for i in s.last_executor.instrumentation)
    finally:
        gen.close()

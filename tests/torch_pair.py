"""One statement stream into a reference ``Cluster`` and a port one
(``device="cpu"``), for the port's DML and transaction parity tests
(tests/test_torch_savepoints.py, _constraints, _dml_from, _alter,
_compaction, _dml_differential). Answers, command tags, row counts and
error messages must be equal, exactly; a query over FLOAT8 sums may ask
for a relative 1e-6 (``rel``: summation order), integers, DECIMAL and
TEXT stay exact."""

import math
import os

import pytest

from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu_torch import Cluster

FLOAT8_REL = 1e-6  # FLOAT8 sums: the order of summation


def same_value(a, b, rel: float = 0.0) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or (rel > 0 and math.isclose(a, b, rel_tol=rel))
    return a == b and type(a) is type(b)


def same_rows(a, b, rel: float = 0.0) -> bool:
    return len(a) == len(b) and all(
        len(x) == len(y) and all(same_value(u, v, rel)
                                 for u, v in zip(x, y))
        for x, y in zip(a, b))


def assert_same_rows(got, want, what="", rel: float = 0.0):
    assert same_rows(got, want, rel), (what, got, want)


def make_clusters(nd=2, shard_groups=16, data_dir=None, conf=None):
    """(reference, port) clusters; ``data_dir``: each under its own
    subdirectory ("ref", "port"), with ``conf`` written to each one's
    opentenbase.conf first."""
    dirs = (None, None)
    if data_dir is not None:
        dirs = (os.path.join(data_dir, "ref"), os.path.join(data_dir, "port"))
        for d in dirs:
            os.makedirs(d, exist_ok=True)
            if conf:
                with open(os.path.join(d, "opentenbase.conf"), "w") as f:
                    f.writelines(f"{k} = {v}\n" for k, v in conf.items())
    return (RefCluster(num_datanodes=nd, shard_groups=shard_groups,
                       data_dir=dirs[0]),
            Cluster(num_datanodes=nd, shard_groups=shard_groups,
                    data_dir=dirs[1], device="cpu"))


def recover_clusters(data_dir, nd=2, shard_groups=16, swap=False):
    """Each package recovers its own directory, or with ``swap`` the
    other package's: (reference, port)."""
    rd, pd = (os.path.join(data_dir, "ref"), os.path.join(data_dir, "port"))
    if swap:
        rd, pd = pd, rd
    return (RefCluster.recover(rd, num_datanodes=nd,
                               shard_groups=shard_groups),
            Cluster.recover(pd, num_datanodes=nd, shard_groups=shard_groups,
                            device="cpu"))


class Pair:
    """A reference session and a port session fed the same statements."""

    def __init__(self, nd=2, shard_groups=16, data_dir=None, conf=None,
                 clusters=None):
        self.rc, self.pc = clusters or make_clusters(
            nd, shard_groups, data_dir, conf)
        self.rs, self.ps = self.rc.session(), self.pc.session()

    def sessions(self):
        """A fresh (reference, port) session pair on the same clusters."""
        return self.rc.session(), self.pc.session()

    def set_fused(self, fused: str) -> None:
        for s in (self.rs, self.ps):
            s.execute(f"set enable_fused_execution = {fused}")

    def both(self, sql: str, sessions=None):
        """Run on both: equal command, rows and row count, or equal
        errors. Returns the port's result (or its exception)."""
        rs, ps = sessions or (self.rs, self.ps)
        out = []
        for s in (rs, ps):
            try:
                out.append(s.execute(sql))
            except Exception as e:  # noqa: BLE001 - compared across packages
                out.append(e)
        want, got = out
        if isinstance(want, Exception) or isinstance(got, Exception):
            assert isinstance(want, Exception) and isinstance(
                got, Exception), (sql, want, got)
            assert str(got) == str(want), (sql, str(want), str(got))
            return got
        assert got.command == want.command, (sql, want.command, got.command)
        assert_same_rows(got.rows, want.rows, sql)
        assert got.rowcount == want.rowcount, (sql, want.rowcount,
                                               got.rowcount)
        return got

    def query(self, sql: str, fused=("on", "off"), sessions=None,
              rel: float = 0.0):
        """A query on both, with the fused route on and off; the rows
        (``rel``: FLOAT8_REL where the query sums FLOAT8)."""
        rs, ps = sessions or (self.rs, self.ps)
        rows = None
        for f in fused:
            for s in (rs, ps):
                s.execute(f"set enable_fused_execution = {f}")
            want = rs.query(sql)
            assert_same_rows(ps.query(sql), want, (sql, f), rel)
            rows = want
        for s in (rs, ps):
            s.execute("set enable_fused_execution = on")
        return rows

    def raises(self, sql: str, match: str, sessions=None):
        """Both refuse with the reference's message."""
        err = self.both(sql, sessions)
        assert isinstance(err, Exception), sql
        with pytest.raises(Exception, match=match):
            raise err
        return err

    def close(self) -> None:
        self.rc.close()
        self.pc.close()

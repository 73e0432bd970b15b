"""A seeded cross-package differential over this slice's writes
(tests/test_differential.py's generator, turned to DML): random
sequences of upserts, UPDATE ... FROM, DELETE ... USING, savepoint
rollbacks, TRUNCATE and ADD/DROP COLUMN over about 160 rows with NULLs
and TEXT run on a reference and a port cluster (tests/torch_pair.py), on
1 and 2 datanodes; after each COMMIT every table and a few aggregates
are compared with the fused route on and off. Plus ROADMAP C's DISTINCT
aggregate over a join as a fixed case."""

import random

import pytest

from torch_pair import FLOAT8_REL, Pair

ROWS = 160
WORDS = ["zeta", "alpha", "mid", "beta", None]


def _lit(w):
    return "null" if w is None else f"'{w}'"


def _setup(rng):
    rows = ",".join(
        f"({k}, {rng.randrange(0, 6)}, {rng.randrange(-50, 200)}, "
        f"{_lit(rng.choice(WORDS))}, {rng.randrange(0, 8)})"
        for k in range(ROWS))
    src = ",".join(
        f"({k}, {rng.randrange(-20, 60)}, {_lit(rng.choice(WORDS))})"
        for k in rng.sample(range(ROWS + 40), 60))
    return [
        "create table dt (k bigint primary key, g bigint, v bigint, "
        "w text, d bigint) distribute by shard(k)",
        "create table src (k bigint, x bigint, s text) "
        "distribute by shard(k)",
        f"insert into dt values {rows}",
        f"insert into src values {src}",
    ]


class Gen:
    """The statement stream of one seed."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.next_key = ROWS + 1000
        self.extra = False  # dt's added column

    def _keys(self, n):
        """``n`` distinct keys, about half of them existing ones."""
        rng = self.rng
        out = set()
        while len(out) < n:
            if rng.random() < 0.5:
                out.add(rng.randrange(0, ROWS + 40))
            else:
                self.next_key += 1
                out.add(self.next_key)
        return sorted(out)

    def _row(self, k):
        rng = self.rng
        vals = [k, rng.randrange(0, 6), rng.randrange(-50, 200),
                _lit(rng.choice(WORDS)), rng.randrange(0, 8)]
        if self.extra:
            vals.append(rng.choice(["null", str(rng.randrange(9))]))
        return "(" + ", ".join(map(str, vals)) + ")"

    def write(self) -> str:
        rng = self.rng
        kind = rng.randrange(9)
        if kind == 0:
            keys = self._keys(rng.choice([3, 8]))
            return ("insert into dt values "
                    + ",".join(self._row(k) for k in keys)
                    + " on conflict (k) do update set v = excluded.v, "
                    "w = excluded.w")
        if kind == 1:
            keys = self._keys(rng.choice([2, 6]))
            return ("insert into dt values "
                    + ",".join(self._row(k) for k in keys)
                    + " on conflict do nothing returning k")
        if kind == 2:
            return (f"update dt set v = dt.v + src.x, w = src.s from src "
                    f"where dt.k = src.k and src.x > {rng.randrange(-10, 50)}"
                    " returning k, v")
        if kind == 3:
            return (f"delete from dt using src where src.k = dt.k and "
                    f"src.x < {rng.randrange(-20, 10)}")
        if kind == 4:
            return (f"update dt set d = d + 1, w = 'upd' where g = "
                    f"{rng.randrange(6)} and v > {rng.randrange(-50, 150)}")
        if kind == 5:
            return f"delete from dt where v % 11 = {rng.randrange(11)}"
        if kind == 6:
            keys = sorted(rng.sample(range(ROWS + 40, ROWS + 400), 4))
            return "insert into src values " + ",".join(
                f"({k}, {rng.randrange(-20, 60)}, {_lit(rng.choice(WORDS))})"
                for k in keys)
        if kind == 7:
            return f"delete from src where x < {rng.randrange(-20, 30)}"
        return (f"update dt set v = (select max(x) from src) where k = "
                f"{rng.randrange(ROWS)}")

    def ddl(self) -> list:
        rng = self.rng
        if rng.random() < 0.4:
            return ["truncate table src", "insert into src values "
                    + ",".join(f"({k}, {rng.randrange(-20, 60)}, "
                               f"{_lit(rng.choice(WORDS))})"
                               for k in rng.sample(range(ROWS + 40), 30))]
        self.extra = not self.extra
        return ["alter table dt add column extra bigint" if self.extra
                else "alter table dt drop column extra"]

    def step(self) -> list:
        """One transaction, or DDL outside one."""
        rng = self.rng
        r = rng.random()
        if r < 0.15:
            return self.ddl()
        if r < 0.45:
            return [self.write()]
        body = ["begin"]
        for _ in range(rng.randrange(1, 4)):
            if rng.random() < 0.4:
                body += ["savepoint s", self.write(), self.write()]
                body.append("rollback to savepoint s" if rng.random() < 0.6
                            else "release savepoint s")
            else:
                body.append(self.write())
        body.append("commit" if rng.random() < 0.8 else "rollback")
        return body


CHECKS = (
    "select * from dt order by k",
    "select * from src order by k",
    "select g, count(*), sum(v), min(w), max(w) from dt group by g "
    "order by g",
    "select count(*), sum(dt.v), count(src.s), max(src.s) from dt join src "
    "on dt.k = src.k",
)


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("seed", [5, 23])
def test_dml_sequences_agree(seed, nd):
    gen = Gen(seed)
    p = Pair(nd=nd)
    for sql in _setup(gen.rng):
        p.both(sql)
    for _ in range(14):
        for sql in gen.step():
            p.both(sql)
        for q in CHECKS:
            p.query(q, rel=FLOAT8_REL)
    p.close()


def test_distinct_aggregate_over_a_join():
    """ROADMAP C item 1: a DISTINCT aggregate grouped by a replicated
    dimension's column over a join. The port answers on both routes as
    the reference's host route does; the reference's fused route raises
    IndexError in its coordinator merge, its own fault."""
    p = Pair()
    for sql in ("create table f (k bigint, g int, s text) "
                "distribute by shard(k)",
                "create table dim (g int, nm text) distribute by replication",
                "insert into f values (1,1,'a'),(2,1,'b'),(3,1,'a'),"
                "(4,2,NULL),(5,2,'c'),(6,3,'a')",
                "insert into dim values (1,'one'),(2,'two'),(4,'four')"):
        p.both(sql)
    want = [("one", 2), ("two", 1)]
    for q, w in (
            ("select nm, count(distinct s) from f join dim on f.g = dim.g "
             "group by nm order by nm", want),
            ("select nm, count(distinct k) from f join dim on f.g = dim.g "
             "group by nm order by nm", [("one", 3), ("two", 2)]),
            ("select nm, sum(distinct k) from f join dim on f.g = dim.g "
             "group by nm order by nm", [("one", 6), ("two", 9)])):
        p.set_fused("off")
        assert p.rs.query(q) == p.ps.query(q) == w
        p.set_fused("on")
        assert p.ps.query(q) == w
        with pytest.raises(IndexError):
            p.rs.query(q)
    p.close()

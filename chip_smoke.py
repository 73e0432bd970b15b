#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (opentenbase_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 42] [--rows 60000000]
                          [--ssb-rows 60000000] [--q3-sf 10]
                          [--hits-rows 60000000]
                          [--sf100-rows 603979776] [--repeats 5]

Phases, one line each; any failure raises and exits non-zero:

1. card: the nvidia-smi name and power limit, and torch's device name;
2. build: every kernel compiled from csrc/ (one nvcc each, in parallel),
   with the registers, spills and shared memory ptxas reports;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, exactly equal. scan_agg: int32/int64/bool columns, G=1 and G=6,
   compact and full MVCC planes with invisible rows (and a run hidden in
   the middle of a tile), shards whose nrows is no tile multiple, shards
   shorter than a tile and an empty one, a spec with no predicate, and
   the widest spec compile_spec accepts (16 columns, 16 groups, 8
   values, stack depth 16). radix_probe: the reference test's data,
   int32 and int64 keys, keys near +-2^62, dead and NULL probe rows, an
   empty build, duplicate build keys, n not a multiple of a thread's
   rows, probes starting at an offset view, and every pass of a
   multi-pass plan;
4. main path, TPC-H: Cluster(num_datanodes=2) on cuda, CREATE TABLE
   lineitem, a bulk append of ``--rows`` rows (60 M = TPC-H SF10, as
   bench.py measures it) made from ``--seed``, then Q6 and Q1 through
   Session.query through the scan-aggregate kernel;
5. main path, SSB: a second cluster holding SSB lineorder (``--ssb-rows``,
   60 M = SF10, round robin over 2 datanodes) and DATE, PART, SUPPLIER
   and CUSTOMER at the same scale factor (replicated; TEXT attributes as
   dictionary codes), loaded once, then query flight 1 (Q1.1-Q1.3)
   through Session.query: a star join through the fused DAG's scalar
   mode and the radix-probe kernel; then flights 2-4 (Q2.1-Q4.3): star
   joins of three or four dimensions, filtered and grouped on TEXT,
   through the DAG's grouped mode (DATE by the radix probe, the other
   dimensions by the dense fold). Every answer must equal a numpy
   computation over the same arrays exactly, and every kernel of each
   path must have launched in that path's run (counts set to 0 just
   before each query and read just after);
5c. main path, device top-k: TPC-H Q3 through the fused DAG's ranking
   modes, once with bench.py's dense order keys (orders and customer
   added to phase 4's cluster: gagg over two folds) and once as the spec
   writes it over dbgen-shaped data at ``--q3-sf`` (sparse order keys,
   TEXT segments, its own cluster: gsort), then ClickBench's top-10
   UserIDs over ``--hits-rows`` rows (full-range ids: the grouped mode,
   every group shipped, as the reference). Each exact against numpy in
   the mode the CPU tests fixed, with K1's and K2's launches counted;
5d. main path, fragment program and coordinator expressions: TPC-H Q1
   as the spec writes it (three avgs, sum_charge) over phase 5c's
   lineitem (its columns Q1 reads), and ClickBench Q0, Q1, Q2, Q6 and
   Q7 over phase 5c's hits (AdvEngineID, ResolutionWidth and EventDate
   added). Each exact against numpy on the route and rung the CPU tests
   fixed (FRAGMENT_ROUTES: the kernel where the certifier takes the
   fragment, else the fragment program's scalar or hash rung), K1
   launched once on its route and never on the program's;
6. timing, per path: median end-to-end ms per query, the layers each
   timed on its own, the device busy and idle share of single queries
   from a torch.profiler trace, kernel ms from CUDA events at the main
   path's own inputs (held against the plain version there too), the
   plain version's ms, the bytes-over-bandwidth bound and the GB/s
   moved;
7. main path, bench.py's TPC-H SF100 leg: lineitem ``--sf100-rows``
   (603 979 776 = 2^26 * 9, SF 100.6), orders a quarter, customer a
   fortieth, made from ``--seed`` on the host (cut to what the host can
   check, as bench.py cuts it, and printed as ``reduced:``), registered
   on the card as device-resident external tables in one datanode.
   OTB_SCAN_HBM_BUDGET is 11 GB and OTB_DIMFOLD_MAX 260 M rows, as
   bench.py sets them, so that Q6's four resident columns (9.7 GB) stay
   on K1's route and the 151 M-row orders side folds. Q6 through K1 in
   one launch; Q3 through the windowed gagg (16 windows under the 6 GB
   window budget) with the orders side hoisted and both joins folded,
   all ten rows exact against numpy; K1 held against its plain version
   at Q6's inputs.

The second-to-last lines are the kernel table as JSON and the nvidia-smi
line; the last line is the run's verdict as JSON. The script imports
neither jax nor the reference package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# HBM bandwidth of the SXM H100 (NVIDIA data sheet), bytes/s. The scan
# is bound by bytes: its few dozen integer operations a row are far
# below the card's ratio of operations to bytes.
HBM_RATE = {"NVIDIA H100 80GB HBM3": 3.35e12}

Q6 = (
    "select sum(l_extendedprice * l_discount) from lineitem "
    "where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' "
    "and l_discount between 0.05 and 0.07 and l_quantity < 24"
)
Q1 = (
    "select l_returnflag, l_linestatus, sum(l_quantity), "
    "sum(l_extendedprice), sum(l_extendedprice * l_discount), "
    "count(*) from lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)
LINEITEM_DDL = (
    "create table lineitem (l_orderkey bigint, l_quantity numeric(10,2), "
    "l_extendedprice numeric(12,2), l_discount numeric(4,2), "
    "l_shipdate date, l_returnflag int, l_linestatus int) "
    "distribute by roundrobin"
)


def make_lineitem(n: int, seed: int = 42):
    """The lineitem generator of bench.py (make_lineitem), copied."""
    rng = np.random.default_rng(seed)
    n_orders = max(n // 4, 1)
    return {
        "l_orderkey": rng.integers(1, n_orders + 1, n).astype(np.int64),
        "l_quantity": (rng.uniform(1, 51, n) * 100).astype(np.int64),
        "l_extendedprice": (rng.uniform(900, 105000, n)).astype(np.int64),
        "l_discount": rng.integers(0, 11, n).astype(np.int64),
        "l_shipdate": (8036 + rng.integers(0, 2556, n)).astype(np.int32),
        "l_returnflag": rng.integers(0, 3, n).astype(np.int32),
        "l_linestatus": rng.integers(0, 2, n).astype(np.int32),
    }


def make_q3_dims(n: int, seed: int = 43):
    """The orders and customer generator of bench.py (make_q3_dims),
    copied: n/4 orders with dense keys 1..n/4 and n/40 customers, the
    segment an int code (0 plays BUILDING)."""
    rng = np.random.default_rng(seed)
    n_orders = max(n // 4, 1)
    n_cust = max(n // 40, 1)
    orders = {
        "o_orderkey": np.arange(1, n_orders + 1, dtype=np.int64),
        "o_custkey": rng.integers(1, n_cust + 1, n_orders).astype(np.int64),
        "o_orderdate": (8036 + rng.integers(0, 2405, n_orders)).astype(
            np.int32),
        "o_shippriority": rng.integers(0, 3, n_orders).astype(np.int32),
    }
    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_mktsegment": rng.integers(0, 5, n_cust).astype(np.int32),
    }
    return orders, customer


# bench.py's orders and customer beside phase 4's lineitem, and its Q3
Q3_DENSE_DDL = (
    "create table orders (o_orderkey bigint, o_custkey bigint, "
    "o_orderdate date, o_shippriority int) distribute by roundrobin",
    "create table customer (c_custkey bigint, c_mktsegment int) "
    "distribute by roundrobin",
)
Q3_DENSE = (
    "select l_orderkey, sum(l_extendedprice * (1 - l_discount)), "
    "o_orderdate, o_shippriority "
    "from customer, orders, lineitem "
    "where c_mktsegment = 0 and c_custkey = o_custkey "
    "and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15' "
    "and l_shipdate > date '1995-03-15' "
    "group by l_orderkey, o_orderdate, o_shippriority "
    "order by 2 desc, o_orderdate limit 10"
)
# TPC-H rev. 3 Q3 (section 2.4.3) with its validation substitutions,
# over the columns it reads, every table round robin (bench.py's layout)
Q3_SPEC_DDL = (
    "create table customer (c_custkey bigint, c_mktsegment text) "
    "distribute by roundrobin",
    "create table orders (o_orderkey bigint, o_custkey bigint, "
    "o_orderdate date, o_shippriority int) distribute by roundrobin",
    "create table lineitem (l_orderkey bigint, "
    "l_extendedprice numeric(12,2), l_discount numeric(4,2), "
    "l_shipdate date, l_quantity numeric(10,2), l_tax numeric(4,2), "
    "l_receiptdate date, l_returnflag text, l_linestatus text) "
    "distribute by roundrobin",
)
Q3_SPEC = (
    "select l_orderkey, sum(l_extendedprice*(1-l_discount)) as revenue, "
    "o_orderdate, o_shippriority "
    "from customer, orders, lineitem "
    "where c_mktsegment = 'BUILDING' "
    "and c_custkey = o_custkey and l_orderkey = o_orderkey "
    "and o_orderdate < date '1995-03-15' "
    "and l_shipdate > date '1995-03-15' "
    "group by l_orderkey, o_orderdate, o_shippriority "
    "order by revenue desc, o_orderdate limit 10"
)
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")


class Text:
    """A TEXT column as indices into a small vocabulary (``vocab[idx]``
    are the strings): ``encode_text`` codes it without sorting a
    string per row."""

    def __init__(self, vocab, idx):
        self.vocab = np.asarray(vocab)
        self.idx = np.asarray(idx)

    def __len__(self) -> int:
        return len(self.idx)


def make_q3_spec(sf: float, seed: int = 42) -> dict:
    """The lineitem columns TPC-H Q3 and Q1 read, and those of customer
    and orders Q3 reads, as dbgen makes them (spec rev. 3, section
    4.2.3), at scale factor ``sf``: customer 150 000 x SF rows, keys
    1..N, the segment uniform over the five; orders 1 500 000 x SF rows
    with SPARSE keys (the first 8 of every 32), a customer uniform over
    the keys not divisible by 3, a date uniform over 1992-01-01 ..
    1998-08-02 and priority 0; 1-7 lines an order, quantity 1-50, the
    extended price the quantity times the part's retail price (90000 +
    (partkey / 10) mod 20001 + 100 (partkey mod 1000), in cents, over
    200 000 x SF parts), discount 0.00-0.10, a ship date 1-121 days
    after the order, tax 0.00-0.08, a receipt date 1-30 days after the
    ship date, the return flag 'R' or 'A' at random where the receipt
    date is on or before 1995-06-17 (dbgen's CURRENTDATE) and 'N'
    after it, the line status 'O' where the ship date is after
    1995-06-17 and 'F' otherwise."""
    rng = np.random.default_rng(seed)
    n_c = max(int(150_000 * sf), 3)
    n_o = max(int(1_500_000 * sf), 1)
    n_p = max(int(200_000 * sf), 1)
    i = np.arange(n_o, dtype=np.int64)
    okey = i // 8 * 32 + i % 8 + 1
    free = n_c - n_c // 3  # customer keys not divisible by 3
    j = rng.integers(0, free, n_o)
    odate = rng.integers(_day("1992-01-01"), _day("1998-08-02") + 1,
                         n_o).astype(np.int32)
    lines = rng.integers(1, 8, n_o)
    oi = np.repeat(i, lines)
    n_l = len(oi)
    pk = rng.integers(1, n_p + 1, n_l)
    retail = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000)
    # the draws Q3's columns take come first, in their earlier order,
    # so Q3's data does not change with the columns Q1 adds
    segment = rng.integers(0, 5, n_c)
    qty = rng.integers(1, 51, n_l)
    disc = rng.integers(0, 11, n_l).astype(np.int64)
    ship = (odate[oi] + rng.integers(1, 122, n_l)).astype(np.int32)
    tax = rng.integers(0, 9, n_l).astype(np.int64)
    receipt = (ship + rng.integers(1, 31, n_l)).astype(np.int32)
    current = _day("1995-06-17")
    # 'A' or 'R' where received by CURRENTDATE, else 'N' (RF_VOCAB)
    flag = np.where(receipt <= current,
                    np.where(rng.random(n_l) < 0.5, 0, 2), 1)
    return {
        "customer": {
            "c_custkey": np.arange(1, n_c + 1, dtype=np.int64),
            "c_mktsegment": np.array(SEGMENTS)[segment],
        },
        "orders": {
            "o_orderkey": okey,
            "o_custkey": (j + j // 2 + 1).astype(np.int64),
            "o_orderdate": odate,
            "o_shippriority": np.zeros(n_o, dtype=np.int32),
        },
        "lineitem": {
            "l_orderkey": okey[oi],
            "l_extendedprice": (qty * retail).astype(np.int64),
            "l_discount": disc,
            "l_shipdate": ship,
            "l_quantity": (qty * 100).astype(np.int64),
            "l_tax": tax,
            "l_receiptdate": receipt,
            "l_returnflag": Text(RF_VOCAB, flag.astype(np.int8)),
            "l_linestatus": Text(LS_VOCAB, (ship > current).astype(np.int8)),
        },
    }


RF_VOCAB = ("A", "N", "R")
LS_VOCAB = ("F", "O")
# TPC-H rev. 3 Q1 (section 2.4.1) with its validation DELTA = 90: the
# spec's `interval '90' day (3)`, in the interval syntax both parsers
# take
Q1_SPEC = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice) as sum_base_price, "
    "sum(l_extendedprice*(1-l_discount)) as sum_disc_price, "
    "sum(l_extendedprice*(1-l_discount)*(1+l_tax)) as sum_charge, "
    "avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price, "
    "avg(l_discount) as avg_disc, count(*) as count_order "
    "from lineitem "
    "where l_shipdate <= date '1998-12-01' - interval '90 days' "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)


def _avg32(total: int, scale: int, n: int) -> float:
    """The reference's avg: CAST(sum AS FLOAT8) / CAST(count AS FLOAT8),
    computed FLOAT8 being float32 on its device (a decimal sum divided
    by its scale factor in float64 first)."""
    return float(np.float32(np.float64(total) / scale) / np.float32(n))


def expected_q1_spec(li) -> list:
    """TPC-H Q1 in numpy over the same arrays: exact scaled-integer sums
    per (return flag, line status) in string order, the averages as the
    reference computes them (``_avg32``)."""
    m = li["l_shipdate"] <= _day("1998-09-02")
    rf, ls = li["l_returnflag"].idx, li["l_linestatus"].idx
    rows = []
    for fi in sorted(range(len(RF_VOCAB)), key=RF_VOCAB.__getitem__):
        for si in sorted(range(len(LS_VOCAB)), key=LS_VOCAB.__getitem__):
            g = m & (rf == fi) & (ls == si)
            n = int(g.sum())
            if not n:
                continue
            q, p = li["l_quantity"][g], li["l_extendedprice"][g]
            d, tx = li["l_discount"][g], li["l_tax"][g]
            sq, sp, sd = int(q.sum()), int(p.sum()), int(d.sum())
            disc_price = p * (100 - d)
            rows.append((
                RF_VOCAB[fi], LS_VOCAB[si], sq / 100, sp / 100,
                int(disc_price.sum()) / 10**4,
                int((disc_price * (100 + tx)).sum()) / 10**6,
                _avg32(sq, 100, n), _avg32(sp, 100, n), _avg32(sd, 100, n),
                n,
            ))
    return rows


def _key_pos(keys, probe):
    """Each probe value's row in ``keys`` (unique positive integers), -1
    where it has none: a lookup table over the key range (a search of
    the sorted keys would pay a cache miss a step for unsorted probes)."""
    table = np.full(int(keys.max()) + 2, -1, dtype=np.int64)
    table[keys] = np.arange(len(keys))
    return table[np.clip(probe, 0, len(table) - 1)]


def expected_q3(lineitem, orders, customer, building) -> list:
    """Q3 in numpy over the same arrays: each line's order and each
    order's customer by key, the filters, exact revenues (scale 4) per
    order, and the first ten by revenue descending, then order date,
    then order key."""
    cut = _day("1995-03-15")
    cpos = _key_pos(customer["c_custkey"], orders["o_custkey"])
    o_ok = (cpos >= 0) & (customer["c_mktsegment"][cpos] == building) & (
        orders["o_orderdate"] < cut)
    ok_ = orders["o_orderkey"]
    opos = _key_pos(ok_, lineitem["l_orderkey"])
    m = (opos >= 0) & o_ok[opos] & (lineitem["l_shipdate"] > cut)
    rev = lineitem["l_extendedprice"][m] * (100 - lineitem["l_discount"][m])
    # float64 sums are exact here: every order's sum is far below 2^53
    sums = np.rint(np.bincount(opos[m], weights=rev, minlength=len(ok_))
                   ).astype(np.int64)
    has = np.bincount(opos[m], minlength=len(ok_)) > 0
    g = np.nonzero(has)[0]
    top = g[np.lexsort((ok_[g], orders["o_orderdate"][g], -sums[g]))[:10]]
    return [(int(ok_[o]), int(sums[o]) / 10**4,
             str(np.datetime64(int(orders["o_orderdate"][o]), "D")),
             int(orders["o_shippriority"][o])) for o in top]


# bench.py's TPC-H SF100 leg (bench.py:1645): int-typed columns (dates
# as day numbers, prices and discounts as integers), one datanode, the
# three tables round robin; lineitem 2^26 * 9 rows (SF 100.6), which the
# window budget halves evenly into 16 windows, orders a quarter of it
# (dense keys 1..N/4), customer a fortieth
SF100_ROWS = 603_979_776
SF100_DDL = (
    "create table lineitem (l_orderkey int, l_quantity int, "
    "l_extendedprice int, l_discount int, l_shipdate int) "
    "distribute by roundrobin",
    "create table orders (o_orderkey int, o_custkey int, "
    "o_orderdate int, o_shippriority int) distribute by roundrobin",
    "create table customer (c_custkey int, c_mktsegment int) "
    "distribute by roundrobin",
)
SF100_Q6 = (
    "select sum(l_extendedprice * l_discount) from lineitem "
    "where l_shipdate >= 8766 and l_shipdate < 9131 "
    "and l_discount between 5 and 7 and l_quantity < 2400"
)
SF100_Q3 = (
    "select l_orderkey, sum(l_extendedprice * (10 - l_discount)), "
    "o_orderdate, o_shippriority "
    "from customer, orders, lineitem "
    "where c_mktsegment = 0 and c_custkey = o_custkey "
    "and l_orderkey = o_orderkey and o_orderdate < 9204 "
    "and l_shipdate > 9204 "
    "group by l_orderkey, o_orderdate, o_shippriority "
    "order by 2 desc, o_orderdate limit 10"
)


def sf100_domains(n: int) -> dict:
    """Each generated column's [lo, hi) (bench.py's specs_li, specs_ord
    and customer's segment) for ``n`` lineitem rows."""
    no, nc = n // 4, n // 40
    return {
        "lineitem": {
            "l_orderkey": (1, no + 1), "l_quantity": (100, 5100),
            "l_extendedprice": (900, 105001), "l_discount": (0, 11),
            "l_shipdate": (8036, 8036 + 2556)},
        "orders": {
            "o_custkey": (1, nc + 1), "o_orderdate": (8036, 8036 + 2405),
            "o_shippriority": (0, 3)},
        "customer": {"c_mktsegment": (0, 5)},
    }


def make_sf100(n: int, seed: int = 42) -> dict:
    """bench.py's SF100 tables at ``n`` lineitem rows, made from
    ``seed`` with numpy (one stream a column, so each column is the same
    whatever else is made): {table: {column: int32 array}}."""
    out = {"orders": {"o_orderkey": np.arange(1, n // 4 + 1,
                                              dtype=np.int32)},
           "customer": {"c_custkey": np.arange(1, n // 40 + 1,
                                               dtype=np.int32)},
           "lineitem": {}}
    rows = {"lineitem": n, "orders": n // 4, "customer": n // 40}
    i = 0
    for table, cols in sf100_domains(n).items():
        for name, (lo, hi) in cols.items():
            rng = np.random.default_rng([seed, i])
            out[table][name] = rng.integers(lo, hi, rows[table],
                                            dtype=np.int32)
            i += 1
    return out


def expected_sf100_q6(t) -> list:
    li = t["lineitem"]
    ship, disc = li["l_shipdate"], li["l_discount"]
    keep = ((ship >= 8766) & (ship < 9131) & (disc >= 5) & (disc <= 7)
            & (li["l_quantity"] < 2400))
    if not keep.any():
        return [(None,)]
    return [(int(np.sum(li["l_extendedprice"][keep].astype(np.int64)
                        * disc[keep])),)]


def expected_sf100_q3(t) -> list:
    """All ten rows of SF100_Q3 in numpy: revenue per order of the lines
    shipped after day 9204 of orders placed before it by segment-0
    customers; ranked by revenue descending, then order date, then order
    key (the device keeps the lowest key on a full tie). Order and
    customer keys are dense from 1, so a key is its row + 1."""
    li, od, cu = t["lineitem"], t["orders"], t["customer"]
    seg0 = np.zeros(len(cu["c_custkey"]) + 1, dtype=bool)
    seg0[cu["c_custkey"][cu["c_mktsegment"] == 0]] = True
    okeep = np.zeros(len(od["o_orderkey"]) + 1, dtype=bool)
    okeep[od["o_orderkey"]] = (od["o_orderdate"] < 9204) & seg0[
        od["o_custkey"]]
    m = li["l_shipdate"] > 9204
    m &= okeep[li["l_orderkey"]]
    key = li["l_orderkey"][m]
    rev = li["l_extendedprice"][m].astype(np.int64) * (
        10 - li["l_discount"][m])
    # float64 sums are exact: every order's revenue is far below 2^53
    sums = np.rint(np.bincount(key, weights=rev, minlength=len(okeep))
                   ).astype(np.int64)
    g = np.nonzero(np.bincount(key, minlength=len(okeep)))[0]
    date = od["o_orderdate"][g - 1]
    top = np.lexsort((g, date, -sums[g]))[:10]
    return [(int(g[i]), int(sums[g[i]]), int(date[i]),
             int(od["o_shippriority"][g[i] - 1])) for i in top]


# hits' columns the queries here read, typed as ClickBench's create.sql
CLICKBENCH_DDL = (
    "create table hits (UserID bigint, AdvEngineID smallint, "
    "ResolutionWidth smallint, EventDate date) distribute by roundrobin")
# ClickBench queries.sql, the top-10 users by hits
CLICKBENCH_Q = ("SELECT UserID, COUNT(*) FROM hits GROUP BY UserID "
                "ORDER BY COUNT(*) DESC LIMIT 10")
# hits_100m: 99 997 497 rows, 17 630 976 distinct UserIDs
HITS_DISTINCT_SHARE = 17_630_976 / 99_997_497


def make_hits(n: int, users: int, seed: int = 42) -> dict:
    """hits' UserID column: ``users`` distinct ids drawn over the signed
    64-bit range, each in at least one row, the other rows' users drawn
    with Zipf weights (s = 1.1) over a random ranking of the ids, so
    the largest counts are far apart; rows shuffled."""
    rng = np.random.default_rng(seed)
    ids = np.unique(rng.integers(-(2**63), 2**63 - 1, users + users // 100
                                 + 16, dtype=np.int64))
    ids = rng.permutation(ids)[:users]
    cdf = np.cumsum(np.arange(1, users + 1, dtype=np.float64) ** -1.1)
    extra = np.searchsorted(cdf / cdf[-1], rng.random(n - users),
                            side="right")
    rows = np.concatenate([np.arange(users), np.minimum(extra, users - 1)])
    rng.shuffle(rows)
    # the scalar queries' columns, synthetic (drawn after the UserIDs,
    # which stay as they were): AdvEngineID 0 on 99 % of the rows, else
    # one of ADV_ENGINES with Zipf weights; ResolutionWidth one of
    # SCREEN_WIDTHS with their weights; EventDate uniform over July 2013
    adv = np.zeros(n, dtype=np.int32)
    ad = rng.random(n) < 0.01
    w = 1.0 / np.arange(1, len(ADV_ENGINES) + 1)
    adv[ad] = np.array(ADV_ENGINES, np.int32)[
        rng.choice(len(ADV_ENGINES), int(ad.sum()), p=w / w.sum())]
    sw = np.array([wt for _w, wt in SCREEN_WIDTHS], np.float64)
    width = np.array([w_ for w_, _wt in SCREEN_WIDTHS], np.int32)[
        rng.choice(len(SCREEN_WIDTHS), n, p=sw / sw.sum())]
    date = (_day("2013-07-01") + rng.integers(0, 31, n)).astype(np.int32)
    return {"userid": ids[rows], "advengineid": adv,
            "resolutionwidth": width, "eventdate": date}


ADV_ENGINES = (2, 3, 4, 8, 12, 13, 16, 17, 21, 22, 27, 30, 32, 35, 41, 48,
               52, 58)
SCREEN_WIDTHS = ((1366, 30), (1920, 20), (1280, 10), (1440, 8), (1600, 6),
                 (1024, 6), (1536, 5), (360, 5), (375, 3), (414, 3),
                 (768, 2), (1680, 1), (2560, 1))
# ClickBench queries.sql Q0, Q1, Q2, Q6 and Q7: single-table scalar and
# small grouped aggregates (Q3, AVG(UserID), is left out: its sum over
# full-range keys overflows int64 in the reference too)
CLICKBENCH_SCALAR_Q = {
    "ClickBench Q0": "SELECT COUNT(*) FROM hits",
    "ClickBench Q1": "SELECT COUNT(*) FROM hits WHERE AdvEngineID <> 0",
    "ClickBench Q2": ("SELECT SUM(AdvEngineID), COUNT(*), "
                      "AVG(ResolutionWidth) FROM hits"),
    "ClickBench Q6": "SELECT MIN(EventDate), MAX(EventDate) FROM hits",
    "ClickBench Q7": ("SELECT AdvEngineID, COUNT(*) FROM hits "
                      "WHERE AdvEngineID <> 0 GROUP BY AdvEngineID "
                      "ORDER BY COUNT(*) DESC"),
}
# what answers each on the port (and on the reference, one device):
# route, and the fragment program's rung (tests/test_torch_fragment.py
# fixes the same at CPU sizes)
FRAGMENT_ROUTES = {
    "TPC-H Q1 (spec)": ("program", ("hash", 64)),
    "ClickBench Q0": ("scan_agg", None),
    "ClickBench Q1": ("scan_agg", None),
    "ClickBench Q2": ("scan_agg", None),
    "ClickBench Q6": ("program", ("scalar", None)),
    "ClickBench Q7": ("program", ("hash", 64)),
}


def expected_clickbench(hits) -> list:
    """The top ten (UserID, count) pairs in numpy: counts by np.unique,
    ties in count by UserID."""
    u, c = np.unique(hits["userid"], return_counts=True)
    top = np.lexsort((u, -c))[:10]
    return [(int(u[i]), int(c[i])) for i in top]


def _date(day: int) -> str:
    return str(np.datetime64(int(day), "D"))


def expected_clickbench_scalar(hits, q: str) -> list:
    """ClickBench ``q`` in numpy over the same arrays; AVG as the
    reference computes an int column's: its partial sum is typed FLOAT8
    (float64) and the count cast to FLOAT8 (float32), divided in
    float64."""
    adv = hits["advengineid"]
    n = len(adv)
    if q == "ClickBench Q0":
        return [(n,)]
    if q == "ClickBench Q1":
        return [(int(np.count_nonzero(adv)),)]
    if q == "ClickBench Q2":
        s = int(hits["resolutionwidth"].sum(dtype=np.int64))
        return [(int(adv.sum(dtype=np.int64)), n,
                 float(np.float64(s) / np.float64(np.float32(n))))]
    if q == "ClickBench Q6":
        d = hits["eventdate"]
        return [(_date(d.min()), _date(d.max()))]
    u, c = np.unique(adv[adv != 0], return_counts=True)
    order = np.lexsort((u, -c))
    return [(int(u[i]), int(c[i])) for i in order]


SSB_DDL = (
    "create table lineorder (lo_orderdate int, lo_quantity int, "
    "lo_discount int, lo_extendedprice bigint) distribute by roundrobin",
    "create table date_dim (d_datekey int, d_year int, d_yearmonthnum int, "
    "d_weeknuminyear int) distribute by replication",
)
SSB_Q = {
    "Q1.1": (
        "select sum(lo_extendedprice * lo_discount) as revenue "
        "from lineorder, date_dim where lo_orderdate = d_datekey "
        "and d_year = 1993 and lo_discount between 1 and 3 "
        "and lo_quantity < 25"
    ),
    "Q1.2": (
        "select sum(lo_extendedprice * lo_discount) as revenue "
        "from lineorder, date_dim where lo_orderdate = d_datekey "
        "and d_yearmonthnum = 199401 and lo_discount between 4 and 6 "
        "and lo_quantity between 26 and 35"
    ),
    "Q1.3": (
        "select sum(lo_extendedprice * lo_discount) as revenue "
        "from lineorder, date_dim where lo_orderdate = d_datekey "
        "and d_weeknuminyear = 6 and d_year = 1994 "
        "and lo_discount between 5 and 7 and lo_quantity between 26 and 35"
    ),
}
# Flights 1-4 in one cluster: every column some flight reads (spec rev. 3,
# section 2; the others are left out, as no scan would upload them).
SSB_FULL_DDL = (
    "create table lineorder (lo_orderdate int, lo_quantity int, "
    "lo_discount int, lo_extendedprice bigint, lo_custkey int, "
    "lo_partkey int, lo_suppkey int, lo_revenue bigint, "
    "lo_supplycost int) distribute by roundrobin",
    "create table date_dim (d_datekey int, d_year int, d_yearmonthnum int, "
    "d_weeknuminyear int, d_yearmonth text) distribute by replication",
    "create table part (p_partkey int, p_mfgr text, p_category text, "
    "p_brand1 text) distribute by replication",
    "create table supplier (s_suppkey int, s_city text, s_nation text, "
    "s_region text) distribute by replication",
    "create table customer (c_custkey int, c_city text, c_nation text, "
    "c_region text) distribute by replication",
)
# Flights 2-4 as published (spec rev. 3, section 3), DATE named date_dim.
_F2 = (
    "select sum(lo_revenue), d_year, p_brand1 "
    "from lineorder, date_dim, part, supplier "
    "where lo_orderdate = d_datekey and lo_partkey = p_partkey "
    "and lo_suppkey = s_suppkey and {} "
    "group by d_year, p_brand1 order by d_year, p_brand1"
)
_F3 = (
    "select {g}, d_year, sum(lo_revenue) as revenue "
    "from customer, lineorder, supplier, date_dim "
    "where lo_custkey = c_custkey and lo_suppkey = s_suppkey "
    "and lo_orderdate = d_datekey and {w} "
    "group by {g}, d_year order by d_year asc, revenue desc"
)
_CITIES = ("(c_city = 'UNITED KI1' or c_city = 'UNITED KI5') "
           "and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')")
_F4 = (
    "select {sel}, sum(lo_revenue - lo_supplycost) as profit "
    "from date_dim, customer, supplier, part, lineorder "
    "where lo_custkey = c_custkey and lo_suppkey = s_suppkey "
    "and lo_partkey = p_partkey and lo_orderdate = d_datekey and {w} "
    "group by {g} order by {g}"
)
_MFGR12 = "(p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')"


def _f3(cols, where):
    return _F3.format(w=where, g=", ".join(cols))


SSB_GROUPED_Q = {
    "Q2.1": _F2.format("p_category = 'MFGR#12' and s_region = 'AMERICA'"),
    "Q2.2": _F2.format("p_brand1 between 'MFGR#2221' and 'MFGR#2228' "
                       "and s_region = 'ASIA'"),
    "Q2.3": _F2.format("p_brand1 = 'MFGR#2239' and s_region = 'EUROPE'"),
    "Q3.1": _f3(("c_nation", "s_nation"),
                "c_region = 'ASIA' and s_region = 'ASIA' "
                "and d_year >= 1992 and d_year <= 1997"),
    "Q3.2": _f3(("c_city", "s_city"),
                "c_nation = 'UNITED STATES' and s_nation = 'UNITED STATES' "
                "and d_year >= 1992 and d_year <= 1997"),
    "Q3.3": _f3(("c_city", "s_city"),
                _CITIES + " and d_year >= 1992 and d_year <= 1997"),
    "Q3.4": _f3(("c_city", "s_city"),
                _CITIES + " and d_yearmonth = 'Dec1997'"),
    "Q4.1": _F4.format(sel="d_year, c_nation", g="d_year, c_nation",
                       w="c_region = 'AMERICA' and s_region = 'AMERICA' "
                       "and " + _MFGR12),
    "Q4.2": _F4.format(sel="d_year, s_nation, p_category",
                       g="d_year, s_nation, p_category",
                       w="c_region = 'AMERICA' and s_region = 'AMERICA' "
                       "and (d_year = 1997 or d_year = 1998) and "
                       + _MFGR12),
    "Q4.3": _F4.format(sel="d_year, s_city, p_brand1",
                       g="d_year, s_city, p_brand1",
                       w="c_region = 'AMERICA' "
                       "and s_nation = 'UNITED STATES' "
                       "and (d_year = 1997 or d_year = 1998) "
                       "and p_category = 'MFGR#14'"),
}


def _isin(*vals):
    return lambda a: np.isin(a, vals)


def _eq(v):
    return lambda a: a == v


def _between(lo, hi):
    return lambda a: (a >= lo) & (a <= hi)


# per query: (filters (table, column, test), output columns in select
# order ((table, column) or "sum"), the summed value, ORDER BY as
# (output position, descending))
_CITY2 = _isin("UNITED KI1", "UNITED KI5")
_Y9297 = ("date_dim", "d_year", _between(1992, 1997))
SSB_GROUPED_SPEC = {
    "Q2.1": ([("part", "p_category", _eq("MFGR#12")),
              ("supplier", "s_region", _eq("AMERICA"))],
             ["sum", ("date_dim", "d_year"), ("part", "p_brand1")],
             "revenue", [(1, False), (2, False)]),
    "Q2.2": ([("part", "p_brand1", _between("MFGR#2221", "MFGR#2228")),
              ("supplier", "s_region", _eq("ASIA"))],
             ["sum", ("date_dim", "d_year"), ("part", "p_brand1")],
             "revenue", [(1, False), (2, False)]),
    "Q2.3": ([("part", "p_brand1", _eq("MFGR#2239")),
              ("supplier", "s_region", _eq("EUROPE"))],
             ["sum", ("date_dim", "d_year"), ("part", "p_brand1")],
             "revenue", [(1, False), (2, False)]),
    "Q3.1": ([("customer", "c_region", _eq("ASIA")),
              ("supplier", "s_region", _eq("ASIA")), _Y9297],
             [("customer", "c_nation"), ("supplier", "s_nation"),
              ("date_dim", "d_year"), "sum"],
             "revenue", [(2, False), (3, True)]),
    "Q3.2": ([("customer", "c_nation", _eq("UNITED STATES")),
              ("supplier", "s_nation", _eq("UNITED STATES")), _Y9297],
             [("customer", "c_city"), ("supplier", "s_city"),
              ("date_dim", "d_year"), "sum"],
             "revenue", [(2, False), (3, True)]),
    "Q3.3": ([("customer", "c_city", _CITY2),
              ("supplier", "s_city", _CITY2), _Y9297],
             [("customer", "c_city"), ("supplier", "s_city"),
              ("date_dim", "d_year"), "sum"],
             "revenue", [(2, False), (3, True)]),
    "Q3.4": ([("customer", "c_city", _CITY2),
              ("supplier", "s_city", _CITY2),
              ("date_dim", "d_yearmonth", _eq("Dec1997"))],
             [("customer", "c_city"), ("supplier", "s_city"),
              ("date_dim", "d_year"), "sum"],
             "revenue", [(2, False), (3, True)]),
    "Q4.1": ([("customer", "c_region", _eq("AMERICA")),
              ("supplier", "s_region", _eq("AMERICA")),
              ("part", "p_mfgr", _isin("MFGR#1", "MFGR#2"))],
             [("date_dim", "d_year"), ("customer", "c_nation"), "sum"],
             "profit", [(0, False), (1, False)]),
    "Q4.2": ([("customer", "c_region", _eq("AMERICA")),
              ("supplier", "s_region", _eq("AMERICA")),
              ("date_dim", "d_year", _isin(1997, 1998)),
              ("part", "p_mfgr", _isin("MFGR#1", "MFGR#2"))],
             [("date_dim", "d_year"), ("supplier", "s_nation"),
              ("part", "p_category"), "sum"],
             "profit", [(0, False), (1, False), (2, False)]),
    "Q4.3": ([("customer", "c_region", _eq("AMERICA")),
              ("supplier", "s_nation", _eq("UNITED STATES")),
              ("date_dim", "d_year", _isin(1997, 1998)),
              ("part", "p_category", _eq("MFGR#14"))],
             [("date_dim", "d_year"), ("supplier", "s_city"),
              ("part", "p_brand1"), "sum"],
             "profit", [(0, False), (1, False), (2, False)]),
}
# each dimension's join: (lineorder's foreign key, the dimension's key)
SSB_JOIN_KEYS = {"date_dim": ("lo_orderdate", "d_datekey"),
                 "part": ("lo_partkey", "p_partkey"),
                 "supplier": ("lo_suppkey", "s_suppkey"),
                 "customer": ("lo_custkey", "c_custkey")}


def ssb_positions(tables) -> dict:
    """Each lineorder row's row in every dimension, by key: DATE's keys
    are unique but gapped (a search of the sorted keys), the others
    1..N (the key less one)."""
    lo = tables["lineorder"]
    out = {}
    for dim, (fk, pk) in SSB_JOIN_KEYS.items():
        keys = tables[dim][pk]
        if np.array_equal(keys, np.arange(1, len(keys) + 1)):
            out[dim] = lo[fk].astype(np.int64) - 1
        else:
            order = np.argsort(keys)
            out[dim] = order[np.searchsorted(keys, lo[fk], sorter=order)]
    return out


def expected_ssb_grouped(tables, q: str, pos=None) -> list:
    """Flights 2-4 in numpy over the same arrays: each dimension's filter
    as a mask over its rows gathered through the key join, the grouping
    by np.unique of the passing rows' keys, exact int64 sums, and the
    ORDER BY in Python's order (strings by code point)."""
    pos = pos if pos is not None else ssb_positions(tables)
    lo = tables["lineorder"]
    filters, outs, value, order = SSB_GROUPED_SPEC[q]
    m = np.ones(len(lo["lo_orderdate"]), dtype=bool)
    for dim, col, test in filters:
        m &= test(tables[dim][col])[pos[dim]]
    idx = np.nonzero(m)[0]
    val = lo["lo_revenue"][idx].astype(np.int64)
    if value == "profit":
        val = val - lo["lo_supplycost"][idx]
    keys = [tables[o[0]][o[1]][pos[o[0]][idx]] for o in outs if o != "sum"]
    if not len(idx):
        return []
    inv = np.zeros(len(idx), dtype=np.int64)
    for k in keys:
        _u, ki = np.unique(k, return_inverse=True)
        inv = inv * (ki.max() + 1) + ki.reshape(-1)
    groups, gi = np.unique(inv, return_inverse=True)
    sums = np.zeros(len(groups), dtype=np.int64)
    np.add.at(sums, gi.reshape(-1), val)
    first = np.zeros(len(groups), dtype=np.int64)
    first[gi.reshape(-1)[::-1]] = np.arange(len(idx))[::-1]
    rows = []
    for g in range(len(groups)):
        it = iter(keys)
        rows.append(tuple(
            int(sums[g]) if o == "sum" else _py(next(it)[first[g]])
            for o in outs))
    for p, desc in reversed(order):  # stable: the last key first
        rows.sort(key=lambda r: r[p], reverse=desc)
    return rows


def _py(x):
    return x.item() if isinstance(x, np.generic) else x


# SSB spec rev. 3: DATE has 2556 rows; lineorder's dates span the first
# 2405 of them
SSB_DATES = 2556
SSB_ORDER_DATES = 2405


def make_date_dim():
    """SSB's DATE table (spec rev. 3, section 2): 2556 rows, one a day
    from 1992-01-01 (as SSB's dbgen makes them, so the last is
    1998-12-30), keyed yyyymmdd; the five columns flights 1-4 read. The
    week number counts 7-day runs from January 1 (1-53); d_yearmonth is
    the month's abbreviation and the year ('Dec1997')."""
    days = np.datetime64("1992-01-01") + np.arange(SSB_DATES)
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    mday = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    yday = (days - days.astype("datetime64[Y]")).astype(np.int64) + 1
    return {
        "d_datekey": (year * 10000 + month * 100 + mday).astype(np.int32),
        "d_year": year.astype(np.int32),
        "d_yearmonthnum": (year * 100 + month).astype(np.int32),
        "d_weeknuminyear": ((yday - 1) // 7 + 1).astype(np.int32),
        "d_yearmonth": _tight(np.char.add(
            np.array(MONTHS)[month - 1], year.astype(str))),
    }


MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
          "Oct", "Nov", "Dec")


def make_lineorder(n: int, date_dim, seed: int = 42, dims=None):
    """SSB lineorder's columns from ``seed``: flight 1's four (an order
    date uniform over the first 2405 dates, quantity 1-50, discount
    0-10, the extended price as quantity times a retail price in
    [90000, 209999]), then the five flights 2-4 read: customer, part and
    supplier keys uniform over each dimension's keys (``dims``: their
    row counts, ``ssb_dim_rows`` of n's scale factor by default), the
    revenue extendedprice * (100 - discount) / 100 and the supply cost
    6/10 of the retail price (dbgen's rules). Flight 1's columns are the
    same for a seed whatever follows them."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, n).astype(np.int32)
    keys = date_dim["d_datekey"][:SSB_ORDER_DATES]
    orderdate = keys[rng.integers(0, SSB_ORDER_DATES, n)]
    disc = rng.integers(0, 11, n).astype(np.int32)
    retail = rng.integers(90_000, 210_000, n)
    price = qty.astype(np.int64) * retail
    dims = dims or ssb_dim_rows(n / SSB_LINEORDER_SF1)
    return {
        "lo_orderdate": orderdate,
        "lo_quantity": qty,
        "lo_discount": disc,
        "lo_extendedprice": price,
        "lo_custkey": rng.integers(1, dims["customer"] + 1, n).astype(
            np.int32),
        "lo_partkey": rng.integers(1, dims["part"] + 1, n).astype(np.int32),
        "lo_suppkey": rng.integers(1, dims["supplier"] + 1, n).astype(
            np.int32),
        "lo_revenue": price * (100 - disc) // 100,
        "lo_supplycost": (retail * 6 // 10).astype(np.int32),
    }


# SSB spec rev. 3, section 2: rows at scale factor SF (lineorder 6 M x SF)
SSB_LINEORDER_SF1 = 6_000_000
# TPC-H's 25 nations and their regions (SSB's supplier and customer draw
# one each)
SSB_NATIONS = (
    ("ALGERIA", "AFRICA"), ("ARGENTINA", "AMERICA"), ("BRAZIL", "AMERICA"),
    ("CANADA", "AMERICA"), ("EGYPT", "MIDDLE EAST"), ("ETHIOPIA", "AFRICA"),
    ("FRANCE", "EUROPE"), ("GERMANY", "EUROPE"), ("INDIA", "ASIA"),
    ("INDONESIA", "ASIA"), ("IRAN", "MIDDLE EAST"), ("IRAQ", "MIDDLE EAST"),
    ("JAPAN", "ASIA"), ("JORDAN", "MIDDLE EAST"), ("KENYA", "AFRICA"),
    ("MOROCCO", "AFRICA"), ("MOZAMBIQUE", "AFRICA"), ("PERU", "AMERICA"),
    ("CHINA", "ASIA"), ("ROMANIA", "EUROPE"),
    ("SAUDI ARABIA", "MIDDLE EAST"), ("VIETNAM", "ASIA"),
    ("RUSSIA", "EUROPE"), ("UNITED KINGDOM", "EUROPE"),
    ("UNITED STATES", "AMERICA"),
)


def ssb_dim_rows(sf: float) -> dict:
    """Dimension rows at scale factor ``sf`` (spec rev. 3, section 2):
    part 200 000 x floor(1 + log2 SF), supplier 2 000 x SF, customer
    30 000 x SF; below SF 1 each in proportion to lineorder."""
    part = (200_000 * int(1 + np.log2(sf)) if sf >= 1
            else max(1, round(200_000 * sf)))
    return {"part": part, "supplier": max(1, round(2_000 * sf)),
            "customer": max(1, round(30_000 * sf))}


def make_part(n: int, seed: int = 42):
    """SSB PART's columns the flights read: key 1..n, p_mfgr MFGR#1-5,
    p_category the mfgr and a digit 1-5, p_brand1 the category and a
    number 1-40 (so 'MFGR#2221' is category MFGR#22, brand 21), as
    strings in numpy arrays."""
    rng = np.random.default_rng(seed)
    mfgr = rng.integers(1, 6, n)
    cat = rng.integers(1, 6, n)
    brand = rng.integers(1, 41, n)
    mf = _tight(np.char.add("MFGR#", mfgr.astype(str)))
    ca = _tight(np.char.add(mf, cat.astype(str)))
    return {
        "p_partkey": np.arange(1, n + 1, dtype=np.int32),
        "p_mfgr": mf,
        "p_category": ca,
        "p_brand1": _tight(np.char.add(ca, brand.astype(str))),
    }


def _tight(a):
    """A numpy string array at the width of its longest value."""
    return a.astype(f"U{max(1, int(np.char.str_len(a).max(initial=1)))}")


def _geo(n: int, rng, prefix: str):
    """City, nation and region of n suppliers or customers: a nation
    uniform over the 25, its region, and a city that is the nation's
    name cut or padded to 9 characters and a digit 0-9 (dbgen's
    '%-9.9s%d', so 'UNITED KI1')."""
    nat = rng.integers(0, len(SSB_NATIONS), n)
    names = np.array([a for a, _ in SSB_NATIONS])
    regions = np.array([b for _, b in SSB_NATIONS])
    stem = np.array([f"{a[:9]:<9}" for a, _ in SSB_NATIONS])
    city = _tight(np.char.add(stem[nat], rng.integers(0, 10, n).astype(str)))
    return {f"{prefix}_city": city, f"{prefix}_nation": names[nat],
            f"{prefix}_region": regions[nat]}


def make_supplier(n: int, seed: int = 42):
    rng = np.random.default_rng(seed)
    return {"s_suppkey": np.arange(1, n + 1, dtype=np.int32),
            **_geo(n, rng, "s")}


def make_customer(n: int, seed: int = 42):
    rng = np.random.default_rng(seed)
    return {"c_custkey": np.arange(1, n + 1, dtype=np.int32),
            **_geo(n, rng, "c")}


def make_ssb(n: int, seed: int = 42) -> dict:
    """All five SSB tables flights 1-4 read, for a lineorder of n rows
    (the dimensions at n's scale factor), each from its own stream of
    ``seed``."""
    dims = ssb_dim_rows(n / SSB_LINEORDER_SF1)
    dd = make_date_dim()
    return {
        "lineorder": make_lineorder(n, dd, seed, dims),
        "date_dim": dd,
        "part": make_part(dims["part"], seed + 1),
        "supplier": make_supplier(dims["supplier"], seed + 2),
        "customer": make_customer(dims["customer"], seed + 3),
    }


def expected_ssb(lo, dd, q: str) -> list:
    """Flight 1's answer in numpy over the same arrays: each order date's
    DATE row by its (unique) key, the filters, the exact int64 sum."""
    order = np.argsort(dd["d_datekey"])
    pos = order[np.searchsorted(dd["d_datekey"], lo["lo_orderdate"],
                                sorter=order)]
    year, ym, week = (dd[c][pos] for c in (
        "d_year", "d_yearmonthnum", "d_weeknuminyear"))
    disc, qty = lo["lo_discount"], lo["lo_quantity"]
    m = {
        "Q1.1": (year == 1993) & (disc >= 1) & (disc <= 3) & (qty < 25),
        "Q1.2": (ym == 199401) & (disc >= 4) & (disc <= 6)
        & (qty >= 26) & (qty <= 35),
        "Q1.3": (week == 6) & (year == 1994) & (disc >= 5) & (disc <= 7)
        & (qty >= 26) & (qty <= 35),
    }[q]
    if not m.any():
        return [(None,)]
    return [(int(np.sum(lo["lo_extendedprice"][m] * disc[m])),)]


def bulk_append(cluster, table: str, arrays) -> None:
    """Pre-sharded append straight into the stores at one commit
    timestamp (bench.py's _bulk_append): a replicated table gets every
    row on every replica."""
    from opentenbase_tpu_torch.storage.column import Column
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    meta = cluster.catalog.get(table)
    arrays = {name: encode_text(meta, name, arrays[name])
              for name in meta.schema}
    n = len(next(iter(arrays.values())))
    nn = len(meta.node_indices)
    commit_ts = cluster.gts.get_gts()
    for i, node in enumerate(meta.node_indices):
        sl = (
            slice(0, n) if meta.dist.is_replicated
            else slice(i * n // nn, (i + 1) * n // nn)
        )
        cols = {
            name: Column(meta.schema[name], arrays[name][sl],
                         None, meta.dictionaries.get(name))
            for name in meta.schema
        }
        batch = ColumnBatch(cols, sl.stop - sl.start)
        cluster.stores[node][table].append_batch(batch, commit_ts)


class ExtStore:
    """Planner and version stub for a device-resident external table
    (bench.py's _ExtStore): no host rows, the device cache holds the
    data (``DeviceCache.register_external``)."""

    def __init__(self, nrows: int):
        self.nrows = nrows
        self.version = 1
        self.structure_version = 0
        self.mvcc_seq = 0


def sf100_stats(n: int) -> dict:
    """The optimizer stats bench.py gives the SF100 tables (what ANALYZE
    would produce) at ``n`` lineitem rows."""
    no, nc = n // 4, n // 40
    return {
        "lineitem": {"rows": n,
                     "ndv": {"l_orderkey": no, "l_shipdate": 2556}},
        "orders": {"rows": no, "ndv": {"o_orderkey": no, "o_custkey": nc}},
        "customer": {"rows": nc,
                     "ndv": {"c_custkey": nc, "c_mktsegment": 5}},
    }


def register_sf100(cluster, tables: dict) -> None:
    """bench.py's SF100 registration: the DDL, a stub store and the
    stats per table, and each table's columns ({column: [n] tensor on
    the cluster's device}) handed to the device cache as one [1, n]
    external table."""
    s = cluster.session()
    for ddl in SF100_DDL:
        s.execute(ddl)
    fx = cluster.fused_executor()
    stats = sf100_stats(len(tables["lineitem"]["l_orderkey"]))
    for table, cols in tables.items():
        meta = cluster.catalog.get(table)
        node = meta.node_indices[0]
        rows = len(next(iter(cols.values())))
        cluster.stores[node][table] = ExtStore(rows)
        meta.stats = stats[table]
        fx.cache.register_external(
            table, meta, (node,), {c: a.reshape(1, rows)
                                   for c, a in cols.items()}, [rows])


def encode_text(meta, name: str, arr):
    """A TEXT column's strings as codes into the table's dictionary,
    minted in order of first appearance, as row-by-row inserts would
    mint them (so code order is not string order); other columns pass
    through."""
    dic = meta.dictionaries.get(name)
    if dic is None:
        return arr
    if isinstance(arr, Text):
        # each vocabulary entry's first row, one compare a value
        first = np.array([
            int(np.argmax(arr.idx == i)) if (arr.idx == i).any()
            else len(arr) for i in range(len(arr.vocab))])
        codes = np.zeros(len(arr.vocab), dtype=np.int32)
        seen = np.argsort(first)[:int((first < len(arr)).sum())]
        codes[seen] = dic.encode(arr.vocab[seen].tolist())
        return codes[arr.idx]
    vocab, first, inv = np.unique(arr, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first)
    codes = np.empty(len(vocab), dtype=np.int32)
    codes[order] = dic.encode(vocab[order].tolist())
    return codes[inv.reshape(-1)]


def _day(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def expected_q6(a) -> list:
    m = (
        (a["l_shipdate"] >= _day("1994-01-01"))
        & (a["l_shipdate"] < _day("1995-01-01"))
        & (a["l_discount"] >= 5) & (a["l_discount"] <= 7)
        & (a["l_quantity"] < 2400)
    )
    if not m.any():
        return [(None,)]
    s = int(np.sum(a["l_extendedprice"][m] * a["l_discount"][m]))
    return [(s / 10**4,)]


def expected_q1(a) -> list:
    m = a["l_shipdate"] <= _day("1998-09-02")
    rows = []
    for f in np.unique(a["l_returnflag"][m]):
        for st in np.unique(a["l_linestatus"][m]):
            g = m & (a["l_returnflag"] == f) & (a["l_linestatus"] == st)
            if not g.any():
                continue
            price = a["l_extendedprice"][g]
            rows.append((
                int(f), int(st),
                int(a["l_quantity"][g].sum()) / 100,
                int(price.sum()) / 100,
                int((price * a["l_discount"][g]).sum()) / 10**4,
                int(g.sum()),
            ))
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def hbm_rate(name: str) -> float:
    if name not in HBM_RATE:
        raise RuntimeError(f"no HBM rate known for {name!r}")
    return HBM_RATE[name]


def _cuda_ms(fn, iters: int) -> float:
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_cases(device, seed: int):
    """(name, cols, xmin, xmax, nrows, snap, spec) cases covering the
    kernel's branches: column widths, G=1/G=6, compact and full MVCC
    planes with invisible rows (and a run hidden mid-tile), shards whose
    nrows is no tile multiple, shorter than a tile or empty, a spec with
    no predicate, and the widest spec compile_spec accepts."""
    import torch

    from opentenbase_tpu_torch import types as t
    from opentenbase_tpu_torch.ops import scan_agg as sa
    from opentenbase_tpu_torch.plan import texpr as E

    rng = np.random.default_rng(seed)
    S, R = 3, 1 << 16
    nrows = np.array([R - 123, 0, 40_000], dtype=np.int64)
    c0 = rng.integers(-5000, 5000, (S, R)).astype(np.int32)
    c1 = rng.integers(0, 9_000_000, (S, R)).astype(np.int64)
    c2 = rng.integers(0, 3, (S, R)).astype(np.int32)
    c3 = rng.integers(0, 2, (S, R)).astype(np.int64)
    c4 = rng.integers(0, 2, (S, R)).astype(np.bool_)
    cols = [torch.from_numpy(c).to(device) for c in (c0, c1, c2, c3, c4)]

    def C(i, ty=t.INT8):
        return E.Col(i, ty)

    def K(v, ty=t.INT8):
        return E.Const(v, ty)

    pred = E.BinE(
        "or",
        E.BinE("and", E.BinE(">=", C(0, t.INT4), K(-1000), t.BOOL),
               E.BinE("<", C(1), K(7_000_000), t.BOOL), t.BOOL),
        E.UnaryE("not", E.InListE(C(2, t.INT4), (K(1), K(2)), False), t.BOOL),
        t.BOOL,
    )
    key = sa.key_expr_from_decoders(
        [(2, 0, 3, 1), (3, 0, 2, 3)], [C(2, t.INT4), C(3)]
    )
    vals = [
        E.BinE("*", C(1), C(2, t.INT4), t.INT8),
        E.UnaryE("-", C(0, t.INT4), t.INT8),
        E.BinE("+", C(4, t.BOOL), K(7), t.INT8),
    ]
    grouped = sa.compile_spec([pred], key, vals, 6)
    scalar = sa.compile_spec(
        [E.BinE("<>", C(3), K(1), t.BOOL)],
        None, [E.BinE("-", C(1), C(0, t.INT4), t.INT8)],
    )
    # MVCC: compact planes with shard 2 invisible; full planes with a
    # third of the rows inserted after the snapshot and some deleted
    snap = 1000
    xmin_c = torch.tensor([[10], [2000], [2000]], dtype=torch.int64)
    xmax_c = torch.full((S, 1), 2**62, dtype=torch.int64)
    xmin_f = torch.from_numpy(
        rng.choice([5, 1000, 1500], (S, R)).astype(np.int64))
    xmax_f = torch.from_numpy(
        rng.choice([2**62, 2**62, 900, 1000, 1001], (S, R)).astype(np.int64))
    # full planes hiding a run of rows in the middle of the first tiles
    xmin_m = torch.full((S, R), 5, dtype=torch.int64)
    xmin_m[:, 1000:1500] = 1500
    xmax_m = torch.full((S, R), 2**62, dtype=torch.int64)
    xmax_m[:, 3001:3077] = 1000
    nr = torch.from_numpy(nrows).to(device)
    out = []
    for pname, xmin, xmax in (("compact", xmin_c, xmax_c),
                              ("full", xmin_f, xmax_f)):
        for sname, spec in (("G6", grouped), ("G1", scalar)):
            sel = [cols[i] for i in spec.cols]
            out.append((f"{sname}/{pname}", sel, xmin.to(device),
                        xmax.to(device), nr, snap, spec))
    sel = [cols[i] for i in grouped.cols]
    out.append(("G6/rows hidden mid-tile", sel, xmin_m.to(device),
                xmax_m.to(device), nr, snap, grouped))
    # shards shorter than a tile (and one empty)
    short = torch.tensor([100, 0, 1], dtype=torch.int64, device=device)
    out.append(("G6/short shards", sel, xmin_c.to(device),
                xmax_c.to(device), short, snap, grouped))
    # no predicate: every visible row is counted
    nopred = sa.compile_spec([], key, vals[:2], 6)
    out.append(("G6/no predicate", [cols[i] for i in nopred.cols],
                xmin_f.to(device), xmax_f.to(device), nr, snap, nopred))
    # the widest spec compile_spec accepts: 16 columns (int64, int32,
    # bool), a predicate of stack depth 16, 16 groups, 8 values (one of
    # depth 16, so the value programs run one after another)
    wide = [rng.integers(-1000, 1000, (S, R)).astype(np.int64)
            for _ in range(10)]
    wide += [rng.integers(0, 4, (S, R)).astype(np.int32) for _ in range(2)]
    wide += [rng.integers(-7, 7, (S, R)).astype(np.int32) for _ in range(2)]
    wide += [rng.integers(0, 2, (S, R)).astype(np.bool_) for _ in range(2)]
    wcols = [torch.from_numpy(c).to(device) for c in wide]
    tys = [t.INT8] * 10 + [t.INT4] * 4 + [t.BOOL] * 2

    def chain(idx):  # c[i0] + (c[i1] + (...)): stack depth len(idx)
        e = C(idx[-1], tys[idx[-1]])
        for i in reversed(idx[:-1]):
            e = E.BinE("+", C(i, tys[i]), e, t.INT8)
        return e

    wpred = E.BinE(">", chain(list(range(16))), K(-2000), t.BOOL)
    wkey = sa.key_expr_from_decoders(
        [(10, 0, 4, 1), (11, 0, 4, 4)], [C(10, t.INT4), C(11, t.INT4)])
    wvals = [C(i, tys[i]) for i in (0, 12, 14)] + [
        E.BinE("*", C(1), C(13, t.INT4), t.INT8),
        E.UnaryE("-", C(2), t.INT8),
        E.BinE("-", C(3), K(5), t.INT8),
        E.BinE("*", C(4), C(5), t.INT8),
        chain([6, 7, 8, 9, 0, 1, 2, 3, 4, 5, 12, 13, 14, 15, 10, 11]),
    ]
    widest = sa.compile_spec([wpred], wkey, wvals, 16)
    assert widest.pred_depth == 16 and widest.n_values == 8
    for pname, xmin, xmax in (("compact", xmin_c, xmax_c),
                              ("full", xmin_f, xmax_f)):
        out.append((f"widest G16xE8 depth 16/{pname}",
                    [wcols[i] for i in widest.cols], xmin.to(device),
                    xmax.to(device), nr, snap, widest))
    return out


def check_kernel_vs_plain(device, seed: int, card: str) -> None:
    import torch

    from opentenbase_tpu_torch.ops import scan_agg as sa

    n0 = sa.scan_agg.launches
    for name, cols, xmin, xmax, nr, snap, spec in kernel_cases(device, seed):
        ks, kc = sa.scan_agg(cols, xmin, xmax, nr, snap, spec)
        ps, pc = sa.scan_agg_plain(cols, xmin, xmax, nr, snap, spec)
        torch.cuda.synchronize()
        if not (torch.equal(ks, ps) and torch.equal(kc, pc)):
            raise AssertionError(f"scan_agg {name}: kernel != plain")
        if int(kc.sum()) == 0:
            raise AssertionError(f"scan_agg {name}: no row passed")
        plan = sa.launch_plan(spec, [c.element_size() for c in cols],
                              xmin.shape[1] != 1)
        print(f"kernel vs plain: scan_agg {name} equal (rows passed "
              f"{int(kc.sum())}; depth {plan.depth}, tile {plan.tile}, "
              f"{plan.stages} stages, {plan.smem_bytes} B shared) [{card}]",
              flush=True)
    sa.scan_agg.launches = n0  # comparison launches are not counted


# ---------------------------------------------------------------------------
# phase 4/5: the main path
# ---------------------------------------------------------------------------


def run_main_path(args, device, card: str) -> dict:
    import torch

    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    t0 = time.perf_counter()
    arrays = make_lineitem(args.rows, args.seed)
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    s.execute(LINEITEM_DDL)
    bulk_append(cluster, "lineitem", arrays)
    print(f"load: {args.rows} rows in 2 datanodes, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    want = {"Q6": expected_q6(arrays), "Q1": expected_q1(arrays)}

    first_ms, launches, k2 = {}, {}, {}
    for q, sql in (("Q6", Q6), ("Q1", Q1)):
        sa.scan_agg.launches = 0
        rp.radix_probe.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        first_ms[q] = (time.perf_counter() - t1) * 1000
        launches[q] = sa.scan_agg.launches
        k2[q] = rp.radix_probe.launches
        if got != want[q]:
            raise AssertionError(f"{q}: port {got} != numpy {want[q]}")
        if launches[q] != 1:
            raise AssertionError(
                f"{q}: scan_agg launched {launches[q]} times, want 1")
        print(f"main path: {q} exact through the kernel (scan_agg "
              f"launches {launches[q]}; first run incl. upload "
              f"{first_ms[q]:.3f} ms) {got[:2]}... [{card}]", flush=True)

    e2e = {}
    for q, sql in (("Q6", Q6), ("Q1", Q1)):
        ts = []
        for _ in range(args.repeats):
            t1 = time.perf_counter()
            got = s.query(sql)
            ts.append((time.perf_counter() - t1) * 1000)
            if got != want[q]:
                raise AssertionError(f"{q}: answer changed between runs")
        e2e[q] = statistics.median(ts)
        print(f"end to end: {q} median {e2e[q]:.3f} ms over "
              f"{args.repeats} runs, {args.rows / e2e[q] * 1e3:.4g} rows/s "
              f"[{card}]", flush=True)
    breakdown = {q: layer_breakdown(cluster, sql, args.repeats)
                 for q, sql in (("Q6", Q6), ("Q1", Q1))}
    for q, b in breakdown.items():
        print(f"layers: {q} median ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in b.items()) + f" [{card}]", flush=True)
    trace = {}
    for q, sql in (("Q6", Q6), ("Q1", Q1)):
        trace[q] = trace_query(s, sql, args.repeats)
        tr = trace[q]
        idle = ("not measured (no device events in the trace)"
                if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
        print(f"trace: {q} one query under torch.profiler, median of "
              f"{args.repeats}: host {tr['wall_ms']:.3f} ms, device busy "
              f"{tr['busy_ms']:.3f} ms, idle share {idle}; device events "
              f"{tr['events']} [{card}]", flush=True)
    return {"cluster": cluster, "e2e": e2e, "launches": launches,
            "breakdown": breakdown, "trace": trace, "arrays": arrays,
            "k2_launches": k2}


def trace_query(session, sql: str, repeats: int) -> dict:
    """Device busy time and idle share of single warm queries, each
    traced alone: busy is the union of the device intervals (kernels,
    copies, fills) in a torch.profiler trace of one Session.query, and
    the share is taken against the host clock around that same query,
    which the profiler's own host work lengthens. The run returned is
    the median of those whose trace holds device activity (of all of
    them where none does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's start-up, not measured
        session.query(sql)
    runs = []
    for _ in range(repeats):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            session.query(sql)
            t1 = time.perf_counter()
        dev = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        busy_us, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in dev):
            if b > end:
                busy_us += b - max(a, end)
                end = b
        by_kind: dict = {}
        for e in dev:  # device ms by kind, the name cut at its template
            k = e.name.split("<")[0].split("(")[0][:60]
            by_kind[k] = by_kind.get(k, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
        wall = (t1 - t0) * 1e3
        runs.append({
            "wall_ms": wall, "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall if dev else None,
            "events": sorted({e.name for e in dev}),
            "top": sorted(by_kind.items(), key=lambda kv: -kv[1])[:5],
        })
    # the profiler sometimes records no device activity for a run
    runs = [r for r in runs if r["events"]] or runs
    runs.sort(key=lambda r: r["wall_ms"])
    return runs[len(runs) // 2]


def layer_breakdown(cluster, sql: str, repeats: int, dag: bool = False):
    """Median ms of one warm query's layers, each timed on its own:
    parse + analyze + optimize + distribute on the host; the device path
    on the host clock — the fused fragment (K1's route) or, with ``dag``,
    the fused DAG (device-cache hit, program, launches, the copies back
    to the host); the coordinator merge; and the device time of the
    device path from CUDA events around it."""
    import torch

    from opentenbase_tpu_torch.executor.local import LocalExecutor
    from opentenbase_tpu_torch.plan import analyze_statement
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse_one

    fx = cluster.fused_executor()
    cat = cluster.catalog
    host, dev = ("dag", "dag_device") if dag else (
        "fragment", "fragment_device")
    out = {"plan": [], host: [], dev: [], "merge": []}
    for _ in range(repeats):
        t0 = time.perf_counter()
        dplan = distribute_statement(optimize_statement(
            analyze_statement(parse_one(sql), cat), cat), cat)
        t1 = time.perf_counter()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        snap = cluster.gts.snapshot_ts()
        a.record()
        if dag:
            idx, part = fx.dag_output(dplan, snap)
        else:
            idx, part = 0, fx.fragment_output(dplan.fragments[0], snap)
        b.record()
        t2 = time.perf_counter()
        LocalExecutor(cat, {idx: part}).run_plan(dplan.root)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        out["plan"].append((t1 - t0) * 1e3)
        out[host].append((t2 - t1) * 1e3)
        out[dev].append(a.elapsed_time(b))
        out["merge"].append((t3 - t2) * 1e3)
    return {k: statistics.median(v) for k, v in out.items()}


def time_kernels(main: dict, card: str, rate: float) -> list:
    """Kernel, plain-version and bound times at the main path's shapes:
    the resident lineitem planes and the specs Q6 and Q1 compiled."""
    import torch

    from opentenbase_tpu_torch.ops import scan_agg as sa

    cluster = main["cluster"]
    fx = cluster.fused_executor()
    (dtab,) = fx.cache._tables.values()
    snap = cluster.gts.snapshot_ts()
    rows = []
    # the programs the main path compiled, in query order (Q6, Q1)
    for qname, (spec, _kinds, scan_cols) in zip(
        ("Q6", "Q1"), [v for k, v in fx._programs.items()
                       if k[0] == "scan_agg"]
    ):
        cols = [dtab.columns[scan_cols[i]] for i in spec.cols]
        args = (cols, dtab.xmin, dtab.xmax, dtab.nrows_dev, snap, spec)
        n0 = sa.scan_agg.launches
        ks, kc = sa.scan_agg(*args, max_nrows=int(dtab.nrows.max()))
        ps, pc = sa.scan_agg_plain(*args)
        err = max(int((ks - ps).abs().max()), int((kc - pc).abs().max()))
        if err:
            raise AssertionError(f"scan_agg {qname}: kernel != plain")
        ms = _cuda_ms(lambda: sa.scan_agg(
            *args, max_nrows=int(dtab.nrows.max())), 20)
        plain_ms = _cuda_ms(lambda: sa.scan_agg_plain(*args), 3)
        sa.scan_agg.launches = n0  # comparison launches are not counted
        nbytes = sa.spec_bytes(*args)
        bound = nbytes / rate * 1e3
        rows.append({
            "query": qname, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
            "max_abs_err": float(err),
        })
        plan = sa.launch_plan(spec, [c.element_size() for c in cols],
                              dtab.xmin.shape[1] != 1)
        print(f"kernel: scan_agg {qname} {ms:.4f} ms, "
              f"{nbytes / ms / 1e6:.1f} GB/s, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({nbytes} bytes at "
              f"{rate / 1e12:.2f} TB/s; rows passed {int(kc.sum())}; "
              f"tile {plan.tile}, {plan.stages} stages, {plan.smem_bytes} "
              f"B shared) [{card}]", flush=True)
    return rows


def ptxas_summary(log) -> str:
    """One line of what ptxas reported per kernel: registers, stack,
    spills, shared memory (or that the library was already built)."""
    if log is None:
        return "library already built (no ptxas report in this run)"
    keep = []
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            keep.append(line.split("'")[1] if "'" in line else line)
        elif "Used" in line or "spill" in line:
            keep.append(line.replace("ptxas info    : ", ""))
    return "; ".join(keep) or log.strip()


# ---------------------------------------------------------------------------
# phase 3b: radix_probe against its plain version
# ---------------------------------------------------------------------------


def radix_cases(device, seed: int):
    """(name, build keys, build real, probe keys, probe real, P, B)
    cases covering the kernel's branches: the reference test's data
    (tests/test_join_device.py:176), int32 keys, keys near +-2^62, dead
    and NULL probe rows, an empty build, duplicate build keys. Multi-pass
    plans are checked pass by pass in ``check_radix_vs_plain``."""
    from opentenbase_tpu_torch.plan import batchplan

    rng = np.random.default_rng(seed)

    def plan(nb, npr):
        p = batchplan.plan_radix_join(
            nb, npr, batchplan.DEFAULT_EXCHANGE_BUDGET)
        return (p.partitions, p.bucket) if p is not None else (1, 8)

    out = []
    nb, npr = 1500, 4000
    bk = (rng.permutation(np.arange(5000))[:nb] * 9 - 10**10).astype(
        np.int64)
    breal = rng.random(nb) > 0.1
    pk = np.concatenate([bk[rng.integers(0, nb, npr - 300)],
                         rng.integers(-(10**14), 10**14, 300)])
    preal = rng.random(npr) > 0.1
    out.append(("reference test data, int64", bk, breal, pk, preal,
                *plan(nb, npr)))
    bk32 = (rng.permutation(np.arange(1 << 20))[:50_000] * 37 - 2**30)
    pk32 = np.concatenate([bk32[rng.integers(0, 50_000, 150_000)],
                           rng.integers(-(2**31), 2**31 - 1, 50_000)])
    out.append(("int32 keys", bk32.astype(np.int32),
                np.ones(50_000, bool), pk32.astype(np.int32),
                np.ones(200_000, bool), *plan(50_000, 200_000)))
    wide = rng.integers(-(2**62), 2**62, 20_000, dtype=np.int64)
    wide[:4] = [2**62, -(2**62), 2**62 - 1, -(2**62) + 1]
    pw = np.concatenate([wide[rng.integers(0, 20_000, 60_000)],
                         rng.integers(-(2**62), 2**62, 20_000)])
    out.append(("keys near +-2^62", wide, np.ones(20_000, bool), pw,
                np.ones(80_000, bool), *plan(20_000, 80_000)))
    dead = rng.random(80_000) > 0.5  # half the probe rows dead or NULL
    out.append(("dead and NULL probe rows", wide, rng.random(20_000) > 0.2,
                pw, dead, *plan(20_000, 80_000)))
    out.append(("empty build", np.zeros(0, np.int64), np.zeros(0, bool),
                pw, np.ones(80_000, bool), 1, 8))
    dups = np.repeat(rng.integers(-50, 50, 600), 3).astype(np.int64)
    pd_ = rng.integers(-60, 60, 7000).astype(np.int64)
    out.append(("duplicate build keys", dups, np.ones(1800, bool), pd_,
                np.ones(7000, bool), *plan(1800, 7000)))
    # n not a multiple of the 16 rows a thread takes
    out.append(("ragged n, int32", bk32.astype(np.int32),
                np.ones(50_000, bool), pk32[:80_003].astype(np.int32),
                rng.random(80_003) > 0.3, *plan(50_000, 80_003)))
    out = [(n, *[torch_from(x, device) for x in (b, br, p, pr)], P, B)
           for n, b, br, p, pr, P, B in out]
    # probes that start at an offset view (no 16-byte alignment)
    for name, bk_, br_, pk_, pr_, P, B in out[:2]:
        out.append((f"{name}, offset view", bk_, br_, pk_[3:-4],
                    pr_[3:-4], P, B))
    return out


def torch_from(a, device):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _radix_equal(name, table, pk, preal, P, B, card, extra=""):
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp

    km, kb = rp.radix_probe(*table, pk, preal, P, B)
    pm, pb = rp.radix_probe_plain(*table, pk, preal, P, B)
    torch.cuda.synchronize()
    if not (torch.equal(km, pm) and torch.equal(kb, pb)):
        raise AssertionError(f"radix_probe {name}: kernel != plain")
    print(f"kernel vs plain: radix_probe {name} equal (P={P}, B={B}, "
          f"{pk.shape[0]} {str(pk.dtype).split('.')[-1]} probe rows, "
          f"{int(km.sum())} matched{extra}) [{card}]", flush=True)
    return km


def check_radix_vs_plain(device, seed: int, card: str) -> None:
    """radix_probe against radix_probe_plain on the card, exactly equal
    (matched everywhere, bidx everywhere: both write 0 on a miss)."""
    import torch

    from opentenbase_tpu_torch.executor import fused_dag
    from opentenbase_tpu_torch.ops import join as join_ops
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.plan import batchplan

    n0 = rp.radix_probe.launches
    for name, bk, breal, pk, preal, P, B in radix_cases(device, seed):
        *table, dup, ovf = join_ops.build_radix_table(bk, breal, P, B)
        m = _radix_equal(name, table, pk, preal, P, B, card,
                         f", dup flag {bool(dup)}, overflow {bool(ovf)}")
        if name == "duplicate build keys" and not bool(dup):
            raise AssertionError("radix_probe: the dup flag did not fire")
        if name != "empty build" and not bool(m.any()):
            raise AssertionError(f"radix_probe {name}: nothing matched")
    # a multi-pass plan: every pass's table, then the DAG's lookup over
    # all passes against the sort-merge lookup
    rng = np.random.default_rng(seed + 1)
    nb, npr = 200_000, 1_000_000
    bk = torch_from(rng.permutation(np.arange(4 * nb))[:nb], device)
    pk = torch_from(np.concatenate([
        bk.cpu().numpy()[rng.integers(0, nb, npr - 100_000)],
        rng.integers(4 * nb, 8 * nb, 100_000)]), device)
    bmask = torch_from(rng.random(nb) > 0.1, device)
    pmask = torch_from(rng.random(npr) > 0.1, device)
    budget, plan = 1 << 16, None
    while plan is None:  # the least budget that admits a plan
        budget *= 2
        plan = batchplan.plan_radix_join(nb, npr, budget)
    if plan.passes < 2:
        raise AssertionError(f"radix_probe: no multi-pass plan ({plan})")
    chunk = -(-nb // plan.passes)
    for p in range(plan.passes):
        s0, e0 = p * chunk, min((p + 1) * chunk, nb)
        *table, _d, _o = join_ops.build_radix_table(
            bk[s0:e0], bmask[s0:e0], plan.partitions, plan.bucket)
        _radix_equal(f"multi-pass plan, pass {p + 1} of {plan.passes}",
                     table, pk, pmask, plan.partitions, plan.bucket, card)
    got = fused_dag._lookup_radix((pk, None), pmask, (bk, None), bmask,
                                  budget, fused_dag._lookup)
    want = fused_dag._lookup((pk, None), pmask, (bk, None), bmask,
                             check_dup=True)
    m = want[0]
    if bool(got[2]) or not torch.equal(got[0], m) or not torch.equal(
            got[1][m], want[1][m]):
        raise AssertionError("multi-pass _lookup_radix != sort-merge")
    print(f"kernel vs plain: multi-pass _lookup_radix ({plan.passes} "
          f"passes) equals the sort-merge lookup ({int(m.sum())} matched) "
          f"[{card}]", flush=True)
    rp.radix_probe.launches = n0  # comparison launches are not counted


# ---------------------------------------------------------------------------
# phase 5: SSB flight 1 through the fused DAG
# ---------------------------------------------------------------------------


def run_ssb_path(args, device, card: str) -> dict:
    import torch

    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    t0 = time.perf_counter()
    tables = make_ssb(args.ssb_rows, args.seed)
    lo, dd = tables["lineorder"], tables["date_dim"]
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    for ddl in SSB_FULL_DDL:
        s.execute(ddl)
    for name, arrays in tables.items():
        bulk_append(cluster, name, arrays)
    print(f"load: SSB lineorder {args.ssb_rows} rows in 2 datanodes; "
          + ", ".join(f"{k} {len(next(iter(v.values())))}"
                      for k, v in tables.items() if k != "lineorder")
          + f" rows replicated; {time.perf_counter() - t0:.3f} s",
          flush=True)
    want = {q: expected_ssb(lo, dd, q) for q in SSB_Q}
    runner = None
    first_ms, launches, modes, k1 = {}, {}, {}, {}
    for q, sql in SSB_Q.items():
        rp.radix_probe.launches = 0
        sa.scan_agg.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        torch.cuda.synchronize()
        first_ms[q] = (time.perf_counter() - t1) * 1000
        launches[q] = rp.radix_probe.launches
        k1[q] = sa.scan_agg.launches
        runner = cluster.fused_executor()._dag
        modes[q] = runner.last_join_modes
        if got != want[q]:
            raise AssertionError(f"{q}: port {got} != numpy {want[q]}")
        if launches[q] < 1:
            raise AssertionError(f"{q}: radix_probe never launched")
        if "radix" not in modes[q]:
            raise AssertionError(f"{q}: join modes {modes[q]} lack radix")
        print(f"main path: SSB {q} exact through the fused DAG (join modes "
              f"{modes[q]}, radix_probe launches {launches[q]}, scan_agg "
              f"launches {sa.scan_agg.launches}; first run incl. upload "
              f"{first_ms[q]:.3f} ms) {got} [{card}]", flush=True)
    e2e = {}
    for q, sql in SSB_Q.items():
        ts = []
        for _ in range(args.repeats):
            t1 = time.perf_counter()
            got = s.query(sql)
            ts.append((time.perf_counter() - t1) * 1000)
            if got != want[q]:
                raise AssertionError(f"{q}: answer changed between runs")
        e2e[q] = statistics.median(ts)
        print(f"end to end: SSB {q} median {e2e[q]:.3f} ms over "
              f"{args.repeats} runs (join modes {runner.last_join_modes}), "
              f"{args.ssb_rows / e2e[q] * 1e3:.4g} rows/s [{card}]",
              flush=True)
    breakdown = {q: layer_breakdown(cluster, sql, args.repeats, dag=True)
                 for q, sql in SSB_Q.items()}
    for q, b in breakdown.items():
        print(f"layers: SSB {q} median ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in b.items()) + f" [{card}]", flush=True)
    trace = {}
    for q, sql in SSB_Q.items():
        trace[q] = tr = trace_query(s, sql, args.repeats)
        idle = ("not measured (no device events in the trace)"
                if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
        print(f"trace: SSB {q} one query under torch.profiler, median of "
              f"{args.repeats}: host {tr['wall_ms']:.3f} ms, device busy "
              f"{tr['busy_ms']:.3f} ms, idle share {idle}; device events "
              f"{len(tr['events'])} kinds [{card}]", flush=True)
    return {"cluster": cluster, "session": s, "e2e": e2e,
            "launches": launches, "breakdown": breakdown, "trace": trace,
            "first_ms": first_ms, "tables": tables, "k1_launches": k1}


# ---------------------------------------------------------------------------
# phase 5b: SSB flights 2-4 through the DAG's grouped mode
# ---------------------------------------------------------------------------


def run_ssb_grouped(ssb: dict, args, card: str) -> dict:
    """Flights 2-4 (Q2.1-Q4.3) in flight 1's cluster: each a star join of
    lineorder with three or four dimensions, filtered and grouped on
    TEXT attributes, through the fused DAG's grouped mode (DATE by the
    radix probe, the dense-keyed dimensions by the fold). Each answer
    must equal numpy exactly, run in the grouped mode, and launch the
    radix probe (its count set to 0 just before the query and read just
    after)."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    cluster, s = ssb["cluster"], ssb["session"]
    runner = cluster.fused_executor()._dag
    t0 = time.perf_counter()
    pos = ssb_positions(ssb["tables"])
    want = {q: expected_ssb_grouped(ssb["tables"], q, pos)
            for q in SSB_GROUPED_Q}
    print(f"numpy: flights 2-4 answered in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    first_ms, launches, modes, k1 = {}, {}, {}, {}
    for q, sql in SSB_GROUPED_Q.items():
        rp.radix_probe.launches = 0
        sa.scan_agg.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        torch.cuda.synchronize()
        first_ms[q] = (time.perf_counter() - t1) * 1000
        launches[q] = rp.radix_probe.launches
        k1[q] = sa.scan_agg.launches
        modes[q] = (runner.last_mode, runner.last_join_modes)
        if got != want[q]:
            raise AssertionError(
                f"{q}: port {got[:4]}... ({len(got)} rows) != numpy "
                f"{want[q][:4]}... ({len(want[q])} rows)")
        if modes[q] != ("grouped", ("fold", "radix")):
            raise AssertionError(f"{q}: mode and join modes {modes[q]}, "
                                 "want grouped with fold and radix")
        if launches[q] < 1:
            raise AssertionError(f"{q}: radix_probe never launched")
        print(f"main path: SSB {q} exact through the fused DAG (mode "
              f"{modes[q][0]}, join modes {modes[q][1]}, radix_probe "
              f"launches {launches[q]}, scan_agg launches "
              f"{sa.scan_agg.launches}; {len(got)} groups; first run incl. "
              f"upload {first_ms[q]:.3f} ms) {got[:2]}... [{card}]",
              flush=True)
    e2e = {}
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for q, sql in SSB_GROUPED_Q.items():
        ts = []
        for _ in range(args.repeats):
            t1 = time.perf_counter()
            got = s.query(sql)
            ts.append((time.perf_counter() - t1) * 1000)
            if got != want[q]:
                raise AssertionError(f"{q}: answer changed between runs")
        e2e[q] = statistics.median(ts)
        print(f"end to end: SSB {q} median {e2e[q]:.3f} ms over "
              f"{args.repeats} runs (mode {runner.last_mode}, join modes "
              f"{runner.last_join_modes}), "
              f"{args.ssb_rows / e2e[q] * 1e3:.4g} rows/s [{card}]",
              flush=True)
    print(f"memory: flights 2-4 resident {resident / 1e9:.3f} GB "
          f"(the SSB tables' planes), peak over the warm runs "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]",
          flush=True)
    breakdown = {q: layer_breakdown(cluster, sql, args.repeats, dag=True)
                 for q, sql in SSB_GROUPED_Q.items()}
    for q, b in breakdown.items():
        print(f"layers: SSB {q} median ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in b.items()) + f" [{card}]", flush=True)
    trace = {}
    for q, sql in SSB_GROUPED_Q.items():
        trace[q] = tr = trace_query(s, sql, args.repeats)
        idle = ("not measured (no device events in the trace)"
                if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
        top = "; ".join(f"{k} {v:.3f} ms" for k, v in tr["top"])
        print(f"trace: SSB {q} one query under torch.profiler, median of "
              f"{args.repeats}: host {tr['wall_ms']:.3f} ms, device busy "
              f"{tr['busy_ms']:.3f} ms, idle share {idle}; device events "
              f"{len(tr['events'])} kinds, the most device time: {top} "
              f"[{card}]", flush=True)
    return {"e2e": e2e, "launches": launches, "breakdown": breakdown,
            "trace": trace, "first_ms": first_ms, "k1_launches": k1}


# ---------------------------------------------------------------------------
# phase 5c: TPC-H Q3 and ClickBench through the DAG's device top-k modes
# ---------------------------------------------------------------------------


def run_topk_query(name: str, cluster, sql: str, want: list, mode: str,
                   join_modes: tuple, folded: int, repeats: int,
                   card: str) -> dict:
    """One top-k query of phase 5c, as phases 5 and 5b run theirs: the
    first run exact against numpy in the mode and join modes the CPU
    tests fixed (tests/test_torch_dag_topk.py), K1's and K2's launches
    counted from 0 around it; then the warm median, the memory, the
    layers and one traced run."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    s = cluster.session()
    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    t1 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    runner = cluster.fused_executor()._dag
    seen = (runner.last_mode, runner.last_join_modes,
            len(runner.last_folded))
    if got != want:
        raise AssertionError(f"{name}: port {got} != numpy {want}")
    if seen != (mode, join_modes, folded) or not s._fused_via_dag:
        raise AssertionError(f"{name}: mode, join modes, folded joins "
                             f"{seen}, want {(mode, join_modes, folded)}")
    print(f"main path: {name} exact through the fused DAG (mode {seen[0]}, "
          f"join modes {seen[1]}, {seen[2]} joins folded; scan_agg launches "
          f"{launches['scan_agg']}, radix_probe launches "
          f"{launches['radix_probe']}; {len(got)} groups; first run incl. "
          f"upload {first_ms:.3f} ms) {got[:2]}... [{card}]", flush=True)
    return {"launches": launches, "first_ms": first_ms,
            **measure_warm(name, cluster, sql, want, repeats, card, True,
                           f" (mode {runner.last_mode})")}


def measure_warm(name: str, cluster, sql: str, want: list, repeats: int,
                 card: str, dag: bool, note: str) -> dict:
    """The rest of a query whose first run was checked: the median of
    ``repeats`` warm runs (each still equal to ``want``), the resident
    and peak device memory over them, the layers (the device path
    through the fused DAG where ``dag``) and one traced run, each
    printed; returned as {e2e, layers, trace, resident_gb, peak_gb}."""
    import torch

    s = cluster.session()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ts = []
    for _ in range(repeats):
        t1 = time.perf_counter()
        got = s.query(sql)
        ts.append((time.perf_counter() - t1) * 1000)
        if got != want:
            raise AssertionError(f"{name}: answer changed between runs")
    e2e = statistics.median(ts)
    peak = torch.cuda.max_memory_allocated()
    print(f"end to end: {name} median {e2e:.3f} ms over {repeats} "
          f"runs{note} [{card}]", flush=True)
    print(f"memory: {name} resident {resident / 1e9:.3f} GB (the cluster's "
          f"planes), peak over the warm runs {peak / 1e9:.3f} GB [{card}]",
          flush=True)
    layers = layer_breakdown(cluster, sql, repeats, dag=dag)
    print(f"layers: {name} median ms " + ", ".join(
        f"{k} {v:.3f}" for k, v in layers.items()) + f" [{card}]", flush=True)
    tr = trace_query(s, sql, repeats)
    idle = ("not measured (no device events in the trace)"
            if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
    top = "; ".join(f"{k} {v:.3f} ms" for k, v in tr["top"])
    print(f"trace: {name} one query under torch.profiler, median of "
          f"{repeats}: host {tr['wall_ms']:.3f} ms, device busy "
          f"{tr['busy_ms']:.3f} ms, idle share {idle}; device events "
          f"{len(tr['events'])} kinds, the most device time: {top} "
          f"[{card}]", flush=True)
    return {"e2e": e2e, "layers": layers, "trace": tr,
            "resident_gb": resident / 1e9, "peak_gb": peak / 1e9}


def run_q3_dense(main: dict, args, card: str) -> dict:
    """Phase 5c (b): bench.py's Q3 — orders and customer (make_q3_dims)
    beside phase 4's lineitem, dense order keys: gagg over two chain
    folds."""
    cluster = main["cluster"]
    s = cluster.session()
    t0 = time.perf_counter()
    orders, customer = make_q3_dims(args.rows, 43)
    for ddl in Q3_DENSE_DDL:
        s.execute(ddl)
    bulk_append(cluster, "orders", orders)
    bulk_append(cluster, "customer", customer)
    want = expected_q3(main["arrays"], orders, customer, 0)
    print(f"load: orders {len(orders['o_orderkey'])} and customer "
          f"{len(customer['c_custkey'])} rows beside lineitem, numpy Q3; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return run_topk_query("TPC-H Q3 (dense keys)", cluster, Q3_DENSE, want,
                          "gagg", ("fold",), 2, args.repeats, card)


def run_q3_spec(args, device, card: str) -> dict:
    """Phase 5c (a): TPC-H Q3 as the spec writes it over make_q3_spec at
    ``--q3-sf`` (sparse order keys, TEXT segments), every table round
    robin over 2 datanodes: the top join by the gsort co-sort, customer
    folded into orders."""
    from opentenbase_tpu_torch import Cluster

    t0 = time.perf_counter()
    tables = make_q3_spec(args.q3_sf, args.seed)
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    for ddl in Q3_SPEC_DDL:
        s.execute(ddl)
    for name, arrays in tables.items():
        bulk_append(cluster, name, arrays)
    want = expected_q3(tables["lineitem"], tables["orders"],
                       tables["customer"], "BUILDING")
    print(f"load: TPC-H SF{args.q3_sf:g} for Q3: " + ", ".join(
        f"{k} {len(next(iter(v.values())))}" for k, v in tables.items())
        + f" rows round robin in 2 datanodes, numpy Q3; "
        f"{time.perf_counter() - t0:.3f} s", flush=True)
    want_q1 = expected_q1_spec(tables["lineitem"])
    del tables
    out = run_topk_query("TPC-H Q3 (spec keys)", cluster, Q3_SPEC, want,
                         "gsort", ("fold",), 1, args.repeats, card)
    # phase 6: Q1 as the spec writes it, over the same lineitem
    out["fragment"] = {"TPC-H Q1 (spec)": run_fragment_query(
        "TPC-H Q1 (spec)", cluster, Q1_SPEC, want_q1, args.repeats, card)}
    return out


def run_clickbench(args, device, card: str) -> dict:
    """Phase 5c (c): ClickBench's top-10 UserIDs over ``--hits-rows``
    rows of make_hits, round robin over 2 datanodes. The full-range
    UserIDs overflow every packed key, so the run ends in the grouped
    mode with every group shipped, as the reference's does."""
    from opentenbase_tpu_torch import Cluster

    t0 = time.perf_counter()
    users = int(args.hits_rows * HITS_DISTINCT_SHARE)
    hits = make_hits(args.hits_rows, users, args.seed)
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    s.execute(CLICKBENCH_DDL)
    bulk_append(cluster, "hits", hits)
    want = expected_clickbench(hits)
    counts = [c for _u, c in want]
    print(f"load: hits {args.hits_rows} rows, {users} distinct UserIDs, "
          f"round robin in 2 datanodes, numpy top 10 (counts {counts}, "
          f"distinct: {len(set(counts)) == len(counts)}); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    want_scalar = {q: expected_clickbench_scalar(hits, q)
                   for q in CLICKBENCH_SCALAR_Q}
    del hits
    out = run_topk_query("ClickBench top-10 UserID", cluster, CLICKBENCH_Q,
                         want, "grouped", (), 0, max(2, args.repeats // 2),
                         card)
    # phase 6: the scalar queries over the same hits
    out["fragment"] = {
        q: run_fragment_query(q, cluster, sql, want_scalar[q],
                              args.repeats, card)
        for q, sql in CLICKBENCH_SCALAR_Q.items()}
    out["k1_rows"] = time_k1_at(cluster, {
        q: CLICKBENCH_SCALAR_Q[q] for q, (route, _r) in
        FRAGMENT_ROUTES.items() if route == "scan_agg"}, card)
    return out


# ---------------------------------------------------------------------------
# phase 6: single-table aggregates off the kernel, coordinator expressions
# ---------------------------------------------------------------------------


def certified_route(cluster, sql: str) -> str:
    """What the port's copy of the reference certifier decides for the
    query's fragment on the resident arrays' bounds: "scan_agg" where
    it takes the fragment, "program" where it does not."""
    from opentenbase_tpu_torch.executor.fused import _match_partial_fragment
    from opentenbase_tpu_torch.ops import scan_agg as sa
    from opentenbase_tpu_torch.plan import analyze_statement
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse_one

    cat = cluster.catalog
    dplan = distribute_statement(optimize_statement(
        analyze_statement(parse_one(sql), cat), cat), cat)
    (frag,) = dplan.fragments
    m = _match_partial_fragment(frag.root)
    fx = cluster.fused_executor()
    meta = cat.get(m.scan.table)
    dtab = fx.cache.get(m.scan.table, meta, fx.node_stores, frag.nodes,
                        columns=m.scan.columns)
    if any(dtab.validity[c] is not None for c in m.scan.columns):
        return "program"
    try:
        fx._scan_agg_plan(m, [dtab.col_maxabs.get(c) for c in
                              m.scan.columns],
                          [dtab.col_range.get(c) for c in m.scan.columns])
    except sa.PallasUnsupported:
        return "program"
    return "scan_agg"


def run_fragment_query(name: str, cluster, sql: str, want: list,
                       repeats: int, card: str) -> dict:
    """One query of phase 6: the first run exact against numpy on the
    route and rung FRAGMENT_ROUTES names (which the certifier's verdict
    on these arrays must confirm), K1's and K2's launches counted from 0
    around it (K1 once on its route, never on the program's); then the
    warm median, the memory, the layers and one traced run."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    route, rung = FRAGMENT_ROUTES[name]
    if certified_route(cluster, sql) != route:
        raise AssertionError(f"{name}: the certifier does not route it "
                             f"to {route}")
    s = cluster.session()
    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    t1 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    fx = cluster.fused_executor()
    seen = (fx.last_route, fx.last_rung)
    if got != want:
        raise AssertionError(f"{name}: port {got} != numpy {want}")
    if seen != (route, rung) or s._fused_via_dag:
        raise AssertionError(f"{name}: route and rung {seen}, want "
                             f"{(route, rung)}")
    k1 = 1 if route == "scan_agg" else 0
    if launches != {"scan_agg": k1, "radix_probe": 0}:
        raise AssertionError(f"{name}: launches {launches}, want "
                             f"scan_agg {k1}, radix_probe 0")
    print(f"main path: {name} exact through {route} (rung {rung}; "
          f"scan_agg launches {launches['scan_agg']}, radix_probe "
          f"launches {launches['radix_probe']}; {len(got)} rows; first "
          f"run incl. upload {first_ms:.3f} ms) {got[:2]}... [{card}]",
          flush=True)
    return {"launches": launches, "first_ms": first_ms, "route": seen,
            **measure_warm(name, cluster, sql, want, repeats, card, False,
                           f" ({route})")}


def time_k1_at(cluster, queries: dict, card: str) -> list:
    """K1's kernel, plain-version and bound times at the inputs the main
    path hands it for each query (captured by one more warm run with the
    wrapper swapped for a recorder that delegates to it), held equal to
    the plain version there; as ``time_kernels`` for Q6 and Q1."""
    import torch

    from opentenbase_tpu_torch.ops import scan_agg as sa

    rate = hbm_rate(torch.cuda.get_device_name(0))
    kernel = sa.scan_agg
    n0 = kernel.launches
    rows = []
    for q, sql in queries.items():
        calls = []

        def record(*a, **kw):
            calls.append((a, kw))
            return kernel(*a, **kw)

        record.launches = 0  # the wrapper counts under its module name
        sa.scan_agg = record
        try:
            cluster.session().query(sql)
        finally:
            sa.scan_agg = kernel
        if len(calls) != 1:
            raise AssertionError(f"{q}: expected one K1 launch, saw "
                                 f"{len(calls)}")
        (args, kw), = calls
        ks, kc = kernel(*args, **kw)
        ps, pc = sa.scan_agg_plain(*args)
        torch.cuda.synchronize()
        err = max(int((ks - ps).abs().max()) if ks.numel() else 0,
                  int((kc - pc).abs().max()))
        if err:
            raise AssertionError(f"scan_agg {q}: kernel != plain")
        ms = _cuda_ms(lambda: kernel(*args, **kw), 20)
        plain_ms = _cuda_ms(lambda: sa.scan_agg_plain(*args), 3)
        nbytes = sa.spec_bytes(*args)
        bound = nbytes / rate * 1e3
        rows.append({"query": q, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": "bytes",
                     "bytes": nbytes, "max_abs_err": float(err)})
        print(f"kernel: scan_agg {q} {ms:.4f} ms, {nbytes / ms / 1e6:.1f} "
              f"GB/s, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes} bytes at {rate / 1e12:.2f} TB/s; "
              f"{len(args[0])} columns; rows passed {int(kc.sum())}) "
              f"[{card}]", flush=True)
    kernel.launches = n0  # comparison and timing launches are not counted
    return rows


# ---------------------------------------------------------------------------
# phase 7: bench.py's TPC-H SF100 leg, device-resident external tables
# ---------------------------------------------------------------------------


def sf100_rows(requested: int) -> int:
    """``requested`` lineitem rows, cut as bench.py cuts them to what the
    host can hold for the numpy check (MemAvailable / 2 at 40 bytes a
    row), rounded down to a multiple of 2^20 so the window halving still
    divides it; a cut is printed."""
    avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    avail = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    cap = avail // 2 // 40
    if avail and requested > cap:
        n = cap >> 20 << 20
        print(f"reduced: SF100 lineitem {requested} -> {n} rows ({avail} "
              f"bytes of host memory available)", flush=True)
        return n
    return requested


def run_sf100_query(name: str, cluster, sql: str, want: list, check,
                    k1: int, repeats: int, card: str) -> dict:
    """One query of phase 7: the first run exact against numpy, in the
    state ``check`` confirms (it returns that state's description), with
    K1 launched ``k1`` times and K2 never (counts from 0 around it); then
    ``measure_warm``."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    s = cluster.session()
    rp.radix_probe.launches = 0
    sa.scan_agg.launches = 0
    t1 = time.perf_counter()
    got = s.query(sql)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1000
    launches = {"scan_agg": sa.scan_agg.launches,
                "radix_probe": rp.radix_probe.launches}
    if got != want:
        raise AssertionError(f"{name}: port {got} != numpy {want}")
    state = check()
    if launches != {"scan_agg": k1, "radix_probe": 0}:
        raise AssertionError(f"{name}: launches {launches}, want "
                             f"scan_agg {k1}, radix_probe 0")
    print(f"main path: {name} exact ({state}; scan_agg launches "
          f"{launches['scan_agg']}, radix_probe launches "
          f"{launches['radix_probe']}; {len(got)} rows; first run "
          f"{first_ms:.3f} ms) {got[:2]}... [{card}]", flush=True)
    fx = cluster.fused_executor()
    dag = bool(s._fused_via_dag)
    route = ("dag", fx._dag.last_mode) if dag else (fx.last_route,
                                                    fx.last_rung)
    return {"launches": launches, "first_ms": first_ms, "route": route,
            **measure_warm(name, cluster, sql, want, repeats, card, dag,
                           "")}


def run_sf100(args, device, card: str) -> dict:
    """Phase 7: bench.py's SF100 leg at ``--sf100-rows`` (default its
    603 979 776): the tables made from ``--seed`` on the host, checked
    there in numpy, and registered on the card as external tables in one
    datanode (``register_sf100``). Q6 through K1 in one launch; Q3
    through the windowed gagg (16 windows at the full size) with the
    orders side hoisted and every join folded, all ten rows exact; then
    K1 held against its plain version at Q6's inputs."""
    import torch

    from opentenbase_tpu_torch import Cluster

    n = sf100_rows(args.sf100_rows)
    t0 = time.perf_counter()
    tables = make_sf100(n, args.seed)
    t1 = time.perf_counter()
    want6 = expected_sf100_q6(tables)
    want3 = expected_sf100_q3(tables)
    t2 = time.perf_counter()
    cluster = Cluster(num_datanodes=1, shard_groups=16, device=device)
    register_sf100(cluster, {
        t: {c: torch.from_numpy(a).to(device) for c, a in cols.items()}
        for t, cols in tables.items()})
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"load: TPC-H SF100 (bench.py's leg): lineitem {n}, orders "
          f"{n // 4}, customer {n // 40} rows made on the host in "
          f"{t1 - t0:.3f} s, numpy Q6 and Q3 in {t2 - t1:.3f} s, "
          f"registered on the card as external tables in {t3 - t2:.3f} s "
          f"({torch.cuda.memory_allocated() / 1e9:.3f} GB); kept out of "
          f"the query times [{card}]", flush=True)
    del tables
    fx = cluster.fused_executor()

    def q6_state():
        if fx.last_route != "scan_agg":
            raise AssertionError(f"SF100 Q6: route {fx.last_route}")
        return "route scan_agg"

    def q3_state():
        r = fx._dag
        seen = (r.last_mode, r.last_hoisted, r.last_join_modes)
        # joins post-order: customer into orders 0 (folded inside the
        # prep), orders into lineitem 1 (folded in every window)
        if seen != ("wgagg", True, ("fold",)) or r.last_folded != {1}:
            raise AssertionError(f"SF100 Q3: mode, hoisted, join modes "
                                 f"{seen}, folded {r.last_folded}")
        if not any(k[0] == "prep" for k in r._programs):
            raise AssertionError("SF100 Q3: no prep program compiled")
        nwin, width, cap = r.last_windows
        return (f"mode wgagg over {nwin} windows of {width} rows, final "
                f"capacity {cap}, build side hoisted, join modes "
                f"{r.last_join_modes}, joins folded {sorted(r.last_folded)}, "
                f"reruns {r.last_retries}")

    out = {"rows": n}
    out["SF100 Q6"] = run_sf100_query("SF100 Q6", cluster, SF100_Q6, want6,
                                      q6_state, 1, args.repeats, card)
    out["SF100 Q3"] = run_sf100_query("SF100 Q3", cluster, SF100_Q3, want3,
                                      q3_state, 0, args.repeats, card)
    out["windows"] = fx._dag.last_windows
    out["k1_rows"] = time_k1_at(cluster, {"SF100 Q6": SF100_Q6}, card)
    return out


def capture_probe_inputs(ssb: dict, sql: str):
    """The arguments the fused DAG hands radix_probe for ``sql``: one more
    warm run with the DAG's handle on the wrapper swapped for a recorder
    that delegates to it (so the launch still counts nowhere that a
    check reads)."""
    import types

    from opentenbase_tpu_torch.executor import fused_dag
    from opentenbase_tpu_torch.ops import radix_probe as rp

    calls = []

    def record(*a):
        calls.append(a)
        return rp.radix_probe(*a)

    fused_dag.rp = types.SimpleNamespace(radix_probe=record)
    try:
        ssb["session"].query(sql)
    finally:
        fused_dag.rp = rp
    if len(calls) != 1:
        raise AssertionError(f"expected one probe, saw {len(calls)}")
    return calls[0]


def time_radix(ssb: dict, card: str, rate: float, queries) -> list:
    """radix_probe's kernel, plain-version and bound times at the main
    path's own inputs (the SF10 shapes), held equal to the plain version
    there too. Bound: the bytes the probe must move (ops/radix_probe
    probe_bytes: each row's real flag read and its matched flag and bidx
    written, the real rows' keys, the table once) over the HBM rate."""
    import torch

    from opentenbase_tpu_torch.ops import radix_probe as rp

    rows = []
    n0 = rp.radix_probe.launches
    for q, sql in queries.items():
        args = capture_probe_inputs(ssb, sql)
        tk, tv, ti, pk, preal, P, B = args
        km, kb = rp.radix_probe(*args)
        pm, pb = rp.radix_probe_plain(*args)
        torch.cuda.synchronize()
        err = max(int((km != pm).sum()), int((kb - pb).abs().max()))
        if err:
            raise AssertionError(f"radix_probe {q}: kernel != plain")
        ms = _cuda_ms(lambda: rp.radix_probe(*args), 20)
        plain_ms = _cuda_ms(lambda: rp.radix_probe_plain(*args), 3)
        n = pk.shape[0]
        nbytes = rp.probe_bytes(tk, pk, preal)
        bound = nbytes / rate * 1e3
        rows.append({
            "query": q, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "bytes": nbytes, "max_abs_err": float(err),
        })
        print(f"kernel: radix_probe SSB {q} {ms:.4f} ms, "
              f"{nbytes / ms / 1e6:.1f} GB/s, plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms "
              f"({nbytes} bytes at {rate / 1e12:.2f} TB/s; P={P}, B={B}, "
              f"{n} probe rows, {int(preal.sum())} real, "
              f"{int(km.sum())} matched) [{card}]", flush=True)
    rp.radix_probe.launches = n0  # timing launches are not counted
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--rows", type=int, default=60_000_000)
    ap.add_argument("--ssb-rows", type=int, default=60_000_000)
    ap.add_argument("--q3-sf", type=float, default=10.0)
    ap.add_argument("--hits-rows", type=int, default=60_000_000)
    ap.add_argument("--sf100-rows", type=int, default=SF100_ROWS)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    # bench.py's knobs for its SF100 leg, set before the port reads them
    # at import: the 151 M-row orders side must pass the fold gate, and
    # Q6's four resident columns (9.7 GB) must stay on K1's route
    os.environ.setdefault("OTB_DIMFOLD_MAX", "260000000")
    os.environ.setdefault("OTB_SCAN_HBM_BUDGET", "11000000000")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "opentenbase_tpu_torch")):
        print("chip_smoke: opentenbase_tpu_torch not found beside the "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from opentenbase_tpu_torch.ops import cuda_build
    from opentenbase_tpu_torch.ops import radix_probe as rp
    from opentenbase_tpu_torch.ops import scan_agg as sa

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch device {name}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    rate = hbm_rate(name)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    libs = cuda_build.build(*cuda_build.SOURCES)
    sa._load()
    rp._load()
    print(f"build: {', '.join('csrc/' + k for k in libs)} in "
          f"{time.perf_counter() - t0:.3f} s (one nvcc each, in parallel)",
          flush=True)
    for src in libs:
        report = ptxas_summary(cuda_build.ptxas_logs.get(src))
        print(f"build: csrc/{src}: {report}", flush=True)

    check_kernel_vs_plain(device, args.seed, card)
    check_radix_vs_plain(device, args.seed, card)
    main_run = run_main_path(args, device, card)
    rows = time_kernels(main_run, card, rate)
    topk = {"Q3 dense": run_q3_dense(main_run, args, card)}
    e2e_tpch, layers_tpch, trace_tpch, launches_tpch, k2_tpch = (
        main_run["e2e"], main_run["breakdown"], main_run["trace"],
        main_run["launches"], main_run["k2_launches"])
    del main_run  # free lineitem's planes before SSB loads (the cluster
    gc.collect()  # and its executors hold each other: a cycle)
    torch.cuda.empty_cache()
    ssb_run = run_ssb_path(args, device, card)
    grouped_run = run_ssb_grouped(ssb_run, args, card)
    radix_rows = time_radix(ssb_run, card, rate,
                            {**SSB_Q, **SSB_GROUPED_Q})
    ssb_launches = {**ssb_run["launches"], **grouped_run["launches"]}
    del ssb_run["cluster"], ssb_run["session"]  # free SSB's planes
    gc.collect()
    torch.cuda.empty_cache()
    topk["Q3 spec"] = run_q3_spec(args, device, card)
    gc.collect()  # Q3's cluster, before hits loads
    torch.cuda.empty_cache()
    topk["ClickBench"] = run_clickbench(args, device, card)
    gc.collect()  # hits' cluster, before the SF100 tables load
    torch.cuda.empty_cache()
    sf100 = run_sf100(args, device, card)
    # K1's and K2's launches in every path's run, the new queries too
    path_launches = {
        "scan_agg": {**launches_tpch, **ssb_run["k1_launches"],
                     **grouped_run["k1_launches"]},
        "radix_probe": {**k2_tpch, **ssb_launches},
    }
    # phase 6's queries ran in phase 5c's clusters
    frag = {**topk["Q3 spec"].pop("fragment"),
            **topk["ClickBench"].pop("fragment")}
    k1_rows = topk["ClickBench"].pop("k1_rows") + sf100.pop("k1_rows")
    sf100_rows_n, windows = sf100.pop("rows"), sf100.pop("windows")
    frag.update(sf100)
    for q, r in {**topk, **frag}.items():
        for k, n in r["launches"].items():
            path_launches[k][q] = n

    kernels = []
    for r in rows:
        kernels.append({
            "name": f"scan_agg ({r['query']} shape)",
            "route": "cuda",
            "source": "opentenbase_tpu_torch/csrc/scan_agg.cu",
            "replaces": "opentenbase_tpu/ops/pallas_scan.py:317",
            "launches": launches_tpch[r["query"]],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "gbps": r["bytes"] / r["ms"] / 1e6,
            "library_ms": None,
            "path_launches": path_launches["scan_agg"],
        })
    for r in k1_rows:
        kernels.append({
            "name": f"scan_agg ({r['query']} shape)",
            "route": "cuda",
            "source": "opentenbase_tpu_torch/csrc/scan_agg.cu",
            "replaces": "opentenbase_tpu/ops/pallas_scan.py:317",
            "launches": frag[r["query"]]["launches"]["scan_agg"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "gbps": r["bytes"] / r["ms"] / 1e6,
            "library_ms": None,
            "path_launches": path_launches["scan_agg"],
        })
    for r in radix_rows:
        kernels.append({
            "name": f"radix_probe ({r['query']} shape)",
            "route": "cuda",
            "source": "opentenbase_tpu_torch/csrc/radix_probe.cu",
            "replaces": "opentenbase_tpu/ops/pallas_join.py:85",
            "launches": ssb_launches[r["query"]],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "gbps": r["bytes"] / r["ms"] / 1e6,
            "library_ms": None,
            "path_launches": path_launches["radix_probe"],
        })
    # the JSON counts each trace's device event kinds; the trace lines
    # of the TPC-H queries name them
    late = {**topk, **frag}
    trace = {q: {**{k: v for k, v in tr.items()
                    if k not in ("events", "top")},
                 "event_kinds": len(tr["events"])}
             for q, tr in {**trace_tpch, **ssb_run["trace"],
                           **grouped_run["trace"],
                           **{q: r["trace"] for q, r in late.items()}}.items()}
    print(json.dumps({"kernels": kernels,
                      "e2e_ms": {**e2e_tpch, **ssb_run["e2e"],
                                 **grouped_run["e2e"],
                                 **{q: r["e2e"] for q, r in late.items()}},
                      "layers_ms": {**layers_tpch, **ssb_run["breakdown"],
                                    **grouped_run["breakdown"],
                                    **{q: r["layers"]
                                       for q, r in late.items()}},
                      "routes": {q: r["route"] for q, r in frag.items()},
                      "memory_gb": {q: [r["resident_gb"], r["peak_gb"]]
                                    for q, r in late.items()},
                      "trace": trace,
                      "rows": args.rows, "ssb_rows": args.ssb_rows,
                      "q3_sf": args.q3_sf, "hits_rows": args.hits_rows,
                      "sf100_rows": sf100_rows_n,
                      "sf100_q3_windows": windows,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

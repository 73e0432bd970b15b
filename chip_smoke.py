#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (opentenbase_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 42] [--rows 60000000]
                          [--ssb-rows 60000000] [--repeats 5]

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
6. timing, per path: median end-to-end ms per query, the layers each
   timed on its own, the device busy and idle share of single queries
   from a torch.profiler trace, kernel ms from CUDA events at the main
   path's own inputs (held against the plain version there too), the
   plain version's ms, the bytes-over-bandwidth bound and the GB/s
   moved.

The second-to-last lines are the kernel table as JSON and the nvidia-smi
line; the last line is the run's verdict as JSON. The script imports
neither jax nor the reference package.
"""

from __future__ import annotations

import argparse
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


def encode_text(meta, name: str, arr):
    """A TEXT column's strings as codes into the table's dictionary,
    minted in order of first appearance, as row-by-row inserts would
    mint them (so code order is not string order); other columns pass
    through."""
    dic = meta.dictionaries.get(name)
    if dic is None:
        return arr
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

    first_ms, launches = {}, {}
    for q, sql in (("Q6", Q6), ("Q1", Q1)):
        sa.scan_agg.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        first_ms[q] = (time.perf_counter() - t1) * 1000
        launches[q] = sa.scan_agg.launches
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
            "breakdown": breakdown, "trace": trace}


def trace_query(session, sql: str, repeats: int) -> dict:
    """Device busy time and idle share of single warm queries, each
    traced alone: busy is the union of the device intervals (kernels,
    copies, fills) in a torch.profiler trace of one Session.query, and
    the share is taken against the host clock around that same query,
    which the profiler's own host work lengthens."""
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
        ("Q6", "Q1"), fx._programs.values()
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
    first_ms, launches, modes = {}, {}, {}
    for q, sql in SSB_Q.items():
        rp.radix_probe.launches = 0
        sa.scan_agg.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        torch.cuda.synchronize()
        first_ms[q] = (time.perf_counter() - t1) * 1000
        launches[q] = rp.radix_probe.launches
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
            "first_ms": first_ms, "tables": tables}


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
    first_ms, launches, modes = {}, {}, {}
    for q, sql in SSB_GROUPED_Q.items():
        rp.radix_probe.launches = 0
        sa.scan_agg.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        torch.cuda.synchronize()
        first_ms[q] = (time.perf_counter() - t1) * 1000
        launches[q] = rp.radix_probe.launches
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
            "trace": trace, "first_ms": first_ms}


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
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

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
    e2e_tpch, layers_tpch, trace_tpch, launches_tpch = (
        main_run["e2e"], main_run["breakdown"], main_run["trace"],
        main_run["launches"])
    del main_run  # free lineitem's planes before SSB loads
    torch.cuda.empty_cache()
    ssb_run = run_ssb_path(args, device, card)
    grouped_run = run_ssb_grouped(ssb_run, args, card)
    radix_rows = time_radix(ssb_run, card, rate,
                            {**SSB_Q, **SSB_GROUPED_Q})
    ssb_launches = {**ssb_run["launches"], **grouped_run["launches"]}

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
        })
    # the JSON counts each trace's device event kinds; the trace lines
    # of the TPC-H queries name them
    trace = {q: {**{k: v for k, v in tr.items()
                    if k not in ("events", "top")},
                 "event_kinds": len(tr["events"])}
             for q, tr in {**trace_tpch, **ssb_run["trace"],
                           **grouped_run["trace"]}.items()}
    print(json.dumps({"kernels": kernels,
                      "e2e_ms": {**e2e_tpch, **ssb_run["e2e"],
                                 **grouped_run["e2e"]},
                      "layers_ms": {**layers_tpch, **ssb_run["breakdown"],
                                    **grouped_run["breakdown"]},
                      "trace": trace,
                      "rows": args.rows, "ssb_rows": args.ssb_rows,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

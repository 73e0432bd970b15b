"""TPC-H's 22 queries (rev. 3, section 2.4, the validation parameters)
over the 8-table schema with every column, and a small seeded dataset
in dbgen's shapes for them. Date arithmetic that neither parser takes
(``interval 'n' unit``) is written as the date literal it folds to.
Shared by the port's TPC-H tests."""

import numpy as np

from chip_smoke import (
    NATIONS,
    P_NAME_WORDS,
    P_TYPES,
    PRIORITIES,
    Q7,
    Q8,
    Q9,
    Q15_QUERY,
    Q15_REVENUE,
    REGIONS,
    SEGMENTS,
)

CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

TPCH_DDL = [
    "create table region (r_regionkey int, r_name text, r_comment text)"
    " distribute by replication",
    "create table nation (n_nationkey int, n_name text, n_regionkey int,"
    " n_comment text) distribute by replication",
    "create table part (p_partkey bigint, p_name text, p_mfgr text,"
    " p_brand text, p_type text, p_size int, p_container text,"
    " p_retailprice numeric(12,2), p_comment text)"
    " distribute by shard(p_partkey)",
    "create table supplier (s_suppkey bigint, s_name text, s_address text,"
    " s_nationkey int, s_phone text, s_acctbal numeric(12,2),"
    " s_comment text) distribute by shard(s_suppkey)",
    "create table partsupp (ps_partkey bigint, ps_suppkey bigint,"
    " ps_availqty int, ps_supplycost numeric(12,2), ps_comment text)"
    " distribute by shard(ps_partkey)",
    "create table customer (c_custkey bigint, c_name text, c_address text,"
    " c_nationkey int, c_phone text, c_acctbal numeric(12,2),"
    " c_mktsegment text, c_comment text) distribute by shard(c_custkey)",
    "create table orders (o_orderkey bigint, o_custkey bigint,"
    " o_orderstatus text, o_totalprice numeric(12,2), o_orderdate date,"
    " o_orderpriority text, o_clerk text, o_shippriority int,"
    " o_comment text) distribute by shard(o_orderkey)",
    "create table lineitem (l_orderkey bigint, l_partkey bigint,"
    " l_suppkey bigint, l_linenumber int, l_quantity numeric(12,2),"
    " l_extendedprice numeric(12,2), l_discount numeric(12,2),"
    " l_tax numeric(12,2), l_returnflag text, l_linestatus text,"
    " l_shipdate date, l_commitdate date, l_receiptdate date,"
    " l_shipinstruct text, l_shipmode text, l_comment text)"
    " distribute by shard(l_orderkey)",
]

SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
             "TAKE BACK RETURN"]


def _day(s: str) -> int:
    return int((np.datetime64(s, "D") - np.datetime64("1970-01-01", "D"))
               .astype(np.int64))


def _date(day: int) -> str:
    return str(np.datetime64("1970-01-01", "D") + np.timedelta64(day, "D"))


def _money(cents: int) -> str:
    return f"{cents // 100}.{cents % 100:02d}" if cents >= 0 else (
        "-" + _money(-cents))


def _q(s) -> str:
    return "null" if s is None else "'" + str(s).replace("'", "''") + "'"


def tpch_rows(seed: int = 2, n_part: int = 40, n_supp: int = 25,
              n_cust: int = 50, n_ord: int = 160) -> dict:
    """table -> list of row tuples (SQL literal strings), in dbgen's
    shapes at a few hundred lines: four suppliers a part by the spec's
    formula, lines priced from their part's retail price, the flags and
    statuses from the dates as dbgen sets them."""
    rng = np.random.default_rng(seed)
    out: dict = {t: [] for t in ("region", "nation", "part", "supplier",
                                 "partsupp", "customer", "orders",
                                 "lineitem")}
    for i, r in enumerate(REGIONS):
        out["region"].append((str(i), _q(r), _q(f"region {i}")))
    for i, (n, r) in enumerate(NATIONS):
        out["nation"].append((str(i), _q(n), str(r), _q(f"nation {i}")))
    price = {}
    for p in range(1, n_part + 1):
        words = rng.choice(P_NAME_WORDS, 5, replace=False)
        ptype = P_TYPES[rng.integers(len(P_TYPES))]
        size = int(rng.integers(1, 51))
        # a few parts of the types and size Q2 and Q8 look for, so that
        # a few hundred lines reach them
        if p % 8 == 1:
            ptype = "ECONOMY ANODIZED STEEL"
        elif p % 8 == 2:
            ptype, size = "LARGE PLATED BRASS", 15
        cont = (CONTAINER_S1[rng.integers(5)] + " "
                + CONTAINER_S2[rng.integers(8)])
        price[p] = 90_000 + (p // 10) % 20_001 + 100 * (p % 1000)
        out["part"].append((
            str(p), _q(" ".join(words)), _q(f"Manufacturer#{p % 5 + 1}"),
            _q(f"Brand#{p % 5 + 1}{rng.integers(1, 6)}"), _q(ptype),
            str(size), _q(cont), _money(price[p]),
            _q("part comment")))
    for s in range(1, n_supp + 1):
        comment = ("wake Customer carefully Complaints" if s % 9 == 0
                   else "supplier comment")
        nk = 2 if s % 6 == 0 else (s - 1) % 25  # Q8's BRAZIL
        out["supplier"].append((
            str(s), _q(f"Supplier#{s:09d}"), _q(f"addr {s}"),
            str(nk), _q(f"{nk + 10}-555-{s:04d}"),
            _money(int(rng.integers(-99_999, 999_999))), _q(comment)))
    supp = {}
    for p in range(1, n_part + 1):
        supp[p] = []
        for i in range(4):
            sk = (p + i * (n_supp // 4 + (p - 1) // n_supp)) % n_supp + 1
            supp[p].append(sk)
            out["partsupp"].append((
                str(p), str(sk), str(int(rng.integers(1, 10_000))),
                _money(int(rng.integers(100, 100_000))), _q("ps")))
    for c in range(1, n_cust + 1):
        nk = int(rng.integers(0, 25))
        if c % 2 == 0:  # Q7's two nations and Q8's region, more often
            nk = (6, 7, 1, 3)[c // 2 % 4]
        out["customer"].append((
            str(c), _q(f"Customer#{c:09d}"), _q(f"caddr {c}"), str(nk),
            _q(f"{nk + 10}-{rng.integers(100, 1000)}-555-0{c:03d}"),
            _money(int(rng.integers(-99_999, 999_999))),
            _q(SEGMENTS[rng.integers(5)]), _q("customer comment")))
    current = _day("1995-06-17")
    for o in range(1, n_ord + 1):
        okey = (o - 1) // 8 * 32 + (o - 1) % 8 + 1
        cust = int(rng.integers(1, n_cust + 1))
        odate = int(rng.integers(_day("1992-01-01"), _day("1998-08-02")))
        total, statuses = 0, []
        # every 15th order is large: Q18's sum(l_quantity) > 300
        large = o % 15 == 0
        for ln in range(1, (7 if large else int(rng.integers(1, 8))) + 1):
            p = int(rng.integers(1, n_part + 1))
            sk = supp[p][int(rng.integers(0, 4))]
            qty = int(rng.integers(44 if large else 1, 51))
            ep = qty * price[p]
            disc, tax = int(rng.integers(0, 11)), int(rng.integers(0, 9))
            ship = odate + int(rng.integers(1, 122))
            commit = odate + int(rng.integers(30, 91))
            receipt = ship + int(rng.integers(1, 31))
            flag = ("RA"[rng.integers(2)] if receipt <= current else "N")
            status = "O" if ship > current else "F"
            statuses.append(status)
            total += ep * (100 + tax) * (100 - disc) // 10_000
            out["lineitem"].append((
                str(okey), str(p), str(sk), str(ln), str(qty), _money(ep),
                f"0.{disc:02d}", f"0.{tax:02d}", _q(flag), _q(status),
                _q(_date(ship)), _q(_date(commit)), _q(_date(receipt)),
                _q(INSTRUCTS[rng.integers(4)]),
                _q(SHIPMODES[rng.integers(7)]), _q("line comment")))
        ostatus = ("F" if all(s == "F" for s in statuses) else
                   "O" if all(s == "O" for s in statuses) else "P")
        comment = ("carefully special requests haggle" if o % 7 == 0
                   else "order comment")
        out["orders"].append((
            str(okey), str(cust), _q(ostatus), _money(total),
            _q(_date(odate)), _q(PRIORITIES[rng.integers(5)]),
            _q(f"Clerk#{rng.integers(1, 1000):09d}"), "0", _q(comment)))
    return out


def tpch_inserts(rows: dict, batch: int = 200) -> list:
    """INSERT VALUES statements for ``tpch_rows``' rows."""
    out = []
    for table, rs in rows.items():
        for i in range(0, len(rs), batch):
            vals = ", ".join("(" + ", ".join(r) + ")"
                             for r in rs[i:i + batch])
            out.append(f"insert into {table} values {vals}")
    return out


TPCH = {
    "Q1": """select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
        sum(l_extendedprice) as sum_base_price,
        sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
        sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
        avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
        avg(l_discount) as avg_disc, count(*) as count_order
        from lineitem where l_shipdate <= date '1998-09-02'
        group by l_returnflag, l_linestatus
        order by l_returnflag, l_linestatus""",
    "Q2": """select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address,
        s_phone, s_comment from part, supplier, partsupp, nation, region
        where p_partkey = ps_partkey and s_suppkey = ps_suppkey
        and p_size = 15 and p_type like '%BRASS'
        and s_nationkey = n_nationkey and n_regionkey = r_regionkey
        and r_name = 'EUROPE'
        and ps_supplycost = (select min(ps_supplycost)
            from partsupp, supplier, nation, region
            where p_partkey = ps_partkey and s_suppkey = ps_suppkey
            and s_nationkey = n_nationkey and n_regionkey = r_regionkey
            and r_name = 'EUROPE')
        order by s_acctbal desc, n_name, s_name, p_partkey limit 100""",
    "Q3": """select l_orderkey, sum(l_extendedprice * (1 - l_discount))
        as revenue, o_orderdate, o_shippriority
        from customer, orders, lineitem
        where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
        and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
        and l_shipdate > date '1995-03-15'
        group by l_orderkey, o_orderdate, o_shippriority
        order by revenue desc, o_orderdate limit 10""",
    "Q4": """select o_orderpriority, count(*) as order_count from orders
        where o_orderdate >= date '1993-07-01'
        and o_orderdate < date '1993-10-01'
        and exists (select * from lineitem where l_orderkey = o_orderkey
            and l_commitdate < l_receiptdate)
        group by o_orderpriority order by o_orderpriority""",
    "Q5": """select n_name, sum(l_extendedprice * (1 - l_discount))
        as revenue from customer, orders, lineitem, supplier, nation, region
        where c_custkey = o_custkey and l_orderkey = o_orderkey
        and l_suppkey = s_suppkey and c_nationkey = s_nationkey
        and s_nationkey = n_nationkey and n_regionkey = r_regionkey
        and r_name = 'ASIA' and o_orderdate >= date '1994-01-01'
        and o_orderdate < date '1995-01-01'
        group by n_name order by revenue desc""",
    "Q6": """select sum(l_extendedprice * l_discount) as revenue
        from lineitem where l_shipdate >= date '1994-01-01'
        and l_shipdate < date '1995-01-01'
        and l_discount between 0.05 and 0.07 and l_quantity < 24""",
    "Q7": Q7,
    "Q8": Q8,
    "Q9": Q9,
    "Q10": """select c_custkey, c_name,
        sum(l_extendedprice * (1 - l_discount)) as revenue, c_acctbal,
        n_name, c_address, c_phone, c_comment
        from customer, orders, lineitem, nation
        where c_custkey = o_custkey and l_orderkey = o_orderkey
        and o_orderdate >= date '1993-10-01'
        and o_orderdate < date '1994-01-01'
        and l_returnflag = 'R' and c_nationkey = n_nationkey
        group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
        c_comment order by revenue desc limit 20""",
    "Q11": """select ps_partkey, sum(ps_supplycost * ps_availqty) as value
        from partsupp, supplier, nation
        where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
        and n_name = 'GERMANY'
        group by ps_partkey having sum(ps_supplycost * ps_availqty) > (
            select sum(ps_supplycost * ps_availqty) * 0.0001
            from partsupp, supplier, nation
            where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
            and n_name = 'GERMANY')
        order by value desc""",
    "Q12": """select l_shipmode, sum(case when o_orderpriority = '1-URGENT'
            or o_orderpriority = '2-HIGH' then 1 else 0 end)
            as high_line_count,
        sum(case when o_orderpriority <> '1-URGENT'
            and o_orderpriority <> '2-HIGH' then 1 else 0 end)
            as low_line_count
        from orders, lineitem where o_orderkey = l_orderkey
        and l_shipmode in ('MAIL', 'SHIP')
        and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
        and l_receiptdate >= date '1994-01-01'
        and l_receiptdate < date '1995-01-01'
        group by l_shipmode order by l_shipmode""",
    "Q13": """select c_count, count(*) as custdist
        from (select c_custkey, count(o_orderkey) as c_count
            from customer left outer join orders on c_custkey = o_custkey
            and o_comment not like '%special%requests%'
            group by c_custkey) as c_orders
        group by c_count order by custdist desc, c_count desc""",
    "Q14": """select 100.00 * sum(case when p_type like 'PROMO%'
            then l_extendedprice * (1 - l_discount) else 0 end)
            / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
        from lineitem, part where l_partkey = p_partkey
        and l_shipdate >= date '1995-09-01'
        and l_shipdate < date '1995-10-01'""",
    "Q15": f"with revenue0 as ({Q15_REVENUE}) {Q15_QUERY}",
    "Q16": """select p_brand, p_type, p_size,
        count(distinct ps_suppkey) as supplier_cnt
        from partsupp, part where p_partkey = ps_partkey
        and p_brand <> 'Brand#45' and p_type not like 'MEDIUM POLISHED%'
        and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
        and ps_suppkey not in (select s_suppkey from supplier
            where s_comment like '%Customer%Complaints%')
        group by p_brand, p_type, p_size
        order by supplier_cnt desc, p_brand, p_type, p_size""",
    "Q17": """select sum(l_extendedprice) / 7.0 as avg_yearly
        from lineitem, part where p_partkey = l_partkey
        and p_brand = 'Brand#23' and p_container = 'MED BOX'
        and l_quantity < (select 0.2 * avg(l_quantity) from lineitem
            where l_partkey = p_partkey)""",
    "Q18": """select c_name, c_custkey, o_orderkey, o_orderdate,
        o_totalprice, sum(l_quantity)
        from customer, orders, lineitem
        where o_orderkey in (select l_orderkey from lineitem
            group by l_orderkey having sum(l_quantity) > 300)
        and c_custkey = o_custkey and o_orderkey = l_orderkey
        group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
        order by o_totalprice desc, o_orderdate limit 100""",
    "Q19": """select sum(l_extendedprice * (1 - l_discount)) as revenue
        from lineitem, part
        where (p_partkey = l_partkey and p_brand = 'Brand#12'
            and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
            and l_quantity >= 1 and l_quantity <= 11
            and p_size between 1 and 5
            and l_shipmode in ('AIR', 'AIR REG')
            and l_shipinstruct = 'DELIVER IN PERSON')
        or (p_partkey = l_partkey and p_brand = 'Brand#23'
            and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
            and l_quantity >= 10 and l_quantity <= 20
            and p_size between 1 and 10
            and l_shipmode in ('AIR', 'AIR REG')
            and l_shipinstruct = 'DELIVER IN PERSON')
        or (p_partkey = l_partkey and p_brand = 'Brand#34'
            and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
            and l_quantity >= 20 and l_quantity <= 30
            and p_size between 1 and 15
            and l_shipmode in ('AIR', 'AIR REG')
            and l_shipinstruct = 'DELIVER IN PERSON')""",
    "Q20": """select s_name, s_address from supplier, nation
        where s_suppkey in (select ps_suppkey from partsupp
            where ps_partkey in (select p_partkey from part
                where p_name like 'forest%')
            and ps_availqty > (select 0.5 * sum(l_quantity) from lineitem
                where l_partkey = ps_partkey and l_suppkey = ps_suppkey
                and l_shipdate >= date '1994-01-01'
                and l_shipdate < date '1995-01-01'))
        and s_nationkey = n_nationkey and n_name = 'CANADA'
        order by s_name""",
    "Q21": """select s_name, count(*) as numwait
        from supplier, lineitem l1, orders, nation
        where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
        and o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate
        and exists (select * from lineitem l2
            where l2.l_orderkey = l1.l_orderkey
            and l2.l_suppkey <> l1.l_suppkey)
        and not exists (select * from lineitem l3
            where l3.l_orderkey = l1.l_orderkey
            and l3.l_suppkey <> l1.l_suppkey
            and l3.l_receiptdate > l3.l_commitdate)
        and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA'
        group by s_name order by numwait desc, s_name limit 100""",
    "Q22": """select cntrycode, count(*) as numcust, sum(c_acctbal)
        as totacctbal
        from (select substring(c_phone from 1 for 2) as cntrycode,
            c_acctbal from customer
            where substring(c_phone from 1 for 2)
                in ('13', '31', '23', '29', '30', '18', '17')
            and c_acctbal > (select avg(c_acctbal) from customer
                where c_acctbal > 0.00 and substring(c_phone from 1 for 2)
                in ('13', '31', '23', '29', '30', '18', '17'))
            and not exists (select * from orders
                where o_custkey = c_custkey)) as custsale
        group by cntrycode order by cntrycode""",
}
# Q15 as the spec writes it: the view, the query, the view dropped
# (the view's column names as aliases: neither parser takes a column
# list after CREATE VIEW's name)
Q15_VIEW = [f"create view revenue0 as {Q15_REVENUE}", Q15_QUERY,
            "drop view revenue0"]

"""SQLite-based TPC-H oracle over the engine's physical encodings.

Plays the role of the reference's exact answer files
(sql/benchmarks/tpch/01.ans..22.ans): an independent SQL engine (stdlib
sqlite3) computes expected rows over the *same* generated data, using the
same physical domains (decimals as scaled int64, dates as epoch days) so
integer results compare exactly and float results compare to tight relative
tolerance. Each query below is the spec query hand-lowered to the physical
domain with MonetDB's decimal-scale semantics (mul adds scales, add/sub
align, div through double) so the expected values carry identical scales to
the engine's outputs.
"""

from __future__ import annotations

import datetime
import sqlite3
from decimal import Decimal
from typing import Dict

import numpy as np

from monetdb_tpu.dtypes import Kind

_EPOCH = datetime.date(1970, 1, 1)


def _days(s: str) -> int:
    return int((np.datetime64(s) - np.datetime64("1970-01-01")).astype(int))


def load_sqlite(data: Dict[str, Dict[str, np.ndarray]]) -> sqlite3.Connection:
    con = sqlite3.connect(":memory:")
    # sqlite LIKE is case-insensitive by default; MonetDB's (and the
    # TPC-H spec queries') LIKE is case-sensitive (ILIKE is the
    # insensitive form).  Without this, SF1 data hits case variants
    # ("customer ... complaints") and the oracle diverges on Q9/Q13/Q16.
    con.execute("pragma case_sensitive_like = ON")
    for tname, cols in data.items():
        names = list(cols)
        con.execute(f"create table {tname} ({', '.join(names)})")
        pyarrs = [a.tolist() if a.dtype.kind in "iu" else
                  a.astype(str).tolist() for a in (cols[n] for n in names)]
        rows = list(zip(*pyarrs))
        con.executemany(
            f"insert into {tname} values ({','.join('?' * len(names))})",
            rows)
    con.commit()
    return con


def add_indexes(con: sqlite3.Connection) -> None:
    """Key indexes (the role of MonetDB's hash indexes, gdk_hash.c),
    planner statistics and a 2 GB page cache: without the full set,
    sqlite's plan for Q5 grows superlinearly with the scale factor."""
    con.execute("pragma cache_size = -2000000")
    for ddl in (
        "create index idx_l_ok on lineitem(l_orderkey)",
        "create index idx_l_pk on lineitem(l_partkey, l_suppkey)",
        "create index idx_l_sk on lineitem(l_suppkey)",
        "create index idx_o_ok on orders(o_orderkey)",
        "create index idx_o_ck on orders(o_custkey)",
        "create index idx_c_ck on customer(c_custkey)",
        "create index idx_p_pk on part(p_partkey)",
        "create index idx_ps_pk on partsupp(ps_partkey, ps_suppkey)",
        "create index idx_ps_sk on partsupp(ps_suppkey)",
        "create index idx_s_sk on supplier(s_suppkey)",
        "create index idx_n_nk on nation(n_nationkey)",
        "create index idx_r_rk on region(r_regionkey)",
    ):
        con.execute(ddl)
    con.execute("analyze")


def convert_row(row, types):
    """An oracle row in the physical domain -> the engine's Python values
    (Decimal at the column's scale, datetime.date for epoch days)."""
    out = []
    for v, t in zip(row, types):
        if v is None:
            out.append(None)
        elif t is not None and t.kind == Kind.DECIMAL:
            out.append(Decimal(int(v)).scaleb(-t.scale))
        elif t is not None and t.kind == Kind.DATE:
            out.append(_EPOCH + datetime.timedelta(days=int(v)))
        elif isinstance(v, float):
            out.append(v)
        elif t is not None and t.np_dtype.kind == "f":
            out.append(float(v))
        else:
            out.append(v)
    return tuple(out)


def row_eq(a, b, floor: float = 1.0):
    """Exact equality except floats, which agree with the expected value
    ``b`` to 1e-9 relative to its magnitude or to ``floor``, whichever is
    larger (floats differ by summation order)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x is None or y is None:
            if x is not y:
                return False
        elif isinstance(x, float) or isinstance(y, float):
            x, y = float(x), float(y)
            if abs(x - y) > 1e-9 * max(floor, abs(y)):
                return False
        elif x != y:
            return False
    return True


def norm(r):
    """Sort key that ignores float columns (ties among float-keyed rows)."""
    return tuple("~" if isinstance(v, float) else v for v in r)


def mismatch(got, want, floor: float = 1.0):
    """None when ``got`` equals ``want`` row for row, or as multisets
    (rows whose ORDER BY keys tie may come in either order); else a
    message naming the first differences."""
    if len(got) != len(want):
        return f"{len(got)} rows, expected {len(want)}"
    diffs = [(g, w) for g, w in zip(got, want) if not row_eq(g, w, floor)]
    if not diffs:
        return None
    got_s = sorted(got, key=lambda r: repr(norm(r)))
    want_s = sorted(want, key=lambda r: repr(norm(r)))
    if all(row_eq(g, w, floor) for g, w in zip(got_s, want_s)):
        return None
    return f"first diffs {diffs[:3]}"


# epoch-day constants used by the queries
D = {
    "1998-12-01": _days("1998-12-01"),
    "1995-03-15": _days("1995-03-15"),
    "1993-07-01": _days("1993-07-01"),
    "1993-10-01": _days("1993-10-01"),
    "1994-01-01": _days("1994-01-01"),
    "1995-01-01": _days("1995-01-01"),
    "1996-12-31": _days("1996-12-31"),
    "1995-09-01": _days("1995-09-01"),
    "1995-10-01": _days("1995-10-01"),
    "1996-01-01": _days("1996-01-01"),
    "1996-04-01": _days("1996-04-01"),
    "1995-01-01+2y": _days("1996-12-31"),
    "1993-10-01+3m": _days("1994-01-01"),
    "1993-07-01+3m": _days("1993-10-01"),
    "1994-01-01+1y": _days("1995-01-01"),
    "1995-09-01+1m": _days("1995-10-01"),
    "1996-01-01+3m": _days("1996-04-01"),
}

# extract(year from <epoch-days column>) in sqlite
def _YR(col):
    return f"cast(strftime('%Y', {col}*86400, 'unixepoch') as integer)"


ORACLE = {}

ORACLE[1] = f"""
select l_returnflag, l_linestatus,
       sum(l_quantity), sum(l_extendedprice),
       sum(l_extendedprice*(100-l_discount)),
       sum(l_extendedprice*(100-l_discount)*(100+l_tax)),
       (cast(sum(l_quantity) as real)/100.0)/count(*),
       (cast(sum(l_extendedprice) as real)/100.0)/count(*),
       (cast(sum(l_discount) as real)/100.0)/count(*),
       count(*)
from lineitem where l_shipdate <= {D['1998-12-01'] - 90}
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

ORACLE[2] = """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
       s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey and s_suppkey = ps_suppkey
  and p_size = 15 and p_type like '%BRASS'
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'EUROPE'
  and ps_supplycost = (
      select min(ps_supplycost) from partsupp, supplier, nation, region
      where p_partkey = ps_partkey and s_suppkey = ps_suppkey
        and s_nationkey = n_nationkey and n_regionkey = r_regionkey
        and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
"""

ORACLE[3] = f"""
select l_orderkey, sum(l_extendedprice*(100-l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
  and c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate < {D['1995-03-15']} and l_shipdate > {D['1995-03-15']}
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""

ORACLE[4] = f"""
select o_orderpriority, count(*) from orders
where o_orderdate >= {D['1993-07-01']} and o_orderdate < {D['1993-07-01+3m']}
  and exists (select * from lineitem
              where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)
group by o_orderpriority order by o_orderpriority
"""

ORACLE[5] = f"""
select n_name, sum(l_extendedprice*(100-l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA'
  and o_orderdate >= {D['1994-01-01']} and o_orderdate < {D['1994-01-01+1y']}
group by n_name order by revenue desc
"""

ORACLE[6] = f"""
select sum(l_extendedprice*l_discount) from lineitem
where l_shipdate >= {D['1994-01-01']} and l_shipdate < {D['1994-01-01+1y']}
  and l_discount between 5 and 7 and l_quantity < 2400
"""

ORACLE[7] = f"""
select supp_nation, cust_nation, l_year, sum(volume)
from (select n1.n_name as supp_nation, n2.n_name as cust_nation,
             {_YR('l_shipdate')} as l_year,
             l_extendedprice*(100-l_discount) as volume
      from supplier, lineitem, orders, customer, nation n1, nation n2
      where s_suppkey = l_suppkey and o_orderkey = l_orderkey
        and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
        and c_nationkey = n2.n_nationkey
        and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
             or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
        and l_shipdate between {D['1995-01-01']} and {D['1996-12-31']})
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
"""

ORACLE[8] = f"""
select o_year,
       (cast(sum(case when nation = 'BRAZIL' then volume else 0 end) as real)
        /10000.0) / (cast(sum(volume) as real)/10000.0)
from (select {_YR('o_orderdate')} as o_year,
             l_extendedprice*(100-l_discount) as volume, n2.n_name as nation
      from part, supplier, lineitem, orders, customer, nation n1,
           nation n2, region
      where p_partkey = l_partkey and s_suppkey = l_suppkey
        and l_orderkey = o_orderkey and o_custkey = c_custkey
        and c_nationkey = n1.n_nationkey and n1.n_regionkey = r_regionkey
        and r_name = 'AMERICA' and s_nationkey = n2.n_nationkey
        and o_orderdate between {D['1995-01-01']} and {D['1996-12-31']}
        and p_type = 'ECONOMY ANODIZED STEEL')
group by o_year order by o_year
"""

ORACLE[9] = f"""
select nation, o_year, sum(amount)
from (select n_name as nation, {_YR('o_orderdate')} as o_year,
             l_extendedprice*(100-l_discount)
               - ps_supplycost*l_quantity as amount
      from part, supplier, lineitem, partsupp, orders, nation
      where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
        and ps_partkey = l_partkey and p_partkey = l_partkey
        and o_orderkey = l_orderkey and s_nationkey = n_nationkey
        and p_name like '%green%')
group by nation, o_year order by nation, o_year desc
"""

ORACLE[10] = f"""
select c_custkey, c_name, sum(l_extendedprice*(100-l_discount)) as revenue,
       c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= {D['1993-10-01']} and o_orderdate < {D['1993-10-01+3m']}
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
order by revenue desc limit 20
"""

ORACLE[11] = """
select ps_partkey, sum(ps_supplycost*ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
  and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost*ps_availqty)*10000 > (
    select sum(ps_supplycost*ps_availqty) from partsupp, supplier, nation
    where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
      and n_name = 'GERMANY')
order by value desc
"""

ORACLE[12] = f"""
select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT'
                 or o_orderpriority = '2-HIGH' then 1 else 0 end),
       sum(case when o_orderpriority <> '1-URGENT'
                and o_orderpriority <> '2-HIGH' then 1 else 0 end)
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= {D['1994-01-01']}
  and l_receiptdate < {D['1994-01-01+1y']}
group by l_shipmode order by l_shipmode
"""

ORACLE[13] = """
select c_count, count(*) as custdist
from (select c_custkey, count(o_orderkey) as c_count
      from customer left outer join orders
           on c_custkey = o_custkey
              and o_comment not like '%special%requests%'
      group by c_custkey)
group by c_count order by custdist desc, c_count desc
"""

ORACLE[14] = f"""
select (cast(10000*sum(case when p_type like 'PROMO%'
                            then l_extendedprice*(100-l_discount)
                            else 0 end) as real)/1000000.0)
       / (cast(sum(l_extendedprice*(100-l_discount)) as real)/10000.0)
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= {D['1995-09-01']} and l_shipdate < {D['1995-09-01+1m']}
"""

ORACLE[15] = f"""
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier,
     (select l_suppkey as supplier_no,
             sum(l_extendedprice*(100-l_discount)) as total_revenue
      from lineitem
      where l_shipdate >= {D['1996-01-01']} and l_shipdate < {D['1996-01-01+3m']}
      group by l_suppkey)
where s_suppkey = supplier_no
  and total_revenue = (
      select max(total_revenue)
      from (select l_suppkey as supplier_no,
                   sum(l_extendedprice*(100-l_discount)) as total_revenue
            from lineitem
            where l_shipdate >= {D['1996-01-01']}
              and l_shipdate < {D['1996-01-01+3m']}
            group by l_suppkey))
order by s_suppkey
"""

ORACLE[16] = """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (
      select s_suppkey from supplier
      where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
"""

ORACLE[17] = """
select (cast(sum(l_extendedprice) as real)/100.0)/7.0
from lineitem, part
where p_partkey = l_partkey and p_brand = 'Brand#23'
  and p_container = 'MED BOX'
  and l_quantity/100.0 < (select 0.2*((sum(l_quantity)/100.0)/count(*))
                          from lineitem l2 where l2.l_partkey = p_partkey)
"""

ORACLE[18] = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey having sum(l_quantity) > 30000)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate limit 100
"""

ORACLE[19] = """
select sum(l_extendedprice*(100-l_discount))
from lineitem, part
where (p_partkey = l_partkey and p_brand = 'Brand#12'
       and p_container in ('SM CASE','SM BOX','SM PACK','SM PKG')
       and l_quantity >= 100 and l_quantity <= 1100
       and p_size between 1 and 5
       and l_shipmode in ('AIR','AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_partkey = l_partkey and p_brand = 'Brand#23'
       and p_container in ('MED BAG','MED BOX','MED PKG','MED PACK')
       and l_quantity >= 1000 and l_quantity <= 2000
       and p_size between 1 and 10
       and l_shipmode in ('AIR','AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_partkey = l_partkey and p_brand = 'Brand#34'
       and p_container in ('LG CASE','LG BOX','LG PACK','LG PKG')
       and l_quantity >= 2000 and l_quantity <= 3000
       and p_size between 1 and 15
       and l_shipmode in ('AIR','AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
"""

ORACLE[20] = f"""
select s_name, s_address from supplier, nation
where s_suppkey in (
    select ps_suppkey from partsupp
    where ps_partkey in (select p_partkey from part
                         where p_name like 'forest%')
      and ps_availqty*1000 > (select 5*sum(l_quantity) from lineitem
                              where l_partkey = ps_partkey
                                and l_suppkey = ps_suppkey
                                and l_shipdate >= {D['1994-01-01']}
                                and l_shipdate < {D['1994-01-01+1y']}))
  and s_nationkey = n_nationkey and n_name = 'CANADA'
order by s_name
"""

ORACLE[21] = """
select s_name, count(*) as numwait
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
group by s_name order by numwait desc, s_name limit 100
"""

ORACLE[22] = """
select cntrycode, count(*), sum(c_acctbal)
from (select substr(c_phone, 1, 2) as cntrycode, c_acctbal
      from customer
      where substr(c_phone, 1, 2) in ('13','31','23','29','30','18','17')
        and c_acctbal/100.0 > (
            select (cast(sum(c_acctbal) as real)/100.0)/count(*)
            from customer
            where c_acctbal > 0
              and substr(c_phone, 1, 2) in
                  ('13','31','23','29','30','18','17'))
        and not exists (select * from orders where o_custkey = c_custkey))
group by cntrycode order by cntrycode
"""

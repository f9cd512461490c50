"""Mini TPC-H: ALL 22 queries over synthetic tables through the full SQL
engine (parse -> plan -> compiled pipeline). Exercises multi-key string
grouping (Q1), correlated min-cost subqueries with joins inside (Q2),
FK join chains with group+top-k (Q3, Q10, Q18), correlated EXISTS (Q4,
Q21 — including the `l2.l_suppkey != l1.l_suppkey` inequality
correlation), 6-to-8-way dimension joins (Q5, Q7, Q8, Q9), derived tables
(Q7, Q8, Q9, Q13, Q22), HAVING with scalar subqueries (Q11, Q18), LEFT
JOIN with a residual ON condition (Q13), CTE reuse + uncorrelated MAX
(Q15), NOT IN subqueries (Q16), correlated scalar expressions like
0.2 * AVG(x) (Q17, Q20), disjunctive multi-table predicates (Q19), and
NOT EXISTS anti-joins over country-code substrings (Q22).

    python benchmarks/tpch_mini.py [lineitem_rows]   # default 2^21

At small scale, every query's full result is cross-checked against pandas.
"""

import datetime
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import query_engine_tpu  # noqa: E402,F401
from query_engine_tpu.core.schema import Field, Schema  # noqa: E402
from query_engine_tpu.core.types import DataType  # noqa: E402
from query_engine_tpu.columnar.batch import (  # noqa: E402
    Column, ColumnBatch, padded_capacity,
)
from query_engine_tpu.columnar.dictionary import Dictionary  # noqa: E402
from query_engine_tpu.engine.session import Session  # noqa: E402

EPOCH = datetime.date(1970, 1, 1)


def d(y, m, dd):
    return (datetime.date(y, m, dd) - EPOCH).days


_SCHEMAS = {
    "orders": Schema([
        Field("o_orderkey", DataType.int64()),
        Field("o_custkey", DataType.int64()),
        Field("o_orderdate", DataType.date32()),
        Field("o_shippriority", DataType.int64()),
        Field("o_orderpriority", DataType.utf8()),
        Field("o_totalprice", DataType.float64()),
        Field("o_comment", DataType.utf8()),
    ]),
    "lineitem": Schema([
        Field("l_orderkey", DataType.int64()),
        Field("l_suppkey", DataType.int64()),
        Field("l_partkey", DataType.int64()),
        Field("l_shipmode", DataType.utf8()),
        Field("l_quantity", DataType.int64()),
        Field("l_extendedprice", DataType.float64()),
        Field("l_discount", DataType.float64()),
        Field("l_tax", DataType.float64()),
        Field("l_returnflag", DataType.utf8()),
        Field("l_linestatus", DataType.utf8()),
        Field("l_shipdate", DataType.date32()),
        Field("l_commitdate", DataType.date32()),
        Field("l_receiptdate", DataType.date32()),
    ]),
}

# registration order; build() returns the batches in this order
TABLES = ("customer", "orders", "lineitem", "supplier", "nation", "region",
          "part", "partsupp")


def generate(n_li: int):
    """The eight tables as host arrays, {table: {column: ndarray}}: dates
    are days since 1970-01-01, strings are numpy str arrays. Seeded, so
    the same n_li always gives the same data."""
    rng = np.random.default_rng(19920521)
    n_ord = max(n_li // 4, 64)
    n_cust = max(n_ord // 10, 16)

    n_supp = max(n_ord // 100, 8)
    n_part = max(n_li // 20, 16)
    n_nation, n_region = 25, 5

    region = {
        "r_regionkey": np.arange(n_region),
        "r_name": np.asarray(
            ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
        ),
    }
    nation = {
        "n_nationkey": np.arange(n_nation),
        "n_name": np.asarray([f"NATION{i:02d}" for i in range(n_nation)]),
        "n_regionkey": (np.arange(n_nation) % n_region),
    }
    supp_comments = [
        "quick deliveries", "Customer slow Complaints filed", "reliable",
        "pending audit", "bulk only",
    ]
    supp = {
        "s_suppkey": np.arange(n_supp),
        "s_nationkey": rng.integers(0, n_nation, n_supp),
        "s_name": np.asarray([f"Supplier#{i:09d}" for i in range(n_supp)]),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_address": np.asarray([f"addr {i}" for i in range(n_supp)]),
        "s_comment": rng.choice(supp_comments, n_supp),
    }
    part_types = [
        "PROMO BURNISHED COPPER", "PROMO PLATED TIN", "STANDARD BRUSHED",
        "ECONOMY ANODIZED STEEL", "MEDIUM POLISHED NICKEL",
        "LARGE BRUSHED BRASS",
    ]
    part_names = [
        "green tomato", "forest lace", "blue steel", "green almond",
        "rosy peach", "forest green mint", "ivory snow", "misty plum",
    ]
    containers = ["SM CASE", "SM BOX", "MED BOX", "MED BAG", "LG CASE",
                  "LG BOX", "JUMBO PKG", "WRAP CASE"]
    part = {
        "p_partkey": np.arange(n_part),
        "p_type": rng.choice(part_types, n_part),
        "p_name": rng.choice(part_names, n_part),
        "p_brand": np.asarray(
            [f"Brand#{b}" for b in rng.integers(11, 56, n_part)]
        ),
        "p_size": rng.integers(1, 51, n_part),
        "p_container": rng.choice(containers, n_part),
        "p_mfgr": np.asarray(
            [f"Manufacturer#{m}" for m in rng.integers(1, 6, n_part)]
        ),
    }
    # partsupp: every part stocked by 2 suppliers (deterministic spread)
    ps_part = np.repeat(np.arange(n_part), 2)
    ps_supp = (ps_part * 7 + np.tile(np.array([0, 3]), n_part)) % n_supp
    partsupp = {
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp,
        "ps_availqty": rng.integers(1, 10000, 2 * n_part),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, 2 * n_part), 2),
    }
    cust = {
        "c_custkey": np.arange(n_cust),
        "c_nationkey": rng.integers(0, n_nation, n_cust),
        "c_mktsegment": rng.choice(
            ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"],
            n_cust,
        ),
        "c_name": np.asarray([f"Customer#{i:09d}" for i in range(n_cust)]),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_phone": np.asarray([
            f"{cc}-{rng.integers(100, 999)}-{rng.integers(100, 999)}-"
            f"{rng.integers(1000, 9999)}"
            for cc in rng.integers(10, 35, n_cust)
        ]),
    }
    o_date = rng.integers(d(1992, 1, 1), d(1998, 8, 2), n_ord)
    o_comments = [
        "deposits nag", "special packages requests", "furious accounts",
        "special asymptotes requests wake", "quiet ideas",
    ]
    orders = {
        "o_orderkey": np.arange(n_ord),
        # top third of custkeys place no orders (keeps Q13's zero bucket and
        # Q22's NOT EXISTS branch populated, as in real TPC-H)
        "o_custkey": rng.integers(0, max(2 * n_cust // 3, 1), n_ord),
        "o_orderdate": o_date,
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_orderpriority": rng.choice(
            ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"],
            n_ord,
        ),
        "o_totalprice": np.round(rng.uniform(900.0, 500000.0, n_ord), 2),
        "o_comment": rng.choice(o_comments, n_ord),
    }
    okey = rng.integers(0, n_ord, n_li)
    ship = o_date[okey] + rng.integers(1, 122, n_li)
    commit = o_date[okey] + rng.integers(30, 91, n_li)
    receipt = ship + rng.integers(1, 31, n_li)
    li = {
        "l_orderkey": okey,
        "l_suppkey": rng.integers(0, n_supp, n_li),
        "l_partkey": rng.integers(0, n_part, n_li),
        "l_shipmode": rng.choice(
            ["MAIL", "SHIP", "AIR", "TRUCK", "RAIL", "FOB", "REG AIR"], n_li
        ),
        "l_quantity": rng.integers(1, 51, n_li),
        "l_extendedprice": np.round(rng.uniform(900, 105000, n_li), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.1, n_li), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n_li), 2),
        "l_returnflag": rng.choice(["A", "N", "R"], n_li),
        "l_linestatus": rng.choice(["O", "F"], n_li),
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
    }
    return {
        "customer": cust, "orders": orders, "lineitem": li,
        "supplier": supp, "nation": nation, "region": region,
        "part": part, "partsupp": partsupp,
    }


def _batch(cols, schema=None):
    """ColumnBatch from generate()'s host arrays, encoded in bulk: each
    string column becomes a sorted dictionary through one np.unique, and
    no value is null."""
    n = len(next(iter(cols.values())))
    cap = padded_capacity(n)

    def pad(a, fill=0):
        out = np.full(cap, fill, dtype=a.dtype)
        out[:n] = a
        return out

    fields = list(schema) if schema is not None else [
        Field(name, DataType.utf8() if a.dtype.kind == "U"
              else DataType.float64() if a.dtype.kind == "f"
              else DataType.int64())
        for name, a in cols.items()
    ]
    valid = pad(np.ones(n, bool), False)
    columns = []
    for f in fields:
        a = cols[f.name]
        if a.dtype.kind == "U":
            uniq, codes = np.unique(a, return_inverse=True)
            columns.append(Column(pad(codes.astype(np.int32)), valid,
                                  f.data_type, Dictionary(uniq.astype(object))))
        else:
            columns.append(Column(pad(a.astype(f.data_type.device_dtype)),
                                  valid, f.data_type, None))
    return ColumnBatch(Schema(fields), columns, n)


def build(n_li: int, raw=None):
    """A Session with the eight tables registered, and their batches in
    TABLES order. `raw` is generate(n_li)'s output, if already made."""
    raw = raw if raw is not None else generate(n_li)
    s = Session()
    batches = []
    for name in TABLES:
        batch = _batch(raw[name], _SCHEMAS.get(name))
        s.register_table(name, batch)
        batches.append(batch)
    return s, tuple(batches)


QUERIES = {
    "Q1": (
        "SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty, "
        "SUM(l_extendedprice) AS sum_base, "
        "SUM(l_extendedprice * (1 - l_discount)) AS sum_disc, "
        "AVG(l_quantity) AS avg_qty, AVG(l_discount) AS avg_disc, "
        "COUNT(*) AS n "
        "FROM lineitem WHERE l_shipdate <= '1998-09-02' "
        "GROUP BY l_returnflag, l_linestatus "
        "ORDER BY l_returnflag, l_linestatus"
    ),
    "Q3": (
        "SELECT l.l_orderkey, "
        "SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue, "
        "o.o_orderdate, o.o_shippriority "
        "FROM customer c JOIN orders o ON c.c_custkey = o.o_custkey "
        "JOIN lineitem l ON l.l_orderkey = o.o_orderkey "
        "WHERE c.c_mktsegment = 'BUILDING' "
        "AND o.o_orderdate < '1995-03-15' AND l.l_shipdate > '1995-03-15' "
        "GROUP BY l.l_orderkey, o.o_orderdate, o.o_shippriority "
        "ORDER BY revenue DESC LIMIT 10"
    ),
    "Q4": (
        "SELECT o.o_orderpriority, COUNT(*) AS n FROM orders o "
        "WHERE o.o_orderdate >= '1993-07-01' AND o.o_orderdate < '1993-10-01' "
        "AND EXISTS (SELECT 1 FROM lineitem l "
        "WHERE l.l_orderkey = o.o_orderkey "
        "AND l.l_commitdate < l.l_receiptdate) "
        "GROUP BY o.o_orderpriority ORDER BY o.o_orderpriority"
    ),
    "Q5": (
        "SELECT n.n_name, "
        "SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue "
        "FROM customer c "
        "JOIN orders o ON c.c_custkey = o.o_custkey "
        "JOIN lineitem l ON l.l_orderkey = o.o_orderkey "
        "JOIN supplier s ON l.l_suppkey = s.s_suppkey "
        "JOIN nation n ON s.s_nationkey = n.n_nationkey "
        "JOIN region r ON n.n_regionkey = r.r_regionkey "
        "WHERE c.c_nationkey = s.s_nationkey AND r.r_name = 'ASIA' "
        "AND o.o_orderdate >= '1994-01-01' AND o.o_orderdate < '1995-01-01' "
        "GROUP BY n.n_name ORDER BY revenue DESC"
    ),
    "Q6": (
        "SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
        "WHERE l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01' "
        "AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"
    ),
    "Q2": (
        "SELECT s.s_acctbal, s.s_name, n.n_name, p.p_partkey, p.p_mfgr "
        "FROM part p JOIN partsupp ps ON p.p_partkey = ps.ps_partkey "
        "JOIN supplier s ON s.s_suppkey = ps.ps_suppkey "
        "JOIN nation n ON s.s_nationkey = n.n_nationkey "
        "JOIN region r ON n.n_regionkey = r.r_regionkey "
        "WHERE p.p_size = 15 AND p.p_type LIKE '%TIN' AND r.r_name = 'EUROPE' "
        "AND ps.ps_supplycost = (SELECT MIN(ps2.ps_supplycost) "
        "FROM partsupp ps2 "
        "JOIN supplier s2 ON s2.s_suppkey = ps2.ps_suppkey "
        "JOIN nation n2 ON s2.s_nationkey = n2.n_nationkey "
        "JOIN region r2 ON n2.n_regionkey = r2.r_regionkey "
        "WHERE ps2.ps_partkey = p.p_partkey AND r2.r_name = 'EUROPE') "
        "ORDER BY s.s_acctbal DESC, n.n_name, s.s_name, p.p_partkey LIMIT 100"
    ),
    "Q7": (
        "SELECT supp_nation, cust_nation, l_year, SUM(volume) AS revenue "
        "FROM (SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation, "
        "EXTRACT(year FROM l.l_shipdate) AS l_year, "
        "l.l_extendedprice * (1 - l.l_discount) AS volume "
        "FROM supplier s JOIN lineitem l ON s.s_suppkey = l.l_suppkey "
        "JOIN orders o ON o.o_orderkey = l.l_orderkey "
        "JOIN customer c ON c.c_custkey = o.o_custkey "
        "JOIN nation n1 ON s.s_nationkey = n1.n_nationkey "
        "JOIN nation n2 ON c.c_nationkey = n2.n_nationkey "
        "WHERE ((n1.n_name = 'NATION01' AND n2.n_name = 'NATION02') "
        "OR (n1.n_name = 'NATION02' AND n2.n_name = 'NATION01')) "
        "AND l.l_shipdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'"
        ") shipping "
        "GROUP BY supp_nation, cust_nation, l_year "
        "ORDER BY supp_nation, cust_nation, l_year"
    ),
    "Q8": (
        "SELECT o_year, SUM(CASE WHEN nation = 'NATION05' THEN volume "
        "ELSE 0 END) / SUM(volume) AS mkt_share "
        "FROM (SELECT EXTRACT(year FROM o.o_orderdate) AS o_year, "
        "l.l_extendedprice * (1 - l.l_discount) AS volume, "
        "n2.n_name AS nation "
        "FROM part p JOIN lineitem l ON p.p_partkey = l.l_partkey "
        "JOIN supplier s ON s.s_suppkey = l.l_suppkey "
        "JOIN orders o ON o.o_orderkey = l.l_orderkey "
        "JOIN customer c ON c.c_custkey = o.o_custkey "
        "JOIN nation n1 ON n1.n_nationkey = c.c_nationkey "
        "JOIN region r ON r.r_regionkey = n1.n_regionkey "
        "JOIN nation n2 ON n2.n_nationkey = s.s_nationkey "
        "WHERE r.r_name = 'AMERICA' "
        "AND o.o_orderdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31' "
        "AND p.p_type = 'ECONOMY ANODIZED STEEL') all_nations "
        "GROUP BY o_year ORDER BY o_year"
    ),
    "Q9": (
        "SELECT nation, o_year, SUM(amount) AS sum_profit "
        "FROM (SELECT n.n_name AS nation, "
        "EXTRACT(year FROM o.o_orderdate) AS o_year, "
        "l.l_extendedprice * (1 - l.l_discount) "
        "- ps.ps_supplycost * l.l_quantity AS amount "
        "FROM part p JOIN lineitem l ON p.p_partkey = l.l_partkey "
        "JOIN supplier s ON s.s_suppkey = l.l_suppkey "
        "JOIN partsupp ps ON ps.ps_suppkey = l.l_suppkey "
        "AND ps.ps_partkey = l.l_partkey "
        "JOIN orders o ON o.o_orderkey = l.l_orderkey "
        "JOIN nation n ON s.s_nationkey = n.n_nationkey "
        "WHERE p.p_name LIKE '%green%') profit "
        "GROUP BY nation, o_year ORDER BY nation, o_year DESC"
    ),
    "Q10": (
        "SELECT c.c_custkey, c.c_name, "
        "SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue, "
        "c.c_acctbal, n.n_name "
        "FROM customer c JOIN orders o ON c.c_custkey = o.o_custkey "
        "JOIN lineitem l ON l.l_orderkey = o.o_orderkey "
        "JOIN nation n ON c.c_nationkey = n.n_nationkey "
        "WHERE o.o_orderdate >= '1993-10-01' AND o.o_orderdate < '1994-01-01' "
        "AND l.l_returnflag = 'R' "
        "GROUP BY c.c_custkey, c.c_name, c.c_acctbal, n.n_name "
        "ORDER BY revenue DESC LIMIT 20"
    ),
    "Q11": (
        "SELECT ps.ps_partkey, "
        "SUM(ps.ps_supplycost * ps.ps_availqty) AS value "
        "FROM partsupp ps JOIN supplier s ON ps.ps_suppkey = s.s_suppkey "
        "JOIN nation n ON s.s_nationkey = n.n_nationkey "
        "WHERE n.n_name = 'NATION07' "
        "GROUP BY ps.ps_partkey "
        "HAVING SUM(ps.ps_supplycost * ps.ps_availqty) > "
        "(SELECT SUM(ps2.ps_supplycost * ps2.ps_availqty) * 0.01 "
        "FROM partsupp ps2 "
        "JOIN supplier s2 ON ps2.ps_suppkey = s2.s_suppkey "
        "JOIN nation n2 ON s2.s_nationkey = n2.n_nationkey "
        "WHERE n2.n_name = 'NATION07') "
        "ORDER BY value DESC"
    ),
    "Q12": (
        "SELECT l.l_shipmode, "
        "SUM(CASE WHEN o.o_orderpriority IN ('1-URGENT', '2-HIGH') "
        "THEN 1 ELSE 0 END) AS high_line_count, "
        "SUM(CASE WHEN o.o_orderpriority NOT IN ('1-URGENT', '2-HIGH') "
        "THEN 1 ELSE 0 END) AS low_line_count "
        "FROM orders o JOIN lineitem l ON o.o_orderkey = l.l_orderkey "
        "WHERE l.l_shipmode IN ('MAIL', 'SHIP') "
        "AND l.l_commitdate < l.l_receiptdate "
        "AND l.l_shipdate < l.l_commitdate "
        "AND l.l_receiptdate >= '1994-01-01' "
        "AND l.l_receiptdate < '1995-01-01' "
        "GROUP BY l.l_shipmode ORDER BY l.l_shipmode"
    ),
    "Q14": (
        "SELECT 100.00 * SUM(CASE WHEN p.p_type LIKE 'PROMO%' "
        "THEN l.l_extendedprice * (1 - l.l_discount) ELSE 0 END) / "
        "SUM(l.l_extendedprice * (1 - l.l_discount)) AS promo_revenue "
        "FROM lineitem l JOIN part p ON l.l_partkey = p.p_partkey "
        "WHERE l.l_shipdate >= '1995-09-01' AND l.l_shipdate < '1995-10-01'"
    ),
    "Q13": (
        "SELECT c_count, COUNT(*) AS custdist FROM ("
        "SELECT c.c_custkey, COUNT(o.o_orderkey) AS c_count FROM customer c "
        "LEFT JOIN orders o ON c.c_custkey = o.o_custkey "
        "AND o.o_comment NOT LIKE '%special%requests%' "
        "GROUP BY c.c_custkey) c_orders "
        "GROUP BY c_count ORDER BY custdist DESC, c_count DESC"
    ),
    "Q15": (
        "WITH revenue AS ("
        "SELECT l_suppkey AS supplier_no, "
        "SUM(l_extendedprice * (1 - l_discount)) AS total_revenue "
        "FROM lineitem "
        "WHERE l_shipdate >= '1996-01-01' AND l_shipdate < '1996-04-01' "
        "GROUP BY l_suppkey) "
        "SELECT s.s_suppkey, s.s_name, r.total_revenue "
        "FROM supplier s JOIN revenue r ON s.s_suppkey = r.supplier_no "
        "WHERE r.total_revenue = (SELECT MAX(total_revenue) FROM revenue) "
        "ORDER BY s.s_suppkey"
    ),
    "Q16": (
        "SELECT p.p_brand, p.p_type, p.p_size, "
        "COUNT(DISTINCT ps.ps_suppkey) AS supplier_cnt "
        "FROM partsupp ps JOIN part p ON p.p_partkey = ps.ps_partkey "
        "WHERE p.p_brand != 'Brand#45' AND p.p_type NOT LIKE 'MEDIUM%' "
        "AND p.p_size IN (1, 4, 7, 10, 14, 19, 23, 36) "
        "AND ps.ps_suppkey NOT IN (SELECT s_suppkey FROM supplier "
        "WHERE s_comment LIKE '%Customer%Complaints%') "
        "GROUP BY p.p_brand, p.p_type, p.p_size "
        "ORDER BY supplier_cnt DESC, p.p_brand, p.p_type, p.p_size LIMIT 40"
    ),
    "Q17": (
        "SELECT SUM(l.l_extendedprice) / 7.0 AS avg_yearly "
        "FROM lineitem l JOIN part p ON p.p_partkey = l.l_partkey "
        "WHERE p.p_brand = 'Brand#23' AND p.p_container = 'MED BOX' "
        "AND l.l_quantity < (SELECT 0.2 * AVG(l2.l_quantity) "
        "FROM lineitem l2 WHERE l2.l_partkey = l.l_partkey)"
    ),
    "Q18": (
        "SELECT c.c_name, c.c_custkey, o.o_orderkey, o.o_orderdate, "
        "o.o_totalprice, SUM(l.l_quantity) AS total_qty "
        "FROM customer c JOIN orders o ON c.c_custkey = o.o_custkey "
        "JOIN lineitem l ON o.o_orderkey = l.l_orderkey "
        "WHERE o.o_orderkey IN (SELECT l_orderkey FROM lineitem "
        "GROUP BY l_orderkey HAVING SUM(l_quantity) > 300) "
        "GROUP BY c.c_name, c.c_custkey, o.o_orderkey, o.o_orderdate, "
        "o.o_totalprice "
        "ORDER BY o.o_totalprice DESC, o.o_orderdate LIMIT 100"
    ),
    "Q19": (
        "SELECT SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue "
        "FROM lineitem l JOIN part p ON p.p_partkey = l.l_partkey "
        "WHERE (p.p_brand = 'Brand#12' "
        "AND p.p_container IN ('SM CASE', 'SM BOX') "
        "AND l.l_quantity BETWEEN 1 AND 11 AND p.p_size BETWEEN 1 AND 5 "
        "AND l.l_shipmode IN ('AIR', 'REG AIR')) "
        "OR (p.p_brand = 'Brand#23' "
        "AND p.p_container IN ('MED BAG', 'MED BOX') "
        "AND l.l_quantity BETWEEN 10 AND 20 AND p.p_size BETWEEN 1 AND 10 "
        "AND l.l_shipmode IN ('AIR', 'REG AIR')) "
        "OR (p.p_brand = 'Brand#34' "
        "AND p.p_container IN ('LG CASE', 'LG BOX') "
        "AND l.l_quantity BETWEEN 20 AND 30 AND p.p_size BETWEEN 1 AND 15 "
        "AND l.l_shipmode IN ('AIR', 'REG AIR'))"
    ),
    "Q20": (
        "SELECT s.s_name, s.s_address FROM supplier s "
        "JOIN nation n ON s.s_nationkey = n.n_nationkey "
        "WHERE n.n_name = 'NATION03' AND s.s_suppkey IN ("
        "SELECT ps.ps_suppkey FROM partsupp ps "
        "WHERE ps.ps_partkey IN (SELECT p_partkey FROM part "
        "WHERE p_name LIKE 'forest%') "
        "AND ps.ps_availqty > (SELECT 0.5 * SUM(l.l_quantity) "
        "FROM lineitem l WHERE l.l_partkey = ps.ps_partkey "
        "AND l.l_suppkey = ps.ps_suppkey "
        "AND l.l_shipdate >= '1994-01-01' AND l.l_shipdate < '1995-01-01')) "
        "ORDER BY s.s_name"
    ),
    "Q21": (
        "SELECT s.s_name, COUNT(*) AS numwait "
        "FROM supplier s JOIN lineitem l1 ON s.s_suppkey = l1.l_suppkey "
        "JOIN orders o ON o.o_orderkey = l1.l_orderkey "
        "JOIN nation n ON s.s_nationkey = n.n_nationkey "
        "WHERE n.n_name = 'NATION04' AND l1.l_receiptdate > l1.l_commitdate "
        "AND EXISTS (SELECT 1 FROM lineitem l2 "
        "WHERE l2.l_orderkey = l1.l_orderkey "
        "AND l2.l_suppkey != l1.l_suppkey) "
        "AND NOT EXISTS (SELECT 1 FROM lineitem l3 "
        "WHERE l3.l_orderkey = l1.l_orderkey "
        "AND l3.l_suppkey != l1.l_suppkey "
        "AND l3.l_receiptdate > l3.l_commitdate) "
        "GROUP BY s.s_name ORDER BY numwait DESC, s.s_name LIMIT 100"
    ),
    "Q22": (
        "SELECT cntrycode, COUNT(*) AS numcust, SUM(c_acctbal) AS totacctbal "
        "FROM (SELECT SUBSTRING(c.c_phone, 1, 2) AS cntrycode, c.c_acctbal "
        "FROM customer c "
        "WHERE SUBSTRING(c.c_phone, 1, 2) IN "
        "('13', '31', '23', '29', '30', '18', '17') "
        "AND c.c_acctbal > (SELECT AVG(c2.c_acctbal) FROM customer c2 "
        "WHERE c2.c_acctbal > 0.00 AND SUBSTRING(c2.c_phone, 1, 2) IN "
        "('13', '31', '23', '29', '30', '18', '17')) "
        "AND NOT EXISTS (SELECT 1 FROM orders o "
        "WHERE o.o_custkey = c.c_custkey)) custsale "
        "GROUP BY cntrycode ORDER BY cntrycode"
    ),
}


def crosscheck(s, tables):
    import pandas as pd

    cust, orders, li = tables[0], tables[1], tables[2]
    supp, nation, region, part = tables[3], tables[4], tables[5], tables[6]
    partsupp = tables[7]
    df = pd.DataFrame(li.to_pydict())  # temporal columns arrive as dates
    # Q6
    m = (
        (df.l_shipdate >= datetime.date(1994, 1, 1))
        & (df.l_shipdate < datetime.date(1995, 1, 1))
        & (df.l_discount >= 0.05) & (df.l_discount <= 0.07)
        & (df.l_quantity < 24)
    )
    want = float((df[m].l_extendedprice * df[m].l_discount).sum())
    got = s.sql(QUERIES["Q6"]).to_pylist()[0][0]
    assert abs(got - want) < 1e-6 * max(abs(want), 1), (got, want)
    # Q1 group count + one aggregate
    m1 = df.l_shipdate <= datetime.date(1998, 9, 2)
    g = df[m1].groupby(["l_returnflag", "l_linestatus"])
    rows = s.sql(QUERIES["Q1"]).to_pylist()
    assert len(rows) == len(g)
    want_n = {k: len(v) for k, v in g.groups.items()}
    for r in rows:
        assert r[-1] == want_n[(r[0], r[1])]
    # Q5: 6-way join revenue by nation
    do = pd.DataFrame(orders.to_pydict())
    dc = pd.DataFrame(cust.to_pydict())
    ds = pd.DataFrame(supp.to_pydict())
    dn = pd.DataFrame(nation.to_pydict())
    dr = pd.DataFrame(region.to_pydict())
    j = (df.merge(do, left_on="l_orderkey", right_on="o_orderkey")
           .merge(dc, left_on="o_custkey", right_on="c_custkey")
           .merge(ds, left_on="l_suppkey", right_on="s_suppkey")
           .merge(dn, left_on="s_nationkey", right_on="n_nationkey")
           .merge(dr, left_on="n_regionkey", right_on="r_regionkey"))
    j = j[(j.c_nationkey == j.s_nationkey) & (j.r_name == "ASIA")
          & (j.o_orderdate >= datetime.date(1994, 1, 1))
          & (j.o_orderdate < datetime.date(1995, 1, 1))]
    want5 = (j.l_extendedprice * (1 - j.l_discount)).groupby(j.n_name).sum()
    got5 = s.sql(QUERIES["Q5"]).to_pylist()
    assert len(got5) == len(want5), (len(got5), len(want5))
    for name, rev in got5:
        assert abs(rev - want5[name]) < 1e-6 * max(abs(want5[name]), 1)
    # Q12: conditional counts by ship mode
    j12 = df.merge(do, left_on="l_orderkey", right_on="o_orderkey")
    j12 = j12[j12.l_shipmode.isin(["MAIL", "SHIP"])
              & (j12.l_commitdate < j12.l_receiptdate)
              & (j12.l_shipdate < j12.l_commitdate)
              & (j12.l_receiptdate >= datetime.date(1994, 1, 1))
              & (j12.l_receiptdate < datetime.date(1995, 1, 1))]
    hi = j12.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
    for mode, h, lo in s.sql(QUERIES["Q12"]).to_pylist():
        m12 = j12.l_shipmode == mode
        assert h == int(hi[m12].sum()) and lo == int((~hi[m12]).sum())
    # Q14: promo ratio
    dp = pd.DataFrame(part.to_pydict())
    j14 = df.merge(dp, left_on="l_partkey", right_on="p_partkey")
    j14 = j14[(j14.l_shipdate >= datetime.date(1995, 9, 1))
              & (j14.l_shipdate < datetime.date(1995, 10, 1))]
    rev = j14.l_extendedprice * (1 - j14.l_discount)
    want14 = 100.0 * rev[j14.p_type.str.startswith("PROMO")].sum() / rev.sum()
    (got14,) = s.sql(QUERIES["Q14"]).to_pylist()[0]
    assert abs(got14 - want14) < 1e-6 * max(abs(want14), 1), (got14, want14)

    dps = pd.DataFrame(partsupp.to_pydict())

    def close(a, b, tol=1e-6):
        return abs(a - b) < tol * max(abs(b), 1.0)

    # Q3: top-10 unshipped BUILDING orders by revenue
    j3 = (df.merge(do, left_on="l_orderkey", right_on="o_orderkey")
            .merge(dc, left_on="o_custkey", right_on="c_custkey"))
    j3 = j3[(j3.c_mktsegment == "BUILDING")
            & (j3.o_orderdate < datetime.date(1995, 3, 15))
            & (j3.l_shipdate > datetime.date(1995, 3, 15))]
    j3["rev"] = j3.l_extendedprice * (1 - j3.l_discount)
    w3 = (j3.groupby(["l_orderkey", "o_orderdate", "o_shippriority"])
            .rev.sum().sort_values(ascending=False).head(10))
    got3 = s.sql(QUERIES["Q3"]).to_pylist()
    assert len(got3) == len(w3)
    for ok3, rev3, od3, sp3 in got3:
        assert close(rev3, w3[(ok3, od3, sp3)]), ok3

    # Q4: order-priority counts over late-line orders (correlated EXISTS)
    late_orders = set(df[df.l_commitdate < df.l_receiptdate].l_orderkey)
    o4 = do[(do.o_orderdate >= datetime.date(1993, 7, 1))
            & (do.o_orderdate < datetime.date(1993, 10, 1))
            & do.o_orderkey.isin(late_orders)]
    w4 = o4.o_orderpriority.value_counts()
    got4 = s.sql(QUERIES["Q4"]).to_pylist()
    assert len(got4) == len(w4)
    for pri, n4 in got4:
        assert n4 == int(w4[pri]), pri

    # Q2: min-cost european supplier per sized part
    eur = (dps.merge(ds, left_on="ps_suppkey", right_on="s_suppkey")
              .merge(dn, left_on="s_nationkey", right_on="n_nationkey")
              .merge(dr, left_on="n_regionkey", right_on="r_regionkey"))
    eur = eur[eur.r_name == "EUROPE"]
    mn = eur.groupby("ps_partkey").ps_supplycost.min().rename("mincost")
    j2 = eur.merge(dp, left_on="ps_partkey", right_on="p_partkey")
    j2 = j2.merge(mn, left_on="ps_partkey", right_index=True)
    j2 = j2[(j2.p_size == 15) & j2.p_type.str.endswith("TIN")
            & (j2.ps_supplycost == j2.mincost)]
    j2 = j2.sort_values(
        ["s_acctbal", "n_name", "s_name", "p_partkey"],
        ascending=[False, True, True, True],
    ).head(100)
    got2 = s.sql(QUERIES["Q2"]).to_pylist()
    want2 = list(zip(j2.s_acctbal, j2.s_name, j2.n_name, j2.p_partkey,
                     j2.p_mfgr))
    assert len(got2) == len(want2), (len(got2), len(want2))
    for g, w in zip(got2, want2):
        assert g[1:] == w[1:] and close(g[0], w[0]), (g, w)

    # Q7: bilateral shipping volume by year
    j7 = (df.merge(do, left_on="l_orderkey", right_on="o_orderkey")
            .merge(dc, left_on="o_custkey", right_on="c_custkey")
            .merge(ds, left_on="l_suppkey", right_on="s_suppkey")
            .merge(dn.add_suffix("1"), left_on="s_nationkey",
                   right_on="n_nationkey1")
            .merge(dn.add_suffix("2"), left_on="c_nationkey",
                   right_on="n_nationkey2"))
    j7 = j7[(((j7.n_name1 == "NATION01") & (j7.n_name2 == "NATION02"))
             | ((j7.n_name1 == "NATION02") & (j7.n_name2 == "NATION01")))
            & (j7.l_shipdate >= datetime.date(1995, 1, 1))
            & (j7.l_shipdate <= datetime.date(1996, 12, 31))]
    j7["year"] = pd.to_datetime(j7.l_shipdate).dt.year
    j7["vol"] = j7.l_extendedprice * (1 - j7.l_discount)
    want7 = j7.groupby(["n_name1", "n_name2", "year"]).vol.sum()
    got7 = s.sql(QUERIES["Q7"]).to_pylist()
    assert len(got7) == len(want7), (len(got7), len(want7))
    for sn, cn, yr, revenue in got7:
        assert close(revenue, want7[(sn, cn, yr)]), (sn, cn, yr)

    # Q8: market share of NATION05 in AMERICA
    j8 = (df.merge(dp, left_on="l_partkey", right_on="p_partkey")
            .merge(ds, left_on="l_suppkey", right_on="s_suppkey")
            .merge(do, left_on="l_orderkey", right_on="o_orderkey")
            .merge(dc, left_on="o_custkey", right_on="c_custkey")
            .merge(dn.add_suffix("1"), left_on="c_nationkey",
                   right_on="n_nationkey1")
            .merge(dr, left_on="n_regionkey1", right_on="r_regionkey")
            .merge(dn.add_suffix("2"), left_on="s_nationkey",
                   right_on="n_nationkey2"))
    j8 = j8[(j8.r_name == "AMERICA")
            & (j8.o_orderdate >= datetime.date(1995, 1, 1))
            & (j8.o_orderdate <= datetime.date(1996, 12, 31))
            & (j8.p_type == "ECONOMY ANODIZED STEEL")]
    j8["year"] = pd.to_datetime(j8.o_orderdate).dt.year
    j8["vol"] = j8.l_extendedprice * (1 - j8.l_discount)
    tot = j8.groupby("year").vol.sum()
    nat = j8[j8.n_name2 == "NATION05"].groupby("year").vol.sum()
    got8 = s.sql(QUERIES["Q8"]).to_pylist()
    assert len(got8) == len(tot)
    for yr, share in got8:
        assert close(share, float(nat.get(yr, 0.0)) / tot[yr]), yr

    # Q9: profit by nation and year over green parts
    j9 = (df.merge(dp, left_on="l_partkey", right_on="p_partkey")
            .merge(ds, left_on="l_suppkey", right_on="s_suppkey")
            .merge(dps, left_on=["l_suppkey", "l_partkey"],
                   right_on=["ps_suppkey", "ps_partkey"])
            .merge(do, left_on="l_orderkey", right_on="o_orderkey")
            .merge(dn, left_on="s_nationkey", right_on="n_nationkey"))
    j9 = j9[j9.p_name.str.contains("green")]
    j9["year"] = pd.to_datetime(j9.o_orderdate).dt.year
    j9["amount"] = (j9.l_extendedprice * (1 - j9.l_discount)
                    - j9.ps_supplycost * j9.l_quantity)
    want9 = j9.groupby(["n_name", "year"]).amount.sum()
    got9 = s.sql(QUERIES["Q9"]).to_pylist()
    assert len(got9) == len(want9), (len(got9), len(want9))
    for nname, yr, profit in got9:
        assert close(profit, want9[(nname, yr)]), (nname, yr)

    # Q10: top returned-revenue customers
    j10 = (df.merge(do, left_on="l_orderkey", right_on="o_orderkey")
             .merge(dc, left_on="o_custkey", right_on="c_custkey")
             .merge(dn, left_on="c_nationkey", right_on="n_nationkey"))
    j10 = j10[(j10.o_orderdate >= datetime.date(1993, 10, 1))
              & (j10.o_orderdate < datetime.date(1994, 1, 1))
              & (j10.l_returnflag == "R")]
    j10["rev"] = j10.l_extendedprice * (1 - j10.l_discount)
    w10 = (j10.groupby(["c_custkey", "c_name", "c_acctbal", "n_name"])
              .rev.sum().sort_values(ascending=False).head(20))
    got10 = s.sql(QUERIES["Q10"]).to_pylist()
    assert len(got10) == len(w10)
    for (ck, cn10, rev10, bal, nn) in got10:
        assert close(rev10, w10[(ck, cn10, bal, nn)]), ck

    # Q11: important stock in NATION07
    j11 = (dps.merge(ds, left_on="ps_suppkey", right_on="s_suppkey")
              .merge(dn, left_on="s_nationkey", right_on="n_nationkey"))
    j11 = j11[j11.n_name == "NATION07"]
    j11["val"] = j11.ps_supplycost * j11.ps_availqty
    vals = j11.groupby("ps_partkey").val.sum()
    w11 = vals[vals > vals.sum() * 0.01]
    got11 = s.sql(QUERIES["Q11"]).to_pylist()
    assert len(got11) == len(w11), (len(got11), len(w11))
    for pk, v in got11:
        assert close(v, w11[pk]), pk

    # Q13: order-count histogram (LEFT JOIN with residual ON)
    dor = do[~do.o_comment.str.match(".*special.*requests.*")]
    counts = (dc.merge(dor, left_on="c_custkey", right_on="o_custkey",
                       how="left")
                .groupby("c_custkey").o_orderkey.count())
    w13 = counts.value_counts()
    got13 = s.sql(QUERIES["Q13"]).to_pylist()
    assert len(got13) == len(w13)
    for c_count, dist in got13:
        assert dist == int(w13[c_count]), c_count

    # Q15: top supplier by quarterly revenue
    m15 = ((df.l_shipdate >= datetime.date(1996, 1, 1))
           & (df.l_shipdate < datetime.date(1996, 4, 1)))
    r15 = (df[m15].l_extendedprice * (1 - df[m15].l_discount)) \
        .groupby(df[m15].l_suppkey).sum()
    got15 = s.sql(QUERIES["Q15"]).to_pylist()
    assert len(got15) >= 1
    for sk, _, trev in got15:
        assert close(trev, r15.max()) and close(r15[sk], r15.max()), sk

    # Q16: supplier counts excluding complaint suppliers
    bad = set(ds[ds.s_comment.str.match(".*Customer.*Complaints.*")]
              .s_suppkey)
    j16 = dps.merge(dp, left_on="ps_partkey", right_on="p_partkey")
    j16 = j16[(j16.p_brand != "Brand#45")
              & ~j16.p_type.str.startswith("MEDIUM")
              & j16.p_size.isin([1, 4, 7, 10, 14, 19, 23, 36])
              & ~j16.ps_suppkey.isin(bad)]
    w16 = (j16.groupby(["p_brand", "p_type", "p_size"])
              .ps_suppkey.nunique().reset_index()
              .sort_values(["ps_suppkey", "p_brand", "p_type", "p_size"],
                           ascending=[False, True, True, True]).head(40))
    got16 = s.sql(QUERIES["Q16"]).to_pylist()
    want16 = [tuple(r) for r in w16.itertuples(index=False)]
    assert got16 == want16, (got16[:3], want16[:3])

    # Q17: small-quantity revenue vs 20% of per-part average
    avg_q = df.groupby("l_partkey").l_quantity.mean()
    j17 = df.merge(dp, left_on="l_partkey", right_on="p_partkey")
    j17 = j17[(j17.p_brand == "Brand#23") & (j17.p_container == "MED BOX")]
    j17 = j17[j17.l_quantity < 0.2 * j17.l_partkey.map(avg_q)]
    want17 = j17.l_extendedprice.sum() / 7.0
    (got17,) = s.sql(QUERIES["Q17"]).to_pylist()[0]
    if len(j17) == 0:
        assert got17 is None, got17  # SQL SUM over zero rows is NULL
    else:
        assert close(got17, want17), (got17, want17)

    # Q18: large-volume orders
    big = df.groupby("l_orderkey").l_quantity.sum()
    big = set(big[big > 300].index)
    j18 = (df[df.l_orderkey.isin(big)]
           .merge(do, left_on="l_orderkey", right_on="o_orderkey")
           .merge(dc, left_on="o_custkey", right_on="c_custkey"))
    w18 = (j18.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                        "o_totalprice"]).l_quantity.sum().reset_index()
           .sort_values(["o_totalprice", "o_orderdate"],
                        ascending=[False, True]).head(100))
    got18 = s.sql(QUERIES["Q18"]).to_pylist()
    assert len(got18) == len(w18)
    for g, w in zip(got18, w18.itertuples(index=False)):
        assert g[:4] == (w.c_name, w.c_custkey, w.o_orderkey, w.o_orderdate)
        assert close(g[4], w.o_totalprice) and g[5] == w.l_quantity

    # Q19: disjunctive brand/container/quantity predicates
    j19 = df.merge(dp, left_on="l_partkey", right_on="p_partkey")
    air = j19.l_shipmode.isin(["AIR", "REG AIR"])
    m19 = (((j19.p_brand == "Brand#12")
            & j19.p_container.isin(["SM CASE", "SM BOX"])
            & j19.l_quantity.between(1, 11) & j19.p_size.between(1, 5) & air)
           | ((j19.p_brand == "Brand#23")
              & j19.p_container.isin(["MED BAG", "MED BOX"])
              & j19.l_quantity.between(10, 20)
              & j19.p_size.between(1, 10) & air)
           | ((j19.p_brand == "Brand#34")
              & j19.p_container.isin(["LG CASE", "LG BOX"])
              & j19.l_quantity.between(20, 30)
              & j19.p_size.between(1, 15) & air))
    want19 = (j19[m19].l_extendedprice * (1 - j19[m19].l_discount)).sum()
    (got19,) = s.sql(QUERIES["Q19"]).to_pylist()[0]
    if int(m19.sum()) == 0:
        assert got19 is None, got19  # SQL SUM over zero rows is NULL
    else:
        assert close(got19, want19), (got19, want19)

    # Q20: suppliers with excess 1994 stock of forest parts
    forest = set(dp[dp.p_name.str.startswith("forest")].p_partkey)
    m94 = ((df.l_shipdate >= datetime.date(1994, 1, 1))
           & (df.l_shipdate < datetime.date(1995, 1, 1)))
    qty94 = df[m94].groupby(["l_partkey", "l_suppkey"]).l_quantity.sum()
    jj = dps[dps.ps_partkey.isin(forest)].copy()
    half = [
        0.5 * qty94.get((pk, sk), np.nan)
        for pk, sk in zip(jj.ps_partkey, jj.ps_suppkey)
    ]
    ok_supp = set(jj.ps_suppkey[jj.ps_availqty > np.asarray(half)])
    j20 = ds.merge(dn, left_on="s_nationkey", right_on="n_nationkey")
    j20 = j20[(j20.n_name == "NATION03") & j20.s_suppkey.isin(ok_supp)]
    want20 = sorted(zip(j20.s_name, j20.s_address))
    got20 = s.sql(QUERIES["Q20"]).to_pylist()
    assert got20 == want20, (got20[:3], want20[:3])

    # Q21: suppliers who alone missed the commit date (EXISTS with != )
    late = df.l_receiptdate > df.l_commitdate
    supps_all = df.groupby("l_orderkey").l_suppkey.agg(set)
    supps_late = df[late].groupby("l_orderkey").l_suppkey.agg(set)
    j21 = (df[late].merge(ds, left_on="l_suppkey", right_on="s_suppkey")
                   .merge(dn, left_on="s_nationkey", right_on="n_nationkey"))
    j21 = j21[j21.n_name == "NATION04"]
    hits = []
    for ok, sk, sn in zip(j21.l_orderkey, j21.l_suppkey, j21.s_name):
        others = supps_all.get(ok, set()) - {sk}
        others_late = supps_late.get(ok, set()) - {sk}
        if others and not others_late:
            hits.append(sn)
    w21 = pd.Series(hits).value_counts() if hits else {}
    got21 = s.sql(QUERIES["Q21"]).to_pylist()
    assert len(got21) == len(w21)
    for sn, nw in got21:
        assert nw == int(w21[sn]), sn

    # Q22: acctbal of order-less customers in selected country codes
    codes = {"13", "31", "23", "29", "30", "18", "17"}
    cc = dc.c_phone.str[:2]
    pos = dc[(dc.c_acctbal > 0) & cc.isin(codes)]
    cutoff = pos.c_acctbal.mean()
    has_ord = set(do.o_custkey)
    sel22 = dc[cc.isin(codes) & (dc.c_acctbal > cutoff)
               & ~dc.c_custkey.isin(has_ord)]
    w22 = sel22.groupby(sel22.c_phone.str[:2]).c_acctbal.agg(["count", "sum"])
    got22 = s.sql(QUERIES["Q22"]).to_pylist()
    assert len(got22) == len(w22), (len(got22), len(w22))
    for code, n22, tot22 in got22:
        assert n22 == int(w22.loc[code, "count"])
        assert close(tot22, w22.loc[code, "sum"]), code

    print("cross-check vs pandas: OK (all 22 TPC-H queries)",
          file=sys.stderr)


def main():
    n_li = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 21
    t0 = time.time()
    s, tables = build(n_li)
    print(f"build: {time.time()-t0:.1f}s  lineitem={n_li}", file=sys.stderr)
    if n_li <= (1 << 18):
        crosscheck(s, tables)
    for name, q in QUERIES.items():
        s.sql(q)  # warm/compile
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = s.sql(q)
            ts.append(time.perf_counter() - t0)
        print(
            f"{name}: {min(ts)*1e3:8.1f} ms  "
            f"{n_li/min(ts)/1e6:7.2f}M lineitem rows/s  "
            f"({out.num_rows} rows)"
        )


if __name__ == "__main__":
    main()

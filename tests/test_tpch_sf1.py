"""TPC-H SF1 correctness envelope (VERDICT r2 item 4; BASELINE.md
north-star config 1).  All 22 queries at SF1 against the independent
sqlite oracle, plus a 100M-row sort/window capacity test with admission
active.  Opt-in (MTPU_SF1=1): the SF1 run generates ~6M-row lineitem and
takes minutes on the CPU mesh — the committed pass ledger lives in
PARITY.md ("SF1 envelope (ledger)").  Reference oracle role:
/root/reference/sql/benchmarks/tpch/01.ans-22.ans.
"""

import os

import numpy as np
import pytest

sf1 = pytest.mark.skipif(not os.environ.get("MTPU_SF1"),
                         reason="SF1 envelope: set MTPU_SF1=1 (slow)")


@pytest.fixture(scope="module")
def data():
    from monetdb_tpu.bench.tpch_gen import gen_tpch
    return gen_tpch(1.0)


@pytest.fixture(scope="module")
def engine(data):
    from monetdb_tpu.bench.tpch_load import load_tables
    from monetdb_tpu.engine import Engine
    return Engine(load_tables(data))


@pytest.fixture(scope="module")
def oracle_con(data):
    from tpch_sqlite_oracle import add_indexes, load_sqlite
    con = load_sqlite(data)
    add_indexes(con)
    return con


@sf1
@pytest.mark.parametrize("q", list(range(1, 23)))
def test_tpch_sf1_query(q, engine, oracle_con):
    from monetdb_tpu.bench.tpch_queries import QUERIES
    from tpch_sqlite_oracle import ORACLE, convert_row, mismatch

    res = engine.query(QUERIES[q])
    want_raw = oracle_con.execute(ORACLE[q]).fetchall()
    want = [convert_row(r, res.types) for r in want_raw]
    err = mismatch(res.rows, want)
    assert err is None, f"q{q}: {err}"


@sf1
def test_sf1_all_fused(engine):
    """No silent fallbacks at SF1 (VERDICT r2 weak #3)."""
    from monetdb_tpu.bench.tpch_queries import QUERIES
    from monetdb_tpu.exec.fragment import STATS
    before = dict(STATS)
    engine.query(QUERIES[1])
    engine.query(QUERIES[6])
    assert STATS["fallbacks"] == before["fallbacks"]


@sf1
def test_100m_row_sort_window_admission():
    """100M-row ORDER BY + window over the engine with capacity bucketing
    / admission active (huge-column scaling, SURVEY §5; the reference
    streams via candidate slices + mitosis row ranges)."""
    from monetdb_tpu.column import Column
    from monetdb_tpu.dtypes import I32, I64
    from monetdb_tpu.engine import Engine
    from monetdb_tpu.table import Catalog, Table

    n = 100_000_000
    rng = np.random.default_rng(11)
    k = rng.integers(0, 1 << 30, n).astype(np.int64)
    g = (k & 7).astype(np.int32)
    cat = Catalog()
    cat.add(Table.from_dict("big", {
        "g": Column.from_numpy(g, I32),
        "k": Column.from_numpy(k, I64),
    }))
    eng = Engine(cat)
    # grouped aggregate over all 100M rows
    r = eng.query("select g, count(*), min(k), max(k) from big "
                  "group by g order by g")
    assert len(r.rows) == 8
    assert sum(row[1] for row in r.rows) == n
    # global sort + limit (top-k over 100M rows)
    r2 = eng.query("select k from big order by k desc limit 5")
    top = np.partition(k, n - 5)[n - 5:]
    assert [int(x[0]) for x in r2.rows] == sorted(
        (int(v) for v in top), reverse=True)
    # window function over partitions
    r3 = eng.query(
        "select g, mx from (select g, k, max(k) over "
        "(partition by g) as mx from big) where k = mx order by g")
    mx = {gi: int(k[g == gi].max()) for gi in range(8)}
    got = {int(a): int(b) for a, b in r3.rows}
    assert got == mx

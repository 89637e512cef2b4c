"""Full TPC-H parity: all 22 queries through the SQL front-end + executor,
compared row-for-row against the independent sqlite oracle (the .ans-file
role, see tests/tpch_sqlite_oracle.py). Integer/decimal/string/date values
must match exactly; floats to 1e-9 relative."""

import pytest

from monetdb_tpu.bench.tpch_gen import gen_tpch
from monetdb_tpu.bench.tpch_load import load_tables
from monetdb_tpu.bench.tpch_queries import QUERIES
from monetdb_tpu.engine import Engine

from tpch_sqlite_oracle import ORACLE, convert_row, load_sqlite, mismatch

SF = 0.01


@pytest.fixture(scope="module")
def data():
    return gen_tpch(SF)


@pytest.fixture(scope="module")
def engine(data):
    return Engine(load_tables(data))


@pytest.fixture(scope="module")
def oracle_con(data):
    return load_sqlite(data)


@pytest.mark.parametrize("q", list(range(1, 23)))
def test_tpch_query(q, engine, oracle_con):
    res = engine.query(QUERIES[q])
    want_raw = oracle_con.execute(ORACLE[q]).fetchall()
    want = [convert_row(r, res.types) for r in want_raw]
    err = mismatch(res.rows, want)
    assert err is None, f"q{q}: {err}"

"""Measured CPU SQL-engine baseline for TPC-H (BASELINE.md protocol step 1).

The intended baseline is MonetDB itself built from /root/reference, timed
via its TRACE profiler (mal_profiler.c:674).  That build is impossible in
this sandbox: MonetDB's configure requires bison to generate
sql/server/sql_parser.y (cmake/monetdb-findpackages.cmake:14) and bison is
not installed (zero-egress environment, no package installs).  The
measurable stand-in is stdlib sqlite3 — a real, single-threaded CPU SQL
engine — running the same 22 queries hand-lowered to the same physical
domains (tests/tpch_sqlite_oracle.py) over the same generated data.
Numbers are recorded in BASELINE.md under a marker that names the engine
actually measured, and bench.py reports the comparison as
`vs_cpu_baseline` with `cpu_baseline_engine` attached — never as MonetDB.

Usage:  python -m monetdb_tpu.bench.cpu_baseline [SF]
Prints per-query cold/warm ms to stderr, a BASELINE.md table to stdout.
"""

from __future__ import annotations

import os
import sys
import time


def main() -> None:
    sf = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.join(repo, "tests"))
    from tpch_sqlite_oracle import ORACLE, add_indexes, load_sqlite

    from monetdb_tpu.bench.tpch_gen import gen_tpch

    t0 = time.perf_counter()
    data = gen_tpch(sf)
    print(f"gen sf{sf}: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    con = load_sqlite(data)
    print(f"sqlite load: {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    # match the analytical setup a tuned CPU run would use: key indexes
    # + stats + big cache
    t0 = time.perf_counter()
    add_indexes(con)
    print(f"index+analyze: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    def run_capped(sql: str, cap_s: float = 300.0):
        """Run one query; abort via sqlite interrupt after cap_s."""
        import threading
        timer = threading.Timer(cap_s, con.interrupt)
        timer.start()
        try:
            t0 = time.perf_counter()
            con.execute(sql).fetchall()
            return (time.perf_counter() - t0) * 1e3
        except sqlite_interrupted():
            return None
        finally:
            timer.cancel()

    warm_ms = {}
    for qn in sorted(ORACLE):
        sql = ORACLE[qn]
        cold = run_capped(sql)
        if cold is None:
            print(f"q{qn:02d}: TIMEOUT (>300s), excluded", file=sys.stderr)
            continue
        reps = []
        for _ in range(3):
            t = run_capped(sql)
            if t is not None:
                reps.append(t)
        warm_ms[qn] = round(sorted(reps)[len(reps) // 2], 1) if reps \
            else round(cold, 1)
        print(f"q{qn:02d}: cold={cold:9.1f}ms warm={warm_ms[qn]:9.1f}ms",
              file=sys.stderr)

    marker = "cpu-sf1-measured" if sf == 1.0 else f"cpu-sf{sf}-measured"
    print(f"<!-- {marker} engine=sqlite-{_sqlite_version()} -->")
    print("| query | warm ms |")
    print("|---|---|")
    for qn in sorted(warm_ms):
        print(f"| q{qn} | {warm_ms[qn]} |")


def sqlite_interrupted():
    import sqlite3
    return sqlite3.OperationalError


def _sqlite_version() -> str:
    import sqlite3
    return sqlite3.sqlite_version


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the SQL path on the GPU: the quickest proof that the
engine still starts and answers correctly on the card.

    python3 chip_smoke.py               # one GPU, TPC-H SF1
    python3 chip_smoke.py --four-cards  # the SPMD path over four GPUs only

Phases, all in this one process (the only one that opens the card):

* ``tpch``: TPC-H from the seeded generator (``bench/tpch_gen.py``) is
  loaded into a Database and all 22 queries run through ``Session.sql``,
  cold (lowering + compile + capacity discovery) and warm.  Each answer
  must equal the independent sqlite oracle (``tests/tpch_sqlite_oracle.py``,
  computed meanwhile on a host thread): integers, decimals, dates and
  strings exactly, floats to 1e-9 relative (GPU float sums reorder).
  ``fragment.STATS["fallbacks"]`` must stay 0.
* ``server``: ``server.Server`` on loopback; Q1, Q6 and Q18 through
  ``server.Client`` must equal the in-process rows exactly.
* ``kernel``: the Triton-route grouped-sum kernel compiled for the card,
  equal to the plain one-hot reduction at 2^23 and 2^26 rows, domains 4
  and 32.

With ``--four-cards`` only the ``tpch`` phase runs, on a 1-D row mesh over
four GPUs (``Session(mesh=...)``).  Prints the card, versions, seconds per
phase, cold/warm ms per query, ``STATS`` and ``peak_bytes_in_use``; the
last line is ``{"ok": true, "device": {...}}``.  Without a GPU, or when a
phase fails, it exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SERVED_QUERIES = (1, 6, 18)


def log(*args) -> None:
    print(*args, flush=True)


def card_info() -> str:
    """Name and power limit of each GPU, from a child process that stays
    off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(devices) -> None:
    """Refuse anything but GPUs: no run here falls back to the CPU."""
    platforms = sorted({d.platform for d in devices})
    if platforms != ["gpu"]:
        raise RuntimeError(f"needs GPU devices, JAX found {platforms}")


@contextlib.contextmanager
def _on_devices(devices):
    """Sessions run on exactly ``devices``: one device means no SPMD mesh
    (the engine's default mesh would span every visible device)."""
    from monetdb_tpu import config
    if len(devices) == 1:
        config.set("spmd_auto_mesh", False)
    try:
        yield
    finally:
        config.reset("spmd_auto_mesh")


class _Oracle(threading.Thread):
    """sqlite answers for ``queries``, computed on a host thread while the
    device path runs (sqlite releases the GIL inside a query)."""

    def __init__(self, data, queries):
        super().__init__(name="sqlite-oracle", daemon=True)
        self.data, self.queries = data, queries
        self.rows, self.error, self.seconds = {}, None, None

    def run(self):
        t0 = time.perf_counter()
        try:
            from tpch_sqlite_oracle import ORACLE, add_indexes, load_sqlite
            con = load_sqlite(self.data)
            add_indexes(con)
            for q in self.queries:
                self.rows[q] = con.execute(ORACLE[q]).fetchall()
            con.close()
        except Exception:                # reported by the main thread
            self.error = traceback.format_exc()
        self.seconds = time.perf_counter() - t0


def tpch_phase(devices, sf: float, queries=tuple(range(1, 23)),
               warm_reps: int = 3):
    """Load TPC-H at ``sf`` and run ``queries`` through ``Session.sql`` on
    ``devices`` (a row mesh when there are several), each compared with
    the sqlite oracle.  Returns (db, {q: rows}, report dict); raises on
    any wrong answer or fragment fallback."""
    if os.path.join(ROOT, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
    from monetdb_tpu.bench.tpch_gen import gen_tpch
    from monetdb_tpu.bench.tpch_load import load_tpch_db
    from monetdb_tpu.bench.tpch_queries import QUERIES
    from monetdb_tpu.exec.fragment import STATS
    from monetdb_tpu.parallel import row_mesh
    from monetdb_tpu.session import Session
    from tpch_sqlite_oracle import convert_row, mismatch

    report = {"sf": sf, "devices": len(devices), "seconds": {},
              "queries": {}}
    t0 = time.perf_counter()
    data = gen_tpch(sf, cache=False)
    report["seconds"]["generate"] = time.perf_counter() - t0
    oracle = _Oracle(data, queries)
    oracle.start()

    t0 = time.perf_counter()
    db = load_tpch_db(data=data)
    del data
    mesh = row_mesh(devices) if len(devices) > 1 else None
    stats0 = dict(STATS)
    got, failed = {}, {}
    with _on_devices(devices):
        sess = Session(db, mesh=mesh)
        report["seconds"]["load"] = time.perf_counter() - t0
        t_q = time.perf_counter()
        for q in queries:
            try:
                t = time.perf_counter()
                res = sess.sql(QUERIES[q])
                cold = time.perf_counter() - t
                warm = []
                for _ in range(warm_reps):
                    t = time.perf_counter()
                    last = sess.sql(QUERIES[q])
                    warm.append(time.perf_counter() - t)
            except Exception as ex:      # the other queries still run
                failed[q] = f"{type(ex).__name__}: {ex}"
                log(f"q{q}: FAILED {failed[q][:2000]}")
                continue
            got[q] = (res, last)
            report["queries"][q] = {
                "rows": len(res.rows), "cold_ms": cold * 1e3,
                "warm_ms": statistics.median(warm) * 1e3}
            log(f"q{q}: rows={len(res.rows)} cold_ms={cold * 1e3:.1f} "
                f"warm_ms={statistics.median(warm) * 1e3:.1f}")
        report["seconds"]["queries"] = time.perf_counter() - t_q

    t0 = time.perf_counter()
    oracle.join()
    report["seconds"]["oracle_wait"] = time.perf_counter() - t0
    report["seconds"]["oracle"] = oracle.seconds
    if oracle.error:
        raise RuntimeError(f"sqlite oracle failed:\n{oracle.error}")
    bad = [f"q{q}: {err}" for q, err in failed.items()]
    for q, (res, last) in got.items():
        want = [convert_row(r, res.types) for r in oracle.rows[q]]
        for tag, r in (("cold", res), ("warm", last)):
            err = mismatch(r.rows, want, floor=0.0)
            if err:
                bad.append(f"q{q} ({tag}): {err}")
    report["stats"] = {k: STATS[k] - stats0[k] for k in STATS}
    log("STATS", json.dumps(report["stats"], sort_keys=True))
    if bad:
        raise AssertionError("queries failed or differ from the sqlite "
                             "oracle:\n" + "\n".join(bad))
    if report["stats"]["fallbacks"]:
        raise AssertionError(
            f"{report['stats']['fallbacks']} plans left the fragment path")
    return db, {q: got[q][1].rows for q in got}, report


def server_phase(db, devices, expected, queries=SERVED_QUERIES) -> dict:
    """Serve ``db`` on loopback and require ``queries`` through
    ``server.Client`` to return ``expected[q]`` exactly."""
    from monetdb_tpu.bench.tpch_queries import QUERIES
    from monetdb_tpu.server import Client, Server

    report = {}
    with _on_devices(devices):
        srv = Server(db, host="127.0.0.1", port=0).start()
        try:
            cli = Client(*srv.address)
            try:
                for q in queries:
                    t = time.perf_counter()
                    rows = cli.sql(QUERIES[q]).rows
                    report[q] = (time.perf_counter() - t) * 1e3
                    if rows != expected[q]:
                        raise AssertionError(
                            f"q{q} via Client differs from in-process rows")
                    log(f"served q{q}: rows={len(rows)} "
                        f"ms={report[q]:.1f}")
            finally:
                cli.close()
        finally:
            srv.stop()
    return report


def kernel_phase(devices, rows=(1 << 23, 1 << 26), domains=(4, 32),
                 interpret: bool = False, reps: int = 20) -> dict:
    """The hand-written grouped-sum kernel (ops/pallas_kernels.py
    ``seg_sum``, Pallas through Triton) against the plain one-hot
    reduction, at SF1 lineitem's capacity (2^23 rows) and 2^26 rows, with
    int64 segment ids (excluded rows = domain) and int64 values as the
    engine passes them.  Sums must be equal; prints ms for both."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from monetdb_tpu.ops.pallas_kernels import seg_sum

    def timed(fn, *args):
        jax.block_until_ready(fn(*args))
        t = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t) / reps * 1e3

    report = {}
    for n in rows:
        for dom in domains:
            k1, k2 = jax.random.split(jax.random.key(n + dom))
            sid = jax.device_put(
                jax.random.randint(k1, (n,), 0, dom + 1, jnp.int64),
                devices[0])
            vals = jax.device_put(
                jax.random.randint(k2, (n,), -(1 << 40), 1 << 40,
                                   jnp.int64), devices[0])
            onehot = jax.jit(lambda s, v, d=dom: jnp.sum(jnp.where(
                s[:, None] == jnp.arange(d)[None, :], v[:, None], 0),
                axis=0))
            kern = jax.jit(lambda s, v, d=dom: seg_sum(
                s, v, domain=d, interpret=interpret))
            if not (np.asarray(kern(sid, vals))
                    == np.asarray(onehot(sid, vals))).all():
                raise AssertionError(f"seg_sum differs from the one-hot "
                                     f"reduction at {n} rows, domain {dom}")
            ms = {"onehot": timed(onehot, sid, vals),
                  "seg_sum": timed(kern, sid, vals)}
            report[(n, dom)] = ms
            log(f"seg_sum rows={n} domain={dom} equal "
                f"onehot_ms={ms['onehot']:.4f} seg_sum_ms={ms['seg_sum']:.4f}")
    return report


def _peak_bytes(devices) -> list:
    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in devices]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the TPC-H phase SPMD over four GPUs")
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor (default 1)")
    args = ap.parse_args(argv)

    import jax
    import monetdb_tpu  # noqa: F401  (x64 + compile cache, before any use)
    devices = jax.devices()
    try:
        require_gpu(devices)
    except RuntimeError as ex:
        print(f"chip_smoke: {ex}", file=sys.stderr)
        return 2
    if args.four_cards:
        if len(devices) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found "
                  f"{len(devices)}", file=sys.stderr)
            return 2
        devices = devices[:4]
    else:
        devices = devices[:1]

    import jaxlib
    log(card_info())
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__} "
        f"devices={[d.device_kind for d in devices]}")

    ok = True
    seconds = {}
    try:
        t0 = time.perf_counter()
        db, rows, report = tpch_phase(devices, args.sf)
        seconds["tpch"] = time.perf_counter() - t0
        log("tpch seconds", json.dumps(report["seconds"]))
    except Exception:
        traceback.print_exc()
        ok = False
    if ok and not args.four_cards:
        try:
            t0 = time.perf_counter()
            server_phase(db, devices, rows)
            seconds["server"] = time.perf_counter() - t0
        except Exception:
            traceback.print_exc()
            ok = False
    if not args.four_cards:
        try:
            t0 = time.perf_counter()
            kernel_phase(devices)
            seconds["kernel"] = time.perf_counter() - t0
        except Exception:
            traceback.print_exc()
            ok = False
    log("phase seconds", json.dumps(seconds))
    log("peak_bytes_in_use", _peak_bytes(devices))
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

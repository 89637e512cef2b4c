"""Benchmark: TPC-H hot-path throughput on one GPU.

Kernel-layer numbers: scan-filter throughput of a hand-written Q6 loop
(filter over 3 columns + masked sum) at 24M rows, a Q1-shaped grouped
aggregation, and join and group-by primitives, each against the card's
memory bandwidth from ``PEAKS``.  End to end: all 22 TPC-H SF1 queries
through the engine, cold and warm.  The grouped-sum kernel against the
one-hot form it replaces is ``seg_sum_bench.py``.

Measurement method: the kernel repeats K times *on device* via lax.scan
with per-iteration scalar parameters (so XLA cannot collapse iterations),
and throughput comes from the slope between two K values — this cancels
both the host↔device dispatch overhead and any loop-invariant
precomputation XLA hoists out of the scan.

Runs only on a GPU listed in ``PEAKS``.  Prints the headline JSON line on
stdout as soon as the microbenches finish, then re-prints it (updated)
after every completed engine query — last line wins, so whatever completed
is on record if the process is killed.  Detail goes to stderr, each line
with the card's name and power limit.  A section that fails leaves the
others running and makes the exit code non-zero.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np

#: memory bandwidth (GB/s) by jax device_kind.  Source: NVIDIA H100
#: Tensor Core GPU data sheet, SXM5 part (80 GB HBM3 at 3.35 TB/s).
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0}}


def _card() -> str:
    """Name and power limit as nvidia-smi reports them (a child process
    that stays off JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _timed(fn, *args, reps=5):
    import jax
    vals = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.device_get(fn(*args))
        vals.append(time.perf_counter() - t0)
    vals.sort()
    return vals[len(vals) // 2]


def main():
    import monetdb_tpu  # noqa: F401  (x64 + compile cache)
    import jax
    import jax.numpy as jnp
    from jax import lax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    if dev.device_kind not in PEAKS:
        print(f"bench: no peak table entry for {dev.device_kind!r}",
              file=sys.stderr)
        return 2
    HBM_GBPS = PEAKS[dev.device_kind]["hbm_gbps"]
    card = _card()
    failures = []

    def say(msg):
        print(f"{msg}  [{card}]", file=sys.stderr, flush=True)

    n = 24_000_000
    rng = np.random.default_rng(7)
    shipdate = jnp.asarray(rng.integers(8035, 10561, n).astype(np.int32))
    disc = jnp.asarray(rng.integers(0, 11, n).astype(np.int64))
    qty = jnp.asarray(rng.integers(100, 5100, n).astype(np.int64))
    extp = jnp.asarray((rng.integers(9000, 2_000_000, n)).astype(np.int32))
    code = jnp.asarray(rng.integers(0, 6, n).astype(np.int32))
    tax = jnp.asarray(rng.integers(0, 9, n).astype(np.int64))
    say(f"devices: {jax.devices()}")

    # ---- Q6 scan-filter: per-iteration HBM traffic ≈ 24 B/row -------------
    @jax.jit
    def q6_loop(shipdate, disc, qty, extp, los, dlos):
        def body(acc, ld):
            lo, dlo = ld
            m = ((shipdate >= lo) & (shipdate < 9131)
                 & (disc >= dlo) & (disc <= 7) & (qty < 2400))
            prod = extp * disc.astype(extp.dtype)
            return acc + jnp.sum(jnp.where(m, prod, 0).astype(jnp.int64)), None
        acc, _ = lax.scan(body, jnp.int64(0), (los, dlos))
        return acc

    def q6_args(k):
        return (shipdate, disc, qty, extp,
                jnp.asarray(8766 + np.arange(k) % 7, jnp.int32),
                jnp.asarray(5 + np.arange(k) % 2, jnp.int64))

    k1, k2 = 4, 36
    jax.device_get(q6_loop(*q6_args(k1)))
    jax.device_get(q6_loop(*q6_args(k2)))
    t1 = _timed(q6_loop, *q6_args(k1))
    t2 = _timed(q6_loop, *q6_args(k2))
    per_iter6 = max((t2 - t1) / (k2 - k1), 1e-9)
    gbs = 24.0 * n / per_iter6 / 1e9
    say(f"q6 scan-filter: {per_iter6*1e3:.3f} ms/iter  {gbs:.1f} GB/s  "
        f"{n/per_iter6/1e6:.0f} Mrows/s (t{k1}={t1*1e3:.1f}ms "
        f"t{k2}={t2*1e3:.1f}ms)")

    # ---- Q1 grouped aggregation: 6 segmented sums over 8 groups -----------
    @functools.partial(jax.jit, static_argnames=("domain",))
    def q1_loop(code, shipdate, qty, extp, disc, tax, cutoffs, *, domain=8):
        one_minus = 100 - disc
        dp = extp.astype(jnp.int64) * one_minus
        ch = dp * (100 + tax)
        ones = jnp.ones_like(qty)

        slots = jax.lax.iota(jnp.int32, domain)[None, :]

        def body(acc, cutoff):
            m = (code >= 0) & (shipdate <= cutoff)
            # one-hot reduction: the fused masked broadcast-reduce the
            # engine uses for dense group domains (exec/fragment.py
            # _SegReduce)
            oh = m[:, None] & (code[:, None] == slots)

            def seg(v):
                return jnp.sum(jnp.where(oh, v[:, None], 0), axis=0)

            parts = seg(qty) + seg(extp.astype(jnp.int64)) + seg(dp) \
                + seg(ch) + seg(disc) + seg(ones)
            return acc + jnp.sum(parts), None

        acc, _ = lax.scan(body, jnp.int64(0), cutoffs)
        return acc

    def q1_args(k):
        return (code, shipdate, qty, extp, disc, tax,
                jnp.asarray(10460 + np.arange(k) % 11, jnp.int32))

    per_iter1 = None
    try:
        j1, j2 = 2, 10
        jax.device_get(q1_loop(*q1_args(j1)))
        jax.device_get(q1_loop(*q1_args(j2)))
        t1q = _timed(q1_loop, *q1_args(j1), reps=3)
        t2q = _timed(q1_loop, *q1_args(j2), reps=3)
        per_iter1 = max((t2q - t1q) / (j2 - j1), 1e-9)
        say(f"q1 group-aggr:  {per_iter1*1e3:.3f} ms/iter  "
            f"{n/per_iter1/1e6:.0f} Mrows/s")
    except Exception as ex:  # keep the headline metric if q1 fails
        failures.append("q1")
        say(f"q1 group-aggr failed: {type(ex).__name__}: {str(ex)[:160]}")

    # ---- join + group-by against the card's memory bandwidth
    # (reference harness analog monetdb5/modules/kernel/microbenchmark.c).
    # Bytes accounted per iteration are the algorithm's compulsory device
    # memory traffic, stated inline. -------
    join_gbps = join_frac = None
    try:
        nb, npr = 10_000_000, 100_000_000
        dom = 16_777_216
        rngj = np.random.default_rng(11)
        bkeys = jnp.asarray(rngj.integers(0, dom - 64, nb)
                            .astype(np.int32))
        pkeys = jnp.asarray(rngj.integers(0, dom - 64, npr)
                            .astype(np.int32))

        @jax.jit
        def join_loop(bkeys, pkeys, offs):
            rid = lax.iota(jnp.int32, nb)

            def body(acc, off):
                # dense-build hash-join analog (the engine's join fast
                # path, exec/fragment.py r_join dense strat): scatter-min
                # build table + gather probe
                tmin = jnp.full(dom + 1, jnp.int32(nb), jnp.int32) \
                    .at[bkeys + off].min(rid, mode="drop")
                hit = tmin[jnp.clip(pkeys + off, 0, dom)]
                return acc + jnp.sum(
                    jnp.where(hit < nb, hit, -1).astype(jnp.int64)), None

            acc, _ = lax.scan(body, jnp.int64(0), offs)
            return acc

        def join_args(k):
            return (bkeys, pkeys,
                    jnp.asarray(np.arange(k) % 7, jnp.int32))
        jax.device_get(join_loop(*join_args(1)))
        jax.device_get(join_loop(*join_args(5)))
        tj1 = _timed(join_loop, *join_args(1), reps=3)
        tj2 = _timed(join_loop, *join_args(5), reps=3)
        per_j = max((tj2 - tj1) / 4, 1e-9)
        # compulsory traffic: build keys read (4B*nb) + table write
        # (4B*dom) + probe keys read (4B*npr) + probe gather (4B*npr)
        jbytes = 4.0 * (nb + dom + 2 * npr)
        join_gbps = jbytes / per_j / 1e9
        join_frac = join_gbps / HBM_GBPS
        say(f"join build+probe ({nb/1e6:.0f}M build x {npr/1e6:.0f}M "
            f"probe): {per_j*1e3:.1f} ms/iter  {join_gbps:.1f} GB/s  "
            f"{join_frac:.3f} of peak")
    except Exception as ex:
        failures.append("join")
        say(f"join roofline bench failed: {type(ex).__name__}: "
            f"{str(ex)[:160]}")

    gb_gbps = gb_frac = None
    try:
        ngr, nseg = 100_000_000, 1_000_000
        rngg = np.random.default_rng(13)
        sid = jnp.asarray(rngg.integers(0, nseg, ngr).astype(np.int32))
        vals = jnp.asarray(rngg.integers(0, 1000, ngr).astype(np.int32))
        from monetdb_tpu.exec.fragment import _lsd_argsort, _ss

        @jax.jit
        def gb_loop(sid, vals, offs):
            def body(acc, off):
                # high-cardinality grouped sum, engine sorted-reduce
                # path (exec/fragment.py _SegReduce sorted strategy):
                # one LSD sort pass + gather + cumsum + boundary diff
                s = (sid + off) % nseg
                perm = _lsd_argsort([s], ngr)
                ss = s[perm]
                v = vals[perm].astype(jnp.int64)
                c = jnp.concatenate([jnp.zeros(1, jnp.int64),
                                     jnp.cumsum(v)])
                ends = _ss(ss, lax.iota(jnp.int32, nseg), "right")
                starts = jnp.concatenate(
                    [jnp.zeros(1, ends.dtype), ends[:-1]])
                sums = c[ends] - c[starts]
                return acc + jnp.sum(sums), None

            acc, _ = lax.scan(body, jnp.int64(0), offs)
            return acc

        def gb_args(k):
            return (sid, vals, jnp.asarray(np.arange(k) % 5, jnp.int32))
        jax.device_get(gb_loop(*gb_args(1)))
        jax.device_get(gb_loop(*gb_args(3)))
        tg1 = _timed(gb_loop, *gb_args(1), reps=3)
        tg2 = _timed(gb_loop, *gb_args(3), reps=3)
        per_g = max((tg2 - tg1) / 2, 1e-9)
        # compulsory traffic: sid read + sort write-back (2x4B) + perm
        # write (4B) + value gather (4B) + widened cumsum (8B) per row
        gbytes = ngr * 24.0
        gb_gbps = gbytes / per_g / 1e9
        gb_frac = gb_gbps / HBM_GBPS
        say(f"group-by sum ({ngr/1e6:.0f}M rows, {nseg/1e6:.1f}M "
            f"groups): {per_g*1e3:.1f} ms/iter  {gb_gbps:.1f} GB/s  "
            f"{gb_frac:.3f} of peak")
    except Exception as ex:
        failures.append("groupby")
        say(f"group-by roofline bench failed: {type(ex).__name__}: "
            f"{str(ex)[:160]}")

    # ---- whole-query engine wall times, TPC-H SF1, all 22 queries -------
    # (BASELINE.md north-star config 1; measures the full SQL→plan-cache→
    # fused-fragment→result path).  Cold = first run (lower + XLA compile
    # + expansion-capacity discovery); warm = median of 3 repeat runs
    # (plan cache hit, 1-2 RPCs).
    engine_ms = {}
    engine_cold_ms = {}
    skipped = []
    failed = {}

    # measured CPU SQL-engine reference (see BASELINE.md "Measured CPU
    # baseline"): per-query warm wall ms, TPC-H SF1, measured on this
    # machine by monetdb_tpu/bench/cpu_baseline.py.  MonetDB itself cannot
    # be configured here (bison absent, zero egress — see BASELINE.md), so
    # the table records which engine was actually measured.
    cpu_engine, cpu_sf1_ms = _load_cpu_baseline()

    def emit():
        """Print the (current) headline JSON line — called after the
        microbenches and again after every engine query so the newest
        line always reflects everything completed so far."""
        vs_cpu = None
        ncov = 0
        if cpu_sf1_ms and engine_ms:
            ratios = [cpu_sf1_ms[q] / engine_ms[q]
                      for q in engine_ms
                      if engine_ms.get(q) and cpu_sf1_ms.get(q)]
            ncov = len(ratios)
            if ratios:
                vs_cpu = round(_geomean(ratios), 2)
        print(json.dumps({
            "metric": "tpch_sf4_q6_scan_filter_throughput",
            "value": round(gbs, 2),
            "unit": "GB/s/chip",
            "peak_share": round(gbs / HBM_GBPS, 4),
            "card": card,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "detail": {
                "q6_ms_per_iter": round(per_iter6 * 1e3, 4),
                "q6_mrows_per_s": round(n / per_iter6 / 1e6, 1),
                "q1_ms_per_iter": (round(per_iter1 * 1e3, 4)
                                   if per_iter1 else None),
                "q1_mrows_per_s": (round(n / per_iter1 / 1e6, 1)
                                   if per_iter1 else None),
                "join_gbps": round(join_gbps, 1) if join_gbps else None,
                "join_roofline_frac": (round(join_frac, 3)
                                       if join_frac else None),
                "groupby_gbps": round(gb_gbps, 1) if gb_gbps else None,
                "groupby_roofline_frac": (round(gb_frac, 3)
                                          if gb_frac else None),
                "hbm_peak_gbps": HBM_GBPS,
                "engine_sf1_wall_ms": engine_ms or None,
                "engine_sf1_cold_ms": engine_cold_ms or None,
                "engine_sf1_skipped": skipped or None,
                "engine_sf1_failed": failed or None,
                "cpu_baseline_engine": cpu_engine,
                "cpu_baseline_sf1_ms": cpu_sf1_ms or None,
                # geomean over the MEASURED queries; coverage says how
                # many of 22 it includes (r4 verdict: don't overstate)
                "vs_cpu_baseline_geomean": vs_cpu,
                "vs_cpu_baseline_coverage": f"{ncov}/22",
                "rows": n,
            },
        }), flush=True)

    emit()              # microbench headline is on record from here on

    try:
        from monetdb_tpu.bench.tpch_load import load_tpch
        from monetdb_tpu.bench.tpch_queries import QUERIES
        from monetdb_tpu.engine import Engine
        from monetdb_tpu.exec.fragment import STATS
        t0 = time.perf_counter()
        eng = Engine(load_tpch(1.0))
        say(f"SF1 gen+load: {time.perf_counter()-t0:.1f}s")
        import os
        # default budget sized to fit the driver window (~30 min total
        # incl. microbenches + SF1 generation; round 3 died at ~31 min)
        budget_s = float(os.environ.get("MTPU_BENCH_BUDGET_S", 900))
        budget_end = time.perf_counter() + budget_s
        # fixed order, cheapest first by earlier cold costs: a budget
        # timeout then drops a known tail instead of a random suffix
        order = [6, 4, 1, 19, 22, 17, 11, 16, 20, 14, 15, 12, 10, 13,
                 18, 2, 5, 3, 7, 21, 8, 9]
        order += [q for q in sorted(QUERIES) if q not in order]
        for qn in order:
            if qn not in QUERIES:
                continue
            if time.perf_counter() > budget_end:
                skipped.append(qn)      # no silent caps: record the drop
                continue
            sql = QUERIES[qn]
            try:
                t0 = time.perf_counter()
                eng.query(sql)
                engine_cold_ms[f"q{qn}"] = round(
                    (time.perf_counter() - t0) * 1e3, 1)
                reps = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    eng.query(sql)
                    reps.append(time.perf_counter() - t0)
                engine_ms[f"q{qn}"] = round(sorted(reps)[1] * 1e3, 1)
                say(f"engine SF1 q{qn}: warm {engine_ms[f'q{qn}']} ms "
                    f"(cold {engine_cold_ms[f'q{qn}']} ms)")
            except Exception as ex:
                say(f"engine SF1 q{qn} failed: {type(ex).__name__}: "
                    f"{str(ex)[:160]}")
                failed[f"q{qn}"] = f"{type(ex).__name__}: {str(ex)[:80]}"
                failures.append(f"q{qn}")
            emit()      # per-query persistence: last line wins
        if skipped:
            say(f"engine SF1 SKIPPED (time budget): {skipped}")
        say(f"engine SF1 wall ms: {engine_ms}")
        say(f"fragment STATS: {STATS}")
    except Exception as ex:
        failures.append("engine")
        say(f"engine wall-time bench failed: {type(ex).__name__}: "
            f"{str(ex)[:160]}")

    emit()
    if failures:
        say(f"failed sections: {failures}")
        return 1
    return 0


def _geomean(xs):
    import math
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def _load_cpu_baseline():
    """Measured CPU SQL-engine per-query times (ms, TPC-H SF1) from
    BASELINE.md's machine-readable table (marker
    `<!-- cpu-sf1-measured engine=NAME -->`), parsed so bench and docs
    cannot drift apart.  Returns (engine_name, {}) if not yet measured."""
    import os
    import re
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE.md")
    try:
        text = open(path).read()
    except OSError:
        return None, {}
    engine = None
    out = {}
    in_table = False
    for line in text.splitlines():
        m = re.search(r"<!-- cpu-sf1-measured engine=(\S+) -->", line)
        if m:
            engine = m.group(1)
            in_table = True
            continue
        if in_table:
            m = re.match(r"\|\s*q(\d+)\s*\|\s*([0-9.]+)\s*\|", line)
            if m:
                out[f"q{m.group(1)}"] = float(m.group(2))
            elif out and line.strip() and not line.startswith("|"):
                break
    return engine, out


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Decides the grouped-sum kernel: times the Triton-route ``seg_sum``
(ops/pallas_kernels.py) against the one-hot XLA form it would replace
(``_SegReduce.sum``, exec/fragment.py), on the GPU only.

    python3 seg_sum_bench.py [--sf 1.0] [--reps 50]

1. Kernel layer: ``chip_smoke.kernel_phase`` (int64 segment ids and
   values as the engine passes them, 2^23 and 2^26 rows, domains 4 and
   32, exact agreement), as GB/s of the 16 bytes per row both must read.
2. End to end: TPC-H Q1 at --sf through ``Session.sql``, warm, in turns
   one-hot, kernel, kernel, one-hot (each turn recompiles).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from bench import PEAKS


def kernel_layer(reps, peak):
    """Both forms at the widths chip_smoke.py checks, as GB/s of the 16
    bytes per row both must read, beside a plain copy's rate."""
    import jax
    import jax.numpy as jnp
    from chip_smoke import kernel_phase

    copy = jax.jit(lambda x: x + 1)
    x = jnp.zeros(1 << 26, jnp.int64)
    jax.block_until_ready(copy(x))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = copy(x)
    jax.block_until_ready(out)
    t = (time.perf_counter() - t0) / reps
    print(f"copy 2^26 int64: {t * 1e3:.4f} ms "
          f"{2 * 8 * (1 << 26) / t / 1e9:.1f} GB/s", flush=True)
    del x, out
    for (n, dom), ms in kernel_phase(jax.devices()[:1], reps=reps).items():
        row = {"rows": n, "domain": dom}
        for form, m in ms.items():
            gbs = 16 * n / m / 1e6
            row[form] = {"ms": m, "gbps": gbs, "peak_share": gbs / peak}
        print(json.dumps(row), flush=True)


def q1_end_to_end(sf, reps):
    import jax
    from monetdb_tpu import config
    from monetdb_tpu.bench.tpch_load import load_tpch_db
    from monetdb_tpu.bench.tpch_queries import QUERIES
    from monetdb_tpu.engine import plan_cache_clear
    from monetdb_tpu.ops import pallas_kernels
    from monetdb_tpu.session import Session

    calls = []
    orig = pallas_kernels.seg_sum

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    pallas_kernels.seg_sum = counting
    t0 = time.perf_counter()
    sess = Session(load_tpch_db(sf))
    print(f"SF{sf} load: {time.perf_counter() - t0:.1f} s", flush=True)
    rows = {}
    for turn, use in enumerate((False, True, True, False)):
        config.set("pallas_groupby", use)
        plan_cache_clear()
        jax.clear_caches()
        n0 = len(calls)
        t0 = time.perf_counter()
        res = sess.sql(QUERIES[1])
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sess.sql(QUERIES[1])
            warm.append(time.perf_counter() - t0)
        warm.sort()
        name = "triton" if use else "onehot"
        rows.setdefault(name, res.rows)
        assert res.rows == rows[name] == rows.get("onehot", res.rows)
        print(json.dumps({"q1_turn": turn, "form": name,
                          "kernel_calls_traced": len(calls) - n0,
                          "cold_ms": cold * 1e3,
                          "warm_median_ms": warm[len(warm) // 2] * 1e3,
                          "warm_p90_ms": warm[int(len(warm) * 0.9)] * 1e3,
                          "warm_n": len(warm)}), flush=True)
    config.reset("pallas_groupby")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    import monetdb_tpu  # noqa: F401
    import jax
    import subprocess
    d = jax.devices()[0]
    if d.platform != "gpu":
        print("seg_sum_bench: needs a GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"jax {jax.__version__} device_kind={d.device_kind}", flush=True)
    if d.device_kind not in PEAKS:
        print(f"seg_sum_bench: no peak table entry for {d.device_kind!r}",
              file=sys.stderr)
        return 2
    peak = PEAKS[d.device_kind]["hbm_gbps"]
    kernel_layer(args.reps, peak)
    q1_end_to_end(args.sf, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

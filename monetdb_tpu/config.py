"""Engine configuration (analog of the reference's GDKgetenv kv-store +
``--set key=value`` startup options, common/options/monet_options.c and
gdk/gdk_utils.c GDKgetenv).

Values can be set programmatically or via environment variables prefixed
``MTPU_`` (e.g. ``MTPU_OVERFLOW_CHECKS=0``).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import jax

# The engine works on exact 64-bit integers (decimals, counts) — enable x64
# before any array is created.
jax.config.update("jax_enable_x64", True)

#: repository root; the default compile-cache directory lives inside it
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Directory of the persistent XLA compile cache: JAX's own
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.
    Fused query fragments then compile once per machine, not once per
    process - the analog of the reference's compiled-plan query cache
    (sql/server/sql_qc.c), which must also survive process restarts."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_ROOT, ".jax_cache"))


# MTPU_COMPILE_CACHE=0 disables the persistent cache (the tests do)
if os.environ.get("MTPU_COMPILE_CACHE", "1") not in ("0", "false", ""):
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

_defaults: Dict[str, Any] = {
    # raise on integer/decimal overflow like the reference's BATcalc*
    # (gdk/gdk_calc_addsub.c ON_OVERFLOW macros)
    "overflow_checks": True,
    # compile whole plans into one fused XLA fragment when supported
    # (exec/fragment.py; analog of running the compiled MAL program as one
    # artifact, mal_interpreter.c:491). Falls back per-plan automatically.
    "fragment_exec": True,
    # bucketed capacity growth factor for device arrays (see column.capacity_for)
    "growth": 2.0,
    "min_capacity": 1024,
    # number of rows below which group-by takes the sort path unconditionally
    "small_sort_threshold": 1 << 14,
    # default bucket count for radix/hash partitioning
    "radix_bits": 8,
    # --- SPMD plan distribution (exec/fragment.py _SpmdRewriter) ---------
    # when >1 device is visible, sessions construct a row mesh and run
    # eligible plans SPMD by default — the reference runs mitosis in
    # default_pipe for every session (opt_pipes.c:76); set 0 to force
    # single-device execution (its no_mitosis_pipe)
    "spmd_auto_mesh": True,
    # tables at or above this many rows (capacity) are row-sharded over
    # the mesh; smaller ones stay replicated (the reference's mitosis
    # MIN_PART_SIZE role, opt_mitosis.c:17)
    "spmd_min_shard_rows": 1 << 16,
    # sharded join build sides whose global capacity is at most this are
    # broadcast (all_gather) to every device; larger builds hash-
    # repartition BOTH sides via the ragged all-to-all shuffle instead
    # (the broadcast-vs-partitioned join cost pick the reference lacks -
    # its remote joins always ship whole columns, remote.c:971 RMTput)
    "spmd_broadcast_rows": 1 << 18,
    # sharded group-by/distinct inputs below this many rows per shard
    # gather to one replica instead of repartitioning by key hash
    "spmd_shuffle_min_rows": 1 << 15,
    # dispatch the Triton-route grouped-sum kernel (ops/pallas_kernels.py
    # seg_sum) for dense-domain integer grouped sums on the GPU
    # (BATgroupsum role, gdk/gdk_aggr.c:900); 0 = the one-hot XLA form,
    # which seg_sum_bench.py compares it with end to end
    "pallas_groupby": True,
    # observability
    "trace": False,
    # GDKdebug-style runtime property assertions (BATassertProps,
    # gdk/gdk_bat.c): validate every operator output's claimed flags
    # (sorted/key/nonil/min/max) and cross-device replication of SPMD
    # results; a wrong flag fails loudly instead of silently picking a
    # wrong fast path. Env: MTPU_ASSERT_PROPS=1.
    "assert_props": False,
    # dataflow scheduler (mal_dataflow.c DFLOWworker pool analog):
    # worker threads for independent plan subtrees; 0/1 = sequential
    "dataflow_workers": 4,
    # admission-control memory pool in bytes (mal_resource.c memorypool);
    # tasks whose estimated footprint exceeds the free pool are delayed
    "mem_maxsize": 4 << 30,
}

_values: Dict[str, Any] = {}


def get(key: str) -> Any:
    if key in _values:
        return _values[key]
    env = os.environ.get("MTPU_" + key.upper())
    if env is not None:
        d = _defaults[key]
        if isinstance(d, bool):
            return env not in ("0", "false", "no", "")
        return type(d)(env)
    return _defaults[key]


def set(key: str, value: Any) -> None:  # noqa: A001 - mirrors GDKsetenv
    if key not in _defaults:
        raise KeyError(f"unknown config key: {key}")
    _values[key] = value


def reset(key: str | None = None) -> None:
    if key is None:
        _values.clear()
    else:
        _values.pop(key, None)

"""Row-partitioned SPMD execution (mitosis analog).

The reference splits a query into #threads row-range pieces
(opt_mitosis.c:150-190 picks the piece count), replicates the plan per piece
(opt_mergetable.c), runs pieces on a worker pool (mal_dataflow.c:247), and
concatenates with mat.pack (modules/mal/mat.c:124). Grouped aggregates run
two-phase: per-piece partials + a combine step (opt_mergetable.c:15-27,
BATgroupavg3combine gdk/gdk_aggr.c:2634).

Device mapping: a 1-D device mesh over the row axis; columns live sharded
in device memory (`NamedSharding(P("rows"))`); operators are
`shard_map`-ped kernels; the combine step is `jax.lax.psum` over the mesh
axis — XLA compiles the whole two-phase aggregate into one program with the
collective between devices.  The mesh follows the algorithm: on one host
the GPUs reach each other all to all over NVLink.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["row_mesh", "shard_array", "two_phase_sum", "sharded_q1",
           "sharded_q6", "default_mesh"]

AXIS = "rows"


def row_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


_DEFAULT_MESH: list = []  # [Mesh | None] once resolved


def default_mesh():
    """The session-default mesh: a 1-D row mesh over all visible devices
    when more than one is present, else None.  Sessions pass this to every
    Engine they build so SPMD is the product path, matching the reference
    where mitosis sits in every session's default_pipe (opt_pipes.c:76).
    Disable with config spmd_auto_mesh=0 (no_mitosis_pipe analog)."""
    from .. import config
    if not config.get("spmd_auto_mesh"):
        return None
    if not _DEFAULT_MESH:
        devs = jax.devices()
        _DEFAULT_MESH.append(row_mesh(devs) if len(devs) > 1 else None)
    return _DEFAULT_MESH[0]


def shard_array(arr: np.ndarray, mesh: Mesh, fill=0) -> jax.Array:
    """Pad to a multiple of the mesh size and place row-sharded on the mesh."""
    n = mesh.devices.size
    cap = -(-len(arr) // n) * n
    if cap != len(arr):
        pad = np.full(cap - len(arr), fill, dtype=arr.dtype)
        arr = np.concatenate([arr, pad])
    return jax.device_put(arr, NamedSharding(mesh, P(AXIS)))


def two_phase_sum(mesh: Mesh, vals: jax.Array, keys: jax.Array,
                  mask: jax.Array, domain: int) -> jax.Array:
    """Grouped sum over row-sharded inputs: shard-local segment-sum, then
    psum across the mesh (the mat_grp two-phase aggregation)."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS)), out_specs=P())
    def run(v, k, m):
        oh = m[:, None] & (k.astype(jnp.int32)[:, None]
                           == jax.lax.iota(jnp.int32, domain)[None])
        part = jnp.sum(jnp.where(oh, v[:, None], v.dtype.type(0)), axis=0)
        return jax.lax.psum(part, AXIS)

    return run(vals, keys, mask)


# ---------------------------------------------------------------------------
# fused sharded query fragments (flagship pipelines; also the bench kernels)
# ---------------------------------------------------------------------------


def sharded_q6(mesh: Mesh):
    """TPC-H Q6 as one SPMD program: scan-filter + masked sum-reduce.
    Per-element products stay in int32 (extendedprice·discount < 2^31);
    accumulation widens to int64. Returns a jitted fn over sharded arrays."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS),) * 4 + (P(),) * 5, out_specs=P())
    def step(shipdate, disc, qty, extp, lo, hi, dlo, dhi, qmax):
        m = ((shipdate >= lo) & (shipdate < hi)
             & (disc >= dlo) & (disc <= dhi) & (qty < qmax))
        prod = extp * disc.astype(extp.dtype)
        local = jnp.sum(jnp.where(m, prod, 0).astype(jnp.int64))
        return jax.lax.psum(local, AXIS)

    return jax.jit(step)


def sharded_q1(mesh: Mesh, domain: int = 8):
    """TPC-H Q1 as one SPMD program: filter + dense-domain grouped
    aggregation (two-phase: shard-local scatter-add, psum combine).

    Inputs: per-row group code (returnflag·nls + linestatus, precomputed by
    the dictionary encoder), measure columns, cutoff. Outputs: per-group
    sum_qty, sum_base, sum_disc_price, sum_charge, sum_disc, count — the
    exact partials the avg columns derive from (BATgroupavg3 decomposition,
    gdk/gdk_aggr.c:1996)."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS),) * 6 + (P(),), out_specs=P())
    def step(code, shipdate, qty, extp, disc, tax, cutoff):
        live = code >= 0
        m = live & (shipdate <= cutoff)
        one_minus = 100 - disc
        one_plus = 100 + tax
        dp = extp * one_minus          # scale 4
        ch = dp * one_plus             # scale 6
        oh = m[:, None] & (code[:, None]
                           == jax.lax.iota(jnp.int32, domain)[None])

        def seg(v):
            return jnp.sum(jnp.where(oh, v.astype(jnp.int64)[:, None], 0),
                           axis=0)

        parts = (seg(qty), seg(extp), seg(dp), seg(ch), seg(disc),
                 seg(jnp.ones_like(qty)))
        return jax.lax.psum(parts, AXIS)

    return jax.jit(step)

"""Fused single-chip benchmark fragments (flagship compiled pipelines).

These are the XLA-fused forms of the engine's hot paths — what the
operator-at-a-time executor's kernels fuse into when a whole query fragment
is jitted (the plan-fragment-jit milestone). Q6 = scan-filter + reduce,
bandwidth-bound; Q1 = filter + dense-domain grouped aggregation
(BATselect + BATgroup/BATgroupsum fused, gdk/gdk_select.c + gdk_aggr.c)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["q6_step", "q1_step"]


@jax.jit
def q6_step(shipdate, disc, qty, extp, lo, hi, dlo, dhi, qmax):
    """Masked sum(extendedprice·discount): per-element product in int32
    (always < 2^31 for TPC-H domains), int64 accumulation."""
    m = ((shipdate >= lo) & (shipdate < hi)
         & (disc >= dlo) & (disc <= dhi) & (qty < qmax))
    prod = extp * disc.astype(extp.dtype)
    return jnp.sum(jnp.where(m, prod, 0).astype(jnp.int64))


@functools.partial(jax.jit, static_argnames=("domain",))
def q1_step(code, shipdate, qty, extp, disc, tax, cutoff, *, domain: int = 8):
    """Filter + grouped sums over a dense group-code domain. Returns the
    associative partials (sums + count) that every Q1 output column —
    including the averages — derives from (gdk/gdk_aggr.c:1996 avg3)."""
    live = code >= 0
    m = live & (shipdate <= cutoff)
    one_minus = 100 - disc
    one_plus = 100 + tax
    dp = extp * one_minus
    ch = dp * one_plus
    # one-hot masked reduction per dense-domain slot: the engine's segmented
    # sum for small domains (exec/fragment.py _SegReduce)
    oh = m[:, None] & (code[:, None] == jax.lax.iota(jnp.int32, domain)[None])

    def seg(v):
        return jnp.sum(jnp.where(oh, v.astype(jnp.int64)[:, None], 0),
                       axis=0)

    return (seg(qty), seg(extp), seg(dp), seg(ch), seg(disc),
            seg(jnp.ones_like(qty)))

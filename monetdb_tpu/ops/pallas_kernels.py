"""Grouped int64 sum over a small dense segment domain, as a Pallas kernel
for the GPU through Triton (``backend="triton"``).

The reference's BATgroupsum loop (gdk/gdk_aggr.c:900) for the shape every
dictionary-encoded GROUP BY takes in this engine: segment ids in
[0, domain) with domain <= 32.  Each program owns a run of rows, walks it
in tiles, and keeps a (domain, tile) int64 partial in registers; one
reduction over the tile axis ends the program, and XLA sums the
per-program partials.  Programs share nothing, so there is no carry
between them and no atomics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["seg_sum", "SEG_SUM_MAX_DOMAIN"]

SEG_SUM_MAX_DOMAIN = 32
#: (domain x rows) int64 partials each program holds in registers
_TILE_ELEMS = 4096
#: rows each program reduces before writing its partial
_ROWS_PER_PROGRAM = 1 << 14


def _seg_sum_kernel(sid_ref, val_ref, out_ref, *, n: int, rows: int,
                    steps: int):
    dp = out_ref.shape[-1]
    base = pl.program_id(0) * (rows * steps)
    slots = lax.broadcasted_iota(jnp.int32, (dp, rows), 0)

    def body(i, acc):
        idx = base + i * rows + jnp.arange(rows, dtype=jnp.int32)
        live = idx < n
        sid = plgpu.load(sid_ref.at[idx], mask=live, other=-1)
        v = plgpu.load(val_ref.at[idx], mask=live, other=0)
        return acc + jnp.where(sid[None, :] == slots, v[None, :],
                               jnp.int64(0))

    acc = lax.fori_loop(0, steps, body, jnp.zeros((dp, rows), jnp.int64))
    out_ref[...] = jnp.sum(acc, axis=1)


@functools.partial(jax.jit, static_argnames=("domain", "interpret"))
def seg_sum(sid, vals, *, domain: int, interpret: bool = False):
    """Exact per-segment int64 sum of ``vals`` over segment ids ``sid``;
    rows whose id lies outside [0, domain) are excluded."""
    assert 0 < domain <= SEG_SUM_MAX_DOMAIN, domain
    n = sid.shape[0]
    dp = pl.next_power_of_2(domain)
    rows = _TILE_ELEMS // dp
    steps = _ROWS_PER_PROGRAM // rows
    grid = pl.cdiv(n, rows * steps)
    part = pl.pallas_call(
        functools.partial(_seg_sum_kernel, n=n, rows=rows, steps=steps),
        out_shape=jax.ShapeDtypeStruct((grid, dp), jnp.int64),
        grid=(grid,),
        in_specs=[pl.no_block_spec, pl.no_block_spec],
        out_specs=pl.BlockSpec((None, dp), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="seg_sum",
    )(sid.astype(jnp.int32), vals.astype(jnp.int64))
    return part.sum(axis=0)[:domain]

"""Sorting & top-N — the reference's BATsort (gdk/gdk_batop.c:2342; internals
GDKrsort radix gdk/gdk_rsort.c, GDKssort stable merge gdk/gdk_ssort.c,
GDKqsort gdk/gdk_qsort.c) and BATfirstn (gdk/gdk_firstn.c:1280).

Design: all orderings are expressed as *monotone int64 key transforms*
(floats via sign-magnitude bit trick, strings via order-preserving dict
codes, descending via bitwise complement), then one multi-operand
``lax.sort`` with the row id as payload gives a stable lexicographic
argsort — the device-efficient replacement for the reference's three
sort algorithms. Nils sort first ascending / last descending by sentinel
construction, matching GDK's "nil is smallest" ordering; explicit
nilslast remaps the sentinel to the far end (BATsort's nilslast flag).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..column import Cand, Column, capacity_for, valid_mask
from ..dtypes import OID
from .project import project_oids
from .select import materialize

__all__ = ["sort_key", "argsort", "sorted_columns", "firstn"]

_I64_MAX = np.int64(np.iinfo(np.int64).max)
_I64_MIN = np.int64(np.iinfo(np.int64).min)


def sort_key(x: jax.Array, descending: bool = False,
             nils_last: Optional[bool] = None) -> jax.Array:
    """Monotone int64 key for any physical column dtype.

    nils_last=None keeps GDK default (nil smallest → first asc, last desc);
    True/False force the position regardless of direction.
    """
    if x.dtype.kind == "f":
        f = x.astype(jnp.float64)
        bits = jax.lax.bitcast_convert_type(f, jnp.int64)
        key = jnp.where(bits < 0, jnp.int64(_I64_MIN) ^ ~bits, bits)
        # NaN (nil) → smallest
        key = jnp.where(jnp.isnan(f), _I64_MIN, key)
        nilmask = jnp.isnan(f)
    elif x.dtype.kind == "b":
        key = x.astype(jnp.int64)
        nilmask = None
    else:
        nilmask = x == jnp.iinfo(x.dtype).min
        key = x.astype(jnp.int64)
        if x.dtype != jnp.int64:
            # keep nil = smallest in the widened key space
            key = jnp.where(nilmask, _I64_MIN, key)
    if descending:
        key = ~key  # order-reversing, overflow-free
        if nilmask is not None:
            # after complement nil became largest = last; GDK default keeps it
            pass
    if nils_last is not None and nilmask is not None:
        target = _I64_MAX if nils_last else _I64_MIN
        key = jnp.where(nilmask, target, key)
    return key


@functools.partial(jax.jit, static_argnames=("nkeys",))
def _lexsort(keys, count, base_mask, *, nkeys: int):
    cap = keys[0].shape[0]
    live = valid_mask(cap, count)
    if base_mask is not None:
        live = live & base_mask
    dead = (~live).astype(jnp.int8)
    io = jax.lax.iota(jnp.int64, cap)
    ops = (dead, *keys, io)
    out = jax.lax.sort(ops, num_keys=nkeys + 1, is_stable=True)
    rows = out[-1]
    n = jnp.sum(live.astype(jnp.int64))
    rows = jnp.where(jax.lax.iota(jnp.int64, cap) < n, rows, -1)
    return rows, n


def argsort(cols: Sequence[Column], descending=None, nils_last=None,
            cand: Optional[Cand] = None) -> Tuple[jax.Array, int]:
    """Stable lexicographic argsort → (oids, count). BATsort's order BAT."""
    k = len(cols)
    descending = descending or [False] * k
    nils_last = nils_last or [None] * k
    keys = [sort_key(c.data, d, nl)
            for c, d, nl in zip(cols, descending, nils_last)]
    base_mask = cand.as_mask(cols[0].cap) if (cand is not None and
                                              not cand.is_all()) else None
    rows, n = _lexsort(tuple(keys), jnp.int64(cols[0].count), base_mask,
                       nkeys=k)
    if cand is None:
        return rows, cols[0].count
    return rows, cand.count()


def sorted_columns(order: Tuple[jax.Array, int],
                   cols: Sequence[Column]) -> List[Column]:
    """Apply an order (oids, n) to payload columns (BATsort's sorted BAT)."""
    oids, n = order
    return [project_oids(oids, n, c) for c in cols]


@functools.partial(jax.jit, static_argnames=("k",))
def _topk_single(key, count, *, k: int):
    """Smallest-k row ids by a single monotone key: lax.top_k of the
    complement (O(n log k), the MXU/VPU-friendly BATfirstn form)."""
    cap = key.shape[0]
    live = valid_mask(cap, count)
    inv = jnp.where(live, ~key, _I64_MIN)      # dead rows lose
    _vals, idx = jax.lax.top_k(inv, k)
    n = jnp.minimum(jnp.int64(k), jnp.sum(live.astype(jnp.int64)))
    io = jax.lax.iota(jnp.int64, k)
    return jnp.where(io < n, idx.astype(jnp.int64), -1), n


def firstn(cols: Sequence[Column], n: int, descending=None, nils_last=None,
           cand: Optional[Cand] = None) -> Tuple[jax.Array, int]:
    """BATfirstn (gdk/gdk_firstn.c:1280): top-n row ids under the ordering.

    Single-key: lax.top_k over the monotone key transform (O(n log k)).
    Multi-key / candidate-filtered: full device sort then prefix (lax.sort
    replaces the reference's heap strategies)."""
    k = len(cols)
    descending = descending or [False] * k
    nils_last = nils_last or [None] * k
    if k == 1 and cand is None and n > 0 and n <= cols[0].cap:
        from ..obs import set_algorithm
        set_algorithm("firstn:topk")
        key = sort_key(cols[0].data, descending[0], nils_last[0])
        out_cap = capacity_for(n)
        kk = min(max(out_cap, n), cols[0].cap)
        oids, nn = _topk_single(key, jnp.int64(cols[0].count), k=kk)
        n = min(n, int(nn))
        out_cap = capacity_for(n)
        sl = oids[:out_cap]
        sl = jnp.where(valid_mask(out_cap, n), sl, -1)
        return sl, n
    from ..obs import set_algorithm
    set_algorithm("firstn:sort")
    oids, total = argsort(cols, descending, nils_last, cand)
    n = min(n, total)
    out_cap = capacity_for(n)
    sl = oids[:out_cap] if out_cap <= oids.shape[0] else jnp.pad(
        oids, (0, out_cap - oids.shape[0]), constant_values=-1)
    sl = jnp.where(valid_mask(out_cap, n), sl, -1)
    return sl, n

"""Grouping — the reference's BATgroup (gdk/gdk_group.c:1347).

Contract preserved (gdk/gdk_group.c:20-45): ``group`` *refines* an existing
grouping — multi-column GROUP BY is chained refinement (col1 → groups;
col2 + groups → groups'), which is how n-ary keys avoid tuple
materialization. Outputs: per-row group ids, extents (representative oid per
group, usable as a candidate list), and histo (group sizes).

The reference documents 6 strategies (gdk_group.c:20-60). This engine
keeps the property-driven dispatch with three:

* ``dense``  — small known domain (dict codes, bools, bounded ints):
  combined = prev_id·D + code, presence histogram + prefix-sum renumber.
  One pass, no sort; this is the reference's "subscan"/histogram strategy
  and covers virtually every SQL GROUP BY over dict-encoded columns.
* ``sorted`` — column already sorted within groups: boundary compare +
  prefix sum (reference strategy 3, consecutive-compare).
* ``sort``   — general: lexicographic device sort of (prev_id, value) with
  row payload, boundary flags, prefix-sum ids, scatter back (replaces the
  reference's hash strategies; XLA's sort is the device primitive).

Group ids are aligned to the *base* rows (capacity array); rows outside the
candidate get id -1. ``ngroups`` is a host int (one sync — the reference
also materializes group counts).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..column import Cand, Column, capacity_for, valid_mask
from ..dtypes import I64, OID, SQLType, Kind

__all__ = ["GroupResult", "group", "group_multi"]

_DENSE_DOMAIN_MAX = 1 << 20


@dataclasses.dataclass
class GroupResult:
    ids: jax.Array          # int32, len = base cap, -1 = not a candidate
    ngroups: int            # host
    base_count: int
    extents: Optional[jax.Array] = None   # int64 oids, cap ≥ ngroups, tail -1
    histo: Optional[jax.Array] = None     # int64 counts, same cap

    @property
    def seg_cap(self) -> int:
        return capacity_for(self.ngroups)

    def extents_column(self) -> Column:
        return Column(OID, self.extents, self.ngroups, sorted=True, key=True)

    def histo_column(self) -> Column:
        return Column(I64, self.histo, self.ngroups)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("domain",))
def _dense_group(comb, count, base_mask, *, domain: int):
    """Histogram + renumber for combined code ∈ [0, domain) (caller builds
    combined = prev_id·D + code)."""
    cap = comb.shape[0]
    live = valid_mask(cap, count)
    if base_mask is not None:
        live = live & base_mask
    safe = jnp.where(live, comb.astype(jnp.int64), domain)
    ones = live.astype(jnp.int64)
    hist = jnp.zeros(domain + 1, jnp.int64).at[safe].add(ones)
    present = hist[:domain] > 0
    # compact renumber: new_id[code] = rank among present codes
    newid = jnp.cumsum(present.astype(jnp.int32)) - 1
    ids = jnp.where(live, newid[jnp.clip(safe, 0, domain - 1)], -1).astype(jnp.int32)
    ngroups = jnp.sum(present.astype(jnp.int32))
    # extents: min oid per combined code, then compact
    io = jax.lax.iota(jnp.int64, cap)
    big = jnp.int64(cap + 1)
    minoid = jnp.full(domain + 1, big, jnp.int64).at[safe].min(
        jnp.where(live, io, big))
    return ids, ngroups, present, hist[:domain], minoid[:domain], newid


@functools.partial(jax.jit, static_argnames=("seg_cap",))
def _compact_per_group(present, values, newid, fill, *, seg_cap: int):
    """Scatter per-domain-slot values into compact group slots."""
    pos = jnp.where(present, newid.astype(jnp.int64), seg_cap)
    out = jnp.full(seg_cap, fill, values.dtype)
    return out.at[pos].set(values, mode="drop")


@jax.jit
def _sort_group(keys_prev, keys_val, count, base_mask):
    """General sort-based grouping. Returns per-row ids + ngroups (device)."""
    cap = keys_val.shape[0]
    live = valid_mask(cap, count)
    if base_mask is not None:
        live = live & base_mask
    # push non-candidates to the end: sort key (dead, prev, val, row)
    dead = (~live).astype(jnp.int32)
    io = jax.lax.iota(jnp.int64, cap)
    sorted_ = jax.lax.sort((dead, keys_prev, keys_val, io), num_keys=3)
    d_s, p_s, v_s, rows = sorted_
    first = jax.lax.iota(jnp.int32, cap) == 0
    bound = first | (p_s != jnp.roll(p_s, 1)) | (v_s != jnp.roll(v_s, 1))
    live_s = d_s == 0
    gid_s = jnp.cumsum((bound & live_s).astype(jnp.int32)) - 1
    ngroups = jnp.max(jnp.where(live_s, gid_s, -1)) + 1
    ids = jnp.full(cap, jnp.int32(-1))
    ids = ids.at[rows].set(jnp.where(live_s, gid_s, -1))
    return ids, ngroups, rows, gid_s, live_s


@functools.partial(jax.jit, static_argnames=("seg_cap",))
def _extents_histo(ids, count, *, seg_cap: int):
    cap = ids.shape[0]
    live = valid_mask(cap, count) & (ids >= 0)
    safe = jnp.where(live, ids.astype(jnp.int64), seg_cap)
    ones = live.astype(jnp.int64)
    hist = jnp.zeros(seg_cap + 1, jnp.int64).at[safe].add(ones)[:seg_cap]
    io = jax.lax.iota(jnp.int64, cap)
    big = jnp.int64(cap + 1)
    ext = jnp.full(seg_cap + 1, big, jnp.int64).at[safe].min(
        jnp.where(live, io, big))[:seg_cap]
    ext = jnp.where(hist > 0, ext, -1)
    return ext, hist


# ---------------------------------------------------------------------------
# host dispatch
# ---------------------------------------------------------------------------


def _dense_domain(col: Column) -> Optional[int]:
    """Domain size if the column maps to small ints [0, D) cheaply.
    Nils get a dedicated extra slot (they form a group of their own,
    matching the reference where nil is an ordinary grouping value)."""
    t = col.typ
    if t.kind == Kind.STR and col.sdict is not None:
        return len(col.sdict) + 1
    if t.np_dtype.kind == "b":
        return 2
    if t.np_dtype == np.dtype(np.int8):
        return 256
    if col.nonil and col.minval is not None and col.maxval is not None:
        d = int(col.maxval) - int(col.minval) + 1
        if 0 < d <= _DENSE_DOMAIN_MAX:
            return d
    return None


def _codes(col: Column):
    """Column → (codes in [0, D), D) for the dense path."""
    t = col.typ
    if t.kind == Kind.STR and col.sdict is not None:
        D = len(col.sdict) + 1
        codes = col.data.astype(jnp.int32)
        codes = jnp.where(codes < 0, D - 1, codes)  # nil → last slot
        return codes, D
    if t.np_dtype.kind == "b":
        return col.data.astype(jnp.int32), 2
    if t.np_dtype == np.dtype(np.int8):
        # int8 nil (-128) lands on slot 0, real values on 1..255 — distinct
        return col.data.astype(jnp.int32) + 128, 256
    lo = int(col.minval)
    return col.data.astype(jnp.int64) - lo, int(col.maxval) - lo + 1


def group(col: Column, cand: Optional[Cand] = None,
          prev: Optional[GroupResult] = None,
          with_extents: bool = True) -> GroupResult:
    """BATgroup: refine ``prev`` grouping by ``col`` within ``cand``."""
    base_mask = None
    if cand is not None and not cand.is_all():
        base_mask = cand.as_mask(col.cap)
    base_count = col.count

    D = _dense_domain(col)
    # empty refinement input (0 prior groups) still needs domain ≥ D
    prev_n = max(prev.ngroups, 1) if prev is not None else 1
    if D is not None and D * prev_n <= _DENSE_DOMAIN_MAX:
        from ..obs import set_algorithm
        set_algorithm("group:dense")
        codes, D = _codes(col)
        if prev is not None:
            comb = jnp.where(prev.ids >= 0,
                             prev.ids.astype(jnp.int64) * D, 0) + codes.astype(jnp.int64)
            pm = prev.ids >= 0
            base_mask = pm if base_mask is None else (base_mask & pm)
            domain = D * prev_n
        else:
            comb = codes.astype(jnp.int64)
            domain = D
        ids, ng, present, hist, minoid, newid = _dense_group(
            comb, jnp.int64(col.count), base_mask, domain=int(domain))
        ngroups = int(ng)
        res = GroupResult(ids, ngroups, base_count)
        if with_extents:
            seg_cap = res.seg_cap
            res.extents = _compact_per_group(present, minoid, newid,
                                             jnp.int64(-1), seg_cap=seg_cap)
            res.histo = _compact_per_group(present, hist, newid,
                                           jnp.int64(0), seg_cap=seg_cap)
        return res

    # general sort path
    from ..obs import set_algorithm
    set_algorithm("group:sort")
    prev_ids = prev.ids if prev is not None else jnp.zeros(col.cap, jnp.int32)
    if prev is not None:
        pm = prev.ids >= 0
        base_mask = pm if base_mask is None else (base_mask & pm)
    vals = col.data
    if vals.dtype.kind == "f":
        # make nils (NaN) group together: bitcast to sortable ints
        v = vals.astype(jnp.float64)
        bits = jax.lax.bitcast_convert_type(v, jnp.int64)
        vals = jnp.where(jnp.isnan(v), jnp.int64(np.iinfo(np.int64).min), bits)
    elif vals.dtype != jnp.int64:
        vals = vals.astype(jnp.int64)
    ids, ng, _rows, _gids, _live = _sort_group(prev_ids, vals,
                                               jnp.int64(col.count), base_mask)
    ngroups = int(ng)
    res = GroupResult(ids, ngroups, base_count)
    if with_extents:
        res.extents, res.histo = _extents_histo(ids, jnp.int64(col.count),
                                                seg_cap=res.seg_cap)
    return res


def group_multi(cols, cand: Optional[Cand] = None,
                with_extents: bool = True) -> GroupResult:
    """Chained refinement over several columns (multi-column GROUP BY)."""
    g = None
    for i, c in enumerate(cols):
        last = i == len(cols) - 1
        g = group(c, cand, g, with_extents=with_extents and last)
    return g

"""Window / analytic functions — the reference's gdk_analytic family
(gdk/gdk_analytic_bounds.c window bounds for ROWS/RANGE/GROUPS frames,
gdk_analytic_func.c diff/ntile/lag/lead/first/last/nth,
gdk_analytic_statistics.c framed aggregates; segment-tree sliding
aggregates via GDKinitialize_segment_tree gdk/gdk_analytic.h:59).

Design: a window computation is expressed over rows *pre-sorted by
(partition, order)* (the SQL layer emits the sort, as the reference's
sql_rank.c does). Partition boundaries are a diff mask; ranking functions
are prefix sums over boundary-reset sequences (associative scans — the
natural device form of the reference's sequential loops); framed aggregates
use prefix sums with searchsorted frame bounds instead of segment trees
(O(1) per row after one scan for invertible aggregates; min/max via
log-step sweeps later).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..column import Column, valid_mask
from ..dtypes import I32, I64, F64

__all__ = ["diff", "row_number", "rank", "dense_rank", "ntile",
           "lag", "lead", "first_value", "last_value",
           "cume_window_sum", "percent_rank", "cume_dist",
           "multi_boundary", "windowed_agg", "framed_agg"]


@jax.jit
def _boundary(parts, count):
    """diff: True at the first row of each partition (GDKanalyticaldiff)."""
    cap = parts.shape[0]
    first = jax.lax.iota(jnp.int32, cap) == 0
    b = first | (parts != jnp.roll(parts, 1))
    return b & valid_mask(cap, count)


def diff(part_col: Column) -> Column:
    from ..dtypes import BOOL
    b = _boundary(part_col.data, jnp.int64(part_col.count))
    return Column(BOOL, b, part_col.count, nonil=True)


@jax.jit
def _seg_start(bound):
    """For each row, index of its partition's first row (via running max)."""
    cap = bound.shape[0]
    io = jax.lax.iota(jnp.int64, cap)
    starts = jnp.where(bound, io, 0)
    return jax.lax.associative_scan(jnp.maximum, starts)


@jax.jit
def _row_number(bound, count):
    io = jax.lax.iota(jnp.int64, bound.shape[0])
    return (io - _seg_start(bound) + 1).astype(jnp.int64)


def row_number(bound: Column) -> Column:
    r = _row_number(bound.data, jnp.int64(bound.count))
    r = jnp.where(valid_mask(bound.cap, bound.count), r, np.iinfo(np.int64).min)
    return Column(I64, r, bound.count, nonil=True)


@jax.jit
def _rank(bound, order_bound):
    """rank: row_number of the first peer row. order_bound marks rows whose
    order-key differs from the previous row (peers share a rank)."""
    io = jax.lax.iota(jnp.int64, bound.shape[0])
    newval = bound | order_bound
    starts = jnp.where(newval, io, 0)
    peer_start = jax.lax.associative_scan(jnp.maximum, starts)
    part_start = _seg_start(bound)
    return peer_start - part_start + 1


def rank(part_bound: Column, order_bound: Column) -> Column:
    r = _rank(part_bound.data, order_bound.data)
    r = jnp.where(valid_mask(part_bound.cap, part_bound.count), r,
                  np.iinfo(np.int64).min)
    return Column(I64, r, part_bound.count, nonil=True)


@jax.jit
def _dense_rank(bound, order_bound):
    newval = (bound | order_bound).astype(jnp.int64)
    run = jnp.cumsum(newval)
    part_base = jnp.where(bound, run, 0)
    base = jax.lax.associative_scan(jnp.maximum, part_base)
    return run - base + 1


def dense_rank(part_bound: Column, order_bound: Column) -> Column:
    r = _dense_rank(part_bound.data, order_bound.data)
    r = jnp.where(valid_mask(part_bound.cap, part_bound.count), r,
                  np.iinfo(np.int64).min)
    return Column(I64, r, part_bound.count, nonil=True)


@functools.partial(jax.jit, static_argnames=())
def _part_size(bound, count):
    """Partition size broadcast to each row."""
    cap = bound.shape[0]
    live = valid_mask(cap, count)
    # partition id = cumsum(bound)-1; sizes via bincount-style scatter
    pid = jnp.cumsum(bound.astype(jnp.int64)) - 1
    ones = live.astype(jnp.int64)
    sizes = jnp.zeros(cap + 1, jnp.int64).at[jnp.where(live, pid, cap)].add(ones)
    return sizes[jnp.clip(pid, 0, cap - 1)], pid


def ntile(part_bound: Column, n: int) -> Column:
    size, _pid = _part_size(part_bound.data, jnp.int64(part_bound.count))
    rn = _row_number(part_bound.data, jnp.int64(part_bound.count))
    # SQL ntile: first (size % n) buckets get ceil(size/n) rows
    t = _ntile_calc(rn, size, jnp.int64(n))
    t = jnp.where(valid_mask(part_bound.cap, part_bound.count), t,
                  np.iinfo(np.int64).min)
    return Column(I64, t, part_bound.count, nonil=True)


@jax.jit
def _ntile_calc(rn, size, n):
    q = size // n
    r = size % n
    boundary = r * (q + 1)
    idx = rn - 1
    return jnp.where(idx < boundary,
                     idx // jnp.maximum(q + 1, 1) + 1,
                     r + (idx - boundary) // jnp.maximum(q, 1) + 1)


@functools.partial(jax.jit, static_argnames=("offset",))
def _shift(x, bound, nil, *, offset: int):
    cap = x.shape[0]
    io = jax.lax.iota(jnp.int64, cap)
    src = io - offset
    start = _seg_start(bound)
    pid = jnp.cumsum(bound.astype(jnp.int64)) - 1
    ok = (src >= 0) & (src < cap)
    safe = jnp.clip(src, 0, cap - 1)
    same_part = pid[safe] == pid
    v = x[safe]
    return jnp.where(ok & same_part, v, nil)


def lag(col: Column, part_bound: Column, offset: int = 1,
        default=None) -> Column:
    nil = default if default is not None else (
        col.typ.nil if col.typ.np_dtype.kind != "b" else False)
    v = _shift(col.data, part_bound.data, col.typ.np_dtype.type(nil),
               offset=offset)
    v = jnp.where(valid_mask(col.cap, col.count), v, col.typ.nil)
    return Column(col.typ, v, col.count, nonil=False, sdict=col.sdict)


def lead(col: Column, part_bound: Column, offset: int = 1,
         default=None) -> Column:
    return lag(col, part_bound, offset=-offset, default=default)


def first_value(col: Column, part_bound: Column) -> Column:
    start = _seg_start(part_bound.data)
    v = col.data[start]
    v = jnp.where(valid_mask(col.cap, col.count), v, col.typ.nil)
    return Column(col.typ, v, col.count, nonil=col.nonil, sdict=col.sdict)


def last_value(col: Column, part_bound: Column) -> Column:
    """last_value with default frame (up to current row) = current value;
    with full-partition frame = value at partition end."""
    size, _ = _part_size(part_bound.data, jnp.int64(part_bound.count))
    start = _seg_start(part_bound.data)
    idx = jnp.clip(start + size - 1, 0, col.cap - 1)
    v = col.data[idx]
    v = jnp.where(valid_mask(col.cap, col.count), v, col.typ.nil)
    return Column(col.typ, v, col.count, nonil=col.nonil, sdict=col.sdict)


def nth_value(col: Column, part_bound: Column, n: int) -> Column:
    """nth_value(col, n) under the default frame (unbounded preceding →
    current row): nil before the nth row of the partition, the nth row's
    value from there on (GDKanalytical_nth_value,
    gdk/gdk_analytic_func.c)."""
    start = _seg_start(part_bound.data)
    io = jax.lax.iota(jnp.int64, col.cap)
    rn = io - start            # 0-based row number within partition
    idx = jnp.clip(start + (n - 1), 0, col.cap - 1)
    v = col.data[idx]
    nil = col.typ.nil if col.typ.np_dtype.kind != "b" else False
    v = jnp.where(rn >= n - 1, v, col.typ.np_dtype.type(nil))
    v = jnp.where(valid_mask(col.cap, col.count), v, col.typ.nil)
    return Column(col.typ, v, col.count, nonil=False, sdict=col.sdict)


def cume_window_sum(col: Column, part_bound: Column) -> Column:
    """Running sum within partition (ROWS UNBOUNDED PRECEDING..CURRENT)."""
    x = col.data.astype(jnp.float64 if col.typ.np_dtype.kind == "f"
                        else jnp.int64)
    nilm = (jnp.isnan(x) if x.dtype.kind == "f"
            else x == np.iinfo(np.int64).min)
    xz = jnp.where(nilm, 0, x)
    cs = jnp.cumsum(xz)
    start = _seg_start(part_bound.data)
    base = jnp.where(start > 0, cs[jnp.clip(start - 1, 0, col.cap - 1)], 0)
    base = jnp.where(start == 0, 0, base)
    out = cs - base
    out = jnp.where(valid_mask(col.cap, col.count), out,
                    np.iinfo(np.int64).min if x.dtype.kind != "f" else np.nan)
    typ = F64 if x.dtype.kind == "f" else I64
    from ..dtypes import decimal, Kind
    if col.typ.kind == Kind.DECIMAL:
        typ = decimal(18, col.typ.scale)
    return Column(typ, out, col.count, nonil=False)


def percent_rank(part_bound: Column, order_bound: Column) -> Column:
    r = _rank(part_bound.data, order_bound.data)
    size, _ = _part_size(part_bound.data, jnp.int64(part_bound.count))
    v = jnp.where(size > 1, (r - 1).astype(jnp.float64) /
                  jnp.maximum(size - 1, 1), 0.0)
    v = jnp.where(valid_mask(part_bound.cap, part_bound.count), v, np.nan)
    return Column(F64, v, part_bound.count, nonil=True)


def cume_dist(part_bound: Column, order_bound: Column) -> Column:
    """count of peers ≤ current / partition size."""
    cap = part_bound.cap
    bound = part_bound.data
    ob = order_bound.data
    newval = bound | ob
    size, _ = _part_size(bound, jnp.int64(part_bound.count))
    start = _seg_start(bound)
    # clamp to partition end
    part_end = start + size
    peer_end = jnp.minimum(_next_start(newval), part_end)
    v = (peer_end - start).astype(jnp.float64) / jnp.maximum(size, 1)
    v = jnp.where(valid_mask(cap, part_bound.count), v, np.nan)
    return Column(F64, v, part_bound.count, nonil=True)


@jax.jit
def _next_start(newval):
    """For each row, the index of the next boundary row strictly after it
    (or cap). Reverse min-scan."""
    cap = newval.shape[0]
    io = jax.lax.iota(jnp.int64, cap)
    marks = jnp.where(newval, io, cap)
    # shift left by one so 'strictly after'
    shifted = jnp.concatenate([marks[1:], jnp.array([cap], jnp.int64)])
    rev = jnp.flip(shifted)
    scan = jax.lax.associative_scan(jnp.minimum, rev)
    return jnp.flip(scan)


# ---------------------------------------------------------------------------
# framed aggregates (gdk_analytic_statistics.c: GDKanalytical{sum,avg,min,...}
# over ROWS/RANGE frames, with prefix scans replacing the segment tree for
# unbounded-preceding frames)
# ---------------------------------------------------------------------------


@jax.jit
def _multi_boundary(datas, count):
    cap = datas[0].shape[0]
    first = jax.lax.iota(jnp.int32, cap) == 0
    b = first
    for x in datas:
        b = b | (x != jnp.roll(x, 1))
    return b & valid_mask(cap, count)


def multi_boundary(cols, count: int) -> Column:
    """True at each row whose (col tuple) differs from the previous row —
    the n-ary GDKanalyticaldiff chain (gdk_analytic_func.c)."""
    from ..dtypes import BOOL
    if not cols:
        cap = 1
        raise ValueError("multi_boundary needs ≥1 column")
    b = _multi_boundary(tuple(c.data for c in cols), jnp.int64(count))
    return Column(BOOL, b, count, nonil=True)


def first_row_boundary(cap: int, count: int) -> Column:
    """Single-partition boundary: True only at row 0."""
    from ..dtypes import BOOL
    b = (jax.lax.iota(jnp.int32, cap) == 0) & valid_mask(cap, count)
    return Column(BOOL, b, count, nonil=True)


@functools.partial(jax.jit, static_argnames=("op",))
def _seg_scan(v, bound, *, op: str):
    """Segmented inclusive scan: restart at each True boundary."""
    def combine(a, b):
        ab, av = a
        bb, bv = b
        if op == "sum":
            nv = jnp.where(bb, bv, av + bv)
        elif op == "min":
            nv = jnp.where(bb, bv, jnp.minimum(av, bv))
        else:
            nv = jnp.where(bb, bv, jnp.maximum(av, bv))
        return ab | bb, nv
    _, out = jax.lax.associative_scan(combine, (bound, v))
    return out


@functools.partial(jax.jit, static_argnames=("op", "cap"))
def _part_reduce(v, pid, live, *, op: str, cap: int):
    """Full-partition reduce: scatter into per-partition slots, gather back."""
    safe = jnp.where(live, pid, cap)
    if op == "sum":
        acc = jnp.zeros(cap + 1, v.dtype).at[safe].add(
            jnp.where(live, v, 0))
    elif op == "min":
        big = v.dtype.type(jnp.inf) if v.dtype.kind == "f" else \
            jnp.iinfo(v.dtype).max
        acc = jnp.full(cap + 1, big, v.dtype).at[safe].min(
            jnp.where(live, v, big))
    else:
        small = v.dtype.type(-jnp.inf) if v.dtype.kind == "f" else \
            jnp.iinfo(v.dtype).min
        acc = jnp.full(cap + 1, small, v.dtype).at[safe].max(
            jnp.where(live, v, small))
    return acc[jnp.clip(pid, 0, cap)]


def windowed_agg(func: str, col: Optional[Column], part_bound: Column,
                 order_bound: Optional[Column], frame: str,
                 count: int) -> Column:
    """sum/count/avg/min/max/count_star over UNBOUNDED-PRECEDING frames.

    frame 'rows'  → through the current row;
          'range' → through the current row's last order-peer;
          'full'  → whole partition.
    Nil handling follows SQL aggregates: nils are skipped; an all-nil
    (or empty) frame yields nil. Inputs live on the (partition, order)
    pre-sorted row domain; the caller unsorts the result.
    """
    from ..dtypes import decimal, Kind
    bound = part_bound.data
    cap = part_bound.cap
    live = valid_mask(cap, count)

    if col is not None:
        x = col.data
        is_f = x.dtype.kind == "f"
        nilm = (jnp.isnan(x) if is_f
                else x == jnp.iinfo(x.dtype).min) if not col.nonil else \
            jnp.zeros(cap, jnp.bool_)
        acc_dtype = jnp.float64 if is_f else jnp.int64
        xv = jnp.where(nilm | ~live, acc_dtype(0) if not is_f else
                       jnp.float64(0), x.astype(acc_dtype))
        ones = jnp.where(nilm | ~live, jnp.int64(0), jnp.int64(1))
    else:
        is_f = False
        acc_dtype = jnp.int64
        xv = jnp.where(live, jnp.int64(1), jnp.int64(0))
        ones = xv

    if frame == "full":
        pid = jnp.cumsum(bound.astype(jnp.int64)) - 1
        sums = _part_reduce(xv, pid, live, op="sum", cap=cap)
        cnts = _part_reduce(ones, pid, live, op="sum", cap=cap)
        if func in ("min", "max"):
            vals = _part_reduce(
                jnp.where((nilm | ~live), _mm_identity(acc_dtype, func),
                          xv), pid, live, op=func, cap=cap)
    else:
        sums = _seg_scan(xv, bound, op="sum")
        cnts = _seg_scan(ones, bound, op="sum")
        if func in ("min", "max"):
            vals = _seg_scan(
                jnp.where((nilm | ~live), _mm_identity(acc_dtype, func), xv),
                bound, op=func)
        if frame == "range" and order_bound is not None:
            peer_last = _next_start(bound | order_bound.data) - 1
            idx = jnp.clip(peer_last, 0, cap - 1)
            sums = sums[idx]
            cnts = cnts[idx]
            if func in ("min", "max"):
                vals = vals[idx]

    nil64 = jnp.int64(np.iinfo(np.int64).min)
    if func in ("count", "count_star"):
        out = jnp.where(live, cnts, nil64)
        return Column(I64, out, count, nonil=True)
    if func == "avg":
        scale = col.typ.scale if col.typ.kind == Kind.DECIMAL else 0
        f = sums.astype(jnp.float64)
        if scale:
            f = f / (10.0 ** scale)
        a = f / jnp.maximum(cnts, 1)
        out = jnp.where(live & (cnts > 0), a, jnp.nan)
        return Column(F64, out, count, nonil=False)
    if func == "sum":
        empty = cnts == 0
        if is_f:
            out = jnp.where(live & ~empty, sums, jnp.nan)
            return Column(F64, out, count, nonil=False)
        out = jnp.where(live & ~empty, sums, nil64)
        typ = decimal(18, col.typ.scale) if col.typ.kind == Kind.DECIMAL \
            else I64
        return Column(typ, out, count, nonil=False)
    if func in ("min", "max"):
        empty = cnts == 0
        if is_f:
            out = jnp.where(live & ~empty, vals, jnp.nan)
            return Column(F64 if col.typ.np_dtype.kind == "f" else col.typ,
                          out, count, nonil=False)
        if col.typ.np_dtype.kind == "b":
            # bool columns cannot hold nil (tri-state gap, PARITY.md)
            out = jnp.where(live & ~empty, vals, nil64)
            return Column(col.typ, out.astype(np.bool_), count,
                          nonil=True)
        # nil in the OUTPUT type's domain: casting the int64 sentinel to
        # a narrower type would truncate to 0, not the narrow nil
        nil_t = jnp.int64(np.iinfo(col.typ.np_dtype).min)
        out = jnp.where(live & ~empty, vals, nil_t)
        res = out.astype(col.typ.np_dtype) if col.typ.np_dtype != out.dtype \
            else out
        return Column(col.typ, res, count, nonil=False, sdict=col.sdict)
    raise ValueError(func)


def _mm_identity(dtype, func):
    dtype = jnp.dtype(dtype)
    if dtype.kind == "f":
        return jnp.float64(jnp.inf if func == "min" else -jnp.inf)
    return jnp.int64(np.iinfo(np.int64).max if func == "min"
                     else np.iinfo(np.int64).min + 1)


# ---------------------------------------------------------------------------
# explicit frames — ROWS/RANGE/GROUPS BETWEEN lo AND hi
# (gdk/gdk_analytic_bounds.c GDKanalyticalwindowbounds :1440; the sliding
# min/max uses an O(n log n) sparse table instead of the reference's
# segment tree — both answer arbitrary [s,e) range queries, the sparse
# table in two gathers per row, which is the vectorizable form)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_iter", "strict"))
def _part_lower_bound(vals, lo0, hi0, target, *, n_iter: int, strict: bool):
    """Vectorized per-row binary search: smallest j in [lo0, hi0) with
    vals[j] >= target (or > target when strict). vals must be ascending
    within each row's [lo0, hi0) slice."""
    cap = vals.shape[0]

    def body(_i, c):
        lo, hi = c
        mid = (lo + hi) // 2
        v = vals[jnp.clip(mid, 0, cap - 1)]
        go = (v <= target) if strict else (v < target)
        active = lo < hi
        lo2 = jnp.where(active & go, mid + 1, lo)
        hi2 = jnp.where(active & ~go, mid, hi)
        return lo2, hi2

    lo, _ = jax.lax.fori_loop(0, n_iter, body, (lo0, hi0))
    return lo


@jax.jit
def _floor_log2(n):
    """floor(log2(n)) for n >= 1, exact (float estimate + correction)."""
    k = jnp.floor(jnp.log2(jnp.maximum(n, 1).astype(jnp.float64))
                  ).astype(jnp.int64)
    k = jnp.where((jnp.int64(1) << k) > n, k - 1, k)
    k = jnp.where((jnp.int64(1) << (k + 1)) <= n, k + 1, k)
    return jnp.maximum(k, 0)


@functools.partial(jax.jit, static_argnames=("op", "levels"))
def _sparse_table(x, *, op: str, levels: int):
    """Rows of T: T[k][i] = op(x[i : i+2^k])."""
    cap = x.shape[0]
    f = jnp.minimum if op == "min" else jnp.maximum
    rows = [x]
    cur = x
    for k in range(1, levels):
        sh = 1 << (k - 1)
        idx = jnp.minimum(jax.lax.iota(jnp.int64, cap) + sh, cap - 1)
        cur = f(cur, cur[idx])
        rows.append(cur)
    return jnp.stack(rows)


@jax.jit
def _range_minmax(table, s, e):
    """op(x[s:e]) per row via two overlapping power-of-two blocks."""
    cap = table.shape[1]
    n = jnp.maximum(e - s, 1)
    k = _floor_log2(n)
    a = table[k, jnp.clip(s, 0, cap - 1)]
    b = table[k, jnp.clip(e - (jnp.int64(1) << k), 0, cap - 1)]
    return a, b


def framed_agg(func: str, col: Optional[Column], part_bound: Column,
               order_vals: Optional[jax.Array], unit: str,
               lo, hi, count: int) -> Column:
    """Aggregate over explicit frames [lo, hi] per row (negative =
    PRECEDING, positive = FOLLOWING, None = UNBOUNDED). unit:
      'rows'   — physical row offsets
      'groups' — peer-group offsets (order_vals required)
      'range'  — order-value deltas (single ascending order key required;
                 the caller negates values for DESC order)
    Inputs live on the (partition, order) pre-sorted domain."""
    from ..dtypes import decimal, Kind
    bound = part_bound.data
    cap = part_bound.cap
    live = valid_mask(cap, count)
    io = jax.lax.iota(jnp.int64, cap)

    part_start = _seg_start(bound)
    size, pid = _part_size(bound, jnp.int64(count))
    part_end = part_start + size                      # exclusive
    n_iter = max(int(np.ceil(np.log2(max(cap, 2)))) + 1, 1)

    if unit == "rows":
        s = part_start if lo is None else \
            jnp.maximum(part_start, io + int(lo))
        e = part_end if hi is None else \
            jnp.minimum(part_end, io + int(hi) + 1)
    elif unit == "groups":
        if order_vals is None:
            raise ValueError("GROUPS frame requires ORDER BY")
        ob = _multi_boundary((order_vals,), jnp.int64(count))
        gidx = _dense_rank(bound, ob) - 1             # 0-based peer group
        if lo is None:
            s = part_start
        else:
            s = _part_lower_bound(gidx, part_start, part_end,
                                  gidx + int(lo), n_iter=n_iter,
                                  strict=False)
        if hi is None:
            e = part_end
        else:
            e = _part_lower_bound(gidx, part_start, part_end,
                                  gidx + int(hi), n_iter=n_iter,
                                  strict=True)
    elif unit == "range":
        if order_vals is None:
            raise ValueError("RANGE frame requires ORDER BY")
        v = order_vals.astype(jnp.int64) \
            if order_vals.dtype.kind == "i" else order_vals
        if lo is None:
            s = part_start
        else:
            s = _part_lower_bound(v, part_start, part_end, v + int(lo),
                                  n_iter=n_iter, strict=False)
        if hi is None:
            e = part_end
        else:
            e = _part_lower_bound(v, part_start, part_end, v + int(hi),
                                  n_iter=n_iter, strict=True)
    else:  # pragma: no cover
        raise ValueError(unit)
    s = jnp.maximum(s, part_start)
    e = jnp.minimum(e, part_end)
    empty_frame = e <= s

    # per-row values with nils zeroed + non-nil counters
    if col is not None:
        x = col.data
        is_f = x.dtype.kind == "f"
        nilm = ((jnp.isnan(x) if is_f else x == jnp.iinfo(x.dtype).min)
                if not col.nonil else jnp.zeros(cap, jnp.bool_))
        acc = jnp.float64 if is_f else jnp.int64
        xv = jnp.where(nilm | ~live, acc(0), x.astype(acc))
        ones = jnp.where(nilm | ~live, jnp.int64(0), jnp.int64(1))
    else:
        is_f = False
        nilm = jnp.zeros(cap, jnp.bool_)
        xv = jnp.where(live, jnp.int64(1), jnp.int64(0))
        ones = xv

    cs = jnp.cumsum(xv)
    cn = jnp.cumsum(ones)

    def range_sum(pref):
        hi_v = pref[jnp.clip(e - 1, 0, cap - 1)]
        lo_v = jnp.where(s > 0, pref[jnp.clip(s - 1, 0, cap - 1)], 0)
        return jnp.where(empty_frame, 0, hi_v - lo_v)

    sums = range_sum(cs)
    cnts = range_sum(cn)

    nil64 = jnp.int64(np.iinfo(np.int64).min)
    if func in ("count", "count_star"):
        out = jnp.where(live, cnts, nil64)
        return Column(I64, out, count, nonil=True)
    if func == "avg":
        scale = col.typ.scale if col.typ.kind == Kind.DECIMAL else 0
        f = sums.astype(jnp.float64)
        if scale:
            f = f / (10.0 ** scale)
        a = f / jnp.maximum(cnts, 1)
        out = jnp.where(live & (cnts > 0), a, jnp.nan)
        return Column(F64, out, count, nonil=False)
    if func == "sum":
        empty = cnts == 0
        if is_f:
            out = jnp.where(live & ~empty, sums, jnp.nan)
            return Column(F64, out, count, nonil=False)
        out = jnp.where(live & ~empty, sums, nil64)
        typ = decimal(18, col.typ.scale) if col.typ.kind == Kind.DECIMAL \
            else I64
        return Column(typ, out, count, nonil=False)
    if func in ("min", "max"):
        ident = _mm_identity(jnp.float64 if is_f else jnp.int64, func)
        xi = jnp.where(nilm | ~live, ident, xv)
        levels = n_iter
        table = _sparse_table(xi, op=func, levels=levels)
        a, b = _range_minmax(table, s, e)
        vals = jnp.minimum(a, b) if func == "min" else jnp.maximum(a, b)
        empty = (cnts == 0) | empty_frame
        if is_f:
            out = jnp.where(live & ~empty, vals, jnp.nan)
            return Column(F64, out, count, nonil=False)
        out = jnp.where(live & ~empty, vals, nil64)
        res = out.astype(col.typ.np_dtype) if col.typ.np_dtype != out.dtype \
            else out
        return Column(col.typ, res, count, nonil=False, sdict=col.sdict)
    raise ValueError(func)

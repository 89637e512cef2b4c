"""Out-of-device-memory column processing: host-resident columns streamed
through the device in bounded tiles — the analog of the reference's
beyond-memory mmap policy (STORE_MMAP, gdk/gdk_heap.c; candidate-list
slice streaming + mitosis memory-aware piece sizing,
monetdb5/optimizer/opt_mitosis.c:150-190).

North-star config 3 (BASELINE.md): 1B-row sort / window on one host.
A 1B-row int64 column is 8 GB — it *fits* in device memory but a monolithic
device sort does not (XLA sort working set is a small multiple of the
input), and larger columns don't fit at all.  So:

* :func:`external_sort` — sample sort: device-sort memory-sized tiles,
  range-partition them by splitters taken from a device-sorted sample,
  then device-sort each bounded range bucket; concatenation of bucket
  results is globally sorted.  Every device step is O(tile), host memory
  holds the column (the mmap role).
* :func:`streaming_cumsum` / :func:`streaming_window_sum` — windowed
  aggregates as a tile scan with carried state (prefix carry, w-1 halo),
  the GDKanalytical sliding-frame role (gdk/gdk_analytic_bounds.c) at
  out-of-device-memory scale.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["external_sort", "streaming_cumsum", "streaming_window_sum"]


@functools.partial(jax.jit, static_argnames=("descending",))
def _dev_sort(x, descending: bool = False):
    s = jnp.sort(x)
    return s[::-1] if descending else s


@jax.jit
def _dev_cumsum(x, carry):
    c = jnp.cumsum(x) + carry
    return c, c[-1]


def _splitters(arr: np.ndarray, nbuckets: int) -> np.ndarray:
    """Device-sorted strided sample → nbuckets-1 range splitters."""
    s = min(len(arr), max(nbuckets * 64, 4096))
    idx = np.linspace(0, len(arr) - 1, s).astype(np.int64)
    sample = np.asarray(_dev_sort(jnp.asarray(arr[idx])))
    cut = np.linspace(0, s, nbuckets + 1).astype(np.int64)[1:-1]
    return sample[np.clip(cut, 0, s - 1)]


def _emit_sorted(bucket: np.ndarray, out: np.ndarray, pos: int,
                 chunk_rows: int, descending: bool) -> int:
    """Write sorted(bucket) into out[pos:]; device-sort when it fits the
    tile, else three-way partition (< pivot, == pivot, > pivot) on a
    sampled median — the == run needs no sort, so heavy ties (splitter
    skew) make guaranteed progress instead of re-partitioning the same
    range forever."""
    n = len(bucket)
    if n == 0:
        return pos
    if n <= chunk_rows:
        out[pos: pos + n] = np.asarray(
            _dev_sort(jnp.asarray(bucket), descending=descending))
        return pos + n
    sample = bucket[:: max(1, n // 4096)]
    # median of a sample may fall between values; snap to a real sample
    # value so the == partition is non-empty
    med = np.median(sample)
    pivot = sample[np.argmin(np.abs(sample.astype(np.float64) - med))]
    lt = bucket[bucket < pivot]
    gt = bucket[bucket > pivot]
    neq = n - len(lt) - len(gt)
    first, last = (gt, lt) if descending else (lt, gt)
    pos = _emit_sorted(first, out, pos, chunk_rows, descending)
    out[pos: pos + neq] = pivot
    pos += neq
    return _emit_sorted(last, out, pos, chunk_rows, descending)


def external_sort(arr: np.ndarray, chunk_rows: int = 1 << 25,
                  descending: bool = False,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Sort a host-resident 1-D array using bounded device tiles.

    Device working set is O(chunk_rows); host holds the input and the
    result.  Handles bucket skew by recursively splitting any range
    bucket that exceeds the tile size (ties/degenerate keys).
    """
    n = len(arr)
    if out is None:
        out = np.empty_like(arr)
    if n <= chunk_rows:
        out[:] = np.asarray(_dev_sort(jnp.asarray(arr),
                                      descending=descending))
        return out
    nchunks = -(-n // chunk_rows)
    spl = _splitters(arr, nchunks)
    # phase 1: sort each tile on device; bucket boundaries via
    # searchsorted on the (host) sorted tile — O(log) per splitter
    pieces = [[] for _ in range(nchunks)]        # per-bucket list of runs
    for c in range(nchunks):
        tile = arr[c * chunk_rows: (c + 1) * chunk_rows]
        st = np.asarray(_dev_sort(jnp.asarray(tile)))
        bounds = np.concatenate(
            [[0], np.searchsorted(st, spl, side="right"), [len(st)]])
        for b in range(nchunks):
            lo, hi = bounds[b], bounds[b + 1]
            if hi > lo:
                pieces[b].append(st[lo:hi])
    # phase 2: device-sort each bounded bucket, emit in range order
    pos = 0
    order = range(nchunks - 1, -1, -1) if descending else range(nchunks)
    for b in order:
        if not pieces[b]:
            continue
        bucket = np.concatenate(pieces[b])
        pieces[b] = None                          # free host memory early
        pos = _emit_sorted(bucket, out, pos, chunk_rows, descending)
    assert pos == n, (pos, n)
    return out


def streaming_cumsum(arr: np.ndarray, chunk_rows: int = 1 << 25,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Running sum over a host-resident column via device tiles with a
    scalar carry (SUM() OVER (ORDER BY ... ROWS UNBOUNDED PRECEDING))."""
    n = len(arr)
    if out is None:
        out = np.empty_like(arr)
    carry = jnp.zeros((), jnp.asarray(arr[:1]).dtype)
    for c in range(0, n, chunk_rows):
        tile = jnp.asarray(arr[c: c + chunk_rows])
        res, carry = _dev_cumsum(tile, carry)
        out[c: c + chunk_rows] = np.asarray(res)
    return out


@functools.partial(jax.jit, static_argnames=())
def _dev_window_sum(tile, halo, w):
    """Moving sum over concat(halo, tile), emitting len(tile) outputs;
    halo is the previous w-1 values (zeros at the start)."""
    x = jnp.concatenate([halo, tile])
    c = jnp.cumsum(x)
    hi = c[halo.shape[0]:]
    lo = jnp.concatenate([jnp.zeros(1, c.dtype), c])[
        jnp.maximum(halo.shape[0] + jnp.arange(tile.shape[0]) - w + 1, 0)]
    return hi - lo


def streaming_window_sum(arr: np.ndarray, w: int,
                         chunk_rows: int = 1 << 25,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
    """Moving-window sum (frame = ROWS w-1 PRECEDING .. CURRENT ROW) over
    a host-resident column: per tile the device sees the tile plus a
    (w-1)-row halo carried from the previous tile, so every output is
    exact with one pass over the host column."""
    n = len(arr)
    assert w >= 1 and w <= chunk_rows, (w, chunk_rows)
    if out is None:
        out = np.empty_like(arr)
    dt = np.asarray(arr[:1]).dtype
    halo = np.zeros(w - 1, dt)
    for c in range(0, n, chunk_rows):
        tile = arr[c: c + chunk_rows]
        res = _dev_window_sum(jnp.asarray(tile), jnp.asarray(halo),
                              jnp.int64(w))
        out[c: c + len(tile)] = np.asarray(res)
        if w > 1:
            tail = np.concatenate([halo, tile])[-(w - 1):]
            halo = tail
    return out

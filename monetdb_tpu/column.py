"""Column substrate: device array + host descriptor.

This is the device-array re-imagining of the reference's BAT (gdk/gdk.h:545-804): a
column is a dense array of fixed-width values with a host-side descriptor
carrying the property flags (sorted/revsorted/key/nonil, min/max) that drive
kernel selection, exactly as COLrec's ``tsorted``/``tkey``/``tnonil`` drive
BATselect/BATjoin strategy picks in the reference.

Differences forced by XLA's static-shape compilation model:

* Device arrays are padded to *bucketed capacities* (powers of two above a
  floor). Each logical column carries ``count`` (the real row count) on the
  host; kernels take count as a traced scalar so one compiled kernel serves
  every column in the same capacity bucket. The padding tail is filled with
  the type's nil sentinel.
* Candidate lists (reference gdk/gdk_cand.h:40-71: dense ranges, oid lists,
  negative lists, bitmasks) become :class:`Cand` — a boolean mask aligned to
  the base column as the primary form, with a dense-range fast path and
  materialized-oid form for gather-style consumers. The reference's
  ``TYPE_msk`` candidate kind is the direct ancestor of the mask form.
* Strings are always dictionary-encoded (codes on device, dictionary on
  host), with *order-preserving* codes so range predicates work on codes —
  the reference's opt_dict/dict.c compression made mandatory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import config
from .dtypes import Kind, SQLType, nil_value, varchar

__all__ = ["Column", "Cand", "StrDict", "capacity_for", "valid_mask"]


def capacity_for(n: int) -> int:
    """Bucketed device capacity for n logical rows (compile-cache friendly)."""
    floor = config.get("min_capacity")
    if n <= floor:
        return floor
    return 1 << math.ceil(math.log2(n))


def valid_mask(cap: int, count) -> jax.Array:
    """Boolean mask selecting the live prefix of a padded device array."""
    return jax.lax.iota(jnp.int32, cap) < count


def _pad_np(arr: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full(cap, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


# ---------------------------------------------------------------------------
# String dictionary
# ---------------------------------------------------------------------------


class StrDict:
    """Order-preserving string dictionary (host side).

    ``values`` is a sorted numpy array of unique strings; the device column
    holds int32 codes = rank in ``values``. Sorted codes ⇒ <,<=,>,>= on codes
    are equivalent to the string comparisons, so range/equality predicates
    compile to integer compares (reference: string heap + dict compression,
    gdk/gdk_string.c + sql/backends/monet5/dict.c).
    """

    # _geom_cache: lazily-parsed geometry per distinct value (ops/geom.py)
    __slots__ = ("values", "_geom_cache")

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values)
        self._geom_cache = None

    def __len__(self):
        return len(self.values)

    @staticmethod
    def encode(strings: np.ndarray) -> Tuple["StrDict", np.ndarray]:
        uniq, codes = np.unique(np.asarray(strings), return_inverse=True)
        return StrDict(uniq), codes.astype(np.int32)

    def code_of(self, s: str) -> int:
        """Exact-match code, or -1 if absent."""
        i = np.searchsorted(self.values, s)
        if i < len(self.values) and self.values[i] == s:
            return int(i)
        return -1

    def range_codes(self, s: str, side: str) -> int:
        """searchsorted rank for range predicates on codes."""
        return int(np.searchsorted(self.values, s, side=side))

    def decode(self, codes: np.ndarray) -> np.ndarray:
        if len(self.values) == 0:      # all-nil column, empty dictionary
            return np.full(len(codes), None, dtype=object)
        out = self.values[np.clip(codes, 0, len(self.values) - 1)]
        return np.where(codes < 0, None, out)

    def match_mask(self, pred) -> np.ndarray:
        """Host-evaluated predicate over the dictionary → bool lookup table.

        This is the strimps/LIKE strategy (reference gdk/gdk_strimps.c): run
        the expensive string predicate once per *distinct* value on the host,
        then the device applies it with a single gather by code.
        """
        return np.fromiter((bool(pred(v)) for v in self.values),
                           count=len(self.values), dtype=np.bool_)


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cand:
    """Candidate set over ``base_count`` rows of an aligned column family.

    kind 'all'   — every live row (the absent-candidate fast path)
    kind 'dense' — contiguous rows [lo, hi)  (reference: void candidates)
    kind 'mask'  — device bool mask of base capacity (reference: TYPE_msk)
    kind 'oids'  — device int64 row ids, sorted ascending (reference: oid BAT)
    """

    kind: str
    base_count: int
    lo: int = 0
    hi: int = 0
    mask: Optional[jax.Array] = None
    oids: Optional[jax.Array] = None
    oid_count: Optional[int] = None  # host count for kind 'oids'

    # -- constructors -------------------------------------------------------
    @staticmethod
    def all(base_count: int) -> "Cand":
        return Cand("all", base_count)

    @staticmethod
    def dense(base_count: int, lo: int, hi: int) -> "Cand":
        lo = max(0, lo)
        hi = min(base_count, hi)
        if hi < lo:
            hi = lo
        return Cand("dense", base_count, lo=lo, hi=hi)

    @staticmethod
    def from_mask(mask: jax.Array, base_count: int) -> "Cand":
        return Cand("mask", base_count, mask=mask)

    @staticmethod
    def from_oids(oids: jax.Array, count: int, base_count: int) -> "Cand":
        return Cand("oids", base_count, oids=oids, oid_count=count)

    # -- conversions --------------------------------------------------------
    def as_mask(self, cap: int):
        """Device bool mask of length cap (True = selected live row)."""
        io = jax.lax.iota(jnp.int64, cap)
        if self.kind == "all":
            return io < self.base_count
        if self.kind == "dense":
            return (io >= self.lo) & (io < self.hi)
        if self.kind == "mask":
            m = self.mask
            if m.shape[0] != cap:
                if m.shape[0] > cap:
                    m = m[:cap]
                else:
                    m = jnp.pad(m, (0, cap - m.shape[0]))
            return m
        # oids → mask via scatter
        m = jnp.zeros(cap, jnp.bool_)
        oid = self.oids
        live = valid_mask(oid.shape[0], self.oid_count)
        safe = jnp.where(live, oid, cap - 1)
        upd = live
        m = m.at[safe].max(upd)
        return m

    def count(self) -> int:
        """Host row count (may synchronise once for mask kind)."""
        if self.kind == "all":
            return self.base_count
        if self.kind == "dense":
            return self.hi - self.lo
        if self.kind == "oids":
            return self.oid_count
        return int(jnp.sum(self.mask))

    def is_all(self) -> bool:
        return self.kind == "all" or (
            self.kind == "dense" and self.lo == 0 and self.hi == self.base_count)


# ---------------------------------------------------------------------------
# Column
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Column:
    typ: SQLType
    data: jax.Array          # 1-D device array, len = capacity, tail = nil
    count: int               # logical row count (host)
    # property flags — drive kernel selection (reference COLrec tsorted etc.)
    sorted: bool = False
    revsorted: bool = False
    key: bool = False        # all values distinct
    nonil: bool = True
    minval: Optional[object] = None
    maxval: Optional[object] = None
    sdict: Optional[StrDict] = None

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_numpy(arr: np.ndarray, typ: Optional[SQLType] = None,
                   sdict: Optional[StrDict] = None, **props) -> "Column":
        arr = np.asarray(arr)
        if typ is None:
            from . import dtypes as dt
            typ = {np.dtype(np.int8): dt.I8, np.dtype(np.int16): dt.I16,
                   np.dtype(np.int32): dt.I32, np.dtype(np.int64): dt.I64,
                   np.dtype(np.float32): dt.F32, np.dtype(np.float64): dt.F64,
                   np.dtype(np.bool_): dt.BOOL}[arr.dtype]
        n = len(arr)
        cap = capacity_for(n)
        fill = typ.nil if typ.np_dtype.kind != "b" else False
        padded = _pad_np(arr.astype(typ.np_dtype, copy=False), cap, fill)
        nonil = props.pop("nonil", None)
        if nonil is None:
            from .dtypes import is_nil_np
            nonil = not bool(is_nil_np(arr.astype(typ.np_dtype, copy=False), typ).any())
        return Column(typ, jnp.asarray(padded), n, nonil=nonil, sdict=sdict, **props)

    @staticmethod
    def from_strings(strings, typ: Optional[SQLType] = None, **props) -> "Column":
        sd, codes = StrDict.encode(np.asarray(strings, dtype=object).astype(str))
        t = typ or varchar()
        col = Column.from_numpy(codes, t, sdict=sd, **props)
        return col

    @staticmethod
    def from_device(data: jax.Array, typ: SQLType, count: int,
                    sdict: Optional[StrDict] = None, **props) -> "Column":
        return Column(typ, data, count, sdict=sdict, **props)

    # -- basic accessors ----------------------------------------------------
    @property
    def cap(self) -> int:
        return self.data.shape[0]

    def live_mask(self) -> jax.Array:
        return valid_mask(self.cap, self.count)

    def head(self, n: int = 10) -> np.ndarray:
        return np.asarray(self.data[: min(n, self.count)])

    def to_numpy(self, decode: bool = True):
        raw = np.asarray(self.data[: self.count])
        if decode and self.typ.kind == Kind.STR and self.sdict is not None:
            return self.sdict.decode(raw)
        return raw

    def with_props(self, **props) -> "Column":
        return dataclasses.replace(self, **props)

    def __len__(self):
        return self.count

    def __repr__(self):
        flags = "".join(f for f, on in
                        [("S", self.sorted), ("R", self.revsorted),
                         ("K", self.key), ("N", not self.nonil)] if on)
        return f"Column<{self.typ!r} n={self.count} cap={self.cap} {flags}>"

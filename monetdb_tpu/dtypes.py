"""Logical type system for the column engine.

Design (see SURVEY.md §2.1 "Atoms"): the reference models types as *atoms* with
fixed physical width and a per-type nil sentinel (reference: gdk/gdk_atoms.h:156
``GDK_int_min``/``is_int_nil`` — nil int = INT32_MIN, usable domain starts one
above). We keep the sentinel-nil model (NOT a NaN, NOT a validity bitmap as the
primary form) because every comparison/arithmetic kernel can special-case the
sentinel with one vectorized compare, and it round-trips exactly through device
arrays. Validity masks are derived on demand (``isnil``).

Logical types carried on top of physical dtypes:
  - DECIMAL(p, s): stored as scaled int64 (the reference stores decimals in the
    smallest int that fits, sql/common/sql_types.c; we standardise on int64 and
    keep int32 as a storage optimisation).
  - DATE: int32 days since 1970-01-01 (reference gdk/gdk_time.c uses its own
    epoch; the arithmetic is equivalent).
  - TIMESTAMP: int64 microseconds since epoch.
  - VARCHAR: int32 order-preserving dictionary codes + host-side dictionary
    (the reference's string vheap + opt_dict dictionary compression,
    sql/backends/monet5/dict.c, made mandatory: device sees only codes).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np

__all__ = [
    "Kind", "SQLType", "nil_value", "is_nil_np",
    "BOOL", "I8", "I16", "I32", "I64", "F32", "F64",
    "DATE", "TIME", "TIMESTAMP", "MONTH_INTERVAL", "SEC_INTERVAL",
    "OID", "decimal", "varchar", "char",
]


class Kind(enum.Enum):
    BOOL = "bool"
    INT = "int"            # width via np dtype
    FLOAT = "float"
    DECIMAL = "decimal"    # scaled int
    DATE = "date"
    TIME = "time"          # µs since midnight (reference daytime, gdk_time.c)
    TIMESTAMP = "timestamp"
    INTERVAL = "interval"  # month_interval (i32 months) / sec_interval (i64 µs)
    STR = "str"            # dict codes
    OID = "oid"            # row id (int64, no nil in normal use)


# Sentinel nils, mirroring the reference's GDK_<t>_min convention
# (gdk/gdk_atoms.h:156-260): the most negative value of each integer type is
# nil and excluded from the usable domain. Floats use NaN-free sentinel too in
# the reference (flt_nil = -FLT_MAX... actually GDK uses NaN for flt/dbl nil);
# we use NaN for float nil which matches GDK's is_flt_nil (isnan).
_INT_NIL = {
    np.dtype(np.int8): np.int8(-(2 ** 7)),
    np.dtype(np.int16): np.int16(-(2 ** 15)),
    np.dtype(np.int32): np.int32(-(2 ** 31)),
    np.dtype(np.int64): np.int64(-(2 ** 63)),
}


@dataclasses.dataclass(frozen=True)
class SQLType:
    kind: Kind
    np_dtype: np.dtype
    precision: int = 0      # decimal precision / varchar length hint
    scale: int = 0          # decimal scale

    def __post_init__(self):
        object.__setattr__(self, "np_dtype", np.dtype(self.np_dtype))

    # -- nil handling -------------------------------------------------------
    @property
    def nil(self):
        return nil_value(self.np_dtype, self.kind)

    @property
    def has_int_nil(self) -> bool:
        return self.np_dtype.kind == "i"

    # -- helpers ------------------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self.kind in (Kind.INT, Kind.FLOAT, Kind.DECIMAL)

    @property
    def is_string(self) -> bool:
        return self.kind == Kind.STR

    def with_scale(self, scale: int, precision: Optional[int] = None) -> "SQLType":
        return SQLType(self.kind, self.np_dtype,
                       self.precision if precision is None else precision, scale)

    def __repr__(self):
        if self.kind == Kind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        if self.kind == Kind.STR:
            return "varchar"
        return self.kind.value + str(8 * self.np_dtype.itemsize)


def nil_value(np_dtype: np.dtype, kind: Kind = Kind.INT):
    np_dtype = np.dtype(np_dtype)
    if np_dtype.kind == "f":
        return np_dtype.type(np.nan)
    if np_dtype.kind == "b":
        return np.bool_(False)  # bool columns are nonil in practice
    return _INT_NIL[np_dtype]


def is_nil_np(arr: np.ndarray, typ: SQLType) -> np.ndarray:
    if typ.np_dtype.kind == "f":
        return np.isnan(arr)
    return arr == typ.nil


BOOL = SQLType(Kind.BOOL, np.dtype(np.bool_))
I8 = SQLType(Kind.INT, np.dtype(np.int8))
I16 = SQLType(Kind.INT, np.dtype(np.int16))
I32 = SQLType(Kind.INT, np.dtype(np.int32))
I64 = SQLType(Kind.INT, np.dtype(np.int64))
F32 = SQLType(Kind.FLOAT, np.dtype(np.float32))
F64 = SQLType(Kind.FLOAT, np.dtype(np.float64))
DATE = SQLType(Kind.DATE, np.dtype(np.int32))
TIME = SQLType(Kind.TIME, np.dtype(np.int64))
TIMESTAMP = SQLType(Kind.TIMESTAMP, np.dtype(np.int64))
# interval types (reference sql_types.c month_interval/sec_interval):
# MONTH_INTERVAL counts months (i32), SEC_INTERVAL counts µs (i64)
MONTH_INTERVAL = SQLType(Kind.INTERVAL, np.dtype(np.int32))
SEC_INTERVAL = SQLType(Kind.INTERVAL, np.dtype(np.int64))
OID = SQLType(Kind.OID, np.dtype(np.int64))


def decimal(precision: int, scale: int) -> SQLType:
    """Decimal stored as scaled int64 (int32 when precision allows)."""
    return SQLType(Kind.DECIMAL, np.dtype(np.int64), precision, scale)


def varchar(length: int = 0) -> SQLType:
    return SQLType(Kind.STR, np.dtype(np.int32), length, 0)


def char(length: int = 0) -> SQLType:
    return varchar(length)


def blob(length: int = 0) -> SQLType:
    """BLOB: dictionary-encoded uppercase-hex strings (the reference's
    blob atom prints as hex, gdk_atoms.c blobWrite). scale=1 marks the
    subtype so length() counts bytes, not hex chars."""
    return SQLType(Kind.STR, np.dtype(np.int32), length, 1)


def is_blob(t) -> bool:
    return t is not None and t.kind == Kind.STR and t.scale == 1


def common_numeric(a: SQLType, b: SQLType) -> SQLType:
    """Type promotion for binary arithmetic (reference: gdk_calc type ladder)."""
    order = {Kind.INT: 0, Kind.DECIMAL: 1, Kind.FLOAT: 2}
    if a.kind == Kind.FLOAT or b.kind == Kind.FLOAT:
        return F64
    if a.kind == Kind.DECIMAL or b.kind == Kind.DECIMAL:
        s = max(a.scale, b.scale)
        return decimal(18, s)
    # both ints: widen to the larger
    w = max(a.np_dtype.itemsize, b.np_dtype.itemsize)
    return {1: I8, 2: I16, 4: I32, 8: I64}[w]

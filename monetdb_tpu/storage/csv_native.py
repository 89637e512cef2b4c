"""ctypes binding for the native parallel CSV parser (native/csvparse.cpp,
the tablet.c analog). Builds the shared library on first use with g++ and
caches it under native/build/; loaders fall back to the Python csv module
when the toolchain is unavailable."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..dtypes import Kind, SQLType

__all__ = ["native_available", "parse_csv"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "csvparse.cpp")
_SO = os.path.join(_ROOT, "native", "build", "libcsvparse.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[str]:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    # build under a private name, then rename: concurrent processes never
    # load a half-written library
    tmp = f"{_SO}.{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except Exception:
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None or not os.path.exists(_SRC):
            return None
        lib = ctypes.CDLL(so)
        lib.csv_count_rows.restype = ctypes.c_long
        lib.csv_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.csv_parse.restype = ctypes.c_int
        lib.csv_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _type_code(t: SQLType) -> Tuple[int, int]:
    if t.kind == Kind.STR:
        return 4, 0
    if t.kind == Kind.DATE:
        return 2, 0
    if t.kind == Kind.DECIMAL:
        return 3, t.scale
    if t.np_dtype.kind == "f":
        return 1, 0
    return 0, 0   # ints (timestamp handled as int64 µs? dates only for now)


def parse_csv(data: bytes, delimiter: str,
              schema: List[Tuple[str, SQLType]],
              limit: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Parse a CSV byte buffer into physical numpy arrays per column.
    Strings come back as object arrays (dictionary encoding happens in the
    storage layer). Raises ValueError with the failing column on bad data."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native csv parser unavailable")
    n = lib.csv_count_rows(data, len(data))
    if limit is not None:
        n = min(n, limit)
        # trim the buffer to the first n lines so the parser stops there
        if n < lib.csv_count_rows(data, len(data)):
            pos = -1
            for _ in range(n):
                pos = data.index(b"\n", pos + 1)
            data = data[:pos + 1]
    ncols = len(schema)
    types = (ctypes.c_int * ncols)()
    scales = (ctypes.c_int * ncols)()
    outs_a = (ctypes.c_void_p * ncols)()
    outs_b = (ctypes.c_void_p * ncols)()
    bufs = {}
    for j, (name, t) in enumerate(schema):
        code, scale = _type_code(t)
        types[j] = code
        scales[j] = scale
        if code == 4:
            a = np.empty(n, np.int64)
            b = np.empty(n, np.int64)
            bufs[name] = (a, b)
            outs_a[j] = a.ctypes.data_as(ctypes.c_void_p)
            outs_b[j] = b.ctypes.data_as(ctypes.c_void_p)
        else:
            dt = {0: np.int64, 1: np.float64, 2: np.int32,
                  3: np.int64}[code]
            a = np.empty(n, dt)
            bufs[name] = (a, None)
            outs_a[j] = a.ctypes.data_as(ctypes.c_void_p)
            outs_b[j] = None
    err = lib.csv_parse(data, len(data), delimiter.encode()[0:1],
                        ncols, types, scales, 0, outs_a, outs_b)
    if err:
        raise ValueError(f"csv parse error in column "
                         f"{schema[err - 1][0]!r}")
    out: Dict[str, np.ndarray] = {}
    for j, (name, t) in enumerate(schema):
        a, b = bufs[name]
        if t.kind == Kind.STR:
            offs, lens = a, b
            vals = np.empty(n, dtype=object)
            for i in range(n):
                vals[i] = data[offs[i]:offs[i] + lens[i]].decode("utf-8")
            out[name] = vals
        elif t.kind == Kind.INT and t.np_dtype != np.dtype(np.int64):
            arr = a
            nil64 = np.iinfo(np.int64).min
            nil = np.iinfo(t.np_dtype).min
            out[name] = np.where(arr == nil64, nil, arr).astype(t.np_dtype)
        else:
            out[name] = a
    return out

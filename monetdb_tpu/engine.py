"""Engine facade: SQL in, rows out — the condensation of the reference's
session scenario (sql/backends/monet5/sql_scenario.c SQLengine: parse →
rel → optimize → codegen → run → export result)."""

from __future__ import annotations

import collections
import dataclasses
import datetime
import threading
from decimal import Decimal as PyDecimal
from typing import List, Optional, Tuple

import numpy as np

from .dtypes import Kind, SQLType
from .exec import Executor
from .sql.binder import bind_select
from .table import Catalog

__all__ = ["Engine", "Result"]

_EPOCH = datetime.date(1970, 1, 1)


# ---------------------------------------------------------------------------
# plan cache - the reference's query cache (sql/server/sql_qc.c): repeat
# queries skip parse + bind + lowering entirely.  Keyed by SQL text; each
# entry pins the exact Table objects it was bound against (the storage layer
# hands out a new Table object whenever a table version changes,
# storage/database.py _materialize), so validity is an identity check.
# ---------------------------------------------------------------------------

_PLAN_CACHE: "collections.OrderedDict[str, list]" = collections.OrderedDict()
_PLAN_LOCK = threading.Lock()
_PLAN_MAX = 256        # distinct SQL texts
_PLAN_VARIANTS = 4     # catalog snapshots per SQL text (concurrent txns)


@dataclasses.dataclass
class _CachedPlan:
    tables: dict           # name -> Table identity pins
    views: dict
    udfs: dict
    rel: object
    out_cols: list
    fragment: object       # exec.fragment.CompiledFragment, or None
    unsupported: Optional[str]   # lowering-time fallback reason
    frag_enabled: bool = True    # fragment_exec config at bind time
    #: table -> schema mapping at bind time: schema-qualified name
    #: resolution (ALTER ... SET SCHEMA / schema renames) must
    #: invalidate cached plans
    tschemas: Optional[dict] = None


def _plan_valid(e: "_CachedPlan", cat: Catalog) -> bool:
    from . import config as _cfg
    if e.frag_enabled != bool(_cfg.get("fragment_exec")):
        return False
    if len(e.tables) != len(cat.tables) or e.views != cat.views:
        return False
    if len(e.udfs) != len(cat.udfs) or \
            any(cat.udfs.get(k) is not v for k, v in e.udfs.items()):
        return False
    if e.tschemas is not None and \
            e.tschemas != (getattr(cat, "table_schemas", None) or {}):
        return False
    return all(cat.tables.get(k) is v for k, v in e.tables.items())


def plan_cache_clear() -> None:
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()


def plan_cache_stats() -> dict:
    with _PLAN_LOCK:
        return {"entries": sum(len(v) for v in _PLAN_CACHE.values()),
                "sqls": len(_PLAN_CACHE)}


class _LazyRows(list):
    """Row tuples materialized on first access: the columnar wire path
    (server._send_columnar) ships raw buffers without ever paying the
    python-tuple construction cost (mvc_export_table_columnar skips the
    text formatter the same way, sql_result.c:1216)."""

    def __init__(self, fn, n: int):
        super().__init__()
        self._fn = fn
        self._n = n

    def _force(self):
        if self._fn is not None:
            fn, self._fn = self._fn, None
            self[:] = fn()
        return self

    def __len__(self):
        return self._n if self._fn is not None else super().__len__()

    def __iter__(self):
        return super(_LazyRows, self._force()).__iter__()

    def __getitem__(self, i):
        return super(_LazyRows, self._force()).__getitem__(i)

    def __eq__(self, other):
        return list(self._force()) == other

    def __ne__(self, other):
        return not self.__eq__(other)

    def __bool__(self):
        return self._n > 0 if self._fn is not None else \
            super().__len__() > 0

    def __repr__(self):
        return repr(list(self._force()))

    def __contains__(self, item):
        return super(_LazyRows, self._force()).__contains__(item)

    def __reversed__(self):
        return super(_LazyRows, self._force()).__reversed__()

    def __add__(self, other):
        return list(self._force()) + other

    def index(self, *a):
        return super(_LazyRows, self._force()).index(*a)

    def count(self, *a):
        return super(_LazyRows, self._force()).count(*a)

    __hash__ = None


@dataclasses.dataclass
class Result:
    names: List[str]
    types: List[SQLType]
    rows: List[tuple]
    trace: Optional[list] = None   # profiler events when trace=True
    #: physical numpy columns [(array, typ, sdict), ...] when the plan ran
    #: through the fragment path with no wide sums - the zero-copy source
    #: for the columnar wire mode (sql_result.c:1216 analog)
    raw: Optional[list] = None

    def __len__(self):
        return len(self.rows)

    def show(self, n: int = 20) -> str:
        out = ["\t".join(self.names)]
        for r in self.rows[:n]:
            out.append("\t".join(str(v) for v in r))
        return "\n".join(out)


def _decode_np(raw: np.ndarray, typ, sdict=None) -> list:
    """Physical numpy column -> python values, vectorized (one numpy pass
    per column instead of per-value conversions; the reference's
    mvc_export_table formats per column the same way, sql_result.c:1243)."""
    raw = np.asarray(raw)
    if typ.kind == Kind.STR:
        if sdict is None or len(sdict.values) == 0:
            return [None] * len(raw)
        vals = sdict.values[np.clip(raw, 0, len(sdict.values) - 1)]
        lst = vals.tolist()
        bad = raw < 0
        if bad.any():
            return [None if b else str(v) for b, v in zip(bad.tolist(), lst)]
        return [str(v) for v in lst]
    k = typ.np_dtype.kind
    if k == "f":
        lst = raw.tolist()
        return [None if v != v else v for v in lst]
    if k == "b":
        return raw.astype(bool).tolist()
    nil = int(np.iinfo(typ.np_dtype).min)
    lst = raw.tolist()
    if typ.kind == Kind.DECIMAL:
        s = typ.scale
        return [None if v == nil else PyDecimal(v).scaleb(-s) for v in lst]
    if typ.kind == Kind.DATE:
        dates = raw.astype("datetime64[D]").tolist()
        return [None if v == nil else d for v, d in zip(lst, dates)]
    if typ.kind == Kind.TIMESTAMP:
        ts = raw.astype("datetime64[us]").tolist()
        return [None if v == nil else t for v, t in zip(lst, ts)]
    if typ.kind == Kind.TIME:
        out = []
        for v in lst:
            if v == nil:
                out.append(None)
                continue
            s, us = divmod(v, 1_000_000)
            h, rem = divmod(s, 3600)
            m, sec = divmod(rem, 60)
            out.append(datetime.time(int(h) % 24, int(m), int(sec), int(us)))
        return out
    if typ.kind == Kind.INTERVAL and typ.np_dtype.itemsize == 8:
        # day-time interval (µs) → timedelta, matching the reference
        # client's sec_interval mapping (pymonetdb/mapilib render the
        # same "-1 day, 23:59:41.998000" forms the test corpus pins)
        return [None if v == nil else datetime.timedelta(microseconds=v)
                for v in lst]
    return [None if v == nil else v for v in lst]


def _decode_wide(lo: np.ndarray, hi: np.ndarray, typ) -> list:
    """Wide (int128-range) sum column -> python values: exact total =
    hi*2^32 + lo recombined in arbitrary-precision python ints (the
    reference's hge result export, sql_result.c over gdk.h:441 hge)."""
    nil = int(np.iinfo(np.int64).min)
    los = np.asarray(lo).tolist()
    his = np.asarray(hi).tolist()
    dec = typ.kind == Kind.DECIMAL
    s = typ.scale if dec else 0
    out = []
    for l, h in zip(los, his):
        if l == nil:
            out.append(None)
        else:
            v = (h << 32) + l
            out.append(PyDecimal(v).scaleb(-s) if dec else v)
    return out


def _decode_column(col) -> list:
    raw = np.asarray(col.data[: col.count])
    return _decode_np(raw, col.typ, col.sdict)


class Engine:
    """SQL in, rows out.  With a ``mesh`` (jax.sharding.Mesh over >1
    devices) fused plans execute SPMD across the mesh - the reference's
    mitosis/mergetable intra-query parallelism (opt_mitosis.c:21) realized
    as shard_map + psum across devices (exec/fragment.py _run_spmd)."""

    def __init__(self, catalog: Catalog, mesh=None, spmd_auto=False):
        self.catalog = catalog
        self.mesh = mesh
        # spmd_auto: the mesh came from the session default (mitosis in
        # default_pipe) rather than an explicit request — only shard
        # plans whose largest scan reaches spmd_min_shard_rows, the
        # reference's MIN_PART_SIZE gate (opt_mitosis.c:17)
        self.spmd_auto = spmd_auto

    def plan(self, sql: str):
        return bind_select(self.catalog, sql)

    def _cached_plan(self, sql: str) -> "_CachedPlan":
        """Bind + lower once per (SQL text, catalog snapshot) - the
        reference's query cache (sql_qc.c qc entries keyed by query text,
        invalidated on DDL)."""
        from .exec.fragment import CompiledFragment, Unsupported
        with _PLAN_LOCK:
            entries = _PLAN_CACHE.get(sql)
            if entries is not None:
                _PLAN_CACHE.move_to_end(sql)
                for e in entries:
                    if _plan_valid(e, self.catalog):
                        return e
        rel, out_cols = bind_select(self.catalog, sql)
        fragment = unsupported = None
        from . import config as _cfg
        if bool(_cfg.get("fragment_exec")):
            try:
                fragment = CompiledFragment(self.catalog, rel,
                                            [c.name for c in out_cols])
            except Unsupported as exc:
                unsupported = str(exc)
        entry = _CachedPlan(dict(self.catalog.tables),
                            dict(self.catalog.views),
                            dict(self.catalog.udfs),
                            rel, out_cols, fragment, unsupported,
                            frag_enabled=bool(_cfg.get("fragment_exec")),
                            tschemas=dict(getattr(self.catalog,
                                                  "table_schemas", None)
                                          or {}))
        with _PLAN_LOCK:
            lst = _PLAN_CACHE.setdefault(sql, [])
            lst[:] = [e for e in lst if _plan_valid(e, self.catalog)]
            lst.append(entry)
            del lst[:-_PLAN_VARIANTS]
            _PLAN_CACHE.move_to_end(sql)
            while len(_PLAN_CACHE) > _PLAN_MAX:
                _PLAN_CACHE.popitem(last=False)
        return entry

    def query(self, sql: str, trace: bool = False) -> Result:
        return self.query_stmt(sql, trace=trace)

    def query_stmt(self, sql_or_stmt, trace: bool = False) -> Result:
        if isinstance(sql_or_stmt, str):
            plan = self._cached_plan(sql_or_stmt)
            return self._execute_cached(plan, trace=trace)
        rel, out_cols = bind_select(self.catalog, sql_or_stmt)
        return self.execute_plan(rel, out_cols, trace=trace)

    def _execute_cached(self, plan: "_CachedPlan", trace: bool) -> Result:
        from . import config as _cfg
        if plan.fragment is not None and bool(_cfg.get("fragment_exec")):
            res = self._run_fragment(plan.fragment, plan.out_cols,
                                     trace=trace)
            if res is not None:
                return res
        return self._run_executor(plan.rel, plan.out_cols, trace=trace,
                                  why=plan.unsupported)

    def execute_plan(self, rel, out_cols, trace: bool = False) -> Result:
        """Fast path: the whole plan compiles to ONE fused XLA fragment
        (exec/fragment.py) - a single device dispatch, like the
        reference's compiled MAL program (mal_interpreter.c:491).  Plans
        outside the fragment compiler take the op-at-a-time executor.

        TRACE mode mirrors the reference's SQLsetTrace
        (sql/backends/monet5/sql_execute.c:61) and measures the path that
        actually runs: fused plans emit per-fragment events (lower ms,
        compile hit/miss, RPC count), fallback plans per-operator events."""
        from . import config as _cfg
        if bool(_cfg.get("fragment_exec")):
            from .exec.fragment import CompiledFragment, Unsupported
            why = None
            try:
                fragment = CompiledFragment(self.catalog, rel,
                                            [c.name for c in out_cols])
            except Unsupported as exc:
                why = str(exc)
            else:
                res = self._run_fragment(fragment, out_cols, trace=trace)
                if res is not None:
                    return res
            return self._run_executor(rel, out_cols, trace=trace, why=why)
        return self._run_executor(rel, out_cols, trace=trace)

    def _run_fragment(self, fragment, out_cols,
                      trace: bool) -> Optional[Result]:
        """Run a compiled fragment; None = fall back to the executor."""
        from .exec.fragment import Unsupported, stats_inc
        from .sql.syscat import CURRENT_QUERY, QUEUE
        events = [] if trace else None
        try:
            QUEUE.check(CURRENT_QUERY.tag)
            names = [getattr(c, "display", None) or c.name
                     for c in out_cols]
            if trace:
                events.append({"op": "fragment.lower",
                               "usec": int(fragment.lower_ms * 1e3)})
            fr = fragment.run(events=events, mesh=self.mesh,
                              spmd_require_min=self.spmd_auto)
            QUEUE.check(CURRENT_QUERY.tag)
            def make_rows():
                decoded = [
                    _decode_wide(a[:fr.count],
                                 fr.arrays[fr.wide[i]][:fr.count], pt.typ)
                    if i in fr.wide
                    else _decode_np(a[:fr.count], pt.typ, pt.sdict)
                    for i, (a, pt) in enumerate(zip(fr.arrays, fr.pts))]
                return [tuple(d[i] for d in decoded)
                        for i in range(fr.count)]

            raw = None
            if not fr.wide:
                raw = [(np.asarray(a[:fr.count]), pt.typ, pt.sdict)
                       for a, pt in zip(fr.arrays, fr.pts)]
            return Result(names, [c.typ for c in out_cols],
                          _LazyRows(make_rows, fr.count),
                          trace=events, raw=raw)
        except Unsupported:
            stats_inc("fallbacks")
            return None

    def _run_executor(self, rel, out_cols, trace: bool = False,
                      why: Optional[str] = None) -> Result:
        if why is not None:
            from .exec.fragment import stats_inc
            stats_inc("fallbacks")
        events = None
        if trace:
            from .obs import PROFILER
            PROFILER.start()
            if why is not None:
                PROFILER.events.append({"op": "fragment.fallback",
                                        "reason": why})
        try:
            frame = Executor(self.catalog).run(rel)
        finally:
            if trace:
                from .obs import PROFILER
                events = PROFILER.stop()
        names = [getattr(c, "display", None) or c.name for c in out_cols]
        cols = [frame.get("#out", c.name) for c in out_cols]
        decoded = [_decode_column(c) for c in cols]
        rows = [tuple(d[i] for d in decoded) for i in range(frame.count)]
        return Result(names, [c.typ for c in out_cols], rows, trace=events)

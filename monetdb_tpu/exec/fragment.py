"""Whole-plan fragment compiler: Rel tree -> one compiled XLA program.

The reference compiles a SQL statement into a single MAL program and runs it
as one artifact (sql/backends/monet5/sql_gencode.c backend_dumpstmt +
monetdb5/mal/mal_interpreter.c:491 runMALsequence): per-operator dispatch
costs nanoseconds.  An operator-at-a-time executor pays one host<->device
round trip per operator.  This module removes that: the plan is lowered to a
hashable IR (nested tuples), interpreted *inside one jit* so XLA fuses the
whole pipeline, and executed with a single dispatch + 1-2 host syncs total.

Design rules (the XLA static-shape answers to data-dependent cardinality,
SURVEY.md "hard parts" #1):

* mask-carrying: Filter produces a boolean mask, never a compaction; rows
  stay at base capacity until a true materialization point (ORDER BY,
  LIMIT, result export).
* group-by over *domain slots*: dense small domains (dict codes, bools,
  bounded ints - the shape of every dict-encoded GROUP BY, mirroring
  gdk/gdk_group.c:20-60 strategy picks) aggregate into [0, domain) slots
  then compact by presence rank - no host sync for ngroups.  This is also
  the SPMD-combinable form (psum over aligned slots = the reference's
  two-phase mat_grp aggregation, monetdb5/optimizer/opt_mergetable.c:15-27).
* errors (overflow / division by zero, gdk/gdk_calc_addsub.c:44-47
  ON_OVERFLOW) become traced flags reduced to one int, checked once on the
  host after the single fetch.
* the jit cache key is (IR, input shapes): the IR is rebuilt per query on
  the host (cheap, ~ms) and identical query shapes reuse the compile,
  the analog of the reference's query cache (sql/server/sql_qc.c).

Plans containing nodes this compiler does not support fall back to the
operator-at-a-time executor (exec/executor.py) - same results, more RPCs.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
from decimal import Decimal as PyDecimal
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..column import Column, StrDict, capacity_for, valid_mask
from ..parallel.shuffle import hash64 as _hash64
from ..dtypes import (BOOL, DATE, F64, I8, I32, I64, TIME, TIMESTAMP, Kind,
                      SQLType, decimal as dec_t, varchar)
from ..plan import logical as L
from ..plan.exprs import (Between, BinOp, BoolOp, Case, Cast, Cmp, ColRef,
                          Const, Expr, Func, InList, IsNull, Like, Not,
                          Subquery, walk)

__all__ = ["Unsupported", "FragmentResult", "CompiledFragment",
           "compile_fragment", "run_fragment", "STATS", "stats_inc"]

_I64_MIN = np.int64(np.iinfo(np.int64).min)
_I64_MAX = np.int64(np.iinfo(np.int64).max)
# error codes >= this encode "join build side <ordinal> was non-unique":
# the host re-lowers that join as an expanding join and retries
_ERR_DUP_BASE = 16
#: histogram-grouping domain cap.  With scatter-mode segment reductions
#: (one .at[].add per aggregate) the dense strategy is taken over the
#: device sort up to here; slot arrays at 16M are 128 MB int64.  Not yet
#: measured on the H100 (ROADMAP 1.3).
_DENSE_DOMAIN_MAX = 1 << 24
#: initial group-output capacity bucket (grown by count-then-retry when
#: ngroups overflows it)
_GROUP_OUT_CAP0 = 1 << 16
#: compaction barrier: inputs of group-by/order-by/distinct larger than
#: _COMPACT_MIN_CAP are compacted to a count-retried bucket starting at
#: _COMPACT_CAP0 - sorts/scatters then run at live-row scale instead of
#: base-capacity scale (a filtered+joined 8.4M-cap pipeline with 300k
#: live rows pays 16-60x less; the reference gets this for free because
#: BATselect materializes candidates, gdk_select.c virtualize)
_COMPACT_MIN_CAP = 1 << 17
_COMPACT_CAP0 = 1 << 19

#: segment count at or below which grouped aggregation uses a fused
#: masked one-hot broadcast-reduce instead of a scatter-add: XLA fuses it
#: without materializing the cap x seg intermediate, and its float sums
#: do not depend on the order of atomics.  Not yet measured on the H100
#: against the scatter form (ROADMAP 1.3).
_ONEHOT_MAX = 128

#: largest build-side capacity that still uses the direct-address
#: (scatter-built) join table; bigger builds sort + binary-search probe.
_JOIN_DENSE_BUILD_MAX = 1 << 16
# results whose final capacity is at most this are fetched in one RPC;
# larger ones sync the count first and compact to a tight capacity
_SINGLE_PHASE_CAP = 1 << 16


class Unsupported(Exception):
    """Plan shape outside the fragment compiler; caller falls back."""


# ---------------------------------------------------------------------------
# physical type bookkeeping (host side, parallel to the IR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PT:
    """Static physical type of a lowered expression.  Mirrors what COLrec
    carries for kernel selection in the reference (gdk/gdk.h:545-804)."""
    typ: SQLType
    nonil: bool = True
    sdict: Optional[StrDict] = None
    minval: Optional[int] = None
    maxval: Optional[int] = None
    key: bool = False        # provably unique among live rows (BAT tkey)
    #: int128-equivalent sum (the reference's hge accumulator,
    #: gdk/gdk.h:441): the value is carried as TWO int64 arrays - this
    #: key holds the low 32 bits (in [0, 2^32), int64-min = nil) and a
    #: companion key (same name + "#hi") holds value >> 32.  Exact total
    #: = hi * 2^32 + lo, recombined into python ints at result decode.
    wide: bool = False

    @property
    def dt(self) -> str:
        return self.typ.np_dtype.str

    @property
    def scale(self) -> int:
        return self.typ.scale if self.typ.kind == Kind.DECIMAL else 0

    @property
    def is_float(self) -> bool:
        return self.typ.np_dtype.kind == "f"

    @property
    def is_str(self) -> bool:
        return self.typ.kind == Kind.STR


def _hikey(key: Tuple[str, str]) -> Tuple[str, str]:
    """Companion env key carrying the high 32-bit limbs of a wide sum."""
    return (key[0], key[1] + "#hi")


def _nil_np(dt: str):
    d = np.dtype(dt)
    if d.kind == "f":
        return d.type(np.nan)
    if d.kind == "b":
        return np.bool_(False)
    return d.type(np.iinfo(d).min)


# ---------------------------------------------------------------------------
# scalar (host) value model during lowering - mirrors executor.Scalar
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HScalar:
    value: object            # physical domain (scaled int for decimals, ...)
    typ: Optional[SQLType]

    @property
    def scale(self):
        return self.typ.scale if (self.typ is not None and
                                  self.typ.kind == Kind.DECIMAL) else 0

    def is_float(self):
        return self.typ is not None and self.typ.np_dtype.kind == "f"

    def as_f64(self) -> float:
        if self.value is None:
            return float("nan")
        v = float(self.value)
        if self.scale:
            v /= 10.0 ** self.scale
        return v


# ---------------------------------------------------------------------------
# lowering: Rel/Expr -> hashable IR + input arrays
# ---------------------------------------------------------------------------


class Lowering:
    """One-pass plan lowering.  Produces:
    * ``ir``     - hashable nested-tuple program (the jit static arg)
    * ``inputs`` - flat list of device arrays (base columns, counts, luts)
    * ``penv``   - final env key -> PT for result decoding
    """

    def __init__(self, catalog, expand: Optional[Dict[int, int]] = None):
        self.catalog = catalog
        self.inputs: List[jax.Array] = []
        # owning table name per input (None = lut/constant); drives the
        # SPMD shard-table choice (the mitosis partition pick,
        # monetdb5/optimizer/opt_mitosis.c:150-190)
        self.input_tables: List[Optional[str]] = []
        self._input_ids: Dict[int, int] = {}
        self.refs: Dict[str, set] = {}
        # joins whose build side proved non-unique at runtime are re-lowered
        # as *expanding* joins (the reference's N:M hashjoin,
        # gdk/gdk_join.c:2900): ordinal -> output capacity (None = pick a
        # default; the host retries with the measured total on overflow)
        self.expand: Dict[int, Optional[int]] = expand or {}
        self.expand_used: Dict[int, int] = {}
        self.scan_counts: Dict[int, int] = {}
        self._join_ord = 0
        # functional dependencies discovered at unique-build joins:
        # (frozenset of determinant key irs, frozenset of dependent env
        # irs).  A group-by whose key set contains all determinants can
        # drop the dependents from its SORT keys (the values are fetched
        # via extents regardless) - the rel_statistics.c/join-FD trick
        # that turns Q3's packed-int64 8M-row group sort into a single
        # int32 key sort.
        self.fds: List[Tuple[frozenset, frozenset]] = []

    # -- inputs --------------------------------------------------------------
    def _add_input(self, arr) -> int:
        k = id(arr)
        got = self._input_ids.get(k)
        if got is not None:
            return got
        idx = len(self.inputs)
        self.inputs.append(arr)
        self.input_tables.append(None)
        self._input_ids[k] = idx
        return idx

    def _add_lut(self, np_arr: np.ndarray) -> int:
        idx = len(self.inputs)
        self.inputs.append(jnp.asarray(np_arr))
        self.input_tables.append(None)
        return idx

    # -- column reference collection (executor._collect_refs analog) ---------
    def collect_refs(self, rel: L.Rel):
        def ref_expr(e: Expr):
            for n in walk(e):
                if isinstance(n, ColRef) and n.table not in ("#out", "#grp"):
                    self.refs.setdefault(n.table, set()).add(n.name)

        def visit(r: L.Rel):
            if isinstance(r, L.Filter):
                ref_expr(r.pred)
            elif isinstance(r, L.Project):
                for _n, e in r.exprs:
                    ref_expr(e)
            elif isinstance(r, L.Join):
                for a, b in r.on:
                    ref_expr(a)
                    ref_expr(b)
                if r.extra is not None:
                    ref_expr(r.extra)
            elif isinstance(r, L.GroupBy):
                for _n, e in r.keys:
                    ref_expr(e)
                for _n, _f, arg, _d in r.aggs:
                    for a in (arg if isinstance(arg, list) else [arg]):
                        if a is not None and isinstance(a, Expr):
                            ref_expr(a)
            elif isinstance(r, L.OrderBy):
                for e, _d, _nl in r.keys:
                    ref_expr(e)
            for c in r.children():
                visit(c)
        visit(rel)

    # ======================================================================
    # relational lowering - each returns (rel_ir, penv, cap)
    # penv: env key (table, name) -> PT
    # ======================================================================

    def rel(self, r: L.Rel):
        m = getattr(self, "_rel_" + type(r).__name__.lower(), None)
        if m is None:
            raise Unsupported(type(r).__name__)
        return m(r)

    def _rel_scan(self, r: L.Scan):
        if r.table not in self.catalog:
            # plan-cache hit on a fresh catalog: system relations only
            # exist after bind-time materialization — re-materialize
            from ..sql.syscat import is_system_table, system_table
            if is_system_table(r.table):
                self.catalog.add(system_table(self.catalog, r.table))
        t = self.catalog.get(r.table)
        wanted = self.refs.get(r.alias) or self.refs.get(r.table) or set()
        names = [n for n in t.names() if n in wanted] or t.names()[:1]
        cols = []
        penv: Dict[Tuple[str, str], PT] = {}
        cap = None
        for n in names:
            c = t.col(n)
            if cap is None:
                cap = c.cap
            elif c.cap != cap:
                raise Unsupported("misaligned scan capacities")
            idx = self._add_input(c.data)
            self.input_tables[idx] = t.name
            cols.append(((r.alias, n), idx))
            penv[(r.alias, n)] = PT(c.typ, nonil=c.nonil, sdict=c.sdict,
                                    minval=c.minval, maxval=c.maxval,
                                    key=bool(getattr(c, "key", False)))
        cnt_idx = self._add_lut(np.int64(t.count))
        # actual row count per count-input index: the SPMD rewriter's
        # broadcast-vs-shuffle cost pick uses real rows, not bucketed
        # capacities (rel_statistics.c rowcount role)
        self.scan_counts[cnt_idx] = int(t.count)
        ir = ("scan", tuple(cols), cnt_idx, cap)
        return ir, penv, cap

    def _rel_subplan(self, r: L.SubPlan):
        cir, penv, cap = self.rel(r.child)
        renamed = {(r.alias, n): pt for (_t, n), pt in penv.items()}
        keys = tuple(((r.alias, n), (t, n)) for (t, n) in penv.keys())
        self._remap_fds({("env", t, n): ("env", r.alias, n)
                         for (t, n) in penv.keys()})
        return ("rename", cir, keys), renamed, cap

    def _remap_fds(self, m: Dict[tuple, tuple]) -> None:
        """Rewrite recorded FDs through an env re-keying (rename/project).
        Determinant irs are rewritten structurally; an FD whose
        determinants reference env keys that no longer exist is dropped."""
        def rw(ir):
            if ir in m:
                return m[ir]
            if isinstance(ir, tuple):
                return tuple(rw(x) for x in ir)
            return ir

        def live(ir, avail):
            """Every env ref inside ir resolves in the new env."""
            if isinstance(ir, tuple):
                if len(ir) == 3 and ir[0] == "env":
                    return ir in avail
                return all(live(x, avail) for x in ir
                           if isinstance(x, tuple))
            return True
        avail = set(m.values())
        out = []
        for dets, deps in self.fds:
            dets2 = frozenset(rw(d) for d in dets)
            deps2 = frozenset(m[d] for d in deps if d in m)
            if deps2 and all(live(d, avail) for d in dets2):
                out.append((dets2, deps2))
        self.fds = out

    def _rel_filter(self, r: L.Filter):
        cir, penv, cap = self.rel(r.child)
        pred = self.pred(r.pred, penv)
        return ("filter", cir, pred), penv, cap

    def _rel_project(self, r: L.Project):
        cir, penv, cap = self.rel(r.child)
        items = []
        penv2: Dict[Tuple[str, str], PT] = {}
        for name, e in r.exprs:
            if isinstance(e, ColRef):
                key = self._resolve(e, penv)
                if penv[key].wide:
                    # pass a wide sum through whole: both limb arrays
                    items.append((("#out", name), ("env",) + key))
                    items.append(((_hikey(("#out", name))),
                                  ("env",) + _hikey(key)))
                    penv2[("#out", name)] = penv[key]
                    penv2[_hikey(("#out", name))] = PT(I64, nonil=True)
                    continue
            ir, pt = self.expr(e, penv)
            items.append((("#out", name), ir))
            penv2[("#out", name)] = pt
        # FDs survive a projection for identity-passed columns
        self._remap_fds({ir: ("env",) + key for key, ir in items
                         if isinstance(ir, tuple) and len(ir) == 3 and
                         ir[0] == "env"})
        return ("project", cir, tuple(items)), penv2, cap

    def _maybe_compact(self, cir, cap):
        """Insert a compaction barrier (count-retried bucket capacity)
        so the sort/scatter consumer runs at live-row scale.  Converges
        to a no-op when the live count reaches the base capacity."""
        ordinal = self._join_ord
        self._join_ord += 1
        if cap <= _COMPACT_MIN_CAP:
            return cir, cap
        oc = self.expand.get(ordinal) or min(cap, _COMPACT_CAP0)
        oc = min(oc, cap)
        if oc >= cap:
            return cir, cap
        self.expand_used[ordinal] = oc
        return ("compact", cir, int(oc), ordinal), oc

    def _rel_orderby(self, r: L.OrderBy):
        cir, penv, cap = self.rel(r.child)
        cir, cap = self._maybe_compact(cir, cap)
        keys = []
        for e, desc, nl in r.keys:
            if isinstance(e, ColRef):
                key = self._resolve(e, penv)
                if penv[key].wide:
                    # order a wide sum without narrowing: (hi, lo) is
                    # value order because lo is kept in [0, 2^32)
                    nlb = nl if nl is None else bool(nl)
                    keys.append((("whi", key, _hikey(key)),
                                 bool(desc), nlb))
                    keys.append((("env",) + key, bool(desc), nlb))
                    continue
            ir, pt = self.expr(e, penv)
            if ir[0] == "lit":
                continue
            keys.append((ir, bool(desc), nl if nl is None else bool(nl)))
        if not keys:
            return cir, penv, cap
        # reordering permutes rows but keeps the value set: stats survive
        return ("orderby", cir, tuple(keys)), dict(penv), cap

    def _rel_limit(self, r: L.Limit):
        cir, penv, cap = self.rel(r.child)
        if r.n is None:
            if not r.offset:
                return cir, penv, cap
            n = None
        n = r.n
        hi = cap if n is None else min(cap, (r.offset or 0) + n)
        out_cap = min(cap, capacity_for(max(hi, 1)))
        return ("limit", cir, None if n is None else int(n),
                int(r.offset or 0), out_cap), penv, out_cap

    def _rel_distinct(self, r: L.Distinct):
        cir, penv, cap = self.rel(r.child)
        cir, cap = self._maybe_compact(cir, cap)
        keys = tuple((("env", t, n), False, None) for (t, n) in penv.keys())
        return ("distinct", cir, keys), penv, cap

    # -- joins ----------------------------------------------------------------
    # In-jit equi-joins keep the mask-carrying shape: the PROBE side's rows
    # stay at their capacity; the BUILD side must match each probe row at
    # most once (PK side of the FK joins that dominate analytics - the
    # reference's joincost picks the same probe/build split,
    # gdk/gdk_join.c:3586).  Build rows land in a direct-address table when
    # the packed key domain is small (fetchjoin/hashjoin analog) else a
    # device sort + binary-search probe (mergejoin analog).  Non-unique
    # build sides are detected *on device* (error flag) and the engine
    # falls back to the op-at-a-time executor.

    _JOIN_DENSE_MAX = 1 << 25

    @staticmethod
    def _env_resolves(env, t, n) -> bool:
        if t is not None:
            return (t, n) in env
        return sum(1 for k in env if k[1] == n) == 1

    def _expr_side(self, e: Expr, lenv, renv) -> str:
        """'l' / 'r' when every column reference resolves in exactly one
        child env, '?' otherwise (mixed or no references)."""
        names = [(n.table, n.name) for n in walk(e) if isinstance(n, ColRef)]
        if not names:
            return "?"
        inl = all(self._env_resolves(lenv, t, n) for t, n in names)
        inr = all(self._env_resolves(renv, t, n) for t, n in names)
        if inl and not inr:
            return "l"
        if inr and not inl:
            return "r"
        return "?"

    def _rel_join(self, r: L.Join):
        kind = r.kind
        if kind == "right":
            return self._rel_join(L.Join(r.right, r.left, "left",
                                         on=r.on, extra=r.extra))
        if kind not in ("inner", "left", "semi", "anti"):
            raise Unsupported(f"join kind {kind}")
        if not r.on:
            raise Unsupported("join without equi keys")
        lir, lenv, lcap = self.rel(r.left)
        rir, renv, rcap = self.rel(r.right)
        ordinal = self._join_ord
        self._join_ord += 1

        # lower each equi pair against the side that resolves it
        pairs = []                      # [(a_ir, a_pt, b_ir, b_pt)]
        for a, b in r.on:
            sa, sb = self._expr_side(a, lenv, renv), \
                self._expr_side(b, lenv, renv)
            if sa == "r" or (sa == "?" and sb == "l"):
                a, b = b, a
            a_ir, a_pt = self.expr(a, lenv)
            b_ir, b_pt = self.expr(b, renv)
            if a_pt.is_str or b_pt.is_str:
                a_ir, a_pt, b_ir, b_pt = self._align_str(a_ir, a_pt,
                                                         b_ir, b_pt)
            elif a_pt.is_float or b_pt.is_float:
                raise Unsupported("float join key")
            else:
                ssa, ssb = a_pt.scale, b_pt.scale
                if ssa < ssb:
                    a_ir, a_pt = self._upscale(a_ir, a_pt, ssb - ssa)
                elif ssb < ssa:
                    b_ir, b_pt = self._upscale(b_ir, b_pt, ssa - ssb)
            pairs.append((a_ir, a_pt, b_ir, b_pt))

        runique = any(b_pt.key for _a, _ap, _b, b_pt in pairs)
        lunique = any(a_pt.key for _a, a_pt, _b, _bp in pairs)
        swap = False
        if kind == "inner" and not runique and lunique:
            # probe from the right side instead (env merge is symmetric)
            swap = True
            lir, rir = rir, lir
            lenv, renv = renv, lenv
            lcap, rcap = rcap, lcap
            pairs = [(b, bp, a, ap) for a, ap, b, bp in pairs]
            runique = True

        # key bounds for packing (union of both sides' stats)
        keyspecs = []
        domain = 1
        for a_ir, a_pt, b_ir, b_pt in pairs:
            if a_pt.is_str:
                lo, hi = 0, max(len(a_pt.sdict) - 1, 0)
            else:
                if a_pt.minval is None or b_pt.minval is None or \
                        a_pt.maxval is None or b_pt.maxval is None:
                    lo = hi = None
                else:
                    lo = min(int(a_pt.minval), int(b_pt.minval))
                    hi = max(int(a_pt.maxval), int(b_pt.maxval))
            if lo is None:
                domain = None
            elif domain is not None:
                span = hi - lo + 1
                if span <= 0 or (domain > 0 and
                                 domain * span > (1 << 62)):
                    domain = None
                else:
                    domain *= span
            keyspecs.append((a_ir, not a_pt.nonil, b_ir, not b_pt.nonil,
                             lo, None if lo is None else hi - lo + 1,
                             a_pt.is_str))
        if domain is None and len(pairs) > 1:
            raise Unsupported("multi-key join without packable bounds")
        # direct-address build: one scatter-min into a domain-sized
        # table + one gather per probe, taken whenever the packed key
        # domain fits a reasonable table; otherwise sort + binary-search
        # probe (the fetchjoin/hashjoin pick of gdk/gdk_join.c:3586).
        # The cut-over is not yet measured on the H100 (ROADMAP 1.3).
        if domain is not None and domain <= self._JOIN_DENSE_MAX:
            strat = "dense"
        else:
            strat = "sort"
            domain = 0

        uniq_check = kind in ("inner", "left") and not runique

        # residual predicate: build-side-only -> prefilter the build rows;
        # cross-side -> evaluate on the merged env (needs unique build)
        bfilter = extra = None
        menv: Dict[Tuple[str, str], PT] = dict(lenv)
        for k, pt in renv.items():
            if k in menv:
                raise Unsupported(f"duplicate column {k} across join")
            menv[k] = dataclasses.replace(
                pt, nonil=pt.nonil and kind == "inner", key=False)
        if r.extra is not None:
            if self._expr_side(r.extra, lenv, renv) == "r":
                # references only the build side: prefilter its rows
                bfilter = self.pred(r.extra, renv)
            else:
                extra = self.pred(r.extra, menv)
                if kind in ("semi", "anti") and not runique:
                    uniq_check = True

        if uniq_check and ordinal in self.expand:
            return self._lower_join_expand(
                ordinal, kind, lir, rir, lenv, renv, lcap, rcap,
                keyspecs, bfilter, extra, menv)

        ir = ("join", kind, lir, rir, tuple(keyspecs), strat, int(domain),
              bool(uniq_check), bfilter, extra,
              tuple(sorted(renv.keys())), ordinal)
        if kind in ("semi", "anti"):
            out = {k: pt for k, pt in lenv.items()}
            return ir, out, lcap
        # unique build ⇒ every build column is functionally determined by
        # the probe-side key exprs (holds for runtime-checked uniqueness
        # too: a failed check re-lowers without recording the FD)
        dets = frozenset(a_ir for a_ir, _ap, _b, _bp in pairs)
        deps = frozenset(("env",) + k for k in renv.keys())
        self.fds.append((dets, deps))
        return ir, menv, lcap

    def _lower_join_expand(self, ordinal, kind, lir, rir, lenv, renv,
                           lcap, rcap, keyspecs, bfilter, extra, menv):
        """N:M join via match enumeration (gdk/gdk_join.c:2900 hashjoin
        with duplicate build keys).  Inner/left joins materialize one
        output row per (probe, match) pair into a static expansion
        capacity (count-then-retry on overflow - the XLA static-shape
        answer to data-dependent join cardinality); semi/anti joins with a
        cross-side residual evaluate it per pair and scatter-OR back onto
        the probe rows, so their output stays mask-carrying at probe
        capacity."""
        if kind == "left" and extra is not None:
            raise Unsupported("expanding left join with cross-side residual")
        ecap = self.expand.get(ordinal)
        if not ecap:
            ecap = capacity_for(2 * max(lcap, rcap))
        self.expand_used[ordinal] = ecap
        ir = ("join_expand", kind, lir, rir, tuple(keyspecs), bfilter,
              extra, tuple(sorted(lenv.keys())), tuple(sorted(renv.keys())),
              int(ecap), ordinal)
        if kind in ("semi", "anti"):
            out = {k: pt for k, pt in lenv.items()}
            return ir, out, lcap
        # probe rows may repeat in the output: every column loses key;
        # value ranges/dicts survive (outputs are copies of input rows)
        oenv = {}
        for k, pt in lenv.items():
            oenv[k] = dataclasses.replace(pt, key=False)
        for k, pt in renv.items():
            oenv[k] = dataclasses.replace(
                pt, nonil=pt.nonil and kind == "inner", key=False)
        return ir, oenv, int(ecap)

    # -- group by -------------------------------------------------------------
    def _rel_groupby(self, r: L.GroupBy):
        cir, penv, cap = self.rel(r.child)
        cir, cap = self._maybe_compact(cir, cap)
        ordinal = self._join_ord          # group-output capacity retry
        self._join_ord += 1               # channel (shared expand space)
        key_irs = []          # (env key, expr ir, pt)
        for name, e in r.keys:
            ir, pt = self.expr(e, penv)
            key_irs.append(((("#grp", name)), ir, pt))

        # FD reduction first: keys functionally determined (via a
        # unique-build join) by other keys in the set are dropped from
        # the GROUPING keys - grouping is identical and their values
        # come back via a representative-row gather (extents).  Q3's
        # (l_orderkey, o_orderdate, o_shippriority) collapses to
        # l_orderkey.
        irset = {ir for _k, ir, _pt in key_irs}
        drop: set = set()
        for _ in range(2):      # FD chains (dep of a dep)
            for dets, deps in self.fds:
                if dets <= (irset - drop):
                    drop |= {ir for ir in irset & deps if ir not in dets}
        keep = [(k, ir, pt) for k, ir, pt in key_irs if ir not in drop]
        if not keep:
            keep = key_irs[:1]
        kept_irs = {ir for _k, ir, _pt in keep}
        fetch_keys = tuple((k, ir) for k, ir, _pt in key_irs
                           if ir not in kept_irs)

        # strategy pick over the KEPT keys: dense combined domain
        # (gdk_group.c histogram strategy; aggregation is one scatter
        # per aggregate) when the domain fits a slot table, else device
        # sort
        dense_specs = []
        domain = 1
        dense_ok = True
        for _k, ir, pt in keep:
            spec = self._dense_code(ir, pt)
            if spec is None:
                dense_ok = False
                break
            code_ir, d = spec
            dense_specs.append((code_ir, d, pt.dt))
            domain *= d
            if domain > _DENSE_DOMAIN_MAX:
                dense_ok = False
                break
        # histogram slots cost O(domain) per aggregate; once the input
        # is compacted near live-row scale, a sparse domain much larger
        # than the rows is worse than one code sort (gdk_group.c makes
        # the same rows-vs-domain pick between histogram and hash)
        if dense_ok and domain > max(65536, 8 * cap):
            dense_ok = False

        aggs = []
        penv2: Dict[Tuple[str, str], PT] = {}
        for k, _ir, pt in key_irs:
            # key outputs are a subset of the input values: min/max bounds
            # survive grouping (rel_statistics.c propagates the same way) -
            # they keep downstream joins on grouped keys packable
            penv2[k] = dataclasses.replace(pt, nonil=False,
                                           key=len(key_irs) == 1)
        for name, func, arg, distinct in r.aggs:
            spec, pt = self._lower_agg(func, arg, penv, distinct=distinct)
            aggs.append(((("#grp", name)), spec))
            penv2[("#grp", name)] = pt
            if pt.wide:
                penv2[_hikey(("#grp", name))] = PT(I64, nonil=True)

        def _out_cap(bound: int) -> int:
            """Group-output capacity: start at a small bucket, grown by
            the count-then-retry loop (exp_totals) when ngroups
            overflows - downstream operators (order-by/limit/joins on
            aggregates) then run at group scale, not input scale."""
            if not key_irs:
                return 1                 # scalar aggregate: one row
            hard = capacity_for(max(bound, 1))
            oc = self.expand.get(ordinal) or min(hard, _GROUP_OUT_CAP0)
            oc = min(oc, hard)
            if oc < bound:
                self.expand_used[ordinal] = oc    # retry channel active
            return oc

        if dense_ok:
            out_cap = _out_cap(int(domain))
            ir = ("groupby_dense", cir,
                  tuple((k, ir) for k, ir, _pt in keep),
                  tuple(dense_specs), int(domain), tuple(aggs),
                  fetch_keys, int(out_cap), ordinal)
            return ir, penv2, out_cap
        # sort strategy: when every kept key pack-codes and the combined
        # domain fits int64, ONE mixed-radix sort key (the mkey.hash
        # role, modules/mal/mkey.c, but exact) replaces the
        # multi-operand comparator sort; the interpreter narrows it to
        # int32 when the domain fits (a narrower sort key)
        kept_specs = []
        kdomain = 1
        kpackable = True
        for _k, ir, pt in keep:
            spec = self._pack_code(ir, pt)
            if spec is None:
                kpackable = False
                break
            code_ir, d = spec
            kept_specs.append((code_ir, d))
            kdomain *= d
            if kdomain > (1 << 62):
                kpackable = False
                break
        if kpackable and kept_specs:
            sort_keys = (("packcode", tuple(kept_specs)),)
        else:
            sort_keys = tuple(ir for _k, ir, _pt in keep)
        out_cap = _out_cap(cap)
        ir = ("groupby_sort", cir,
              tuple((k, ir) for k, ir, _pt in key_irs),
              sort_keys, tuple(aggs), int(out_cap), ordinal)
        return ir, penv2, out_cap

    def _dense_code(self, ir, pt: PT):
        """(code_ir in [0, D), D) for the dense histogram strategy -
        mirrors ops/group.py _dense_domain/_codes incl. the nil slot."""
        t = pt.typ
        if t.kind == Kind.STR and pt.sdict is not None:
            d = len(pt.sdict) + 1
            return ("dcode_str", ir, d), d
        if t.np_dtype.kind == "b":
            return ("dcode_bool", ir), 2
        if t.np_dtype == np.dtype(np.int8):
            return ("dcode_i8", ir), 256
        if pt.nonil and pt.minval is not None and pt.maxval is not None:
            d = int(pt.maxval) - int(pt.minval) + 1
            if 0 < d <= _DENSE_DOMAIN_MAX:
                return ("dcode_range", ir, int(pt.minval)), d
        return None

    def _pack_code(self, ir, pt: PT):
        """(code_ir in [0, D), D) for SORT-key packing: like _dense_code
        but without the histogram domain cap (packing only needs the
        combined domain to fit an integer sort key, not a slot array)
        and with an explicit nil slot for nullable ranges."""
        spec = self._dense_code(ir, pt)
        if spec is not None:
            return spec
        t = pt.typ
        if t.kind == Kind.STR or pt.is_float:
            return None
        if pt.minval is None or pt.maxval is None:
            return None
        lo, hi = int(pt.minval), int(pt.maxval)
        span = hi - lo + 1
        if span <= 0:
            return None
        if pt.nonil:
            return ("dcode_range", ir, lo), span
        # nullable wide range: nil -> slot 0, values shifted +1 (keeps
        # the sort_key convention of nils-first group order)
        return ("pcode_rangenil", ir, lo), span + 1

    def _lower_agg(self, func: str, arg, penv, distinct: bool = False):
        """Aggregate spec mirroring ops/aggr.py semantics (gdk_aggr.c:900
        BATgroupsum family): returns (spec_ir, out PT).  DISTINCT
        aggregates dedup (group, value) pairs by sort before reducing
        (the reference's count-distinct path in gdk_aggr.c)."""
        if isinstance(arg, list):
            raise Unsupported(f"2-ary aggregate")
        if func == "count_star":
            return ("count_star",), PT(I64, nonil=True)
        if arg is None:
            raise Unsupported(f"aggregate {func} without argument")
        air, apt = self.expr(arg, penv)
        anil = not apt.nonil
        if distinct and func in ("min", "max"):
            distinct = False            # DISTINCT is a no-op for min/max
        if distinct:
            if func == "count":
                return ("count_distinct", air, anil, apt.dt), \
                    PT(I64, nonil=True)
            if func in ("sum", "avg"):
                if apt.is_float:
                    acc = F64
                elif apt.typ.kind == Kind.DECIMAL:
                    acc = dec_t(18, apt.typ.scale)
                elif apt.typ.np_dtype.kind in ("i", "b"):
                    acc = I64
                else:
                    raise Unsupported(f"{func} over {apt.typ!r}")
                if func == "avg":
                    return ("avg_distinct", air, anil, apt.dt, apt.scale), \
                        PT(F64, nonil=False)
                check = acc.np_dtype.kind == "i" \
                    and apt.typ.np_dtype.itemsize == 8
                return ("sum_distinct", air, anil, apt.dt,
                        acc.np_dtype.str, check), \
                    PT(acc, nonil=False, wide=check)
            raise Unsupported(f"distinct aggregate {func}")
        if func == "count":
            return ("count", air, anil, apt.dt), PT(I64, nonil=True)
        if func in ("sum", "avg", "prod"):
            if apt.is_float:
                acc = F64
            elif apt.typ.kind == Kind.DECIMAL:
                acc = dec_t(18, apt.typ.scale)
            elif apt.typ.np_dtype.kind in ("i", "b"):
                acc = I64
            else:
                raise Unsupported(f"{func} over {apt.typ!r}")
            if func == "avg":
                return ("avg", air, anil, apt.dt, apt.scale), \
                    PT(F64, nonil=False)
            check = func == "sum" and acc.np_dtype.kind == "i" \
                and apt.typ.np_dtype.itemsize == 8
            return (func, air, anil, apt.dt, acc.np_dtype.str, check), \
                PT(acc, nonil=False, wide=check)
        if func in ("min", "max"):
            return (func, air, anil, apt.dt), \
                dataclasses.replace(apt, nonil=False, minval=None,
                                    maxval=None)
        if func in ("stddev_samp", "stddev_pop", "var_samp", "var_pop"):
            want = "std" if func.startswith("stddev") else "var"
            return ("moment2", air, anil, apt.dt, want,
                    func.endswith("samp"), apt.scale), PT(F64, nonil=False)
        raise Unsupported(f"aggregate {func}")

    # ======================================================================
    # expression lowering (value context) -> (ir, PT)
    # ======================================================================

    def expr(self, e: Expr, penv) -> Tuple[tuple, PT]:
        if isinstance(e, ColRef):
            key = self._resolve(e, penv)
            pt = penv[key]
            if pt.wide:
                # expression consumption of a wide sum narrows it to
                # int64 with an exact fits-check (22003 beyond int64 -
                # replaces the old f64-shadow heuristic); root outputs
                # bypass this via the project passthrough and decode
                # the full value exactly
                return ("wnarrow", key, _hikey(key)), \
                    dataclasses.replace(pt, wide=False)
            return ("env",) + key, pt
        if isinstance(e, Const):
            s = self._const(e)
            return self._lit(s)
        if isinstance(e, BinOp):
            return self._binop(e, penv)
        if isinstance(e, Cast):
            return self._cast(e, penv)
        if isinstance(e, Case):
            return self._case(e, penv)
        if isinstance(e, Func):
            return self._func(e, penv)
        if isinstance(e, Subquery):
            return self._subquery(e)
        if isinstance(e, (Cmp, BoolOp, Not, IsNull, Between, InList, Like)):
            p = self.pred(e, penv)
            return ("bool2val", p), PT(I8, nonil=True)
        raise Unsupported(f"expr {type(e).__name__}")

    def _resolve(self, e: ColRef, penv) -> Tuple[str, str]:
        if e.table is not None and (e.table, e.name) in penv:
            return (e.table, e.name)
        hits = [k for k in penv if k[1] == e.name]
        if len(hits) == 1:
            return hits[0]
        raise Unsupported(f"unresolved column {e.table}.{e.name}")

    def _const(self, e: Const) -> HScalar:
        v = e.value
        typ = e.typ
        if v is None:
            return HScalar(None, typ)
        if isinstance(v, PyDecimal):
            scale = typ.scale if typ is not None else 0
            return HScalar(int(v.scaleb(scale).to_integral_value()), typ)
        if isinstance(v, datetime.datetime):
            us = int((v - datetime.datetime(1970, 1, 1)).total_seconds()
                     * 1_000_000)
            return HScalar(us, typ or TIMESTAMP)
        if isinstance(v, datetime.date):
            return HScalar((v - datetime.date(1970, 1, 1)).days, typ or DATE)
        if isinstance(v, bool):
            return HScalar(bool(v), typ or BOOL)
        if isinstance(v, (int, float, str)):
            return HScalar(v, typ)
        raise Unsupported(f"constant {v!r}")

    def _lit(self, s: HScalar) -> Tuple[tuple, PT]:
        typ = s.typ or I64
        pt = PT(typ, nonil=s.value is not None)
        if s.value is None:
            return ("nil", pt.dt), pt
        if typ.kind == Kind.STR:
            # string literal in value context: single-entry dictionary
            sd = StrDict(np.array([str(s.value)]))
            pt = PT(typ, nonil=True, sdict=sd)
            return ("lit", 0, "<i4"), pt
        v = s.value
        if typ.np_dtype.kind == "f":
            v = float(v)
        elif typ.np_dtype.kind == "b":
            v = bool(v)
        else:
            v = int(v)
        return ("lit", v, pt.dt), pt

    def _subquery(self, e: Subquery):
        """Scalar subquery: run it via the op-at-a-time executor at plan
        time and bake the value (data-dependent -> IR changes with data,
        which keys the compile cache correctly)."""
        if not (isinstance(e.select, tuple) and e.select[0] == "bound"):
            raise Unsupported("unbound subquery")
        if e.kind != "scalar":
            raise Unsupported(f"{e.kind} subquery in fragment expression")
        from .executor import Executor
        _tag, rel, scols = e.select
        frame = Executor(self.catalog).run(rel)
        col = frame.get("#out", scols[0].name)
        if frame.count == 0:
            return self._lit(HScalar(None, col.typ))
        v = np.asarray(col.data[0])
        if col.typ.np_dtype.kind == "f":
            fv = float(v)
            return self._lit(HScalar(None if np.isnan(fv) else fv, col.typ))
        iv = int(v)
        if col.typ.np_dtype.kind == "i" and \
                iv == np.iinfo(col.typ.np_dtype).min:
            return self._lit(HScalar(None, col.typ))
        if col.typ.kind == Kind.STR:
            return self._lit(HScalar(str(col.sdict.values[iv]), col.typ))
        return self._lit(HScalar(iv, col.typ))

    # -- arithmetic (mirrors executor._eval_binop + ops/calc.py) -------------
    def _tofloat(self, ir, pt: PT):
        if pt.is_float and pt.typ is F64:
            return ir, pt
        return ("tofloat", ir, pt.scale, not pt.nonil, pt.dt), \
            PT(F64, nonil=pt.nonil)

    def _upscale(self, ir, pt: PT, k: int):
        if k == 0:
            return ir, pt
        out = dec_t(18, pt.scale + k)
        check = bool(config.get("overflow_checks"))
        return ("upscale", ir, int(k), not pt.nonil, pt.dt, check), \
            dataclasses.replace(pt, typ=out, minval=None, maxval=None)

    def _binop(self, e: BinOp, penv):
        a_ir, a_pt = self.expr(e.left, penv)
        b_ir, b_pt = self.expr(e.right, penv)
        op = {"+": "add", "-": "sub", "*": "mul", "/": "div",
              "%": "mod"}.get(e.op)
        if op is None:
            raise Unsupported(f"operator {e.op}")
        if a_pt.is_str or b_pt.is_str:
            raise Unsupported("string arithmetic")
        check = bool(config.get("overflow_checks"))

        if a_pt.is_float or b_pt.is_float or \
                (op == "div" and (a_pt.scale or b_pt.scale)):
            a_ir, a_pt = self._tofloat(a_ir, a_pt)
            b_ir, b_pt = self._tofloat(b_ir, b_pt)
            node = "fdiv" if op == "div" else "farith"
            ir = (node, op, a_ir, b_ir, not a_pt.nonil, not b_pt.nonil)
            return ir, PT(F64, nonil=a_pt.nonil and b_pt.nonil)

        sa, sb = a_pt.scale, b_pt.scale
        if op == "mul":
            s = sa + sb
            out = dec_t(18, s) if s else self._common_int(a_pt, b_pt)
        elif op in ("add", "sub"):
            s = max(sa, sb)
            if sa < s:
                a_ir, a_pt = self._upscale(a_ir, a_pt, s - sa)
            if sb < s:
                b_ir, b_pt = self._upscale(b_ir, b_pt, s - sb)
            out = dec_t(18, s) if s else self._common_int(a_pt, b_pt)
        else:  # idiv / mod, scale-free
            out = self._common_int(a_pt, b_pt)
        ir = ("iarith", op, a_ir, b_ir, out.np_dtype.str, check,
              not a_pt.nonil, not b_pt.nonil)
        return ir, PT(out, nonil=a_pt.nonil and b_pt.nonil)

    @staticmethod
    def _common_int(a_pt: PT, b_pt: PT) -> SQLType:
        from ..dtypes import common_numeric
        return common_numeric(a_pt.typ, b_pt.typ)

    # -- casts ---------------------------------------------------------------
    def _cast(self, e: Cast, penv):
        ir, pt = self.expr(e.arg, penv)
        to = e.to
        if pt.is_str and to.kind != Kind.STR:
            return self._str_parse_lut(ir, pt, to)
        if to.kind == Kind.STR and not pt.is_str:
            return self._val_to_str_lut(ir, pt, to)
        if to.kind == Kind.STR:
            return ir, pt
        fs, ts = pt.scale, to.scale if to.kind == Kind.DECIMAL else 0
        check = bool(config.get("overflow_checks"))
        out = ("convert", ir, to.np_dtype.str, max(0, ts - fs),
               max(0, fs - ts), check, not pt.nonil, pt.dt,
               pt.typ.kind == Kind.DECIMAL, to.kind == Kind.DECIMAL)
        return out, PT(to, nonil=pt.nonil)

    def _str_parse_lut(self, ir, pt: PT, to: SQLType):
        """string->value cast: parse each *distinct* dict value on the host,
        apply by gather (gdk_calc_convert.c convert_str_any analog)."""
        if pt.sdict is None:
            raise Unsupported("string cast without dictionary")
        from .executor import _parse_str_cast
        from ..storage.columns import to_physical_np
        vals = []
        for sv in pt.sdict.values:
            try:
                vals.append(_parse_str_cast(str(sv), to))
            except Exception:
                raise Unsupported("unparseable string cast")
        phys = to_physical_np(vals, to)
        lut = self._add_lut(np.asarray(phys, dtype=to.np_dtype))
        return ("lutmap", lut, ir, to.np_dtype.str), PT(to, nonil=pt.nonil)

    def _val_to_str_lut(self, ir, pt: PT, to: SQLType):
        raise Unsupported("value->string cast")

    # -- CASE / functions ------------------------------------------------------
    def _coerce(self, ir, pt: PT, out: SQLType):
        """Coerce a lowered value to the CASE/COALESCE output type
        (executor._coerce_val)."""
        if out.kind == Kind.STR:
            return ir, pt
        if out.np_dtype.kind == "f":
            return self._tofloat(ir, pt)
        os = out.scale if out.kind == Kind.DECIMAL else 0
        if pt.scale < os:
            return self._upscale(ir, pt, os - pt.scale)
        if pt.typ.np_dtype != out.np_dtype:
            check = bool(config.get("overflow_checks"))
            return ("convert", ir, out.np_dtype.str, 0, 0, check,
                    not pt.nonil, pt.dt, False, False), \
                PT(out, nonil=pt.nonil)
        return ir, dataclasses.replace(pt, typ=out)

    def _unify_str_vals(self, lowered):
        """Merge the dictionaries of string CASE branches into one
        order-preserving dict; remap each branch by lut."""
        dicts = []
        for ir, pt in lowered:
            if pt.typ is not None and not pt.is_str:
                # mixed-type branches need host-side value→string casts:
                # executor path (convert_any_str)
                raise Unsupported("mixed-type string CASE/COALESCE")
            if pt.sdict is not None and len(pt.sdict.values):
                dicts.append(np.asarray(pt.sdict.values, dtype=str))
        merged = np.unique(np.concatenate(dicts)) if dicts \
            else np.empty(0, dtype=str)
        sd = StrDict(merged)
        out = []
        for ir, pt in lowered:
            if pt.sdict is None or not len(pt.sdict.values):
                out.append((ir, dataclasses.replace(pt, sdict=sd)))
                continue
            remap = np.searchsorted(merged, pt.sdict.values).astype(np.int32)
            lut = self._add_lut(remap)
            out.append((("lutmap", lut, ir, "<i4"),
                        dataclasses.replace(pt, sdict=sd)))
        return out, sd

    def _case(self, e: Case, penv):
        out_typ = e.typ
        if out_typ is None:
            raise Unsupported("untyped CASE")
        conds = [self.pred(c, penv) for c, _ in e.whens]
        vals = [self.expr(v, penv) for _, v in e.whens]
        default = self.expr(e.default, penv) if e.default is not None \
            else self._lit(HScalar(None, out_typ))
        sd = None
        if out_typ.kind == Kind.STR:
            unified, sd = self._unify_str_vals(vals + [default])
            vals, default = unified[:-1], unified[-1]
        else:
            vals = [self._coerce(ir, pt, out_typ) for ir, pt in vals]
            default = self._coerce(*default, out_typ)
        any_nil = any(not pt.nonil for _ir, pt in vals + [default])
        ir = ("case", tuple(zip(conds, (ir for ir, _ in vals))),
              default[0], out_typ.np_dtype.str)
        return ir, PT(out_typ, nonil=not any_nil, sdict=sd)

    _MATH = frozenset({"sqrt", "ln", "log10", "exp", "sin", "cos", "tan",
                       "floor", "ceil", "ceiling"})
    _DATE_FUNCS = frozenset({
        "year", "month", "day", "dayofmonth", "quarter", "dayofweek",
        "weekday", "dayofyear", "weekofyear", "week", "hour", "minute",
        "second", "century", "decade", "epoch"})

    def _func(self, e: Func, penv):
        name = e.name
        if name.startswith("extract_"):
            name = name[len("extract_"):]
        if name in self._DATE_FUNCS:
            ir, pt = self.expr(e.args[0], penv)
            return self._extract(name, ir, pt)
        if name in self._MATH:
            ir, pt = self.expr(e.args[0], penv)
            ir, pt = self._tofloat(ir, pt)
            fn = "ceil" if name == "ceiling" else name
            return ("math", fn, ir), PT(F64, nonil=False)
        if name == "power":
            a, apt = self.expr(e.args[0], penv)
            b, bpt = self.expr(e.args[1], penv)
            a, _ = self._tofloat(a, apt)
            b, _ = self._tofloat(b, bpt)
            return ("pow", a, b), PT(F64, nonil=False)
        if name in ("neg", "abs"):
            ir, pt = self.expr(e.args[0], penv)
            if pt.is_str:
                raise Unsupported("neg/abs over strings")
            return ("unop", name, ir, pt.dt, not pt.nonil), \
                dataclasses.replace(pt, minval=None, maxval=None)
        if name in ("coalesce", "ifnull", "nvl"):
            return self._coalesce(e, penv)
        if name == "nullif":
            c = Cmp("=", e.args[0], e.args[1])
            c.typ = BOOL
            p = self.pred(c, penv)
            ir, pt = self.expr(e.args[0], penv)
            return ("nullif", p, ir, pt.dt), \
                dataclasses.replace(pt, nonil=False)
        if name in ("upper", "ucase", "lower", "lcase", "trim", "ltrim",
                    "rtrim", "reverse", "substring", "left", "right",
                    "replace", "lpad", "rpad", "repeat"):
            return self._str_func(name, e, penv)
        if name in ("length", "char_length", "character_length",
                    "octet_length"):
            ir, pt = self.expr(e.args[0], penv)
            if not pt.is_str or pt.sdict is None:
                raise Unsupported("length of non-dict value")
            from ..dtypes import is_blob
            div = 2 if is_blob(pt.typ) else 1   # blob length = bytes
            lens = np.array([len(str(v)) // div
                             for v in pt.sdict.values], dtype=np.int32)
            lut = self._add_lut(lens)
            return ("lutmap", lut, ir, "<i4"), PT(I32, nonil=pt.nonil)
        if name == "date_trunc":
            field = e.args[0]
            if not isinstance(field, Const):
                raise Unsupported("dynamic date_trunc field")
            ir, pt = self.expr(e.args[1], penv)
            is_ts = pt.typ.kind == Kind.TIMESTAMP
            return ("dtrunc", str(field.value), ir, is_ts, not pt.nonil), \
                dataclasses.replace(pt, minval=None, maxval=None)
        raise Unsupported(f"function {e.name}")

    def _extract(self, field: str, ir, pt: PT):
        from ..ops.datecalc import _FIELD_ALIASES
        field = _FIELD_ALIASES.get(field, field)
        k = pt.typ.kind
        if k == Kind.TIME:
            if field not in ("hour", "minute", "second", "epoch"):
                raise Unsupported(f"extract {field} from TIME")
            return ("textract", field, ir, not pt.nonil), \
                PT(I64 if field == "epoch" else I32, nonil=pt.nonil)
        if k not in (Kind.DATE, Kind.TIMESTAMP):
            raise Unsupported(f"extract from {pt.typ!r}")
        out_pt = PT(I64 if field == "epoch" else I32, nonil=pt.nonil)
        if field == "year" and k == Kind.DATE and pt.minval is not None \
                and pt.maxval is not None:
            out_pt.minval = 1970 + int(pt.minval) // 366 - 1
            out_pt.maxval = 1970 + int(pt.maxval) // 365 + 1
            # year() over a nonil bounded date column is nonil and bounded:
            # eligible for the dense group-by domain (opt_mitosis-friendly)
            out_pt.nonil = pt.nonil
        return ("dextract", field, ir, k == Kind.TIMESTAMP, not pt.nonil), \
            out_pt

    def _coalesce(self, e: Func, penv):
        out_typ = e.typ
        if out_typ is None:
            raise Unsupported("untyped coalesce")
        vals = [self.expr(a, penv) for a in e.args]
        sd = None
        if out_typ.kind == Kind.STR:
            vals, sd = self._unify_str_vals(vals)
        else:
            vals = [self._coerce(ir, pt, out_typ) for ir, pt in vals]
        ir = vals[-1][0]
        for v_ir, _pt in reversed(vals[:-1]):
            ir = ("ifnil", v_ir, ir, out_typ.np_dtype.str)
        nonil = any(pt.nonil for _ir, pt in vals)
        return ir, PT(out_typ, nonil=nonil, sdict=sd)

    def _str_func(self, name: str, e: Func, penv):
        """Unary-ish string function = host map over the *distinct* dict
        values + device code-remap lut (the strimps/dict trick: compute
        per distinct once, gather by code - gdk_string.c bulk ops)."""
        ir, pt = self.expr(e.args[0], penv)
        if not pt.is_str or pt.sdict is None:
            raise Unsupported(f"{name} over non-dict value")
        args = []
        for a in e.args[1:]:
            la, lpt = self.expr(a, penv)
            if la[0] not in ("lit", "nil"):
                raise Unsupported(f"{name} with non-constant argument")
            if lpt.is_str:
                args.append(None if la[0] == "nil"
                            else str(lpt.sdict.values[la[1]]))
            else:
                args.append(None if la[0] == "nil" else la[1])

        def f(s: str) -> str:
            if name in ("upper", "ucase"):
                return s.upper()
            if name in ("lower", "lcase"):
                return s.lower()
            if name == "trim":
                return s.strip() if not args else s.strip(str(args[0]))
            if name == "ltrim":
                return s.lstrip() if not args else s.lstrip(str(args[0]))
            if name == "rtrim":
                return s.rstrip() if not args else s.rstrip(str(args[0]))
            if name == "reverse":
                return s[::-1]
            if name == "substring":
                start = int(args[0])
                out = s[max(start - 1, 0):]
                if len(args) > 1 and args[1] is not None:
                    out = out[:max(int(args[1]), 0)]
                return out
            if name == "left":
                return s[:max(int(args[0]), 0)]
            if name == "right":
                k = max(int(args[0]), 0)
                return s[-k:] if k else ""
            if name == "replace":
                return s.replace(str(args[0]), str(args[1]))
            if name == "lpad":
                fill = str(args[1]) if len(args) > 1 else " "
                k = int(args[0])
                return (fill * k + s)[-k:] if len(s) < k else s[:k]
            if name == "rpad":
                fill = str(args[1]) if len(args) > 1 else " "
                k = int(args[0])
                return (s + fill * k)[:k] if len(s) < k else s[:k]
            if name == "repeat":
                return s * int(args[0])
            raise Unsupported(name)

        mapped = np.array([f(str(v)) for v in pt.sdict.values], dtype=object)
        uniq, codes = (np.unique(mapped.astype(str), return_inverse=True)
                       if len(mapped) else (np.empty(0, dtype=str),
                                            np.empty(0, dtype=np.int64)))
        lut = self._add_lut(codes.astype(np.int32))
        out_pt = PT(varchar(), nonil=pt.nonil, sdict=StrDict(uniq))
        return ("lutmap", lut, ir, "<i4"), out_pt

    # ======================================================================
    # predicate lowering -> bool IR ("raw": caller ANDs with liveness)
    # ======================================================================

    def pred(self, e: Expr, penv) -> tuple:
        if isinstance(e, BoolOp):
            parts = tuple(self.pred(a, penv) for a in e.args)
            return ("and" if e.op == "and" else "or", parts)
        if isinstance(e, Not):
            return ("not", self.pred(e.arg, penv))
        if isinstance(e, Cmp):
            return self._pred_cmp(e, penv)
        if isinstance(e, Between):
            return self._pred_between(e, penv)
        if isinstance(e, InList):
            return self._pred_inlist(e, penv)
        if isinstance(e, Like):
            return self._pred_like(e, penv)
        if isinstance(e, IsNull):
            ir, pt = self.expr(e.arg, penv)
            p = ("isnilp", ir, pt.dt)
            return ("not", p) if e.negated else p
        if isinstance(e, Const):
            return ("ptrue",) if e.value else ("pfalse",)
        # bare boolean expression
        ir, pt = self.expr(e, penv)
        if pt.typ.kind == Kind.BOOL:
            return ("asbool", ir, pt.dt)
        raise Unsupported(f"predicate {type(e).__name__}")

    _FLIP = {"=": "=", "<>": "<>", "<": ">", "<=": ">=", ">": "<",
             ">=": "<="}
    _CMPN = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le",
             ">": "gt", ">=": "ge"}

    def _pred_cmp(self, e: Cmp, penv) -> tuple:
        a = self._val_or_scalar(e.left, penv)
        b = self._val_or_scalar(e.right, penv)
        op = e.op
        if isinstance(a, HScalar) and not isinstance(b, HScalar):
            a, b = b, a
            op = self._FLIP[op]
        if isinstance(b, HScalar):
            if isinstance(a, HScalar):                 # const vs const
                return self._fold_cmp(op, a, b)
            return self._cmp_col_scalar(a, op, b)
        # column vs column
        (a_ir, a_pt), (b_ir, b_pt) = a, b
        if a_pt.is_str or b_pt.is_str:
            a_ir, a_pt, b_ir, b_pt = self._align_str(a_ir, a_pt, b_ir, b_pt)
        elif a_pt.is_float or b_pt.is_float:
            a_ir, a_pt = self._tofloat(a_ir, a_pt)
            b_ir, b_pt = self._tofloat(b_ir, b_pt)
        else:
            sa, sb = a_pt.scale, b_pt.scale
            if sa < sb:
                a_ir, a_pt = self._upscale(a_ir, a_pt, sb - sa)
            elif sb < sa:
                b_ir, b_pt = self._upscale(b_ir, b_pt, sa - sb)
        return ("cmp", self._CMPN[op], a_ir, b_ir,
                not a_pt.nonil, not b_pt.nonil, a_pt.dt)

    def _align_str(self, a_ir, a_pt, b_ir, b_pt):
        if not (a_pt.is_str and b_pt.is_str):
            raise Unsupported("string vs non-string comparison")
        if a_pt.sdict is b_pt.sdict:
            return a_ir, a_pt, b_ir, b_pt
        if a_pt.sdict is None or b_pt.sdict is None:
            raise Unsupported("string compare without dictionary")
        # translate right codes into the left code space (-2 = absent)
        idx = np.searchsorted(a_pt.sdict.values, b_pt.sdict.values)
        idx = np.clip(idx, 0, max(len(a_pt.sdict) - 1, 0))
        if len(a_pt.sdict):
            found = a_pt.sdict.values[idx] == b_pt.sdict.values
        else:
            found = np.zeros(len(b_pt.sdict.values), bool)
        remap = np.where(found, idx, -2).astype(np.int32)
        lut = self._add_lut(remap)
        b2 = ("lutmap_keepnil", lut, b_ir)
        return a_ir, a_pt, b2, dataclasses.replace(b_pt, sdict=a_pt.sdict)

    def _val_or_scalar(self, e: Expr, penv):
        """Lower to either an HScalar (host constant) or (ir, pt)."""
        if isinstance(e, Const):
            return self._const(e)
        ir, pt = self.expr(e, penv)
        if ir[0] == "nil":
            return HScalar(None, pt.typ)
        if ir[0] == "lit" and pt.is_str:
            return HScalar(str(pt.sdict.values[ir[1]]), pt.typ)
        if ir[0] == "lit":
            return HScalar(ir[1], pt.typ)
        return (ir, pt)

    def _fold_cmp(self, op, a: HScalar, b: HScalar):
        if a.value is None or b.value is None:
            return ("pfalse",)
        if a.is_float() or b.is_float():
            av, bv = a.as_f64(), b.as_f64()
        elif a.typ is not None and a.typ.kind == Kind.STR:
            av, bv = str(a.value), str(b.value)
        else:
            s = max(a.scale, b.scale)
            av = int(a.value) * 10 ** (s - a.scale)
            bv = int(b.value) * 10 ** (s - b.scale)
        res = {"=": av == bv, "<>": av != bv, "!=": av != bv, "<": av < bv,
               "<=": av <= bv, ">": av > bv, ">=": av >= bv}[op]
        return ("ptrue",) if res else ("pfalse",)

    def _cmp_col_scalar(self, a, op: str, s: HScalar):
        """BATthetaselect semantics (gdk/gdk_select.c:2103 + the
        truth table :1280-1340): nil guards match ops/select.py."""
        ir, pt = a
        if s.value is None:
            return ("pfalse",)
        if pt.is_str:
            sd = pt.sdict
            if sd is None:
                raise Unsupported("string compare without dictionary")
            val = str(s.value)
            if op in ("=", "<>"):
                code = sd.code_of(val)
                node = ("rangesel", ir, "eq", code, 0, True, True, False,
                        pt.dt)
                if op == "<>":
                    return ("rangesel", ir, "ne", code, 0, True, True,
                            not pt.nonil, pt.dt)
                return node
            if op == "<":
                th = sd.range_codes(val, "left")
                return ("rangesel", ir, "lt", th, 0, True, False,
                        not pt.nonil, pt.dt)
            if op == "<=":
                th = sd.range_codes(val, "right")
                return ("rangesel", ir, "lt", th, 0, True, False,
                        not pt.nonil, pt.dt)
            if op == ">":
                tl = sd.range_codes(val, "right")
                return ("rangesel", ir, "ge", tl, 0, True, True, False,
                        pt.dt)
            if op == ">=":
                tl = sd.range_codes(val, "left")
                return ("rangesel", ir, "ge", tl, 0, True, True, False,
                        pt.dt)
            raise Unsupported(op)
        if s.is_float() and not pt.is_float:
            ir, pt = self._tofloat(ir, pt)
            return ("cmp", self._CMPN[op], ir,
                    ("lit", s.as_f64(), "<f8"), not pt.nonil, False, "<f8")
        if pt.is_float:
            return ("cmp", self._CMPN[op], ir,
                    ("lit", s.as_f64(), "<f8"), not pt.nonil, False, pt.dt)
        cs, ss = pt.scale, s.scale
        v = s.value
        if ss > cs:
            ir, pt = self._upscale(ir, pt, ss - cs)
        elif cs > ss:
            v = int(v) * 10 ** (cs - ss)
        v = int(v) if not isinstance(v, bool) else bool(v)
        mode = self._CMPN[op]
        # nil guards per ops/select.py _GUARDED_INT: lt/le/ne admit the
        # int sentinel on a raw compare
        guard = (not pt.nonil) and mode in ("lt", "le", "ne")
        return ("rangesel", ir, mode, v, 0, True, True, guard, pt.dt)

    def _pred_between(self, e: Between, penv) -> tuple:
        a = self._val_or_scalar(e.arg, penv)
        lo = self._val_or_scalar(e.lo, penv)
        hi = self._val_or_scalar(e.hi, penv)
        if isinstance(a, HScalar) or not (isinstance(lo, HScalar)
                                          and isinstance(hi, HScalar)):
            # general shape: a >= lo AND a <= hi
            lo_p = self._cmp_parts(a, ">=", lo, penv)
            hi_p = self._cmp_parts(a, "<=", hi, penv)
            p = ("and", (lo_p, hi_p))
            return ("not", p) if e.negated else p
        ir, pt = a
        if pt.is_str:
            vals = pt.sdict.values
            lv = int(np.searchsorted(vals, str(lo.value), "left"))
            hv = int(np.searchsorted(vals, str(hi.value), "right")) - 1
            mode = "anti_between" if e.negated else "between"
            return ("rangesel", ir, mode, lv, hv, True, True,
                    e.negated and not pt.nonil, pt.dt)
        if lo.value is None or hi.value is None:
            return ("pfalse",)
        if pt.is_float or lo.is_float() or hi.is_float():
            ir2, pt2 = self._tofloat(ir, pt)
            mode = "anti_between" if e.negated else "between"
            return ("rangesel", ir2, mode, lo.as_f64(), hi.as_f64(),
                    True, True, e.negated and not pt2.nonil, pt2.dt)
        s = max(pt.scale, lo.scale, hi.scale)
        if pt.scale < s:
            ir, pt = self._upscale(ir, pt, s - pt.scale)
        lv = int(lo.value) * 10 ** (s - lo.scale)
        hv = int(hi.value) * 10 ** (s - hi.scale)
        mode = "anti_between" if e.negated else "between"
        return ("rangesel", ir, mode, lv, hv, True, True,
                e.negated and not pt.nonil, pt.dt)

    def _cmp_parts(self, a, op, b, penv):
        c = Cmp(op, _Wrapped(a), _Wrapped(b))
        return self._pred_cmp(c, penv)

    def _pred_inlist(self, e: InList, penv) -> tuple:
        ir, pt = self.expr(e.arg, penv)
        items = [self._val_or_scalar(i, penv) for i in e.items]
        if not all(isinstance(i, HScalar) for i in items):
            raise Unsupported("non-constant IN list")
        if pt.is_str:
            if pt.sdict is None:
                raise Unsupported("IN over string without dictionary")
            want = {str(i.value) for i in items if i.value is not None}
            lut = pt.sdict.match_mask(lambda v: v in want)
            li = self._add_lut(lut)
            p = ("strpred", li, ir)
            if e.negated:
                guard = ("notnilp", ir, pt.dt) if not pt.nonil else ("ptrue",)
                return ("and", (guard, ("not", p)))
            return p
        cs = pt.scale
        vals = tuple(sorted(int(i.value) * 10 ** (cs - i.scale)
                            for i in items if i.value is not None))
        p = ("inints", ir, vals, pt.dt)
        if e.negated:
            guard = ("notnilp", ir, pt.dt) if not pt.nonil else ("ptrue",)
            return ("and", (guard, ("not", p)))
        return p

    def _pred_like(self, e: Like, penv) -> tuple:
        """LIKE -> host regex over the dictionary, device code gather
        (ops/strfuncs.py like_cand semantics; strimps analog,
        gdk/gdk_strimps.c). NOT LIKE inverts the lut so nils stay
        excluded (SQL three-valued logic)."""
        import re
        ir, pt = self.expr(e.arg, penv)
        if not pt.is_str or pt.sdict is None:
            raise Unsupported("LIKE over non-dict value")
        from ..ops.strfuncs import _like_mask_vectorized, like_regex
        caseless = getattr(e, "caseless", False)
        flags = re.DOTALL | (re.IGNORECASE if caseless else 0)
        lut = None
        if not getattr(e, "regex", False):
            # vectorized %-pattern matching over the dict: one numpy pass
            # per literal segment; survives distincts ~ rows (the
            # high-cardinality case where a python regex loop collapses)
            lut = _like_mask_vectorized(pt.sdict.values, e.pattern,
                                        e.escape, caseless)
        if lut is None and getattr(e, "regex", False):
            rx = re.compile(e.pattern, flags)
            lut = pt.sdict.match_mask(lambda v: rx.search(v) is not None)
        elif lut is None:
            rx = re.compile(like_regex(e.pattern, e.escape).pattern, flags)
            lut = pt.sdict.match_mask(lambda v: rx.match(v) is not None)
        if e.negated:
            lut = ~lut
        li = self._add_lut(lut)
        return ("strpred", li, ir)


class _Wrapped(Expr):
    """Adapter letting pre-lowered values re-enter _pred_cmp."""
    def __init__(self, lowered):
        super().__init__()
        self.lowered = lowered


# hook _val_or_scalar for _Wrapped
_orig_val_or_scalar = Lowering._val_or_scalar


def _val_or_scalar_w(self, e, penv):
    if isinstance(e, _Wrapped):
        return e.lowered
    return _orig_val_or_scalar(self, e, penv)


Lowering._val_or_scalar = _val_or_scalar_w


# ---------------------------------------------------------------------------
# traced interpreter - runs inside one jit; XLA fuses the whole pipeline
# ---------------------------------------------------------------------------


def _nilm_arr(x):
    if x.dtype.kind == "f":
        return jnp.isnan(x)
    if x.dtype.kind == "b":
        return jnp.zeros(x.shape, jnp.bool_)
    return x == jnp.iinfo(x.dtype).min


def _ss(sorted_arr, targets, side: str, method: str = "scan"):
    """Device searchsorted.

    'sort' instantiates an extra device sort per call site (slow to
    compile, fast to run); 'scan' compiles fast but runs ~log2(n)
    dependent gather rounds.  Small-needle and cold-path sites use
    'scan'; the few hot big-domain join probes that cannot use the dense
    direct-address strategy ask for 'sort' (compiled once per machine -
    the persistent compile cache, config.py).  Not yet measured on the
    H100 (ROADMAP 1.3)."""
    return jnp.searchsorted(sorted_arr, targets, side=side, method=method)


# ---------------------------------------------------------------------------
# LSD argsort: the engine's ONE way to sort on device.
#
# A device sort's compile time grows with its comparator operand count
# and dtype width, and each instantiation compiles separately.  So:
# every ordering is decomposed into int32 key ROWS
# (int64/float keys split into hi/lo passes - GDKrsort's 8-bit-digit
# LSB radix idea, gdk/gdk_rsort.c:20, at 32-bit granularity), and ONE
# (int32 key, int32 payload) stable-sort instantiation inside a
# lax.scan runs every pass.  Compile cost per call site is ~one 2-op
# int32 sort regardless of how many keys the ordering has.  Whether this
# beats one multi-operand lax.sort on the H100 is not yet measured
# (ROADMAP 1.3).
# ---------------------------------------------------------------------------

_I32_BIAS = np.int64(1 << 31)


def _key_rows_i64(key64) -> list:
    """int64 ordering -> [hi, lo] int32 rows (lex order preserved):
    hi = arithmetic high word; lo biased so unsigned low-word order
    becomes signed int32 order."""
    hi = (key64 >> 32).astype(jnp.int32)
    lo = ((key64 & 0xFFFFFFFF) - _I32_BIAS).astype(jnp.int32)
    return [hi, lo]


def _sort_rows(arr, descending: bool = False,
               nils_last: Optional[bool] = None) -> list:
    """Physical column -> int32 key rows realizing BATsort's ordering
    contract (ops/sort.py sort_key): nil smallest by default, explicit
    nils_last pins nils to the far end, descending = complement rows."""
    from ..ops.sort import sort_key
    if nils_last is None and (arr.dtype == jnp.bool_ or
                              (arr.dtype.kind == "i" and
                               arr.dtype.itemsize <= 4)):
        rows = [arr.astype(jnp.int32)]     # nil = INT32_MIN, smallest
        if descending:
            rows = [~r for r in rows]
        return rows
    # sort_key applies direction BEFORE the explicit nils_last pin
    # (NULLS LAST must hold for DESC too) - no post-complement here
    return _key_rows_i64(sort_key(arr, descending, nils_last))


def _rows_of(arr) -> list:
    """Ascending-order int32 key rows for an already-normalized key
    array (int32 codes pass through; int64 sort keys split)."""
    if arr.dtype == jnp.int32:
        return [arr]
    if arr.dtype == jnp.bool_ or (arr.dtype.kind == "i" and
                                  arr.dtype.itemsize < 4):
        return [arr.astype(jnp.int32)]
    return _key_rows_i64(arr.astype(jnp.int64))


def _lsd_argsort(rows: list, cap: int):
    """Stable argsort of the int32 key rows (first row most
    significant) -> int32 permutation; ONE sort instantiation via
    lax.scan regardless of key count."""
    perm0 = jax.lax.iota(jnp.int32, cap)
    if len(rows) == 1:
        _k, perm = jax.lax.sort((rows[0], perm0), num_keys=1,
                                is_stable=True)
        return perm

    def body(perm, key_row):
        k = key_row[perm]
        _, perm2 = jax.lax.sort((k, perm), num_keys=1, is_stable=True)
        return perm2, None

    stacked = jnp.stack(rows[::-1])        # LSD: least significant first
    perm, _ = jax.lax.scan(body, perm0, stacked)
    return perm


class _SegReduce:
    """Segmented reduction (the device form of the reference's BATgroup*
    aggregation loops, gdk/gdk_aggr.c:900).

    sid must hold the segment id in [0, seg) for contributing rows and
    seg for excluded rows.  Strategies:

    * seg <= _ONEHOT_MAX: masked one-hot broadcast-reduce - XLA fuses
      the (cap, seg) comparison into the reduction, no intermediate.
    * seg > _ONEHOT_MAX: scatter-add/min/max into seg + 1 slots.
    * sorted: the caller (groupby_sort) already sorted and passes its
      (sorted_sid, perm) - one shared device sort (GDKrsort analog,
      gdk/gdk_rsort.c:20); per-aggregate reductions gather values into
      segment order and use log-depth prefix ops: cumsum +
      boundary-diff for sums (exact for ints; ~eps*log n error for
      floats), segmented associative_scan for min/max.

    Per-aggregate validity (skip_nils) is handled by the caller masking
    values to the reduction identity; excluded rows keep their slot in
    the shared sort, so one sort serves every aggregate of a group-by.
    """

    def __init__(self, sid, seg: int, cap: int, sorted_ctx=None):
        self.seg = int(seg)
        self.cap = int(cap)
        if sorted_ctx is None and self.seg > _ONEHOT_MAX:
            # scatter strategy: one .at[].add/min/max per aggregate -
            # the BATgroupsum loop made parallel, no shared sort
            self.mode = "scatter"
            self.sid = sid            # segment id, excluded rows = seg
            return
        if sorted_ctx is None and self.seg <= _ONEHOT_MAX:
            self.mode = "onehot"
            self.sid = sid
            # integer sums on the GPU at >= 2^20 rows take the Triton-route
            # kernel (ops/pallas_kernels.py seg_sum): TPC-H Q1 at SF1 runs
            # ~25% faster warm with it than with the one-hot form on an
            # H100 (PERF.md).  The one-hot form stays for the CPU, floats
            # and smaller inputs, where the kernel is unmeasured.
            from ..ops import pallas_kernels as PK
            self._pallas = (config.get("pallas_groupby")
                            and jax.default_backend() == "gpu"
                            and self.cap >= (1 << 20)
                            and self.seg <= PK.SEG_SUM_MAX_DOMAIN)
            self._oh = None
            return
        self.mode = "sorted"
        self.s, self.perm = sorted_ctx
        # segment boundaries from a histogram scatter-add + cumsum
        # (replaces a searchsorted - see _ss compile economics): s holds
        # sid in [0, seg], excluded rows at seg
        hist = jnp.zeros(self.seg + 1, jnp.int32).at[self.s].add(
            jnp.int32(1), mode="drop")
        self.ends = jnp.cumsum(hist[: self.seg])
        self.starts = jnp.concatenate(
            [jnp.zeros(1, self.ends.dtype), self.ends[:-1]])

    @property
    def oh(self):
        """(cap, seg) one-hot matrix, built on first use — plans whose
        aggregates are all Pallas-summed never materialize it."""
        if self._oh is None:
            slots = jax.lax.iota(jnp.int64, self.seg)[None, :]
            self._oh = self.sid[:, None] == slots
        return self._oh

    def sum(self, vals, dtype=None):
        """Per-segment sum; vals must be 0 outside the contributing set."""
        dt = np.dtype(dtype) if dtype is not None else vals.dtype
        if self.mode == "scatter":
            return jnp.zeros(self.seg + 1, dt).at[self.sid].add(
                vals.astype(dt), mode="drop")[: self.seg]
        if self.mode == "onehot":
            if self._pallas and dt.kind == "i":
                from ..ops.pallas_kernels import seg_sum
                return seg_sum(self.sid, vals, domain=self.seg).astype(dt)
            return jnp.sum(jnp.where(self.oh, vals.astype(dt)[:, None],
                                     dt.type(0)), axis=0)
        v = vals.astype(dt)[self.perm]
        c = jnp.concatenate([jnp.zeros(1, dt), jnp.cumsum(v)])
        return c[self.ends] - c[self.starts]

    def extreme(self, vals, fill, is_min: bool):
        """Per-segment min/max; vals must be `fill` outside the set."""
        if self.mode == "scatter":
            out = jnp.full(self.seg + 1, fill, vals.dtype)
            out = out.at[self.sid].min(vals, mode="drop") if is_min \
                else out.at[self.sid].max(vals, mode="drop")
            return out[: self.seg]
        if self.mode == "onehot":
            red = jnp.min if is_min else jnp.max
            return red(jnp.where(self.oh, vals[:, None], fill), axis=0)
        v = vals[self.perm]
        first = (jax.lax.iota(jnp.int64, self.cap) == 0) | \
            (self.s != jnp.roll(self.s, 1))

        def op(a, b):
            fa, va = a
            fb, vb = b
            m = jnp.minimum(va, vb) if is_min else jnp.maximum(va, vb)
            return fa | fb, jnp.where(fb, vb, m)

        _f, m = jax.lax.associative_scan(op, (first, v))
        out = m[jnp.clip(self.ends - 1, 0, self.cap - 1)]
        return jnp.where(self.ends > self.starts, out, fill)

    def prod(self, vals):
        """Per-segment product; vals must be 1 outside the set.  The
        sorted strategy keeps the (small, seg-sized) scatter: cumprod
        would overflow where the product itself does not."""
        if self.mode == "scatter":
            return jnp.ones(self.seg + 1, vals.dtype).at[self.sid].mul(
                vals, mode="drop")[: self.seg]
        if self.mode == "onehot":
            return jnp.prod(jnp.where(self.oh, vals[:, None],
                                      vals.dtype.type(1)), axis=0)
        v = vals[self.perm]
        out = jnp.ones(self.seg + 1, vals.dtype)
        return out.at[self.s].mul(v, mode="drop")[:self.seg]

    def first_index(self):
        """Original-row index of each segment's first sorted element
        (-1 for empty segments) - BATgroup extents."""
        if self.mode == "scatter":
            big = jnp.int64(self.cap + 1)
            ext = jnp.full(self.seg + 1, big).at[self.sid].min(
                jax.lax.iota(jnp.int64, self.cap), mode="drop")[: self.seg]
            return jnp.where(ext > self.cap, jnp.int64(-1), ext)
        if self.mode == "onehot":
            io = jax.lax.iota(jnp.int64, self.oh.shape[0])
            big = jnp.int64(self.cap + 1)
            ext = jnp.min(jnp.where(self.oh, io[:, None], big), axis=0)
            return jnp.where(ext > self.cap, jnp.int64(-1), ext)
        ext = self.perm[jnp.clip(self.starts, 0, self.cap - 1)]
        return jnp.where(self.ends > self.starts, ext, jnp.int64(-1))


def _nil_const(dtype):
    d = np.dtype(dtype)
    if d.kind == "f":
        return d.type(np.nan)
    if d.kind == "b":
        return np.bool_(False)
    return d.type(np.iinfo(d).min)


def _gather_nil(arr, oids, live_out):
    """arr[oids] with dead slots (live_out False or oid<0) -> nil."""
    ok = live_out & (oids >= 0)
    safe = jnp.where(ok, oids, 0)
    return jnp.where(ok, arr[safe], _nil_const(arr.dtype))


class _Interp:
    """IR interpreter; every method traces jnp ops (no host syncs)."""

    def __init__(self, inputs, axis: Optional[str] = None, nsh: int = 1):
        self.inputs = inputs
        # SPMD mode (inside shard_map over a device mesh): axis name +
        # shard count; None = single-device trace
        self.axis = axis
        self.nsh = nsh
        self.errs: list = []
        # traced total match counts per expanding join (host compares with
        # the static expansion capacity and retries with a bigger one)
        self.exp_totals: Dict[int, jax.Array] = {}
        # per-row error suppression inside untaken CASE branches (the
        # reference only evaluates the taken branch per row,
        # BugTracker-2009 case_evaluates_all_branches.SF-2893484; under
        # eager whole-column evaluation the per-element error conditions
        # are masked by the branch-selection mask instead)
        self._vmask = None

    def flag(self, cond_scalar, code: int):
        self.errs.append(jnp.where(cond_scalar, jnp.int32(code),
                                   jnp.int32(0)))

    def flag_rows(self, rows, code: int):
        """Flag an error from per-row conditions, honoring the CASE
        branch-selection mask (rows where the branch is not taken never
        raise)."""
        if self._vmask is not None:
            rows = rows & self._vmask
        self.flag(jnp.any(rows), code)

    def err(self):
        if not self.errs:
            e = jnp.int32(0)
        else:
            e = self.errs[0]
            for x in self.errs[1:]:
                e = jnp.maximum(e, x)
        if self.axis is not None:
            e = jax.lax.pmax(e, self.axis)
        return e

    # -- relational nodes --------------------------------------------------
    def rel(self, ir):
        return getattr(self, "r_" + ir[0])(ir)

    @staticmethod
    def live_of(cap, count, mask):
        live = jax.lax.iota(jnp.int64, cap) < count
        if mask is not None:
            live = live & mask
        return live

    def r_scan(self, ir):
        _, cols, cnt_idx, _cap = ir
        env = {key: self.inputs[i] for key, i in cols}
        count = self.inputs[cnt_idx]
        # capacity from the array shape (inside shard_map the arrays are
        # the per-device shards, so this is the LOCAL capacity)
        cap = env[cols[0][0]].shape[0]
        return env, count, None, cap

    def r_scan_sharded(self, ir):
        """Row-sharded scan (the mitosis slice, opt_mitosis.c:21): each
        device holds rows [i*lcap, (i+1)*lcap) of the base column; the
        global count becomes a per-shard liveness mask against the global
        row index."""
        _, cols, cnt_idx, _cap = ir
        env = {key: self.inputs[i] for key, i in cols}
        count = self.inputs[cnt_idx]            # global count (replicated)
        lcap = env[cols[0][0]].shape[0]
        if self.axis is None:
            return env, count, None, lcap
        base = jax.lax.axis_index(self.axis).astype(jnp.int64) * lcap
        mask = (jax.lax.iota(jnp.int64, lcap) + base) < count
        return env, jnp.int64(lcap), mask, lcap

    def r_gather(self, ir):
        """Shard -> replicated barrier: all_gather every column + the
        liveness mask over the mesh axis (the reference's mat.pack merge
        of mitosis pieces, monetdb5/modules/mal/mat.c:124)."""
        env, count, mask, cap = self.rel(ir[1])
        if self.axis is None:
            return env, count, mask, cap
        live = self.live_of(cap, count, mask)
        env2 = {k: jax.lax.all_gather(v, self.axis, tiled=True)
                for k, v in env.items()}
        live_g = jax.lax.all_gather(live, self.axis, tiled=True)
        gcap = cap * self.nsh
        return env2, jnp.int64(gcap), live_g, gcap

    def _repart_code(self, keyspec, env, live, cap):
        """Per-row partition key for a hash-repartition exchange.
        ("join", keyspecs, side) reuses the join's packed key codes so
        both sides of a key land on the same owner shard; ("keys", irs)
        hash-combines normalized sort keys (group-by / distinct)."""
        from ..ops.sort import sort_key
        if keyspec[0] == "join":
            _, keyspecs, side = keyspec
            return self._join_codes(keyspecs, env, live, cap, side)
        h = None
        for e in keyspec[1]:
            arr = self.ev(e, env, live)
            if arr.ndim == 0:
                arr = jnp.broadcast_to(arr, (cap,))
            k = sort_key(arr, False, None)
            h = k if h is None else _hash64(h) ^ k
        return h, live

    def r_repartition(self, ir):
        """Ragged all-to-all hash-partition exchange (parallel/shuffle.py
        design; the distributed feature the reference lacks - its remote
        joins ship whole columns to one site, modules/mal/remote.c:971
        RMTput).  Rows move to the shard owning hash(key) mod D; rows
        with invalid keys (nil / out-of-range - they can never match)
        stay local.  Static [D, lane_cap] send buffers are packed
        scatter-free (dest-sort + gather); the measured max lane count is
        reported to the host, which retries with a larger capacity on
        overflow (the expanding-join retry discipline)."""
        _, cir, keyspec, lane_cap, ordinal = ir
        env, count, mask, cap = self.rel(cir)
        if self.axis is None:
            return env, count, mask, cap     # single-device: no-op
        D = self.nsh
        live = self.live_of(cap, count, mask)
        code, valid = self._repart_code(keyspec, env, live, cap)
        my = jax.lax.axis_index(self.axis).astype(jnp.int32)
        dest = jnp.where(valid & live,
                         (_hash64(code.astype(jnp.int64)) % D)
                         .astype(jnp.int32),
                         jnp.where(live, my, jnp.int32(D)))
        order = jnp.argsort(dest, stable=True)    # dead rows (D) sort last
        d_s = dest[order]
        ends = _ss(d_s, jax.lax.iota(jnp.int32, D), "right")
        offs = jnp.concatenate([jnp.zeros(1, ends.dtype), ends[:-1]])
        cnt = (ends - offs).astype(jnp.int32)
        # overflow channel: host compares max lane vs lane_cap, retries
        self.exp_totals[-1 - ordinal] = jax.lax.pmax(
            jnp.max(cnt).astype(jnp.int64), self.axis)
        c_idx = jax.lax.iota(jnp.int32, lane_cap)[None, :]
        src = offs[:, None].astype(jnp.int32) + c_idx
        valid_cell = c_idx < jnp.minimum(cnt, lane_cap)[:, None]
        srcc = jnp.clip(src, 0, cap - 1).astype(jnp.int64)
        cnt_send = jnp.minimum(cnt, lane_cap)
        cnt_r = jax.lax.all_to_all(cnt_send, self.axis, 0, 0, tiled=True)
        env2 = {}
        for k2, col in env.items():
            cs = col[order]
            buf = jnp.where(valid_cell, cs[srcc], _nil_const(col.dtype))
            env2[k2] = jax.lax.all_to_all(
                buf, self.axis, 0, 0, tiled=True).reshape(-1)
        live_out = (jax.lax.iota(jnp.int32, lane_cap)[None, :]
                    < cnt_r[:, None]).reshape(-1)
        cap2 = D * lane_cap
        return env2, jnp.int64(cap2), live_out, cap2

    def r_rename(self, ir):
        env, count, mask, cap = self.rel(ir[1])
        env2 = {newk: env[oldk] for newk, oldk in ir[2]}
        return env2, count, mask, cap

    def r_compact(self, ir):
        """Compaction barrier: gather live rows to the front of a
        smaller (count-retried) capacity so sort/scatter consumers pay
        for data, not padding (gdk_select.c virtualize role)."""
        _, cir, out_cap, ordinal = ir
        env, count, mask, cap = self.rel(cir)
        live = self.live_of(cap, count, mask)
        nlive = jnp.sum(live.astype(jnp.int64))
        # overflow -> count-retry channel (rows would be dropped)
        self.exp_totals[ordinal] = nlive if self.axis is None else \
            jax.lax.pmax(nlive, self.axis)
        oids, _n, live_out = _compact_oids(live, out_cap)
        env2 = {k: _gather_nil(v, oids, live_out) for k, v in env.items()}
        return env2, nlive, None, out_cap

    def r_filter(self, ir):
        env, count, mask, cap = self.rel(ir[1])
        live = self.live_of(cap, count, mask)
        p = self.pv(ir[2], env, live)
        m = jnp.broadcast_to(p, (cap,))
        mask = m if mask is None else (mask & m)
        return env, count, mask, cap

    def r_project(self, ir):
        env, count, mask, cap = self.rel(ir[1])
        live = self.live_of(cap, count, mask)
        env2 = {}
        for key, e in ir[2]:
            v = self.ev(e, env, live)
            env2[key] = jnp.broadcast_to(v, (cap,)) if v.ndim == 0 else v
        return env2, count, mask, cap

    def r_orderby(self, ir):
        env, count, mask, cap = self.rel(ir[1])
        live = self.live_of(cap, count, mask)
        rows = [(~live).astype(jnp.int32)]      # dead rows sort last
        for e, desc, nl in ir[2]:
            arr = self.ev(e, env, live)
            if arr.ndim == 0:
                arr = jnp.broadcast_to(arr, (cap,))
            rows += _sort_rows(arr, desc, nl)
        perm = _lsd_argsort(rows, cap)
        nlive = jnp.sum(live.astype(jnp.int64))
        live_out = jax.lax.iota(jnp.int64, cap) < nlive
        env2 = {k: _gather_nil(a, perm, live_out) for k, a in env.items()}
        return env2, nlive, None, cap

    def r_limit(self, ir):
        _, cir, n, offset, out_cap = ir
        env, count, mask, cap = self.rel(cir)
        live = self.live_of(cap, count, mask)
        if mask is None:
            nlive = count
            oids = jax.lax.iota(jnp.int64, out_cap) + offset
            oids = jnp.where(oids < count, oids, -1)
        else:
            # oids[r] = index of the (offset+r+1)-th live row via one
            # rank-indexed scatter-set (see _compact_oids)
            nlive = jnp.sum(live.astype(jnp.int64))
            csum = jnp.cumsum(live.astype(jnp.int32))
            pos = csum - 1 - offset
            pos = jnp.where(live & (pos >= 0), pos, out_cap)
            oids = jnp.full(out_cap, jnp.int32(-1)).at[pos].set(
                jax.lax.iota(jnp.int32, cap), mode="drop")
        count2 = jnp.clip(nlive - offset, 0,
                          out_cap if n is None else min(n, out_cap))
        live_out = jax.lax.iota(jnp.int64, out_cap) < count2
        if mask is not None:
            oids = jnp.where(live_out, oids, -1)
        env2 = {k: _gather_nil(a, oids, live_out) for k, a in env.items()}
        return env2, count2, None, out_cap

    def r_distinct(self, ir):
        """BATunique via sort grouping (gdk/gdk_unique.c): first row of
        each distinct combination survives, in sorted order."""
        from ..ops.sort import sort_key
        env, count, mask, cap = self.rel(ir[1])
        live = self.live_of(cap, count, mask)
        keys = [env[(e[1], e[2])]
                if env[(e[1], e[2])].dtype.kind in "ib"
                else sort_key(env[(e[1], e[2])], False, None)
                for e, _d, _n in ir[2]]
        ng, _rows, sctx = self._sort_ids(keys, live, cap)
        ext = _SegReduce(None, cap, cap, sorted_ctx=sctx).first_index()
        live_out = jax.lax.iota(jnp.int64, cap) < ng
        env2 = {k: _gather_nil(a, ext, live_out) for k, a in env.items()}
        return env2, ng, None, cap

    # joins ------------------------------------------------------------------
    def _join_codes(self, keyspecs, env, live, cap, side: str):
        """Evaluate one side's join keys -> (packed int64 code, valid).
        valid excludes dead rows, nil keys and out-of-bounds values (a
        probe value outside the build stats range cannot match)."""
        comb = None
        valid = live
        for a_ir, anil, b_ir, bnil, lo, span, is_str in keyspecs:
            ir = a_ir if side == "l" else b_ir
            mnil = anil if side == "l" else bnil
            k = self.ev(ir, env, live)
            if k.ndim == 0:
                k = jnp.broadcast_to(k, (cap,))
            if mnil and not is_str:
                valid = valid & ~_nilm_arr(k)
            k = k.astype(jnp.int64)
            if span is not None:
                c = k - lo
                valid = valid & (c >= 0) & (c < span)
                comb = c if comb is None else comb * span + c
            else:
                if is_str:
                    valid = valid & (k >= 0)
                comb = k
        # 32-bit codes when the static key domain fits: narrow before
        # sorting (half the key bytes)
        if self._codes_domain(keyspecs) is not None:
            comb = comb.astype(jnp.int32)
        return comb, valid

    @staticmethod
    def _codes_domain(keyspecs):
        """Combined key domain when statically < 2^31-8 (int32-safe with
        a sentinel), else None."""
        dom = 1
        for _a, _an, _b, _bn, _lo, span, _s in keyspecs:
            if span is None:
                return None
            dom *= span
            if dom >= (1 << 31) - 8:
                return None
        return dom

    def r_join(self, ir):
        (_, kind, lir, rir, keyspecs, strat, domain, uniq_check,
         bfilter, extra, rkeys, ordinal) = ir
        lenv, lcount, lmask, lcap = self.rel(lir)
        renv, rcount, rmask, rcap = self.rel(rir)
        llive = self.live_of(lcap, lcount, lmask)
        rlive = self.live_of(rcap, rcount, rmask)
        if bfilter is not None:
            rlive = rlive & jnp.broadcast_to(
                self.pv(bfilter, renv, rlive), (rcap,))
        code_l, lvalid = self._join_codes(keyspecs, lenv, llive, lcap, "l")
        code_r, rvalid = self._join_codes(keyspecs, renv, rlive, rcap, "r")

        rid = jax.lax.iota(jnp.int32, rcap)
        big = jnp.int32(rcap)
        if strat == "dense":
            # direct-address build (fetchjoin/hashjoin analog)
            safe_r = jnp.where(rvalid, code_r, domain)
            tmin = jnp.full(domain + 1, big, jnp.int32).at[safe_r].min(
                jnp.where(rvalid, rid, big))[:domain]
            if uniq_check:
                tmax = jnp.full(domain + 1, jnp.int32(-1),
                                jnp.int32).at[safe_r].max(
                    jnp.where(rvalid, rid, -1))[:domain]
                dup = (tmin < big) & (tmax != tmin)
                self.flag(jnp.any(dup), _ERR_DUP_BASE + ordinal)
            safe_l = jnp.where(lvalid, code_l, 0)
            hit = tmin[safe_l]
            matched = lvalid & (hit < big)
            rowid = jnp.where(matched, hit, -1)
        else:
            # sort + binary-search probe (mergejoin analog); sentinel in
            # the code dtype (int32 when the key domain fits)
            sent = jnp.asarray(jnp.iinfo(code_r.dtype).max,
                               code_r.dtype)
            kr = jnp.where(rvalid, code_r, sent)
            rs = _lsd_argsort(_rows_of(kr), rcap)
            ks = kr[rs]
            if uniq_check:
                dup = (ks[1:] == ks[:-1]) & (ks[1:] != sent)
                self.flag(jnp.any(dup), _ERR_DUP_BASE + ordinal)
            kl = jnp.where(lvalid, code_l.astype(code_r.dtype), sent)
            pos = jnp.clip(_ss(ks, kl, "left", method="sort"),
                           0, rcap - 1)
            matched = lvalid & (ks[pos] == kl) & (kl != sent)
            rowid = jnp.where(matched, rs[pos], -1)

        if kind in ("semi", "anti") and extra is None:
            m = matched if kind == "semi" else ~matched
            mask2 = m if lmask is None else (lmask & m)
            return lenv, lcount, mask2, lcap

        menv = dict(lenv)
        ok = rowid >= 0
        for k in rkeys:
            menv[k] = _gather_nil(renv[k], rowid.astype(jnp.int64), ok)
        if extra is not None:
            ex = jnp.broadcast_to(self.pv(extra, menv, llive), (lcap,))
            matched2 = matched & ex
            if kind != "inner":
                for k in rkeys:
                    a = menv[k]
                    menv[k] = jnp.where(matched2, a, _nil_const(a.dtype))
            matched = matched2
            if kind in ("semi", "anti"):
                m = matched if kind == "semi" else ~matched
                mask2 = m if lmask is None else (lmask & m)
                return lenv, lcount, mask2, lcap
        if kind == "inner":
            mask2 = matched if lmask is None else (lmask & matched)
            return menv, lcount, mask2, lcap
        return menv, lcount, lmask, lcap     # left outer

    def r_join_expand(self, ir):
        """N:M join by match enumeration (gdk/gdk_join.c:2900 hashjoin with
        duplicate keys).  Build side sorted by key; per probe row the match
        run is [searchsorted_left, searchsorted_right); output slot j maps
        back to (probe row, k-th match) through a cumsum of per-probe
        output counts.  Total match count is returned to the host, which
        retries with a larger static capacity on overflow."""
        (_, kind, lir, rir, keyspecs, bfilter, extra, lkeys, rkeys,
         ecap, ordinal) = ir
        lenv, lcount, lmask, lcap = self.rel(lir)
        renv, rcount, rmask, rcap = self.rel(rir)
        llive = self.live_of(lcap, lcount, lmask)
        rlive = self.live_of(rcap, rcount, rmask)
        if bfilter is not None:
            rlive = rlive & jnp.broadcast_to(
                self.pv(bfilter, renv, rlive), (rcap,))
        code_l, lvalid = self._join_codes(keyspecs, lenv, llive, lcap, "l")
        code_r, rvalid = self._join_codes(keyspecs, renv, rlive, rcap, "r")

        sent = jnp.asarray(jnp.iinfo(code_r.dtype).max, code_r.dtype)
        kr = jnp.where(rvalid, code_r, sent)
        rs = _lsd_argsort(_rows_of(kr), rcap)
        dom = self._codes_domain(keyspecs)
        if dom is not None:
            # dense packed domain: per-code match runs from a histogram
            # scatter + cumsum LUT instead of two searchsorteds (same
            # compile-economics trade as the dense join strat)
            hist = jnp.zeros(dom + 1, jnp.int32).at[
                jnp.where(rvalid, code_r, dom)].add(jnp.int32(1),
                                                    mode="drop")
            ends_lut = jnp.cumsum(hist[:dom])
            starts_lut = ends_lut - hist[:dom]
            safe_l = jnp.clip(jnp.where(lvalid, code_l, 0), 0, dom - 1)
            s = starts_lut[safe_l]
            e = ends_lut[safe_l]
        else:
            ks = kr[rs]
            kl = jnp.where(lvalid, code_l.astype(code_r.dtype), sent)
            s = _ss(ks, kl, "left", method="sort")
            e = _ss(ks, kl, "right", method="sort")
        c = jnp.where(lvalid, (e - s).astype(jnp.int64), 0)
        if kind == "left":
            # probe rows with no match still emit one (nil-right) row
            c_out = jnp.where(llive, jnp.maximum(c, 1), 0)
        else:
            c_out = c
        csum = jnp.cumsum(c_out)
        total = csum[-1] if lcap else jnp.int64(0)
        # host capacity check needs the max over shards (each shard
        # expands its own probe rows into the same static capacity)
        self.exp_totals[ordinal] = total if self.axis is None else \
            jax.lax.pmax(total, self.axis)

        # slot j -> owning probe row: scatter each emitting row's first
        # slot, then a running max backfills the runs (replaces the
        # inverse-rank searchsorted; owners' first slots are unique and
        # ascending, so cummax reconstructs ownership exactly)
        row_starts = csum - c_out
        owner = jnp.full(ecap, jnp.int32(0)).at[
            jnp.where(c_out > 0, row_starts, ecap)].set(
            jax.lax.iota(jnp.int32, lcap), mode="drop")
        i = jax.lax.cummax(owner)
        i_safe = jnp.clip(i, 0, lcap - 1)
        j = jax.lax.iota(jnp.int64, ecap)
        ok = j < total
        start = csum[i_safe] - c_out[i_safe]
        k = j - start
        has_match = k < c[i_safe]
        ridx = rs[jnp.clip(s[i_safe] + k, 0, rcap - 1)]
        rok = ok & has_match

        if kind in ("semi", "anti"):
            # evaluate the residual per pair, scatter-OR onto probe rows
            env2 = {key: _gather_nil(lenv[key], i_safe, ok) for key in lkeys}
            for key in rkeys:
                env2[key] = _gather_nil(renv[key], ridx, rok)
            live_out = ok
            ex = rok
            if extra is not None:
                ex = ex & jnp.broadcast_to(
                    self.pv(extra, env2, live_out), (ecap,))
            # pairs are emitted in probe-row order, so "any pair of probe
            # row i passed" is a range-sum over [csum[i]-c_out[i], csum[i])
            # - scatter-free (cumsum + two gathers), unlike a scatter-OR
            cs = jnp.concatenate([jnp.zeros(1, jnp.int64),
                                  jnp.cumsum(ex.astype(jnp.int64))])
            hi_i = jnp.clip(csum, 0, ecap)
            lo_i = jnp.clip(csum - c_out, 0, ecap)
            hit = (cs[hi_i] - cs[lo_i]) > 0
            m = hit if kind == "semi" else ~hit
            mask2 = m if lmask is None else (lmask & m)
            return lenv, lcount, mask2, lcap

        env2 = {key: _gather_nil(lenv[key], i_safe, ok) for key in lkeys}
        for key in rkeys:
            env2[key] = _gather_nil(renv[key], ridx, rok)
        if extra is not None:
            live_out = ok
            ex = jnp.broadcast_to(self.pv(extra, env2, live_out), (ecap,))
            return env2, total, ok & ex, ecap
        return env2, total, None, ecap

    # group-by machinery ----------------------------------------------------
    @staticmethod
    def _sort_ids(keys, live, cap):
        """Per-row group ids via device sort (ops/group.py _sort_group).
        Also returns the sorted context (sorted segment ids + the
        permutation) so segment reductions reuse this sort instead of
        re-sorting (_SegReduce sorted strategy)."""
        dead = (~live).astype(jnp.int32)
        rows = [dead]
        for k in keys:
            rows += _rows_of(k)
        perm = _lsd_argsort(rows, cap)
        d_s = dead[perm]
        first = jax.lax.iota(jnp.int32, cap) == 0
        bound = first
        for k in keys:
            k_s = k[perm]
            bound = bound | (k_s != jnp.roll(k_s, 1))
        live_s = d_s == 0
        gid_s = jnp.cumsum((bound & live_s).astype(jnp.int32)) - 1
        ng = (jnp.max(jnp.where(live_s, gid_s, -1)) + 1).astype(jnp.int64)
        sid_sorted = jnp.where(live_s, gid_s.astype(jnp.int64),
                               jnp.int64(cap))
        return ng, perm, (sid_sorted, perm)

    @staticmethod
    def _ids_of(sctx, cap):
        """Per-original-row group id (-1 dead) - the inverse permutation,
        a cap-size scatter; only built when an aggregate needs ids in
        original row order (distinct aggregates)."""
        sid_sorted, rows = sctx
        gid = jnp.where(sid_sorted < cap, sid_sorted, -1)
        return jnp.full(cap, jnp.int64(-1)).at[rows].set(gid)

    def r_groupby_dense(self, ir, spmd: bool = False):
        """Histogram grouping over a combined small domain
        (gdk/gdk_group.c:20-60 strategies 4-5; ops/group.py dense path).
        Aggregates land in domain slots then compact by presence rank -
        the psum-alignable two-phase form (opt_mergetable.c mat_grp).
        SPMD mode: per-shard slot partials are combined across the mesh
        with psum/pmin/pmax (the mat_grp + BATgroupavg3combine shape,
        gdk/gdk_aggr.c:2634) - the whole group-by costs one collective.
        Group keys are decoded from the slot index itself (the slot IS the
        packed key combination), so every shard materializes identical,
        replicated outputs without gathering rows."""
        (_, cir, key_outs, dense_specs, domain, aggs, fetch_keys,
         out_cap, ordinal) = ir
        env, count, mask, cap = self.rel(cir)
        comb_axis = self.axis if (spmd and self.axis is not None) else None
        live = self.live_of(cap, count, mask)
        comb = jnp.zeros(cap, jnp.int64)
        for code_ir, d, _dt in dense_specs:
            code = self._dcode(code_ir, env, live, cap)
            comb = comb * d + code
        safe = jnp.where(live, comb, domain)
        red = _SegReduce(safe, domain, cap)
        if dense_specs:
            # int32 histogram: counts fit int32
            hist = red.sum(live.astype(jnp.int32))
            if comb_axis is not None:
                hist = jax.lax.psum(hist, comb_axis)
            present = hist > 0
            newid = jnp.cumsum(present.astype(jnp.int32)) - 1
            ng = jnp.sum(present.astype(jnp.int64))
        else:
            # scalar aggregation: always exactly one output row, even for
            # empty input (SQL: SELECT sum(x) over nothing -> one nil row)
            present = jnp.ones(1, jnp.bool_)
            newid = jnp.zeros(1, jnp.int32)
            ng = jnp.int64(1)
        if out_cap < max(domain, 1):
            # group-output capacity retry channel (count-then-allocate)
            self.exp_totals[ordinal] = ng if self.axis is None else \
                jax.lax.pmax(ng, self.axis)
        pos = jnp.where(present, newid.astype(jnp.int64), out_cap)

        def compact(slot_vals, fill):
            return jnp.full(out_cap, fill, slot_vals.dtype).at[pos].set(
                slot_vals, mode="drop")

        env2 = {}
        live_out = jax.lax.iota(jnp.int64, out_cap) < ng
        if key_outs:
            # compact rank -> slot index -> key values (mixed-radix decode)
            slot_of = jnp.full(out_cap, jnp.int64(-1)).at[pos].set(
                jax.lax.iota(jnp.int64, domain), mode="drop")
            ok = live_out & (slot_of >= 0)
            rem = jnp.where(ok, slot_of, 0)
            vals = []
            for code_ir, d, dt in reversed(dense_specs):
                code = rem % d
                rem = rem // d
                vals.append(self._decode_dcode(code_ir, code, dt, ok))
            vals.reverse()
            for (key, _e), v in zip(key_outs, vals):
                env2[key] = v
        if fetch_keys:
            # FD-dropped keys: gather from each group's representative
            # row (BATgroup extents; the value is well-defined per group
            # because the key is functionally determined)
            ext_rank = compact(red.first_index(), jnp.int64(-1))
            for key, e in fetch_keys:
                arr = self.ev(e, env, live)
                if arr.ndim == 0:
                    arr = jnp.broadcast_to(arr, (cap,))
                env2[key] = _gather_nil(arr, ext_rank, live_out)
        for key, spec in aggs:
            slot = self._agg_slots(spec, env, live, safe, domain, cap,
                                   comb_axis, red=red)
            if isinstance(slot, tuple):     # wide sum: (lo, hi) limbs
                lo, hi = slot
                env2[key] = compact(lo, _nil_const(lo.dtype))
                env2[_hikey(key)] = compact(hi, jnp.int64(0))
            else:
                env2[key] = compact(slot, _nil_const(slot.dtype))
        return env2, ng, None, out_cap

    def r_groupby_dense_spmd(self, ir):
        return self.r_groupby_dense(ir, spmd=True)

    @staticmethod
    def _decode_dcode(code_ir, code, dt, ok):
        """Inverse of _dcode: slot code -> key value (nil where ~ok)."""
        kind = code_ir[0]
        dtype = np.dtype(dt)
        if kind == "dcode_str":
            d = code_ir[2]
            v = code.astype(jnp.int32)
            ok = ok & (v != d - 1)        # last slot = the nil string
        elif kind == "dcode_bool":
            return ok & (code > 0) if dtype.kind == "b" else \
                jnp.where(ok, code.astype(dtype), _nil_const(dtype))
        elif kind == "dcode_i8":
            v = (code - 128).astype(jnp.int8)
            return jnp.where(ok, v, _nil_const(dtype))
        else:  # dcode_range
            v = (code + code_ir[2]).astype(dtype)
            return jnp.where(ok, v, _nil_const(dtype))
        return jnp.where(ok, v, _nil_const(dtype))

    def r_groupby_sort(self, ir):
        """General grouping: device lexsort + boundary scan (replaces the
        reference's hash strategies; gdk/gdk_group.c:1347 BATgroup)."""
        from ..ops.sort import sort_key
        _, cir, key_outs, sort_keys, aggs, out_cap, ordinal = ir
        env, count, mask, cap = self.rel(cir)
        live = self.live_of(cap, count, mask)
        karrs = []
        for e in sort_keys:
            arr = self.ev(e, env, live)
            if arr.ndim == 0:
                arr = jnp.broadcast_to(arr, (cap,))
            if e[0] == "packcode":
                # already a nonneg order-consistent code; narrow to
                # int32 when the static domain fits (a narrower sort key)
                dom = 1
                for _c, d in e[1]:
                    dom *= d
                if dom < (1 << 31) - 8:
                    arr = arr.astype(jnp.int32)
                karrs.append(arr)
            elif arr.dtype.kind in "ib":
                # grouping needs only a total order with nils grouped:
                # raw integer/code order qualifies, no int64 widening
                karrs.append(arr)
            else:
                karrs.append(sort_key(arr, False, None))
        ng, _rows, sctx = self._sort_ids(karrs, live, cap)
        red = _SegReduce(None, cap, cap, sorted_ctx=sctx)
        # per-original-row ids (a cap-size scatter) only for distinct aggs
        sid = None
        if any(spec[0].endswith("_distinct") for _k, spec in aggs):
            ids = self._ids_of(sctx, cap)
            sid = jnp.where(ids >= 0, ids, cap)
        env2 = {}
        if key_outs:
            ext = red.first_index()
            live_out = jax.lax.iota(jnp.int64, cap) < ng
            for key, e in key_outs:
                arr = self.ev(e, env, live)
                if arr.ndim == 0:
                    arr = jnp.broadcast_to(arr, (cap,))
                env2[key] = _gather_nil(arr, ext, live_out)
        for key, spec in aggs:
            slot = self._agg_slots(spec, env, live, sid, cap, cap,
                                   red=red)
            if isinstance(slot, tuple):     # wide sum: (lo, hi) limbs
                env2[key], env2[_hikey(key)] = slot
            else:
                env2[key] = slot
        # outputs are rank-compacted in [0, ng): slice to the group
        # bucket; ng overflow goes to the count-then-retry channel.
        # Under SPMD the LOCAL cap (shard slice / repartition lanes) may
        # differ from the lowering-time cap - bound by what exists.
        eff = min(out_cap, cap)
        if eff < cap:
            self.exp_totals[ordinal] = ng if self.axis is None else \
                jax.lax.pmax(ng, self.axis)
            env2 = {k: v[:eff] for k, v in env2.items()}
        return env2, ng, None, eff

    def _dcode(self, code_ir, env, live, cap):
        """Column -> code in [0, D) (ops/group.py _codes incl. nil slot)."""
        kind = code_ir[0]
        arr = self.ev(code_ir[1], env, live)
        if arr.ndim == 0:
            arr = jnp.broadcast_to(arr, (cap,))
        if kind == "dcode_str":
            d = code_ir[2]
            c = arr.astype(jnp.int64)
            return jnp.where(c < 0, d - 1, c)
        if kind == "dcode_bool":
            return arr.astype(jnp.int64)
        if kind == "dcode_i8":
            return arr.astype(jnp.int64) + 128
        if kind == "pcode_rangenil":
            # sort-key packing slot for a nullable range: nil -> 0,
            # value -> (v - lo) + 1 (nils-first group order)
            v = arr.astype(jnp.int64)
            return jnp.where(_nilm_arr(arr), jnp.int64(0),
                             v - code_ir[2] + 1)
        # dcode_range
        return arr.astype(jnp.int64) - code_ir[2]

    # aggregates into [0, seg) slots (gdk_aggr.c BATgroupsum family;
    # mirrors ops/aggr.py _seg_reduce + _fix_empty_and_nil).  comb_axis:
    # SPMD mesh axis - per-shard slot partials are combined (psum for
    # sums/counts, pmin/pmax for extrema) before finalization, the
    # associative decomposition the reference uses for partitioned
    # aggregation (BATgroupavg3combine, gdk/gdk_aggr.c:2634).
    def _agg_slots(self, spec, env, live, sid_live, seg, cap,
                   comb_axis: Optional[str] = None, red=None):
        def comb_sum(x):
            return x if comb_axis is None else jax.lax.psum(x, comb_axis)

        if red is None:
            red = _SegReduce(jnp.where(live, sid_live, seg), seg, cap)
        op = spec[0]
        if op == "count_star":
            return comb_sum(red.sum(live.astype(jnp.int64)))
        arr = self.ev(spec[1], env, live)
        if arr.ndim == 0:
            arr = jnp.broadcast_to(arr, (cap,))
        anil = spec[2]
        nilm = _nilm_arr(arr) if anil else jnp.zeros(cap, jnp.bool_)
        use = live & ~nilm
        if op == "count":
            return comb_sum(red.sum(use.astype(jnp.int64)))
        if op in ("count_distinct", "sum_distinct", "avg_distinct"):
            # dedup (group, value) pairs by sort, reduce first occurrences
            # (gdk_aggr.c count-distinct; the fused form of
            # BATgroup-refine + BATgroupcount).  Not shard-combinable:
            # the SPMD rewrite gathers before a distinct aggregate.
            if comb_axis is not None:
                raise Unsupported("distinct aggregate under SPMD combine")
            from ..ops.sort import sort_key
            k1 = jnp.where(use, sid_live, seg).astype(jnp.int64)
            k2 = sort_key(arr, False, None)
            perm = _lsd_argsort([k1.astype(jnp.int32)] + _rows_of(k2),
                                cap)
            k1s, k2s, vs = k1[perm], k2[perm], arr[perm]
            first = (jax.lax.iota(jnp.int32, cap) == 0) | \
                (k1s != jnp.roll(k1s, 1)) | (k2s != jnp.roll(k2s, 1))
            fu = first & (k1s < seg)
            # k1s is sorted by group: reduce via the shared sorted
            # strategy with an identity permutation (no second sort)
            dred = _SegReduce(k1s, seg, cap, sorted_ctx=(
                k1s, jax.lax.iota(jnp.int64, cap)))
            cnt_d = dred.sum(fu.astype(jnp.int64))
            if op == "count_distinct":
                return cnt_d
            if op == "sum_distinct":
                acc_dt = np.dtype(spec[4])
                vals = jnp.where(fu, vs.astype(acc_dt), acc_dt.type(0))
                if spec[5]:   # exact wide accumulation (see "sum" below)
                    v64 = vals.astype(jnp.int64)
                    lo = dred.sum(v64 & 0xFFFFFFFF)
                    hi = dred.sum(v64 >> 32)
                    hi = hi + (lo >> 32)
                    lo = lo & 0xFFFFFFFF
                    lo = jnp.where(cnt_d == 0,
                                   _nil_const(np.dtype(np.int64)), lo)
                    return lo, hi
                out = dred.sum(vals, acc_dt)
                return jnp.where(cnt_d == 0, _nil_const(acc_dt), out)
            # avg_distinct
            scale = spec[4]
            sd = dred.sum(jnp.where(fu, vs.astype(jnp.float64), 0.0))
            if scale:
                sd = sd / (10.0 ** scale)
            a = sd / jnp.maximum(cnt_d, 1)
            return jnp.where(cnt_d == 0, jnp.nan, a)
        cnt = comb_sum(red.sum(use.astype(jnp.int64)))
        if op in ("sum", "prod"):
            acc_dt = np.dtype(spec[4])
            xa = arr.astype(acc_dt)
            if op == "sum":
                vals = jnp.where(use, xa, acc_dt.type(0))
                if spec[5]:
                    # exact int128-range accumulation (the reference's
                    # hge accumulator, gdk/gdk.h:441 + hge sums in
                    # gdk_aggr.c) via paired 32-bit limbs: lo = sum of
                    # the low halves, hi = sum of the arithmetic high
                    # halves; both int64, both psum-combinable, exact
                    # total = hi*2^32 + lo.  Safe to 2^31 rows/group.
                    v64 = vals.astype(jnp.int64)
                    lo = comb_sum(red.sum(v64 & 0xFFFFFFFF))
                    hi = comb_sum(red.sum(v64 >> 32))
                    hi = hi + (lo >> 32)   # carry: lo into [0, 2^32)
                    lo = lo & 0xFFFFFFFF
                    lo = jnp.where(cnt == 0,
                                   _nil_const(np.dtype(np.int64)), lo)
                    return lo, hi
                out = comb_sum(red.sum(vals, acc_dt))
            else:
                vals = jnp.where(use, xa, acc_dt.type(1))
                out = red.prod(vals)
                if comb_axis is not None:
                    # no pprod primitive: gather partial products, reduce
                    out = jnp.prod(
                        jax.lax.all_gather(out, comb_axis), axis=0)
            return jnp.where(cnt == 0, _nil_const(acc_dt), out)
        if op == "avg":
            scale = spec[4]
            if arr.dtype.kind == "f":
                f = comb_sum(red.sum(
                    jnp.where(use, arr.astype(jnp.float64), 0.0)))
            else:
                s = comb_sum(red.sum(
                    jnp.where(use, arr.astype(jnp.int64), 0)))
                f = s.astype(jnp.float64)
            if scale:
                f = f / (10.0 ** scale)
            a = f / jnp.maximum(cnt, 1)
            return jnp.where(cnt == 0, jnp.nan, a)
        if op in ("min", "max"):
            dt = arr.dtype
            if op == "min":
                fill = dt.type(np.inf) if dt.kind == "f" else \
                    dt.type(np.iinfo(dt).max)
                out = red.extreme(jnp.where(use, arr, fill), fill, True)
                if comb_axis is not None:
                    out = jax.lax.pmin(out, comb_axis)
            else:
                fill = dt.type(-np.inf) if dt.kind == "f" else \
                    dt.type(np.iinfo(dt).min)
                out = red.extreme(jnp.where(use, arr, fill), fill, False)
                if comb_axis is not None:
                    out = jax.lax.pmax(out, comb_axis)
            return jnp.where(cnt == 0, _nil_const(dt), out)
        if op == "moment2":
            want, sample, scale = spec[4], spec[5], spec[6]
            xf = jnp.where(use, arr.astype(jnp.float64), 0.0)
            s1 = comb_sum(red.sum(xf))
            s2 = comb_sum(red.sum(xf * xf))
            denom = jnp.maximum(cnt - 1, 1) if sample else jnp.maximum(cnt, 1)
            var = (s2 - s1 * s1 / jnp.maximum(cnt, 1)) / denom
            var = jnp.maximum(var, 0.0)
            if scale:
                var = var / (10.0 ** (2 * scale))
            bad = (cnt <= 1) if sample else (cnt == 0)
            out = jnp.sqrt(var) if want == "std" else var
            return jnp.where(bad, jnp.nan, out)
        raise Unsupported(op)

    # -- expression nodes ---------------------------------------------------
    def ev(self, ir, env, live):
        return getattr(self, "e_" + ir[0])(ir, env, live)

    def e_env(self, ir, env, live):
        return env[(ir[1], ir[2])]

    def e_packcode(self, ir, env, live):
        """Mixed-radix pack of dense key codes into one int64 sort key
        (exact mkey.bulk_rotate_xor_hash role, modules/mal/mkey.c)."""
        cap = live.shape[0]
        comb = None
        for code_ir, d in ir[1]:
            code = self._dcode(code_ir, env, live, cap)
            comb = code if comb is None else comb * d + code
        return comb

    def e_whi(self, ir, env, live):
        """High-limb order key of a wide sum: hi, with the lo nil
        sentinel propagated so nil groups sort by the nulls rule."""
        lo = env[ir[1]]
        hi = env[ir[2]]
        nil = _nil_const(np.dtype(np.int64))
        return jnp.where(lo == nil, nil, hi)

    def e_wnarrow(self, ir, env, live):
        """Wide (int128-range) sum -> int64, exact fits-check.  The limb
        invariant (lo in [0, 2^32), total = hi*2^32 + lo) makes the check
        precise: the value fits int64 iff hi is in [-2^31, 2^31)."""
        lo = env[ir[1]]
        hi = env[ir[2]]
        isnil = lo == _nil_const(np.dtype(np.int64))
        fits = (hi >= -(1 << 31)) & (hi < (1 << 31))
        self.flag_rows(jnp.broadcast_to(live, lo.shape)
                       & ~isnil & ~fits, 4)
        v = hi * (1 << 32) + lo
        return jnp.where(isnil, _nil_const(np.dtype(np.int64)), v)

    def e_in(self, ir, env, live):
        return self.inputs[ir[1]]

    def e_lit(self, ir, env, live):
        return jnp.asarray(np.dtype(ir[2]).type(ir[1]))

    def e_nil(self, ir, env, live):
        return jnp.asarray(_nil_const(ir[1]))

    def e_bool2val(self, ir, env, live):
        p = self.pv(ir[1], env, live)
        return (jnp.broadcast_to(p, live.shape) & live).astype(jnp.int8)

    def e_iarith(self, ir, env, live):
        """Integer/decimal arithmetic with the reference's overflow and
        div-by-zero errors (gdk/gdk_calc_addsub.c ON_OVERFLOW; mirrors
        ops/calc.py _binop) - error checks restricted to *live* rows."""
        _, op, a_ir, b_ir, out_dt, check, anil, bnil = ir
        a = self.ev(a_ir, env, live)
        b = self.ev(b_ir, env, live)
        dt = np.dtype(out_dt)
        nil_in = jnp.zeros(live.shape, jnp.bool_)
        if anil:
            nil_in = nil_in | jnp.broadcast_to(_nilm_arr(a), live.shape)
        if bnil:
            nil_in = nil_in | jnp.broadcast_to(_nilm_arr(b), live.shape)
        valid = live & ~nil_in
        ai = a.astype(dt)
        bi = b.astype(dt)
        if op == "add":
            res = ai + bi
            if check:
                ovf = ((ai ^ res) & (bi ^ res)) < 0
                self.flag_rows(valid & ovf, 1)
        elif op == "sub":
            res = ai - bi
            if check:
                ovf = ((ai ^ bi) & (ai ^ res)) < 0
                self.flag_rows(valid & ovf, 1)
        elif op == "mul":
            res = ai * bi
            if check:
                if dt.itemsize < 8:
                    wide = ai.astype(jnp.int64) * bi.astype(jnp.int64)
                    ovf = wide != res.astype(jnp.int64)
                else:
                    bz = bi == 0
                    q = jax.lax.div(res, jnp.where(bz, dt.type(1), bi))
                    ovf = (~bz) & (q != ai)
                    ovf = ovf | ((ai == jnp.iinfo(jnp.int64).min) & (bi == -1))
                self.flag_rows(valid & ovf, 1)
        elif op == "div":
            bz = bi == 0
            res = jax.lax.div(ai, jnp.where(bz, dt.type(1), bi))
            self.flag_rows(valid & bz, 2)
            if check:
                ovf = (ai == np.iinfo(dt).min) & (bi == -1)
                self.flag_rows(valid & ovf, 1)
        elif op == "mod":
            bz = bi == 0
            res = jax.lax.rem(ai, jnp.where(bz, dt.type(1), bi))
            self.flag_rows(valid & bz, 2)
        else:
            raise Unsupported(op)
        return jnp.where(valid, res, _nil_const(dt))

    def e_farith(self, ir, env, live):
        _, op, a_ir, b_ir, _anil, _bnil = ir
        a = self.ev(a_ir, env, live).astype(jnp.float64)
        b = self.ev(b_ir, env, live).astype(jnp.float64)
        if op == "add":
            return a + b
        if op == "sub":
            return a - b
        if op == "mul":
            return a * b
        if op == "mod":
            bz = b == 0
            return jnp.where(bz, jnp.nan,
                             a - jnp.trunc(a / jnp.where(bz, 1.0, b)) * b)
        raise Unsupported(op)

    def e_fdiv(self, ir, env, live):
        _, _op, a_ir, b_ir, anil, bnil = ir
        a = self.ev(a_ir, env, live).astype(jnp.float64)
        b = self.ev(b_ir, env, live).astype(jnp.float64)
        nil_in = jnp.zeros(live.shape, jnp.bool_)
        if anil:
            nil_in = nil_in | jnp.broadcast_to(jnp.isnan(a), live.shape)
        if bnil:
            nil_in = nil_in | jnp.broadcast_to(jnp.isnan(b), live.shape)
        bz = b == 0
        self.flag_rows(live & ~nil_in &
                       jnp.broadcast_to(bz, live.shape), 2)
        res = a / jnp.where(bz, 1.0, b)
        return jnp.where(jnp.broadcast_to(bz, res.shape) if res.ndim
                         else bz, jnp.nan, res)

    def e_tofloat(self, ir, env, live):
        _, a_ir, scale, anil, _dt = ir
        a = self.ev(a_ir, env, live)
        if a.dtype.kind == "f":
            return a.astype(jnp.float64)
        f = a.astype(jnp.float64)
        if scale:
            f = f / (10.0 ** scale)
        if anil or a.dtype.kind == "i":
            f = jnp.where(_nilm_arr(a), jnp.nan, f)
        return f

    def e_upscale(self, ir, env, live):
        _, a_ir, k, anil, _dt, _check = ir
        a = self.ev(a_ir, env, live)
        x = a.astype(jnp.int64) * (10 ** k)
        nilm = _nilm_arr(a)
        return jnp.where(nilm, jnp.int64(np.iinfo(np.int64).min), x)

    def e_convert(self, ir, env, live):
        """gdk/gdk_calc_convert.c semantics (mirrors ops/calc.py _convert):
        float->int rounds half away from zero, integer downscale rounds
        half away, narrowing range-checked (error 3)."""
        _, a_ir, out_dt, up, down, check, anil, _in_dt, from_dec, _to_dec = ir
        a = self.ev(a_ir, env, live)
        dt = np.dtype(out_dt)
        nilm = _nilm_arr(a) if (anil or a.dtype.kind in "if") else \
            jnp.zeros(a.shape, jnp.bool_)
        valid = live & ~jnp.broadcast_to(nilm, live.shape)
        if a.dtype.kind == "f" and dt.kind == "i":
            xs = a * (10 ** up) if up else a
            r = jnp.where(xs >= 0, jnp.floor(xs + 0.5), jnp.ceil(xs - 0.5))
            if check:
                lo = float(np.iinfo(dt).min + 1)
                hi = float(np.iinfo(dt).max)
                bad = valid & jnp.broadcast_to((r < lo) | (r > hi),
                                               live.shape)
                self.flag_rows(bad, 3)
            res = r.astype(dt)
        else:
            x = a.astype(jnp.int64) if (a.dtype.kind == "i" and
                                        (up or down)) else a
            if up:
                x = x * (10 ** up)
            if a.dtype.kind == "i" and dt.kind == "f" and down:
                res = a.astype(dt) / (10 ** down)
            else:
                if down:
                    d = 10 ** down
                    half = d // 2
                    x = jnp.where(x >= 0, (x + half) // d,
                                  -((-x + half) // d))
                if check and a.dtype.kind == "i" and dt.kind == "i" \
                        and dt.itemsize < 8:
                    lo = np.iinfo(dt).min + 1
                    hi = np.iinfo(dt).max
                    bad = valid & jnp.broadcast_to((x < lo) | (x > hi),
                                                   live.shape)
                    self.flag_rows(bad, 3)
                res = x.astype(dt)
        nilv = _nil_const(dt)
        return jnp.where(jnp.broadcast_to(nilm, res.shape) if res.ndim
                         else nilm, nilv, res)

    def e_lutmap(self, ir, env, live):
        _, lut_i, a_ir, out_dt = ir
        lut = self.inputs[lut_i]
        a = self.ev(a_ir, env, live)
        if lut.shape[0] == 0:      # empty dict: every code is nil
            nil = _nil_const(np.dtype(out_dt))
            return jnp.full(a.shape, nil)
        ok = a >= 0
        out = lut[jnp.where(ok, a, 0)]
        return jnp.where(ok, out, _nil_const(np.dtype(out_dt)))

    def e_lutmap_keepnil(self, ir, env, live):
        _, lut_i, a_ir = ir
        lut = self.inputs[lut_i]
        a = self.ev(a_ir, env, live)
        if lut.shape[0] == 0:      # empty dict: no valid codes exist
            return jnp.minimum(a, jnp.asarray(-1, a.dtype))
        ok = a >= 0
        return jnp.where(ok, lut[jnp.where(ok, a, 0)], a)

    def e_case(self, ir, env, live):
        _, whens, default, out_dt = ir
        dt = np.dtype(out_dt)
        # branch-selection masks: errors (div-zero/overflow) inside a
        # branch only fire for rows that actually take it (the
        # reference's per-row lazy CASE, SF-2893484)
        preds = []
        taken = jnp.zeros(live.shape, jnp.bool_)
        sels = []
        for p_ir, _v in whens:
            p = jnp.broadcast_to(self.pv(p_ir, env, live), live.shape)
            preds.append(p)
            sels.append(p & ~taken)
            taken = taken | p
        outer = self._vmask

        def under(sel, f):
            self._vmask = sel if outer is None else (outer & sel)
            try:
                return f()
            finally:
                self._vmask = outer
        res = under(~taken,
                    lambda: self.ev(default, env, live)).astype(dt)
        for (p_ir, v_ir), p, sel in zip(reversed(whens),
                                        reversed(preds),
                                        reversed(sels)):
            v = under(sel,
                      lambda v_ir=v_ir: self.ev(v_ir, env, live)
                      ).astype(dt)
            res = jnp.where(p, v, res)
        return res

    def e_ifnil(self, ir, env, live):
        _, a_ir, b_ir, out_dt = ir
        dt = np.dtype(out_dt)
        a = self.ev(a_ir, env, live).astype(dt)
        isnil = _nilm_arr(a)
        # COALESCE fallback is lazy per row (see e_case error masking)
        outer = self._vmask
        sel = jnp.broadcast_to(isnil, live.shape)
        self._vmask = sel if outer is None else (outer & sel)
        try:
            b = self.ev(b_ir, env, live).astype(dt)
        finally:
            self._vmask = outer
        return jnp.where(isnil, b, a)

    def e_nullif(self, ir, env, live):
        _, p_ir, a_ir, dt = ir
        p = self.pv(p_ir, env, live)
        a = self.ev(a_ir, env, live)
        return jnp.where(p, _nil_const(np.dtype(dt)), a)

    def e_unop(self, ir, env, live):
        _, name, a_ir, dt, anil = ir
        a = self.ev(a_ir, env, live)
        res = -a if name == "neg" else jnp.abs(a)
        if anil or a.dtype.kind == "i":
            res = jnp.where(_nilm_arr(a), _nil_const(a.dtype), res)
        return res

    def e_math(self, ir, env, live):
        _, fn, a_ir = ir
        x = self.ev(a_ir, env, live)
        f = {"sqrt": jnp.sqrt, "ln": jnp.log, "log10": jnp.log10,
             "exp": jnp.exp, "sin": jnp.sin, "cos": jnp.cos,
             "tan": jnp.tan, "floor": jnp.floor, "ceil": jnp.ceil}[fn]
        return f(x)

    def e_pow(self, ir, env, live):
        return self.ev(ir[1], env, live) ** self.ev(ir[2], env, live)

    def e_dextract(self, ir, env, live):
        from ..ops.datecalc import _extract
        _, field, a_ir, is_ts, anil = ir
        a = self.ev(a_ir, env, live)
        cap = a.shape[0] if a.ndim else 1
        out = _extract(a if a.ndim else a[None], jnp.int64(cap),
                       field=field, is_ts=is_ts, may_nil=True)
        nil64 = jnp.int64(np.iinfo(np.int64).min)
        if field == "epoch":
            return out if a.ndim else out[0]
        out32 = jnp.where(out == nil64,
                          jnp.int64(np.iinfo(np.int32).min),
                          out).astype(jnp.int32)
        return out32 if a.ndim else out32[0]

    def e_textract(self, ir, env, live):
        _, field, a_ir, _anil = ir
        us = self.ev(a_ir, env, live)
        nil64 = jnp.int64(np.iinfo(np.int64).min)
        nil_in = us == nil64
        if field == "hour":
            out = us // 3_600_000_000
        elif field == "minute":
            out = (us // 60_000_000) % 60
        elif field == "second":
            out = (us // 1_000_000) % 60
        else:  # epoch
            out = us // 1_000_000
        out = jnp.where(nil_in, nil64, out)
        if field == "epoch":
            return out
        return jnp.where(out == nil64, jnp.int64(np.iinfo(np.int32).min),
                         out).astype(jnp.int32)

    def e_dtrunc(self, ir, env, live):
        from ..ops.datecalc import _trunc
        _, field, a_ir, is_ts, _anil = ir
        a = self.ev(a_ir, env, live)
        cap = a.shape[0] if a.ndim else 1
        out = _trunc(a if a.ndim else a[None], jnp.int64(cap),
                     field=field, is_ts=is_ts, may_nil=True)
        return out if a.ndim else out[0]

    # -- predicate nodes (raw booleans; consumer ANDs liveness) --------------
    def pv(self, ir, env, live):
        return getattr(self, "p_" + ir[0])(ir, env, live)

    def p_ptrue(self, ir, env, live):
        return jnp.bool_(True)

    def p_pfalse(self, ir, env, live):
        return jnp.bool_(False)

    def p_and(self, ir, env, live):
        parts = [self.pv(p, env, live) for p in ir[1]]
        out = parts[0]
        for p in parts[1:]:
            out = out & p
        return out

    def p_or(self, ir, env, live):
        parts = [self.pv(p, env, live) for p in ir[1]]
        out = parts[0]
        for p in parts[1:]:
            out = out | p
        return out

    def p_not(self, ir, env, live):
        return ~self.pv(ir[1], env, live)

    def p_cmp(self, ir, env, live):
        _, op, a_ir, b_ir, anil, bnil, _dt = ir
        a = self.ev(a_ir, env, live)
        b = self.ev(b_ir, env, live)
        raw = {"eq": a == b, "ne": a != b, "lt": a < b, "le": a <= b,
               "gt": a > b, "ge": a >= b}[op]
        guard = jnp.bool_(True)
        if anil:
            guard = guard & ~_nilm_arr(a)
        if bnil:
            guard = guard & ~_nilm_arr(b)
        return raw & guard

    def p_rangesel(self, ir, env, live):
        """BATselect scan kernel (gdk/gdk_select.c:964 scan_sel; mirrors
        ops/select.py _range_mask minus the liveness term)."""
        _, a_ir, mode, lo, hi, li, hi_incl, guard, _dt = ir
        x = self.ev(a_ir, env, live)
        dt = x.dtype
        tl = dt.type(lo)
        th = dt.type(hi)
        if mode == "eq":
            m = x == tl
        elif mode == "ne":
            m = x != tl
        elif mode == "lt":
            m = x < tl
        elif mode == "le":
            m = x <= tl
        elif mode == "gt":
            m = x > tl
        elif mode == "ge":
            m = x >= tl
        elif mode == "between":
            m = ((x >= tl) if li else (x > tl)) & \
                ((x <= th) if hi_incl else (x < th))
        elif mode == "anti_between":
            m = ((x < tl) if li else (x <= tl)) | \
                ((x > th) if hi_incl else (x >= th))
        else:
            raise Unsupported(mode)
        if guard:
            m = m & ~_nilm_arr(x)
        return m

    def p_isnilp(self, ir, env, live):
        return _nilm_arr(self.ev(ir[1], env, live))

    def p_notnilp(self, ir, env, live):
        return ~_nilm_arr(self.ev(ir[1], env, live))

    def p_strpred(self, ir, env, live):
        _, lut_i, a_ir = ir
        lut = self.inputs[lut_i]
        codes = self.ev(a_ir, env, live)
        ok = codes >= 0
        if lut.shape[0] == 0:
            # empty dictionary (all-nil / empty column): nothing matches
            return jnp.zeros(codes.shape, jnp.bool_)
        return lut[jnp.where(ok, codes, 0)] & ok

    def p_inints(self, ir, env, live):
        _, a_ir, vals, _dt = ir
        x = self.ev(a_ir, env, live)
        m = jnp.zeros(x.shape, jnp.bool_)
        for v in vals:
            m = m | (x == x.dtype.type(v))
        return m

    def p_asbool(self, ir, env, live):
        x = self.ev(ir[1], env, live)
        if x.dtype.kind == "b":
            return x
        return x == 1


# ---------------------------------------------------------------------------
# jit entry points + host orchestration
# ---------------------------------------------------------------------------


def _root_compact(itp, rel_ir, out_keys, out_cap):
    """Run the plan and compact the result to out_cap (shared by the
    single-device and SPMD entry points)."""
    env, count, mask, cap = itp.rel(rel_ir)
    if mask is None:
        nlive = count
        arrays = tuple(env[k][:out_cap] for k in out_keys)
    else:
        live = itp.live_of(cap, count, mask)
        oids, nlive, live_out = _compact_oids(live, out_cap)
        arrays = tuple(_gather_nil(env[k], oids, live_out) for k in out_keys)
    return itp.err(), itp.exp_totals, nlive, arrays


@functools.partial(jax.jit, static_argnames=("ir",))
def _run_single(ir, inputs):
    """Whole plan + result compaction in ONE dispatch (final capacity is
    small enough to fetch padded)."""
    rel_ir, out_keys, out_cap = ir
    return _root_compact(_Interp(inputs), rel_ir, out_keys, out_cap)


@functools.partial(jax.jit, static_argnames=("ir",))
def _run_raw(ir, inputs):
    """Whole plan, results left at native capacity on device (the host
    syncs the count, then compacts with a tight capacity - 2 RPCs total)."""
    rel_ir, out_keys = ir
    itp = _Interp(inputs)
    env, count, mask, cap = itp.rel(rel_ir)
    if mask is None:
        live = None
        nlive = count
    else:
        live = itp.live_of(cap, count, mask)
        nlive = jnp.sum(live.astype(jnp.int64))
    arrays = tuple(env[k] for k in out_keys)
    return itp.err(), itp.exp_totals, nlive, live, arrays


def _compact_oids(live, out_cap: int):
    """Compaction map: oids[r] = index of the (r+1)-th live row, -1 past
    the live count (the virtualize role, gdk/gdk_select.c:30).  One
    rank-indexed scatter-set (unique indices - XLA keeps it parallel);
    measured faster to compile AND run than the searchsorted form."""
    cap = live.shape[0]
    csum = jnp.cumsum(live.astype(jnp.int32))
    nlive = (csum[-1] if cap else jnp.int32(0)).astype(jnp.int64)
    pos = jnp.where(live, csum - 1, out_cap)
    oids = jnp.full(out_cap, jnp.int32(-1)).at[pos].set(
        jax.lax.iota(jnp.int32, cap), mode="drop")
    live_out = jax.lax.iota(jnp.int64, out_cap) < nlive
    return oids, nlive, live_out


@functools.partial(jax.jit, static_argnames=("out_cap",))
def _finish_mask(live, arrays, *, out_cap: int):
    oids, _nlive, live_out = _compact_oids(live, out_cap)
    return tuple(_gather_nil(a, oids, live_out) for a in arrays)


@functools.partial(jax.jit, static_argnames=("out_cap",))
def _finish_slice(arrays, *, out_cap: int):
    return tuple(a[:out_cap] for a in arrays)


# ---------------------------------------------------------------------------
# SPMD execution over a device mesh - the reference's mitosis + mergetable
# pipeline (opt_mitosis.c:21 slices every eligible plan across workers;
# opt_mergetable.c:15-27 replicates operators per piece and two-phase-
# combines aggregates; mat.c:124 packs the pieces).  Here: the largest
# scanned table is row-sharded over the mesh, the mask-carrying operator
# pipeline runs shard-local, dense group-bys combine slot partials with
# psum across devices, and order/limit/distinct/build-side barriers
# all_gather.
# ---------------------------------------------------------------------------


def _ir_cap(ir, nsh: int, counts=None) -> int:
    """Static per-shard row-count bound of a (rewritten) plan IR subtree -
    mirrors the interpreter's cap propagation, tightened by actual scan
    row counts when known; drives the repartition lane-capacity guess and
    the broadcast-vs-shuffle cost pick (the role of the reference's
    joincost row estimates, gdk/gdk_join.c:3586)."""
    k = ir[0]
    if k in ("scan", "scan_sharded"):
        c = ir[3]
        if counts is not None and ir[2] in counts:
            c = min(c, max(counts[ir[2]], 1))
        # sharded scans hold a row-range slice; live rows are a prefix of
        # the capacity, so one shard holds at most min(cap/nsh, count)
        return c if k == "scan" else max(min(ir[3] // nsh, c), 1)
    if k in ("rename", "filter", "project", "orderby", "distinct"):
        return _ir_cap(ir[1], nsh, counts)
    if k == "compact":
        return ir[2]
    if k == "gather":
        return _ir_cap(ir[1], nsh, counts) * nsh
    if k == "repartition":
        return ir[3] * nsh
    if k == "limit":
        return ir[4]
    if k == "groupby_sort":
        return ir[5]
    if k in ("groupby_dense", "groupby_dense_spmd"):
        return ir[7]
    if k == "join":
        return _ir_cap(ir[2], nsh, counts)
    if k == "join_expand":
        return ir[9]
    raise Unsupported(f"spmd cap: {k}")


def _ir_rows(ir, counts=None) -> int:
    """Static GLOBAL row-count bound of a subtree (sums over shards -
    differs from _ir_cap at sharded/gathered nodes)."""
    k = ir[0]
    if k in ("scan", "scan_sharded"):
        c = ir[3]
        if counts is not None and ir[2] in counts:
            c = min(c, max(counts[ir[2]], 1))
        return c
    if k in ("rename", "filter", "project", "orderby", "distinct",
             "gather", "repartition"):
        return _ir_rows(ir[1], counts)
    if k == "compact":
        return min(_ir_rows(ir[1], counts), ir[2])
    if k == "limit":
        return ir[4]
    if k == "groupby_sort":
        return ir[5]
    if k in ("groupby_dense", "groupby_dense_spmd"):
        return ir[7]
    if k == "join":
        return _ir_rows(ir[2], counts)
    if k == "join_expand":
        return ir[9]
    raise Unsupported(f"spmd rows: {k}")


class _SpmdRewriter:
    """Single-device plan IR -> mesh IR (the reference's mitosis +
    mergetable pipeline as one pass).  ``rw`` returns (ir', dist) with
    dist in {"shard", "repl"}: whether the node's rows live sharded over
    the mesh axis or replicated on every device.

    Distribution strategy per consumer of a sharded subtree:
    * orderby/limit: all_gather barrier (mat.pack before the
      order-sensitive consumer).
    * join build sides: cost pick - small builds broadcast (all_gather);
      large builds hash-repartition BOTH sides through the ragged
      all-to-all exchange so each device joins only the keys it owns.
      This is the partitioned shuffle the reference lacks (its remote
      joins ship whole columns to one site, modules/mal/remote.c:971
      RMTput, design note remote.c:13-58).
    * group-by/distinct: dense small domains psum slot partials
      (two-phase, opt_mergetable.c:15-27); high-cardinality sorts and
      distinct aggregates repartition by key hash so groups are wholly
      shard-owned and every aggregate (incl. DISTINCT) runs local.
    """

    def __init__(self, sharded: frozenset, nsh: int,
                 lane_caps: Dict[int, int], counts=None):
        self.sharded = sharded
        self.nsh = nsh
        self.scan_rows = counts               # cnt input idx -> real rows
        self.lane_caps = lane_caps            # ordinal -> lane cap override
        self.lane_used: Dict[int, int] = {}   # ordinal -> lane cap used
        self.counts = {"shuffle_joins": 0, "shuffle_groupbys": 0,
                       "shuffle_distincts": 0}
        self._ord = 0
        self.bcast_rows = int(config.get("spmd_broadcast_rows"))
        self.min_rows = int(config.get("spmd_shuffle_min_rows"))

    def _repart(self, ir, keyspec):
        """Wrap ir in a hash-repartition exchange node.  The lane
        capacity starts at ~4x the uniform-hash mean and is corrected by
        the host retry loop from the measured max lane (the engine-wide
        count-then-allocate two-phase-shape discipline)."""
        o = self._ord
        self._ord += 1
        cap = _ir_cap(ir, self.nsh, self.scan_rows)
        default = capacity_for(max(4 * cap // max(self.nsh, 1), 256))
        lane = self.lane_caps.get(o, default)
        self.lane_used[o] = lane
        return ("repartition", ir, keyspec, int(lane), o)

    def rw(self, ir):
        k = ir[0]
        if k == "scan":
            if ir[1][0][1] in self.sharded:
                return ("scan_sharded",) + ir[1:], "shard"
            return ir, "repl"
        if k == "rename":
            c, d = self.rw(ir[1])
            return ("rename", c, ir[2]), d
        if k in ("filter", "project"):
            c, d = self.rw(ir[1])
            return (k, c) + ir[2:], d
        if k == "compact":
            # shard-local compaction: each shard packs its own live rows
            c, d = self.rw(ir[1])
            return (k, c) + ir[2:], d
        if k in ("orderby", "limit"):
            # global-order barriers: gather the shards first
            c, d = self.rw(ir[1])
            if d == "shard":
                c = ("gather", c)
            return (k, c) + ir[2:], "repl"
        if k == "distinct":
            c, d = self.rw(ir[1])
            if d == "shard" and ir[2] and \
                    _ir_cap(c, self.nsh, self.scan_rows) >= self.min_rows:
                keys = tuple(e for e, _d, _n in ir[2])
                c = self._repart(c, ("keys", keys))
                self.counts["shuffle_distincts"] += 1
                return ("distinct", c) + ir[2:], "shard"
            if d == "shard":
                c = ("gather", c)
            return ("distinct", c) + ir[2:], "repl"
        if k == "groupby_sort":
            c, d = self.rw(ir[1])
            if d == "shard" and ir[3] and \
                    _ir_cap(c, self.nsh, self.scan_rows) >= self.min_rows:
                # repartition by group-key hash: every group is wholly
                # owned by one shard, so the sort-group and ALL its
                # aggregates (incl. avg/distinct) run shard-local with
                # no combine step
                c = self._repart(c, ("keys", ir[3]))
                self.counts["shuffle_groupbys"] += 1
                return ("groupby_sort", c) + ir[2:], "shard"
            if d == "shard":
                c = ("gather", c)
            return ("groupby_sort", c) + ir[2:], "repl"
        if k == "groupby_dense":
            c, d = self.rw(ir[1])
            if d == "shard":
                if ir[6] or any(spec[0].endswith("_distinct")
                                for _key, spec in ir[5]):
                    # FD-fetched keys need a shard-local representative
                    # row per whole group, and distinct aggregates need
                    # per-group global value sets: repartition by group
                    # key when big enough, else gather
                    if ir[3] and _ir_cap(c, self.nsh,
                                         self.scan_rows) >= self.min_rows:
                        keys = tuple(ci[1] for ci, _d, _dt in ir[3])
                        c = self._repart(c, ("keys", keys))
                        self.counts["shuffle_groupbys"] += 1
                        return ("groupby_dense", c) + ir[2:], "shard"
                    return ("groupby_dense", ("gather", c)) + ir[2:], \
                        "repl"
                return ("groupby_dense_spmd", c) + ir[2:], "repl"
            return ("groupby_dense", c) + ir[2:], "repl"
        if k in ("join", "join_expand"):
            l, dl = self.rw(ir[2])
            r, dr = self.rw(ir[3])
            if dr == "shard":
                bglobal = _ir_rows(r, self.scan_rows)
                if dl == "shard" and bglobal > self.bcast_rows:
                    # partitioned shuffle join: exchange both sides by
                    # join-key hash, then join shard-locally
                    keyspecs = ir[4]
                    l = self._repart(l, ("join", keyspecs, "l"))
                    r = self._repart(r, ("join", keyspecs, "r"))
                    self.counts["shuffle_joins"] += 1
                else:
                    # broadcast join: every device gets the full build
                    r = ("gather", r)
            return ir[:2] + (l, r) + ir[4:], dl
        raise Unsupported(f"spmd rewrite: {k}")


_SPMD_CACHE: Dict[tuple, object] = {}


def _spmd_callable(ir_bundle, mesh, shard_flags: tuple,
                   repcheck: bool = False):
    """jit(shard_map(plan)) cached by (IR, mesh, input sharding).

    ``repcheck`` (config assert_props, the GDKdebug analog) returns every
    output with a leading per-device axis instead of collapsing to one
    replica, so the caller can assert cross-device replication at runtime
    — the dynamic version of the static vma check disabled below.
    """
    key = (ir_bundle, mesh, shard_flags, repcheck)
    fn = _SPMD_CACHE.get(key)
    if fn is not None:
        return fn
    from jax.sharding import PartitionSpec as P
    axis = mesh.axis_names[0]
    nsh = int(mesh.shape[axis])
    rel_ir, out_keys, out_cap = ir_bundle

    def f(inputs):
        itp = _Interp(inputs, axis=axis, nsh=nsh)
        out = _root_compact(itp, rel_ir, out_keys, out_cap)
        if repcheck:
            return jax.tree.map(lambda v: v[None], out)
        return out

    in_specs = (tuple(P(axis) if s else P() for s in shard_flags),)
    # outputs are replicated by construction (psum-combined aggregates or
    # all_gather-ed rows + deterministic per-device compute); the static
    # vma checker cannot infer replication through all_gather, so it is
    # disabled and P() takes the (identical) per-device value
    out_specs = P(axis) if repcheck else P()
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False))
    _SPMD_CACHE[key] = fn
    return fn


def _raise_err(code: int):
    from ..ops.calc import CalcDivZero, CalcOverflow
    if code == 0:
        return
    if code == 1:
        raise CalcOverflow("22003!overflow in calculation")
    if code == 2:
        raise CalcDivZero("22012!division by zero")
    if code == 3:
        raise CalcOverflow("22003!value exceeds limits of type")
    if code == 4:
        raise CalcOverflow("22003!overflow in sum aggregate")
    raise CalcOverflow(f"22003!error {code}")


@dataclasses.dataclass
class FragmentResult:
    count: int
    arrays: List[np.ndarray]   # live prefix = rows [0, count)
    pts: List[PT]              # one per result column (≤ len(arrays))
    #: column index -> index (into arrays) of its high-limb companion
    #: for wide (int128-range) sums; exact value = hi*2^32 + lo
    wide: Dict[int, int] = dataclasses.field(default_factory=dict)


#: per-plan memo: naive plan IR -> {join ordinal: expansion capacity} for
#: joins whose build side proved non-unique (the reference discovers the
#: same thing from hash stats, gdk/gdk_join.c joincost). Guarded by _LOCK.
_JOIN_MEMO: Dict[tuple, Dict[int, int]] = {}

#: disk-persisted expand/bucket memo: measured expanding-join totals,
#: group-output buckets and compaction capacities survive process
#: restarts (else every fresh process re-lowers with defaults, and the
#: post-measurement shrink forces one cold XLA compile per query per
#: process - the persistent compile cache only helps if the IR is
#: byte-identical), so the memo lives beside that cache.  Keyed by a
#: digest of the naive plan IR; scan capacities are part of that IR, so
#: different datasets never collide.  MTPU_EXPAND_MEMO=0 disables it.
_MEMO_PATH = os.environ.get(
    "MTPU_EXPAND_MEMO",
    os.path.join(config.compile_cache_dir(), "expand_memo.json"))
if _MEMO_PATH in ("0", "off", ""):
    _MEMO_PATH = None
_DISK_MEMO: Optional[dict] = None


def _memo_digest(plan_key) -> str:
    import hashlib
    return hashlib.sha256(repr(plan_key).encode()).hexdigest()


def _memo_disk_get(plan_key) -> Optional[Dict[int, Optional[int]]]:
    global _DISK_MEMO
    import json
    if _MEMO_PATH is None:
        return None
    if _DISK_MEMO is None:
        try:
            with open(_MEMO_PATH) as f:
                _DISK_MEMO = json.load(f)
        except Exception:
            _DISK_MEMO = {}
    d = _DISK_MEMO.get(_memo_digest(plan_key))
    if d is None:
        return None
    return {int(o): v for o, v in d.items()}


def _memo_disk_put(plan_key, expand: Dict[int, Optional[int]]) -> None:
    global _DISK_MEMO
    import json
    import os as _os
    if _MEMO_PATH is None:
        return
    if _DISK_MEMO is None:
        _memo_disk_get(plan_key)
    _DISK_MEMO[_memo_digest(plan_key)] = {str(o): v
                                          for o, v in expand.items()}
    try:
        _os.makedirs(_os.path.dirname(_MEMO_PATH) or ".", exist_ok=True)
        tmp = _MEMO_PATH + f".{_os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(_DISK_MEMO, f)
        _os.replace(tmp, _MEMO_PATH)
    except Exception:
        pass

import threading as _threading

_LOCK = _threading.Lock()

#: observability: how many plans ran fused vs fell back (engine increments
#: "fallback"); tests use this to prove the fused path actually executed.
#: "uniq_retries"/"cap_retries" count expanding-join re-lowerings.
STATS = {"runs": 0, "fallbacks": 0, "uniq_retries": 0, "cap_retries": 0,
         "spmd_runs": 0,
         # SPMD plans that exchanged rows through the ragged all-to-all
         # (hash-partitioned joins / group-bys / distincts) instead of
         # broadcast-gathering - tests assert the shuffle path executed
         "shuffle_joins": 0, "shuffle_groupbys": 0, "shuffle_distincts": 0}


def stats_inc(key: str, n: int = 1) -> None:
    with _LOCK:
        STATS[key] += n


class CompiledFragment:
    """A lowered plan ready to execute (the engine's plan-cache value; the
    reference's query-cache entry, sql/server/sql_qc.c).  Holds the input
    device arrays by reference - validity is pinned by the engine cache
    checking table identity."""

    def __init__(self, catalog, rel: L.Rel, out_names: List[str]):
        import time as _time
        t0 = _time.perf_counter()
        self.catalog = catalog
        self.rel = rel
        self.out_names = list(out_names)
        self._lower({})
        self.plan_key = self.rel_ir       # naive IR identifies the plan
        with _LOCK:
            memo = dict(_JOIN_MEMO.get(self.plan_key, ()))
        if not memo:
            memo = _memo_disk_get(self.plan_key) or {}
        if memo:
            self._lower(memo)
        self.lower_ms = (_time.perf_counter() - t0) * 1e3

    def _lower(self, expand: Dict[int, int]) -> None:
        low = Lowering(self.catalog, expand=expand)
        low.collect_refs(self.rel)
        rel_ir, penv, cap = low.rel(self.rel)
        out_keys, pts = [], []
        for name in self.out_names:
            if ("#out", name) in penv:
                key = ("#out", name)
            else:
                hits = [k for k in penv if k[1] == name]
                if len(hits) != 1:
                    raise Unsupported(f"ambiguous output column {name}")
                key = hits[0]
            out_keys.append(key)
            pts.append(penv[key])
        # wide sums ship both limb arrays: hi companions ride after the
        # column arrays; decode recombines exactly (engine._decode_wide)
        wide: Dict[int, int] = {}
        for i, (key, pt) in enumerate(zip(list(out_keys), pts)):
            if pt.wide:
                wide[i] = len(out_keys)
                out_keys.append(_hikey(key))
        self.wide = wide
        self.expand = expand
        self.expand_used = dict(low.expand_used)
        self.rel_ir = rel_ir
        self.inputs = tuple(low.inputs)
        self.input_tables = list(low.input_tables)
        self.scan_counts = dict(low.scan_counts)
        self.out_keys = tuple(out_keys)
        self.pts = pts
        self.cap = cap

    def _memoize(self) -> None:
        with _LOCK:
            _JOIN_MEMO[self.plan_key] = dict(self.expand)
        _memo_disk_put(self.plan_key, dict(self.expand))

    def _pick_shard_inputs(self, nsh: int,
                           require_min: bool = False) -> Optional[frozenset]:
        """Input indices of the tables to row-shard: every scanned table
        large enough to split over the mesh (the reference shards every
        eligible bind, opt_mitosis.c:21; small tables stay replicated
        like its non-partitioned sides).  With an explicit mesh the
        largest table is always sharded so even small-table plans
        exercise the mesh; session auto-meshes set ``require_min`` so
        plans with no table ≥ spmd_min_shard_rows stay single-device
        (the reference's MIN_PART_SIZE gate, opt_mitosis.c:17)."""
        caps: Dict[str, int] = {}
        idxs: Dict[str, set] = {}
        for i, tname in enumerate(self.input_tables):
            if tname is None:
                continue
            caps[tname] = self.inputs[i].shape[0]
            idxs.setdefault(tname, set()).add(i)
        min_rows = int(config.get("spmd_min_shard_rows"))
        best = None
        chosen = set()
        for tname, cap in caps.items():
            if cap % nsh or cap < nsh:
                continue
            if best is None or cap > caps[best]:
                best = tname
            if cap >= min_rows:
                chosen.add(tname)
        if best is None or (require_min and not chosen):
            return None
        chosen.add(best)
        return frozenset(i for t in chosen for i in idxs[t])

    def _run_spmd(self, mesh, events: Optional[list],
                  require_min: bool = False) -> FragmentResult:
        """Execute over a device mesh: SQL in, SPMD out.  The same retry
        discipline as the single-device path (non-unique build discovery,
        expansion-capacity overflow) applies."""
        import time as _time
        if len(mesh.axis_names) != 1:
            raise Unsupported("spmd fragment needs a 1-D mesh")
        nsh = int(mesh.shape[mesh.axis_names[0]])
        if nsh <= 1:
            raise Unsupported("single-device mesh")
        picked = self._pick_shard_inputs(nsh, require_min)
        if picked is None:
            raise Unsupported("no shardable scan for the mesh")
        if require_min:
            # auto-mesh cost gate: SPMD pays off when the plan *reduces*
            # (group-by/top-n/selective join) — if the root result is on
            # the order of the sharded input, the final all_gather ships
            # ~everything to every device and single-device wins (the
            # gather cost the reference never pays: its mat.pack is a
            # shared-memory concat, modules/mal/mat.c:124)
            big = max(self.inputs[i].shape[0] for i in picked)
            if self.cap * 2 > big:
                raise Unsupported("result ~ input size: gather dominates")
        from ..obs import set_algorithm
        set_algorithm("fragment:spmd")
        stats_inc("runs")
        stats_inc("spmd_runs")
        t0 = _time.perf_counter()
        rpcs = 0
        lane_caps = getattr(self, "_lane_caps", None)
        if lane_caps is None:
            lane_caps = self._lane_caps = {}
        for _attempt in range(12):
            sharded = self._pick_shard_inputs(nsh, require_min)
            if sharded is None:
                raise Unsupported("no shardable scan for the mesh")
            rwr = _SpmdRewriter(sharded, nsh, lane_caps,
                                getattr(self, "scan_counts", None))
            sp_ir, d = rwr.rw(self.rel_ir)
            if d == "shard":
                sp_ir = ("gather", sp_ir)
            flags = tuple(i in sharded for i in range(len(self.inputs)))
            repcheck = bool(config.get("assert_props"))
            fn = _spmd_callable((sp_ir, self.out_keys, self.cap), mesh,
                                flags, repcheck=repcheck)
            err, tots, count, arrays = fn(self.inputs)
            err_v, tots_v, count_v, arrs = jax.device_get(
                (err, tots, count, arrays))
            if repcheck:
                # runtime replication assert (GDKdebug/assert_props):
                # every device must have produced identical outputs
                def _dedup(v, what):
                    first = v[0]
                    nan_ok = np.asarray(first).dtype.kind == "f"
                    for d in range(1, v.shape[0]):
                        if not np.array_equal(v[d], first,
                                              equal_nan=nan_ok):
                            raise AssertionError(
                                f"SPMD replication violated: {what} "
                                f"diverges on device {d}")
                    return first
                err_v = _dedup(err_v, "error flag")
                count_v = _dedup(count_v, "row count")
                tots_v = {o: _dedup(t, f"total[{o}]")
                          for o, t in tots_v.items()}
                arrs = [_dedup(a, f"output[{i}]")
                        for i, a in enumerate(arrs)]
            rpcs += 1
            code = int(err_v)
            if code >= _ERR_DUP_BASE:
                expand = dict(self.expand)
                expand[code - _ERR_DUP_BASE] = None
                self._lower(expand)
                self.expand = {**expand, **self.expand_used}
                self._memoize()
                stats_inc("uniq_retries")
                continue
            # negative keys = repartition max-lane counts (shuffle
            # overflow); positive = expanding-join totals
            lane_over = {(-1 - o): int(t) for o, t in tots_v.items()
                         if o < 0 and int(t) > rwr.lane_used.get(-1 - o, 0)}
            if lane_over:
                for o, t in lane_over.items():
                    lane_caps[o] = capacity_for(max(t, 1))
                stats_inc("cap_retries")
                continue
            over = {o: int(t) for o, t in tots_v.items()
                    if o >= 0 and int(t) > self.expand_used.get(o, 0)}
            if over:
                expand = dict(self.expand)
                for o, t in over.items():
                    expand[o] = capacity_for(max(t, 1))
                self._lower(expand)
                self._memoize()
                stats_inc("cap_retries")
                continue
            _raise_err(code)
            for key, v in rwr.counts.items():
                if v:
                    stats_inc(key, v)
            n = int(count_v)
            if events is not None:
                events.append({
                    "op": "fragment.run", "algorithm": "fragment:spmd",
                    "rows": n, "rpcs": rpcs, "devices": nsh,
                    "shuffles": dict(rwr.counts),
                    "usec": int((_time.perf_counter() - t0) * 1e6)})
            return FragmentResult(n, [np.asarray(a) for a in arrs],
                                  self.pts, self.wide)
        raise Unsupported("expanding-join retry limit exceeded")

    def run(self, events: Optional[list] = None,
            mesh=None, spmd_require_min: bool = False) -> FragmentResult:
        """Execute; 1 RPC when the result capacity is small (the common
        analytics shape: group-by / limit root), 2 RPCs otherwise, plus
        one re-lowered retry per newly-discovered non-unique join build
        or expansion-capacity overflow (memoized across runs).  With a
        mesh (>1 device), the plan runs SPMD (see _run_spmd); plans with
        no shardable scan fall back to single-device execution.
        ``spmd_require_min`` (session auto-mesh) keeps plans whose
        largest scan is below spmd_min_shard_rows single-device."""
        import time as _time
        if mesh is not None:
            try:
                return self._run_spmd(mesh, events,
                                      require_min=spmd_require_min)
            except Unsupported:
                pass    # e.g. tiny/unshardable plan: run single-device
        from ..obs import set_algorithm
        set_algorithm("fragment:jit")
        stats_inc("runs")
        t0 = _time.perf_counter()
        rpcs = 0
        import os
        dbg = os.environ.get("MTPU_DEBUG_TIMING")
        compiles0 = _run_single._cache_size() + _run_raw._cache_size()
        for _attempt in range(8):
            t_at = _time.perf_counter()
            single = self.cap <= _SINGLE_PHASE_CAP
            if single:
                err, tots, count, arrays = _run_single(
                    (self.rel_ir, self.out_keys, self.cap), self.inputs)
                err_v, tots_v, count_v, arrs = jax.device_get(
                    (err, tots, count, arrays))
            else:
                err, tots, count, live, arrays = _run_raw(
                    (self.rel_ir, self.out_keys), self.inputs)
                err_v, tots_v, count_v = jax.device_get((err, tots, count))
            if dbg:
                import sys as _sys
                print(f"[frag] attempt={_attempt} single={single} "
                      f"cap={self.cap} err={int(err_v)} "
                      f"dt={_time.perf_counter() - t_at:.2f}s "
                      f"lower={self.lower_ms:.0f}ms",
                      file=_sys.stderr, flush=True)
            rpcs += 1
            code = int(err_v)
            if code >= _ERR_DUP_BASE:
                # join <ordinal> build side is non-unique: re-lower it as
                # an expanding join and retry
                expand = dict(self.expand)
                expand[code - _ERR_DUP_BASE] = None
                self._lower(expand)
                self.expand = {**expand, **self.expand_used}
                self._memoize()
                stats_inc("uniq_retries")
                continue
            over = {o: int(t) for o, t in tots_v.items()
                    if int(t) > self.expand_used.get(o, 0)}
            if over:
                expand = dict(self.expand)
                for o, t in over.items():
                    expand[o] = capacity_for(max(t, 1))
                self._lower(expand)
                self._memoize()
                stats_inc("cap_retries")
                continue
            _raise_err(code)
            n = int(count_v)
            if not single:
                out_cap = min(self.cap, capacity_for(max(n, 1)))
                if live is None:
                    arrs = jax.device_get(
                        _finish_slice(arrays, out_cap=out_cap))
                else:
                    arrs = jax.device_get(
                        _finish_mask(live, arrays, out_cap=out_cap))
                rpcs += 1
            result = FragmentResult(n, [np.asarray(a) for a in arrs],
                                    self.pts, self.wide)
            # capacity SHRINK: expanding joins / group buckets start at
            # a conservative default (e.g. 2x the larger side - 16M for
            # lineitem-sized operands); once the true total is measured,
            # re-lower to its bucket so every later run's ecap-sized
            # ops (cummax, gathers, residuals) pay for actual matches,
            # not the guess.  An overflow on a later run grows it back
            # via the normal retry.
            shrink = {}
            for o, t in tots_v.items():
                if o < 0:
                    continue
                used = self.expand_used.get(o, 0)
                tight = capacity_for(max(int(t), 1))
                if used > 2 * tight:
                    shrink[o] = tight
            if shrink:
                self._lower({**self.expand, **shrink})
                self.expand = {**self.expand, **shrink,
                               **self.expand_used}
                self._memoize()
            if events is not None:
                compiled = (_run_single._cache_size() +
                            _run_raw._cache_size()) - compiles0
                events.append({
                    "op": "fragment.run", "algorithm": "fragment:jit",
                    "rows": n, "rpcs": rpcs,
                    "compile": "miss" if compiled else "hit",
                    "expanding_joins": len(self.expand_used),
                    "usec": int((_time.perf_counter() - t0) * 1e6)})
            return result
        raise Unsupported("expanding-join retry limit exceeded")


def compile_fragment(catalog, rel: L.Rel, out_names: List[str]):
    """Lower a plan (host-only, no device work); raises Unsupported for
    plan shapes outside the compiler."""
    return CompiledFragment(catalog, rel, out_names)


def run_fragment(catalog, rel: L.Rel, out_names: List[str],
                 events: Optional[list] = None) -> FragmentResult:
    """One-shot lower + execute (see CompiledFragment; the engine caches
    the compiled object instead, engine._PLAN_CACHE)."""
    return CompiledFragment(catalog, rel, out_names).run(events=events)

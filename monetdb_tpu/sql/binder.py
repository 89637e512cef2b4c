"""Binder / planner: AST → typed logical plan.

This is the engine's condensation of the reference's semantic layer:
name resolution & typing (sql/server/rel_select.c, sql_semantic.c),
subquery unnesting (rel_unnest.c — here: targeted decorrelation of
correlated EXISTS/scalar-aggregate subqueries into semi/anti/equi joins on
the correlation keys), and the bind-time rewrites that matter most from the
rel_optimizer pipeline (predicate classification & pushdown, equi-join
extraction from WHERE conjuncts, greedy selectivity-ordered join trees).
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
from decimal import Decimal
from typing import Dict, List, Optional, Set, Tuple

from ..dtypes import (BOOL, DATE, F64, I32, I64, Kind, SQLType, TIMESTAMP,
                      decimal as dec_t, varchar)
from ..plan import logical as L
from ..plan.exprs import (AggRef, Between, BinOp, BoolOp, Case, Cast, Cmp,
                          ColRef, Const, Expr, Func, InList, IsNull, Like,
                          Not, Star, Subquery, WinRef, walk)
from ..table import Catalog
from . import ast as A
from .parser import parse

__all__ = ["Binder", "BindError", "bind_select"]


class BindError(Exception):
    pass


EPOCH = datetime.date(1970, 1, 1)


def date_to_days(d: datetime.date) -> int:
    return (d - EPOCH).days


def add_interval(d, amount: int, unit: str):
    """date/datetime + interval (reference gdk_time.c date_add_month/
    timestamp_add_usec semantics: month arithmetic clamps the day)."""
    if unit.startswith("day"):
        return d + datetime.timedelta(days=amount)
    if unit.startswith("week"):
        return d + datetime.timedelta(weeks=amount)
    if unit in ("hour", "minute", "second"):
        td = datetime.timedelta(**{unit + "s": amount})
        if isinstance(d, datetime.datetime):
            return d + td
        return datetime.datetime(d.year, d.month, d.day) + td
    if unit.startswith("quarter"):
        amount, unit = amount * 3, "month"
    if unit.startswith("month"):
        m = d.month - 1 + amount
        y = d.year + m // 12
        m = m % 12 + 1
        import calendar
        day = min(d.day, calendar.monthrange(y, m)[1])
        return d.replace(year=y, month=m, day=day)
    if unit.startswith("year"):
        return d.replace(year=d.year + amount)
    raise BindError(f"unsupported interval unit {unit}")


@dataclasses.dataclass
class ColInfo:
    alias: str
    name: str                      # internal (unique within a projection)
    typ: SQLType
    table: Optional[str] = None
    display: Optional[str] = None  # user-visible header when it differs
    #: duplicate of a NATURAL JOIN / USING column: hidden from ``*`` and
    #: from unqualified resolution (rel_select.c natural-join dedup);
    #: still reachable qualified
    shadow: bool = False


class Scope:
    """Visible columns during binding; chains to an outer scope for
    correlated subqueries (the reference's stack of sql_rel scopes)."""

    def __init__(self, outer: Optional["Scope"] = None):
        self.tables: Dict[str, List[ColInfo]] = {}
        self.outer = outer

    def add_table(self, alias: str, cols: List[ColInfo]):
        if alias in self.tables:
            raise BindError(f"duplicate table alias {alias}")
        self.tables[alias] = cols

    def resolve(self, table: Optional[str], name: str) -> Tuple[ColInfo, bool]:
        if table is not None:
            if table in self.tables:
                for c in self.tables[table]:
                    if c.name == name:
                        return c, False
                raise BindError(f"column {table}.{name} not found")
            if self.outer is not None:
                info, _ = self.outer.resolve(table, name)
                return info, True
            raise BindError(f"unknown table {table}")
        hits = [c for cols in self.tables.values() for c in cols
                if c.name == name]
        if len(hits) > 1:
            # NATURAL/USING shadow copies don't make a name ambiguous
            vis = [c for c in hits if not c.shadow]
            if len(vis) == 1:
                return vis[0], False
        if len(hits) == 1:
            return hits[0], False
        if len(hits) > 1:
            raise BindError(f"ambiguous column {name}")
        if self.outer is not None:
            info, _ = self.outer.resolve(table, name)
            return info, True
        raise BindError(f"column {name} not found")


def _split_conjuncts(e: Optional[Expr]) -> List[Expr]:
    if e is None:
        return []
    if isinstance(e, BoolOp) and e.op == "and":
        out = []
        for a in e.args:
            out.extend(_split_conjuncts(a))
        return out
    return [e]


def _expr_tables(e: Expr) -> Set[str]:
    return {n.table for n in walk(e)
            if isinstance(n, ColRef) and n.table is not None}


def _and(exprs: List[Expr]) -> Optional[Expr]:
    if not exprs:
        return None
    if len(exprs) == 1:
        return exprs[0]
    b = BoolOp("and", exprs)
    b.typ = BOOL
    return b


def _factor_or(e: Expr) -> Expr:
    """Hoist conjuncts common to every OR branch out of the OR — the
    reference's find_fk/pushdown enabler in rel_optimize_sel.c. Without it
    Q19-style ``(a=b and p1) or (a=b and p2)`` hides its join key inside the
    disjunction and forces a cross product."""
    if isinstance(e, BoolOp) and e.op == "and":
        b = BoolOp("and", [_factor_or(a) for a in e.args])
        b.typ = e.typ
        return b
    if not (isinstance(e, BoolOp) and e.op == "or"):
        return e
    branches = [_split_conjuncts(_factor_or(a)) for a in e.args]
    keyed = [{repr(c): c for c in b} for b in branches]
    common = set(keyed[0])
    for ks in keyed[1:]:
        common &= set(ks)
    if not common:
        return e
    hoisted = [keyed[0][k] for k in sorted(common)]
    resid = []
    for b in branches:
        rb = [c for c in b if repr(c) not in common]
        if not rb:
            # a branch is fully covered by the common part ⇒ OR is implied
            return _and(hoisted)
        resid.append(_and(rb))
    orx = BoolOp("or", resid)
    orx.typ = BOOL
    return _and(hoisted + [orx])


class Binder:
    def __init__(self, catalog: Catalog, outer_scope: Optional[Scope] = None,
                 ctes: Optional[Dict] = None):
        self.catalog = catalog
        self.scope = Scope(outer_scope)
        # correlation triples (outer_ref, op, inner_ref) stripped from WHERE
        self.correlations: List[Tuple[Expr, str, Expr]] = []
        # output column names for correlation keys (grouped scalar subqueries)
        self.corr_out: Dict[int, str] = {}
        # WITH-clause bindings visible in this query: name → (col_aliases,
        # SelectStmt). Inherited by nested binders (the reference keeps CTEs
        # in the sql_query frame stack, rel_select.c).
        self.ctes: Dict[str, Tuple[Optional[List[str]], object]] = \
            dict(ctes) if ctes else {}
        self._expanding: Set[str] = set()   # SQL-function recursion guard
        # correlated scalar subqueries found in value position: each is
        # LEFT-joined into the source tree before projection (the
        # rel_unnest.c dependent-join flattening for scalar position):
        # [(srel, [(outer_expr, inner_ref)], )]
        self.pending_applies: List[tuple] = []

    def _sub(self, outer_scope: Optional[Scope] = None) -> "Binder":
        return Binder(self.catalog, outer_scope, ctes=self.ctes)

    # ==================================================================
    # entry
    # ==================================================================
    def bind(self, stmt: A.SelectStmt) -> Tuple[L.Rel, List[ColInfo]]:
        for name, cols, sel in getattr(stmt, "ctes", []):
            self.ctes[name.lower()] = (cols, sel)
        if stmt.grouping_sets is not None:
            rel, out_cols = self._bind_grouping_sets(stmt)
        else:
            rel, out_cols = self._bind_query(stmt)
        for op, rhs in stmt.setops:
            rb = self._sub()
            rrel, rcols = rb.bind(rhs)
            corr = getattr(rhs, "corresponding", None)
            if corr:
                # CORRESPONDING [BY]: project both sides onto the shared
                # column-name list, in left-side order
                lnames = [c.name for c in out_cols]
                rnames = {c.name for c in rcols}
                keep = [n for n in lnames if n in rnames] \
                    if corr is True else list(corr)
                if not keep:
                    raise BindError("CORRESPONDING: no common columns")
                rel = L.Project(rel, [(n, self._out_ref(c))
                                      for n, c in zip(lnames, out_cols)
                                      if n in keep])
                out_cols = [c for c in out_cols if c.name in keep]
                rrel = L.Project(rrel, [
                    (n, self._out_ref(next(c for c in rcols
                                           if c.name == n)))
                    for n in keep])
                rcols = [next(c for c in rcols if c.name == n)
                         for n in keep]
            if len(rcols) != len(out_cols):
                raise BindError("set operands differ in arity")
            rel = L.SetOp(op, rel, rrel)
        if stmt.order_by:
            keys = []
            nhidden = 0
            for e, d, nl in stmt.order_by:
                k = self._bind_order_key(e, out_cols)
                if not (isinstance(k, ColRef) and k.table == "#out") \
                        and isinstance(rel, L.Project) \
                        and not stmt.setops and not stmt.distinct:
                    # ORDER BY a non-projected expression: carry it as a
                    # hidden projection column (the reference keeps such
                    # exprs alive through rel_project the same way)
                    hn = f"#sort{nhidden}"
                    nhidden += 1
                    rel.exprs.append((hn, k))
                    hr = ColRef("#out", hn)
                    hr.typ = k.typ
                    k = hr
                keys.append((k, d, nl))
            rel = L.OrderBy(rel, keys)
        if stmt.limit is not None or stmt.offset:
            rel = L.Limit(rel, stmt.limit, stmt.offset)
        if stmt.sample is not None:
            rel = L.Sample(rel, stmt.sample, stmt.sample_seed)
        return rel, out_cols

    def _bind_grouping_sets(self, stmt: A.SelectStmt):
        """ROLLUP/CUBE/GROUPING SETS → union_all of one GROUP BY plan per
        key subset, with keys absent from a subset projected as typed
        NULLs (the reference lowers these in rel_select.c the same way:
        a union of groupings over the shared input)."""
        import copy as _copy

        def strip(var):
            var.grouping_sets = None
            var.order_by = []
            var.limit = None
            var.offset = 0
            var.setops = []
            var.sample = None
            return var

        # typing pass: all keys grouped → per-item output types
        probe = strip(_copy.deepcopy(stmt))
        _rel, probe_cols = self._sub()._bind_query(probe)

        def names_of(exprs):
            return {(e.table, e.name) for e in exprs
                    if isinstance(e, ColRef)}

        full_names = names_of(stmt.group_by)
        rels = []
        out_cols = None
        for keyset in stmt.grouping_sets:
            var = strip(_copy.deepcopy(stmt))
            var.group_by = _copy.deepcopy(keyset)
            missing = full_names - names_of(keyset)
            items = list(var.items)
            for i, (alias, it) in enumerate(items):
                if isinstance(it, ColRef) and \
                        (it.table, it.name) in missing:
                    items[i] = (alias or it.name,
                                Cast(Const(None), probe_cols[i].typ))
            var.items = items
            rel, cols = self._sub()._bind_query(var)
            rels.append(rel)
            if out_cols is None:
                out_cols = cols
        out = rels[0]
        for r in rels[1:]:
            out = L.SetOp("union_all", out, r)
        return out, out_cols

    def _bind_order_key(self, e: Expr, out_cols: List[ColInfo]) -> Expr:
        if isinstance(e, Const) and isinstance(e.value, int) \
                and e.ctype is None:
            idx = e.value - 1
            if not (0 <= idx < len(out_cols)):
                raise BindError(f"ORDER BY position {e.value} out of range")
            return self._out_ref(out_cols[idx])
        if isinstance(e, ColRef) and e.table is None:
            for c in out_cols:
                if (c.display or c.name) == e.name:
                    return self._out_ref(c)
        return self.bind_expr(e)

    def _out_ref(self, c: ColInfo) -> ColRef:
        r = ColRef("#out", c.name)
        r.typ = c.typ
        return r

    # ==================================================================
    # query core
    # ==================================================================
    def _bind_query(self, stmt: A.SelectStmt, collect_corr: bool = False,
                    mode: str = "project"):
        """mode: 'project' (normal), 'bare' (EXISTS: no projection)."""
        for name, cols, sel in getattr(stmt, "ctes", []):
            self.ctes.setdefault(name.lower(), (cols, sel))
        if not stmt.sources:
            # SELECT without FROM: a one-row dual (the reference plans this
            # as a single-row projection, rel_select.c rel_simple_project)
            frontier = [L.Series(0, 1, 1, "%dual")]
            self.scope.add_table("%dual", [ColInfo("%dual", "value", I64)])
        else:
            frontier = [self._bind_source(s) for s in stmt.sources]

        filters: List[Expr] = []
        join_preds: List[Tuple[Expr, Expr]] = []
        sub_preds: List[Expr] = []
        conjuncts: List[Expr] = []
        for c0 in _split_conjuncts(stmt.where):
            conjuncts.extend(_split_conjuncts(_factor_or(c0)))
        for c in conjuncts:
            if any(isinstance(n, Subquery) for n in walk(c)):
                sub_preds.append(c)
                continue
            if collect_corr:
                corr = self._try_correlation(c)
                if corr is not None:
                    self.correlations.append(corr)
                    continue
            b = self.bind_expr(c)
            if (isinstance(b, Cmp) and b.op == "=" and
                    isinstance(b.left, ColRef) and isinstance(b.right, ColRef)
                    and b.left.table != b.right.table):
                join_preds.append((b.left, b.right))
            else:
                filters.append(b)

        rel = self._build_join_tree(frontier, join_preds, filters)
        for sp in sub_preds:
            rel = self._apply_subquery_pred(rel, sp)

        has_aggs = any(isinstance(n, AggRef)
                       for _, it in stmt.items for n in walk(it)) or \
            stmt.having is not None
        if mode == "bare":
            if has_aggs or stmt.group_by:
                raise BindError("bare subquery with aggregates")
            return rel, None
        if stmt.group_by or has_aggs:
            rel, out_cols = self._bind_groupby(rel, stmt)
        else:
            rel, out_cols = self._bind_project(rel, stmt)
        if stmt.distinct:
            rel = L.Distinct(rel)
        return rel, out_cols

    # ==================================================================
    # FROM sources
    # ==================================================================
    def _bind_source(self, src) -> L.Rel:
        if isinstance(src, A.ValuesSource):
            return self._bind_values(src)
        if isinstance(src, A.TableSource):
            lname = src.name.lower()
            if lname in self.ctes:
                cte_cols, cte_sel = self.ctes[lname]
                sub = self._sub()
                del sub.ctes[lname]        # no self-reference (no RECURSIVE)
                import copy as _copy
                srel, scols = sub.bind(_copy.deepcopy(cte_sel))
                names = cte_cols or [c.name for c in scols]
                if len(names) != len(scols):
                    raise BindError("CTE column list arity mismatch")
                cols = [ColInfo(src.alias, nm, c.typ)
                        for nm, c in zip(names, scols)]
                self.scope.add_table(src.alias, cols)
                if cte_cols:
                    srel = L.Project(srel, [(nm, self._out_ref(c))
                                            for nm, c in zip(names, scols)])
                return L.SubPlan(srel, src.alias)
            from .syscat import is_system_table, system_table
            if lname not in self.catalog and not is_system_table(lname) \
                    and "." in lname:
                # schema-qualified name over the single physical
                # namespace: s.t → t when s is a known schema
                pre, bare = lname.split(".", 1)
                if pre in (getattr(self.catalog, "schemas", None) or
                           {"sys": 1}):
                    ts = getattr(self.catalog, "table_schemas", None) or {}
                    actual = ts.get(bare)
                    if actual is not None and actual != pre:
                        # the table lives in another schema (SET SCHEMA
                        # / schema rename moved it): qualified access
                        # through the old schema must fail (sql_cat.c)
                        raise BindError(
                            f"42S02!SELECT: no such table "
                            f"'{pre}'.'{bare}'")
                    if src.alias == src.name:
                        src.alias = bare
                    lname = src.name = bare
            if lname not in self.catalog and is_system_table(lname):
                self.catalog.add(system_table(self.catalog, lname))
            elif not is_system_table(lname):
                self._check_select(lname)
            ddef = (self.catalog.merges.get(lname)
                    or self.catalog.remotes.get(lname)
                    or self.catalog.replicas.get(lname))
            if ddef is not None:
                cols = [ColInfo(src.alias, n, t) for n, t in ddef.schema]
                self.scope.add_table(src.alias, cols)
                if lname in self.catalog.merges:
                    return L.MergeScan(lname, src.alias)
                if lname in self.catalog.remotes:
                    return L.RemoteScan(lname, src.alias, ddef.addr,
                                        ddef.rtable)
                from .distribute import _Expander
                return _Expander(self.catalog).replica_rel(ddef, src.alias)
            vsql = self.catalog.views.get(src.name.lower())
            if vsql is not None:
                sub = self._sub()
                if getattr(self.catalog, "access", None) is not None:
                    # views execute with definer rights (sql_privileges.c):
                    # the caller needs SELECT on the view, not on its bases
                    cat2 = copy.copy(self.catalog)
                    cat2.access = None
                    sub.catalog = cat2
                srel, scols = sub.bind(parse(vsql))
                cols = [ColInfo(src.alias, c.name, c.typ) for c in scols]
                self.scope.add_table(src.alias, cols)
                return L.SubPlan(srel, src.alias)
            if src.name not in self.catalog:
                raise BindError(f"unknown table {src.name}")
            t = self.catalog.get(src.name)
            cols = [ColInfo(src.alias, n, c.typ, src.name)
                    for n, c in t.columns.items()]
            self.scope.add_table(src.alias, cols)
            return L.Scan(src.name, src.alias)
        if isinstance(src, A.SubquerySource):
            sub = self._sub()
            srel, scols = sub.bind(src.select)
            names = src.col_aliases or [c.name for c in scols]
            if len(names) != len(scols):
                raise BindError("derived column list arity mismatch")
            cols = [ColInfo(src.alias, nm, c.typ)
                    for nm, c in zip(names, scols)]
            self.scope.add_table(src.alias, cols)
            if src.col_aliases:
                srel = L.Project(srel, [(nm, self._out_ref(c))
                                        for nm, c in zip(names, scols)])
            return L.SubPlan(srel, src.alias)
        if isinstance(src, A.TableFuncSource):
            sf = getattr(self.catalog, "sqlfuncs", {}) or {}
            f = sf.get(src.name.split(".")[-1].lower())
            if f is not None and f.get("kind") == "table":
                # user table function: substitute constant args into the
                # stored SELECT body and bind it as a derived table
                # (rel_psm.c table-returning function inlining)
                import re as _re
                if len(src.args) != len(f["params"]):
                    raise BindError(
                        f"table function {src.name} expects "
                        f"{len(f['params'])} arguments")
                body = f["body"]
                for (pn, _tag), a in zip(f["params"], src.args):
                    b = self.bind_expr(a)
                    if not isinstance(b, Const):
                        raise BindError(
                            "table function arguments must be constant")
                    v = b.value
                    lit = "NULL" if v is None else (
                        "'" + str(v).replace("'", "''") + "'"
                        if isinstance(v, str) else str(v))
                    body = _re.sub(rf"\b{_re.escape(pn)}\b", f"({lit})",
                                   body, flags=_re.I)
                from .parser import parse as _parse
                sel = _parse(body)
                names = [c[0] for c in (f.get("cols") or [])]
                return self._bind_source(A.SubquerySource(
                    sel, src.alias, names or None))
            if src.name != "generate_series":
                raise BindError(f"unknown table function {src.name}")
            vals = []
            for a in src.args:
                b = self.bind_expr(a)
                if not isinstance(b, Const):
                    raise BindError("generate_series needs constant args")
                v = b.value
                import datetime as _dt
                if isinstance(v, _dt.date):
                    v = date_to_days(v)
                vals.append(int(v))
            start = vals[0]
            stop = vals[1] if len(vals) > 1 else 0
            step = vals[2] if len(vals) > 2 else 1
            self.scope.add_table(src.alias,
                                 [ColInfo(src.alias, "value", I64)])
            return L.Series(start, stop, step, src.alias)
        if isinstance(src, A.JoinSource):
            before = set(self.scope.tables)
            lrel = self._bind_source(src.left)
            mid = set(self.scope.tables)
            rrel = self._bind_source(src.right)
            after = set(self.scope.tables)
            on = src.on
            using = getattr(src, "using", None)
            if getattr(src, "natural", False) or using:
                # NATURAL JOIN / JOIN USING (cols): equijoin over the
                # shared column names (sql_parser.y joined_table;
                # rel_select.c rel_joinquery natural path)
                # hidden columns (__rowid__) are never NATURAL-join keys
                lcols = {c.name for a in (mid - before)
                         for c in self.scope.tables[a]
                         if not c.name.startswith("__")}
                rcols = {c.name for a in (after - mid)
                         for c in self.scope.tables[a]
                         if not c.name.startswith("__")}
                common = [c for c in (using or sorted(lcols & rcols))]
                if not common:
                    raise BindError("NATURAL JOIN: no common columns")
                la = sorted(mid - before)
                ra = sorted(after - mid)

                def ref(aliases, name):
                    for a in aliases:
                        if any(c.name == name
                               for c in self.scope.tables[a]):
                            return ColRef(a, name)
                    raise BindError(f"USING column {name} not found")
                from ..plan.exprs import BoolOp, Cmp, ColRef
                conds = [Cmp("=", ref(la, c), ref(ra, c)) for c in common]
                on = conds[0] if len(conds) == 1 else BoolOp("and", conds)
                # coalesce the shared columns: hide the non-preserved
                # side's copies from * and unqualified references
                # (rel_select.c natural-join dedup).  RIGHT joins keep
                # the right side's values; everything else the left's.
                shadow_aliases = la if src.kind == "right" else ra
                for a in shadow_aliases:
                    for ci in self.scope.tables[a]:
                        if ci.name in common:
                            ci.shadow = True
            on_b = self.bind_expr(on) if on is not None else None
            eq, extra = self._extract_equi(on_b)
            return L.Join(lrel, rrel, src.kind, on=eq, extra=extra)
        raise BindError(f"unsupported source {src}")

    def _check_select(self, name: str) -> None:
        """SELECT privilege (sql_privileges.c table_privs): enforced only
        when the session catalog carries an access context."""
        acc = getattr(self.catalog, "access", None)
        if acc is None:
            return
        user, role, db = acc
        t = name.lower()
        if db.owners.get(t) == user.lower():
            return
        if "select" not in db.effective_privs(user, t, role):
            raise BindError(
                f"SELECT: access denied for {user} to table {t}")

    def _bind_values(self, src: A.ValuesSource) -> L.Rel:
        """(VALUES ...) table constructor → literal relation."""
        if not src.rows:
            raise BindError("VALUES with no rows")
        width = len(src.rows[0])
        rows = []
        for r in src.rows:
            if len(r) != width:
                raise BindError("VALUES rows differ in arity")
            rows.append([self.bind_expr(e) for e in r])
        for r in rows:
            for e in r:
                if not isinstance(e, Const):
                    raise BindError("VALUES requires constant expressions")
        names = src.col_aliases or [f"col{i+1}" for i in range(width)]
        if len(names) != width:
            raise BindError("VALUES column list arity mismatch")
        types = []
        for i in range(width):
            t = None
            for r in rows:
                ct = r[i].typ
                if ct is None:
                    continue
                if t is None:
                    t = ct
                elif t.kind != ct.kind or t.np_dtype != ct.np_dtype or \
                        t.scale != ct.scale:
                    from ..dtypes import common_numeric
                    if t.is_numeric and ct.is_numeric:
                        if t.kind == Kind.DECIMAL or ct.kind == Kind.DECIMAL:
                            t = dec_t(18, max(t.scale, ct.scale))
                        else:
                            t = common_numeric(t, ct)
                    else:
                        raise BindError(f"VALUES column {i+1} mixes types")
            types.append(t or I32)
        vals = [[r[i].value for r in rows] for i in range(width)]
        self.scope.add_table(src.alias,
                             [ColInfo(src.alias, nm, t)
                              for nm, t in zip(names, types)])
        return L.Values(src.alias, names, types, vals)

    def _extract_equi(self, on: Optional[Expr]):
        if on is None:
            return [], None
        eq, rest = [], []
        for c in _split_conjuncts(on):
            if (isinstance(c, Cmp) and c.op == "=" and
                    isinstance(c.left, ColRef) and isinstance(c.right, ColRef)
                    and c.left.table != c.right.table):
                eq.append((c.left, c.right))
            else:
                rest.append(c)
        return eq, _and(rest)

    # ==================================================================
    # join tree (greedy, smallest-filtered-first)
    # ==================================================================
    def _rel_aliases(self, rel: L.Rel) -> Set[str]:
        if isinstance(rel, (L.Scan, L.SubPlan, L.MergeScan, L.RemoteScan)):
            return {rel.alias}
        out: Set[str] = set()
        for c in rel.children():
            out |= self._rel_aliases(c)
        return out

    def _card_estimate(self, rel: L.Rel, filters_on: int) -> float:
        base = rel
        while isinstance(base, L.Filter):
            base = base.child
        n = (self.catalog.get(base.table).count
             if isinstance(base, L.Scan) else 10_000.0)
        return n * (0.1 ** filters_on)

    def _build_join_tree(self, frontier, join_preds, filters) -> L.Rel:
        items = []
        placed = set()
        for rel in frontier:
            aliases = self._rel_aliases(rel)
            nf = 0
            for fi, f in enumerate(filters):
                ts = _expr_tables(f)
                if ts and ts <= aliases:
                    rel = L.Filter(rel, f)
                    placed.add(fi)
                    nf += 1
            items.append([rel, aliases, nf])
        remaining = [f for i, f in enumerate(filters) if i not in placed]

        preds = list(join_preds)
        if len(items) == 1:
            rel = items[0][0]
        else:
            # anchor on the LARGEST relation: in the mask-carrying
            # executor the left/probe side rides at its capacity while
            # every right side is a build - the fact table must be the
            # probe root so dimension edges join on their unique keys
            # (the probe/build split joincost makes, gdk/gdk_join.c:3586)
            items.sort(key=lambda it: self._card_estimate(it[0], it[2]))
            cur, cur_aliases, _ = items.pop(-1)
            while items:
                # prefer a join whose incoming side is a unique key (the
                # PK side of a FK edge): a non-unique build expands N:M
                # (exec/fragment.py join_expand) - e.g. Q5's
                # c_nationkey = s_nationkey must ride as a residual
                # filter over the FK-joined stream, never as a join edge
                # (rel_optimizer's join-order pass makes the same call
                # from stats, sql/server/rel_optimizer.c:619)
                picked = None
                for idx, (r, aliases, nf) in enumerate(items):
                    keys = [(a, b) for a, b in preds
                            if (a.table in cur_aliases and b.table in aliases)
                            or (b.table in cur_aliases and a.table in aliases)]
                    if keys:
                        uniq = any(self._ref_unique(
                            b if b.table in aliases else a)
                            for a, b in keys)
                        if uniq:
                            picked = (idx, keys)
                            break
                        if picked is None:
                            picked = (idx, keys)
                if picked is None:
                    r, aliases, _ = items.pop(0)
                    cur = L.Join(cur, r, "cross", on=[])
                else:
                    idx, keys = picked
                    r, aliases, _ = items.pop(idx)
                    on = []
                    for a, b in keys:
                        on.append((a, b) if a.table in cur_aliases else (b, a))
                        preds.remove((a, b))
                    cur = L.Join(cur, r, "inner", on=on)
                cur_aliases |= aliases
            rel = cur
            for a, b in preds:
                remaining.append(Cmp("=", a, b))
                remaining[-1].typ = BOOL
        f = _and(remaining)
        if f is not None:
            rel = L.Filter(rel, f)
        return rel

    # ==================================================================
    # subquery predicates (rel_unnest.c analog)
    # ==================================================================
    def _apply_subquery_pred(self, rel: L.Rel, pred: Expr) -> L.Rel:
        neg = False
        p = pred
        while isinstance(p, Not):
            neg = not neg
            p = p.arg
        if isinstance(p, Subquery):
            negated = neg or p.negated
            if p.kind == "exists":
                return self._bind_exists(rel, p.select, negated)
            if p.kind == "in":
                return self._bind_in_subquery(rel, p, negated)
            if p.kind in ("any", "all"):
                op = p.cmp_op
                if (p.kind == "any" and op == "=") or \
                        (p.kind == "all" and op == "<>"):
                    # = ANY is IN; <> ALL is NOT IN (sql_subquery.c
                    # anyequal / allnotequal)
                    inv = p.kind == "all"
                    return self._bind_in_subquery(rel, p, negated ^ inv)
                # negation is pushed into the CASE (NOT of UNKNOWN must
                # stay UNKNOWN, i.e. excluded by WHERE - a Not() wrapper
                # over a null-less bool would wrongly admit it)
                return L.Filter(rel, self._bind_quant(p, negated=negated))
        if isinstance(p, Cmp):
            sq = None
            other = None
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                    "=": "=", "<>": "<>"}
            op = p.op
            if isinstance(p.right, Subquery) and p.right.kind == "scalar":
                sq, other = p.right, p.left
            elif isinstance(p.left, Subquery) and p.left.kind == "scalar":
                sq, other = p.left, p.right
                op = flip[op]
            if sq is not None:
                if neg:
                    op = {"=": "<>", "<>": "=", "<": ">=", ">=": "<",
                          ">": "<=", "<=": ">"}[op]
                return self._bind_scalar_cmp(rel, other, op, sq)
        # fallback: bind as ordinary expression (uncorrelated scalar subqueries
        # inside are evaluated by the executor)
        return L.Filter(rel, self.bind_expr(pred))

    def _bind_exists(self, rel, sel: A.SelectStmt, negated: bool) -> L.Rel:
        sub = self._sub(outer_scope=self.scope)
        srel, _ = sub._bind_query(sel, collect_corr=True, mode="bare")
        eq = [(o, i) for o, op, i in sub.correlations if op == "="]
        extra = _and([self._mk_cmp(op, o, i)
                      for o, op, i in sub.correlations if op != "="])
        if not eq:
            if sub.correlations:
                raise BindError("EXISTS without equi-correlation unsupported")
            # uncorrelated EXISTS: evaluate COUNT(*) over the subplan once,
            # filter all-or-nothing (the reference plans this as a
            # single-value semijoin against a grouped count)
            cnt_rel = L.GroupBy(srel, [], [("_c", "count_star", None, False)])
            cref = ColRef("#grp", "_c")
            cref.typ = I64
            proj = L.Project(cnt_rel, [("_c", cref)])
            sq = Subquery(("bound", proj, [ColInfo("#out", "_c", I64)]),
                          "scalar")
            sq.typ = I64
            zero = Const(0, I64)
            zero.typ = I64
            return L.Filter(rel, self._mk_cmp("=" if negated else ">",
                                              sq, zero))
        return L.Join(rel, srel, "anti" if negated else "semi",
                      on=eq, extra=extra)

    def _mk_cmp(self, op, a, b):
        c = Cmp(op, a, b)
        c.typ = BOOL
        return c

    def _bind_in_subquery(self, rel, p: Subquery, negated: bool) -> L.Rel:
        if getattr(p.select, "limit", None) is not None or \
                getattr(p.select, "offset", 0):
            # the reference rejects LIMIT/OFFSET inside IN subqueries
            # (rel_select.c; pinned by limit_in_subquery.SF-2620437)
            raise BindError(
                "42000!SELECT: LIMIT not supported in IN subquery")
        outer = self.bind_expr(p.outer)
        sub = self._sub(outer_scope=self.scope)
        srel, scols = sub._bind_query(p.select, collect_corr=True)
        if len(scols) != 1:
            raise BindError("IN subquery must return one column")
        eq = [(outer, self._out_ref(scols[0]))]
        for o, op, i in sub.correlations:
            if op != "=":
                raise BindError("non-equi correlation in IN unsupported")
            # correlation key must be in subquery output for the join;
            # grouped subqueries add them via corr_out
            nm = sub.corr_out.get(id(i))
            if nm is None:
                raise BindError("correlated IN needs grouped key output")
            ref = ColRef("#out", nm)
            ref.typ = i.typ
            eq.append((o, ref))
        j = L.Join(rel, srel, "anti" if negated else "semi", on=eq)
        if negated and not sub.correlations:
            # three-valued NOT IN (the mark-join certainty flag,
            # gdk/gdk_join.c:4367): x NOT IN S is TRUE only when S is
            # empty, or x is nonnull and S holds no nulls — a non-match
            # against a null-bearing set is UNKNOWN, which a WHERE
            # excludes.  The anti join alone would wrongly keep null x
            # and ignore nulls in S.
            sub2 = self._sub(outer_scope=self.scope)
            srel2, scols2 = sub2._bind_query(p.select, collect_corr=True)
            arg2 = self._out_ref(scols2[0])
            g = L.GroupBy(srel2, [], [("_qc", "count_star", None, False),
                                      ("_qn", "count", arg2, False)])
            refs = {}
            for nm2 in ("_qc", "_qn"):
                r2 = ColRef("#grp", nm2)
                r2.typ = I64
                refs[nm2] = r2
            proj = L.Project(g, [("_qc", refs["_qc"]),
                                 ("_qn", refs["_qn"])])

            def scalar(nm2):
                sq = Subquery(
                    ("bound", L.Project(proj, [(nm2, self._ref_out(nm2))]),
                     [ColInfo("#out", nm2, I64)]), "scalar")
                sq.typ = I64
                return sq

            zero = Const(0, I64)
            zero.typ = I64
            empty = self._mk_cmp("=", scalar("_qc"), zero)
            no_nulls = self._mk_cmp("=",
                                    self._mk_sub(scalar("_qc"),
                                                 scalar("_qn")), zero)
            nonnull_x = IsNull(outer, negated=True)
            nonnull_x.typ = BOOL
            ok = BoolOp("or", [empty,
                               _and([nonnull_x, no_nulls])])
            ok.typ = BOOL
            return L.Filter(j, ok)
        return j

    @staticmethod
    def _ref_out(nm):
        r = ColRef("#out", nm)
        r.typ = I64
        return r

    @staticmethod
    def _mk_sub(a, b):
        e = BinOp("-", a, b)
        e.typ = I64
        return e

    def _bind_scalar_cmp(self, rel, outer_expr: Expr, op: str,
                         sq: Subquery) -> L.Rel:
        sub = self._sub(outer_scope=self.scope)
        srel, scols = sub._bind_query(sq.select, collect_corr=True)
        if len(scols) < 1:
            raise BindError("scalar subquery with no output")
        val_ref = self._out_ref(scols[0])
        outer_b = self.bind_expr(outer_expr)
        if not sub.correlations:
            # uncorrelated scalar: executor evaluates the subplan once
            c = copy.copy(sq)
            c.select = ("bound", srel, scols)
            c.typ = scols[0].typ
            return L.Filter(rel, self._mk_cmp(op, outer_b, c))
        eq = []
        for o, cop, i in sub.correlations:
            if cop != "=":
                raise BindError("non-equi correlated scalar unsupported")
            nm = sub.corr_out.get(id(i))
            if nm is None:
                raise BindError("correlated scalar needs grouped key output")
            ref = ColRef("#out", nm)
            ref.typ = i.typ
            eq.append((o, ref))
        self._push_corr_semi(rel, srel, sub.correlations)
        j = L.Join(rel, srel, "inner", on=eq)
        return L.Filter(j, self._mk_cmp(op, outer_b, val_ref))

    def _push_corr_semi(self, rel: L.Rel, srel: L.Rel,
                        correlations) -> None:
        """Magic-set reduction (rel_unnest.c + the reference's
        pushselect role): when a decorrelated scalar subquery's
        correlation keys come from a FILTERED outer scan, semi-join the
        subquery's aggregation input against a clone of that filtered
        scan, so the inner aggregate runs over the keys the outer can
        actually ask about (TPC-H Q17: avg-per-part over ~200 selected
        parts instead of all 200k)."""
        import copy as _copy
        outs = [o for o, _cop, _i in correlations]
        tabs = {c.table for e in outs for c in walk(e)
                if isinstance(c, ColRef)}
        if len(tabs) != 1:
            return
        alias = tabs.pop()

        def find(r):
            """The Filter(...Filter(Scan alias)) chain, or the Scan."""
            if isinstance(r, L.Scan):
                return r if r.alias == alias else None
            if isinstance(r, L.Filter):
                got = find(r.child)
                if got is not None and got is r.child:
                    return r            # contiguous filter chain
                return got
            for c in r.children():
                got = find(c)
                if got is not None:
                    return got
            return None

        src = find(rel)
        if src is None or not isinstance(src, L.Filter):
            return                      # unfiltered: nothing to gain
        clone = _copy.deepcopy(src)
        gb = srel
        while not isinstance(gb, L.GroupBy) and gb.children():
            gb = gb.children()[0]
        if not isinstance(gb, L.GroupBy):
            return
        on = [(i, o) for o, _cop, i in correlations]
        gb.child = L.Join(gb.child, clone, "semi", on=on)

    def _bind_scalar_apply(self, sub, srel, scols):
        """Correlated scalar subquery in VALUE position (projection /
        SET / CASE ...): LEFT-join the subquery on its correlation keys
        and reference its value column — rel_unnest.c's dependent-join
        flattening for scalar position.  Aggregated inners already
        group by the correlation keys (corr_out, _bind_groupby);
        non-aggregated inners get the keys appended to their
        projection."""
        if not scols:
            raise BindError("scalar subquery with no output")
        k = len(self.pending_applies)
        eq = []                      # (outer bound expr, renamed key ref)
        wrap_items = [(f"_ap{k}_v", self._out_ref(scols[0]))]
        for j, (o, cop, i) in enumerate(sub.correlations):
            if cop != "=":
                raise BindError(
                    "non-equi correlated scalar subquery unsupported")
            nm = sub.corr_out.get(id(i))
            if nm is None:
                # non-aggregated inner: expose the key through its
                # projection (srel must end in a Project)
                if not isinstance(srel, L.Project):
                    raise BindError(
                        "correlated subquery in unsupported position")
                nm = f"_apk{j}"
                srel.exprs.append((nm, i))
            ref = ColRef("#out", nm)
            ref.typ = i.typ
            wrap_items.append((f"_ap{k}_k{j}", ref))
            r2 = ColRef("#out", f"_ap{k}_k{j}")
            r2.typ = i.typ
            eq.append((self.bind_expr(o), r2))
        # rename outputs so several applies cannot collide
        wrap = L.Project(srel, wrap_items)
        self.pending_applies.append((wrap, eq))
        out = ColRef("#out", f"_ap{k}_v")
        out.typ = scols[0].typ
        # COUNT subqueries yield 0 (not NULL) for outer rows with no
        # match — the LEFT join's miss-NULL must coalesce back to 0
        # (rel_unnest.c adds the same ifthenelse over the outer join)
        gb = srel
        while not isinstance(gb, L.GroupBy) and gb.children():
            gb = gb.children()[0]
        if isinstance(gb, L.GroupBy) and isinstance(srel, L.Project):
            counts = {nm for nm, f, _a, _d in gb.aggs
                      if f in ("count", "count_star")}
            val_e = dict(srel.exprs).get(scols[0].name)
            if isinstance(val_e, ColRef) and val_e.name in counts:
                zero = Const(0)
                zero.typ = out.typ
                zero.ctype = out.typ
                f = Func("coalesce", [out, zero])
                f.typ = out.typ
                return f
        return out

    def _drain_applies(self, rel: L.Rel) -> L.Rel:
        """LEFT-join any pending correlated scalar subqueries into the
        source tree (missing key → NULL value, scalar semantics)."""
        while self.pending_applies:
            srel, eq = self.pending_applies.pop(0)
            rel = L.Join(rel, srel, "left", on=eq)
        return rel

    def _bind_quant(self, e: Subquery, value_pos: bool = False,
                    negated: bool = False) -> Expr:
        """x op ANY/ALL(subq) -> 3-valued CASE over (count, nonnull count,
        min, max) scalar subqueries — the associative decomposition of the
        reference's quantified-comparison rewrite (rel_unnest.c +
        sql_subquery.c anyequal/allnotequal family): for ordered ops the
        only adversary that matters is the extreme value, so the subquery
        reduces to four scalars and the tri-state null logic becomes a
        CASE.  Membership forms (= ANY / <> ALL) bind as IN in predicate
        position (_apply_subquery_pred); in value position they would
        need a mark join (gdk/gdk_join.c:4367) and are rejected."""
        op = e.cmp_op
        if op in ("=", "<>") and not (
                (e.kind == "all" and op == "=") or
                (e.kind == "any" and op == "<>")):
            # membership in value position: a mark join
            # (gdk/gdk_join.c:4367 BATmarkjoin's 3-valued certainty flag),
            # evaluated rowwise by the executor as kind "mark_in"
            sub = self._sub(outer_scope=self.scope)
            srel, scols = sub._bind_query(e.select, collect_corr=True)
            if sub.correlations:
                raise BindError("correlated ANY/ALL subquery unsupported")
            from ..dtypes import I8
            c = Subquery(("bound", srel, scols), "mark_in",
                         outer=self.bind_expr(e.outer),
                         negated=(op == "<>"))
            c.typ = I8
            return c
        sub = self._sub(outer_scope=self.scope)
        srel, scols = sub._bind_query(e.select, collect_corr=True)
        if sub.correlations:
            raise BindError("correlated ANY/ALL subquery unsupported")
        if not scols:
            raise BindError("ANY/ALL subquery with no output")
        vt = scols[0].typ
        arg = self._out_ref(scols[0])

        def agg(name, func, a, typ):
            g = L.GroupBy(srel, [], [(name, func, a, False)])
            ref = ColRef("#grp", name)
            ref.typ = typ
            proj = L.Project(g, [(name, ref)])
            sq = Subquery(("bound", proj, [ColInfo("#out", name, typ)]),
                          "scalar")
            sq.typ = typ
            return sq

        cnt = agg("_qc", "count_star", None, I64)
        cn = agg("_qn", "count", arg, I64)
        mn = agg("_qmn", "min", arg, vt)
        mx = agg("_qmx", "max", arg, vt)
        x = self.bind_expr(e.outer)

        def K(v, t):
            k = Const(v, t)
            k.typ = t
            return k

        def B(node):
            node.typ = BOOL
            return node

        # value position: i8 1/0/NULL so UNKNOWN survives decode (BOOL
        # is physically numpy bool_, which has no nil - the reference's
        # bit type reserves -128); filter position: BOOL, where the
        # nil-less UNKNOWN collapsing to False is exactly WHERE semantics
        if value_pos:
            from ..dtypes import I8
            out_t = I8
            TRUE, FALSE = K(1, I8), K(0, I8)
        else:
            out_t = BOOL
            TRUE, FALSE = K(True, BOOL), K(False, BOOL)
        if negated:
            TRUE, FALSE = FALSE, TRUE
        NULLB = Const(None)
        NULLB.typ = out_t
        zero = K(0, I64)
        empty = self._mk_cmp("=", cnt, zero)
        xnull = B(IsNull(x))
        has_null = self._mk_cmp("<", cn, cnt)  # incl. the all-null set
        bnd_any, bnd_all = (mx, mn) if op in ("<", "<=") else (mn, mx)
        if op in ("=", "<>"):
            neq = B(BoolOp("or", [self._mk_cmp("<>", mn, x),
                                  self._mk_cmp("<>", mx, x)]))
            if e.kind == "all":    # = ALL
                case = Case([(empty, TRUE), (xnull, NULLB), (neq, FALSE),
                             (has_null, NULLB)], TRUE)
            else:                  # <> ANY
                case = Case([(empty, FALSE), (xnull, NULLB), (neq, TRUE),
                             (has_null, NULLB)], FALSE)
        elif e.kind == "any":
            # true iff x beats the friendliest nonnull value; else null
            # when x is null or the set has nulls; else false
            hit = self._mk_cmp(op, x, bnd_any)
            case = Case([(empty, FALSE), (hit, TRUE),
                         (B(BoolOp("or", [xnull, has_null])), NULLB)],
                        FALSE)
        else:
            # ALL: false iff x loses to the harshest nonnull value
            viol = B(Not(self._mk_cmp(op, x, bnd_all)))
            case = Case([(empty, TRUE), (xnull, NULLB), (viol, FALSE),
                         (has_null, NULLB)], TRUE)
        case.typ = out_t
        return case

    def _try_correlation(self, c: Expr):
        if not isinstance(c, Cmp):
            return None
        if not (isinstance(c.left, ColRef) and isinstance(c.right, ColRef)):
            return None
        try:
            li, l_outer = self.scope.resolve(c.left.table, c.left.name)
            ri, r_outer = self.scope.resolve(c.right.table, c.right.name)
        except BindError:
            return None
        if l_outer == r_outer:
            return None
        lref, rref = self._mk_ref(li), self._mk_ref(ri)
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                "=": "=", "<>": "<>"}
        if l_outer:
            return (lref, c.op, rref)
        return (rref, flip[c.op], lref)

    def _mk_ref(self, info: ColInfo) -> ColRef:
        r = ColRef(info.alias, info.name)
        r.typ = info.typ
        return r

    def _ref_unique(self, ref: ColRef) -> bool:
        """Bound column provably unique (BAT tkey): drives the join-order
        preference for PK build sides."""
        cols = self.scope.tables.get(ref.table)
        if not cols:
            return False
        for c in cols:
            if c.name == ref.name and c.table is not None:
                tab = self.catalog.tables.get(c.table)
                col = tab.columns.get(c.name) if tab is not None else None
                return bool(getattr(col, "key", False))
        return False

    # ==================================================================
    # projection / grouping
    # ==================================================================
    def _expand_items(self, stmt: A.SelectStmt):
        items = []
        for alias, e in stmt.items:
            if isinstance(e, Star):
                tabs = [e.table] if e.table else list(self.scope.tables)
                for t in tabs:
                    for c in self.scope.tables[t]:
                        if c.name.startswith("__") or c.shadow:
                            continue   # hidden columns (rowid) / USING dups
                        items.append((c.name, self._mk_ref(c)))
            else:
                items.append((alias or self._auto_name(e), self.bind_expr(e)))
        return items

    _auto_counter = 0

    def _auto_name(self, e: Expr) -> str:
        if isinstance(e, ColRef):
            return e.name
        if isinstance(e, AggRef):
            return e.func
        Binder._auto_counter += 1
        return f"col{Binder._auto_counter}"

    @staticmethod
    def _uniquify(items):
        """Duplicate output names (SELECT f1.a, f2.a) get unique internal
        keys; the display header keeps the original (the reference keeps
        duplicate result headers, distinguishing exps internally)."""
        seen: Dict[str, int] = {}
        out = []
        for n, e in items:
            if n in seen:
                seen[n] += 1
                out.append((f"{n}#{seen[n]}", e, n))
            else:
                seen[n] = 0
                out.append((n, e, None))
        return out

    def _bind_project(self, rel, stmt):
        items = self._expand_items(stmt)
        uni = self._uniquify(items)
        items = [(n, e) for n, e, _d in uni]
        out_cols = [ColInfo("#out", n, e.typ, display=d)
                    for n, e, d in uni]
        rel = self._drain_applies(rel)
        return L.Project(rel, items), out_cols

    def _bind_groupby(self, rel, stmt):
        keys: List[Tuple[str, Expr]] = []
        for i, ge in enumerate(stmt.group_by):
            try:
                b = self.bind_expr(ge)
            except BindError:
                # GROUP BY <output alias> (MonetDB allows it:
                # rel_select.c group_by_pe aliases)
                b = None
                if isinstance(ge, ColRef) and ge.table is None:
                    for alias, ie in stmt.items:
                        if alias and alias.lower() == ge.name.lower():
                            b = self.bind_expr(ie)
                            break
                if b is None:
                    raise
            name = b.name if isinstance(b, ColRef) else f"_gk{i}"
            keys.append((name, b))
        # correlated scalar-aggregate subquery: group by correlation keys too
        corr_key_names: List[Tuple[str, Expr]] = []
        for o, op, iref in self.correlations:
            hit = None
            for kn, ke in keys:
                if isinstance(ke, ColRef) and ke.table == iref.table \
                        and ke.name == iref.name:
                    hit = kn
                    break
            if hit is None:
                hit = f"_ck{len(keys)}"
                keys.append((hit, iref))
            self.corr_out[id(iref)] = hit
            corr_key_names.append((hit, iref))

        aggs: List[Tuple[str, str, Optional[Expr], bool]] = []

        def lift(e: Expr) -> Expr:
            if isinstance(e, Subquery):
                # e.g. HAVING agg > (subquery): bind the subquery in place
                return self.bind_expr(e)
            if isinstance(e, AggRef):
                arg = self.bind_expr(e.arg) if e.arg is not None else None
                if e.arg2 is not None:
                    arg = [arg, self.bind_expr(e.arg2)]
                nm = f"_agg{len(aggs)}"
                aggs.append((nm, e.func, arg, e.distinct))
                r = ColRef("#grp", nm)
                r.typ = self._agg_type(e.func,
                                       arg[0] if isinstance(arg, list)
                                       else arg)
                return r
            if isinstance(e, ColRef) or not e.children():
                b = self.bind_expr(e)
                for kn, ke in keys:
                    if self._expr_eq_ast(b, ke):
                        r = ColRef("#grp", kn)
                        r.typ = ke.typ
                        return r
                if isinstance(e, ColRef):
                    raise BindError(f"{e!r} not in GROUP BY")
                return b
            b = self.bind_expr(e)
            for kn, ke in keys:
                if self._expr_eq_ast(b, ke):
                    r = ColRef("#grp", kn)
                    r.typ = ke.typ
                    return r
            clone = self._clone_with(e, [lift(c) for c in e.children()])
            self._retype(clone)
            return clone

        out_items: List[Tuple[str, Expr]] = []
        for alias, e in stmt.items:
            if isinstance(e, Star):
                raise BindError("SELECT * with GROUP BY unsupported")
            nm = alias or self._auto_name(e)
            out_items.append((nm, lift(e)))
        uni = self._uniquify(out_items)
        out_items = [(n, e) for n, e, _d in uni]
        # expose correlation keys as hidden outputs
        for kn, iref in corr_key_names:
            r = ColRef("#grp", kn)
            r.typ = iref.typ
            out_items.append((kn, r))

        gb = L.GroupBy(rel, keys, aggs)
        out_rel: L.Rel = gb
        if stmt.having is not None:
            out_rel = L.Filter(out_rel, lift(stmt.having))
        proj = L.Project(out_rel, out_items)
        out_cols = [ColInfo("#out", n, e.typ,
                            display=uni[i][2] if i < len(uni) else None)
                    for i, (n, e) in enumerate(out_items)]
        return proj, out_cols

    # ==================================================================
    # expression utilities
    # ==================================================================
    def _expr_eq_ast(self, a: Expr, b: Expr) -> bool:
        if type(a) is not type(b):
            return False
        if isinstance(a, ColRef):
            return a.table == b.table and a.name == b.name
        if isinstance(a, Const):
            return a.value == b.value
        ca, cb = a.children(), b.children()
        if len(ca) != len(cb):
            return False
        sa = {k: v for k, v in a.__dict__.items()
              if not isinstance(v, (Expr, list)) and k != "typ"}
        sb = {k: v for k, v in b.__dict__.items()
              if not isinstance(v, (Expr, list)) and k != "typ"}
        if sa != sb:
            return False
        return all(self._expr_eq_ast(x, y) for x, y in zip(ca, cb))

    def _clone_with(self, e: Expr, new_children: List[Expr]) -> Expr:
        c = copy.copy(e)
        if not e.children():
            return c
        if isinstance(e, (BinOp, Cmp)):
            c.left, c.right = new_children
        elif isinstance(e, BoolOp):
            c.args = new_children
        elif isinstance(e, Not):
            c.arg = new_children[0]
        elif isinstance(e, (IsNull, Like)):
            c.arg = new_children[0]
        elif isinstance(e, Between):
            c.arg, c.lo, c.hi = new_children
        elif isinstance(e, InList):
            c.arg, c.items = new_children[0], new_children[1:]
        elif isinstance(e, Case):
            n = len(e.whens)
            c.whens = [(new_children[2 * i], new_children[2 * i + 1])
                       for i in range(n)]
            c.default = new_children[2 * n] if e.default is not None else None
        elif isinstance(e, Cast):
            c.arg = new_children[0]
        elif isinstance(e, Func):
            c.args = new_children
        elif isinstance(e, Subquery):
            if e.outer is not None:
                c.outer = new_children[0]
        elif isinstance(e, WinRef):
            # window over a grouped query: children (arg / partition keys /
            # order keys) are lifted into the grouped output, the window
            # itself then runs over the aggregate rows (sql_rank.c lowers
            # rank-over-aggregate the same way: the window's inputs are
            # the projected aggregate columns)
            i = 0
            if e.arg is not None:
                c.arg = new_children[0]
                i = 1
            np_ = len(e.partition)
            c.partition = list(new_children[i:i + np_])
            c.order = [(nc, d) for nc, (_o, d) in
                       zip(new_children[i + np_:], e.order)]
        else:
            raise BindError(f"cannot clone {type(e).__name__}")
        return c

    def _agg_type(self, func: str, arg: Optional[Expr]) -> SQLType:
        if func in ("count", "count_star"):
            return I64
        if func in ("group_concat", "listagg"):
            return varchar()
        if func == "avg" or func.startswith(("stddev", "var", "covar")) \
                or func in ("median", "quantile", "corr"):
            return F64
        if arg is None or arg.typ is None:
            return I64
        t = arg.typ
        if func in ("min", "max"):
            return t
        if t.kind == Kind.DECIMAL:
            return dec_t(18, t.scale)
        if t.np_dtype.kind == "f":
            return F64
        return I64

    # ==================================================================
    # expression binding & typing
    # ==================================================================
    def bind_expr(self, e: Expr) -> Expr:
        if isinstance(e, ColRef):
            if e.table in ("#out", "#grp"):
                return e
            try:
                info, is_outer = self.scope.resolve(e.table, e.name)
            except BindError:
                # session variable (DECLARE/SET; sql_mvc.c mvc vars)
                svars = getattr(self.catalog, "vars", None)
                if e.table is None and svars is not None \
                        and e.name in svars:
                    c = Const(svars[e.name])
                    self._type_const(c)
                    return c
                raise
            if is_outer:
                raise BindError(
                    f"correlated reference {e!r} outside supported pattern")
            return self._mk_ref(info)
        if isinstance(e, Const):
            c = copy.copy(e)
            self._type_const(c)
            return c
        if isinstance(e, AggRef):
            c = copy.copy(e)
            if c.arg is not None:
                c.arg = self.bind_expr(c.arg)
            if c.arg2 is not None:
                c.arg2 = self.bind_expr(c.arg2)
            self._retype(c)
            return c
        if isinstance(e, WinRef):
            c = copy.copy(e)
            c.arg = self.bind_expr(c.arg) if c.arg is not None else None
            c.partition = [self.bind_expr(p) for p in c.partition]
            c.order = [(self.bind_expr(o), d) for o, d in c.order]
            c.extra = [self.bind_expr(x) if isinstance(x, Expr) else x
                       for x in c.extra]
            self._retype(c)
            return c
        if isinstance(e, Subquery):
            if e.kind in ("any", "all"):
                return self._bind_quant(e, value_pos=True)
            c = copy.copy(e)
            if c.outer is not None:
                c.outer = self.bind_expr(c.outer)
            sub = self._sub(outer_scope=self.scope)
            srel, scols = sub._bind_query(c.select, collect_corr=True)
            if sub.correlations:
                return self._bind_scalar_apply(sub, srel, scols)
            c.select = ("bound", srel, scols)
            c.typ = scols[0].typ if scols else F64
            return c
        if isinstance(e, Func):
            sf = getattr(self.catalog, "sqlfuncs", {}) or {}
            f = sf.get(e.name)
            if f is not None and f.get("kind", "scalar") == "scalar":
                # SQL scalar function: inline the RETURN expression with
                # arguments substituted (the reference inlines side-effect-
                # free SQL functions the same way, rel_optimize_proj.c)
                if len(e.args) != len(f["params"]):
                    raise BindError(
                        f"function {e.name} expects {len(f['params'])} "
                        f"arguments, got {len(e.args)}")
                if e.name in self._expanding:
                    raise BindError(f"recursive SQL function {e.name}")
                from .parser import parse_expr
                tmpl = parse_expr(f["body"])
                # bind arguments first so nested calls of the same function
                # expand before the guard engages (composition ≠ recursion)
                sub = {pn: self.bind_expr(arg) for (pn, _tag), arg
                       in zip(f["params"], e.args)}
                self._expanding.add(e.name)
                try:
                    return self.bind_expr(self._subst(tmpl, sub))
                finally:
                    self._expanding.discard(e.name)
        kids = e.children()
        if not kids:
            c = copy.copy(e)
            self._retype(c)
            return c
        c = self._clone_with(e, [self.bind_expr(k) for k in kids])
        self._retype(c)
        return c

    def _subst(self, e: Expr, sub: Dict[str, Expr]) -> Expr:
        if isinstance(e, ColRef) and e.table is None and e.name in sub:
            return copy.deepcopy(sub[e.name])
        if isinstance(e, Subquery) and not isinstance(e.select, tuple):
            # SQL-function params reach into subquery bodies (rel_psm.c
            # inlines through nested selects the same way)
            c = copy.copy(e)
            c.select = self._subst_stmt(e.select, sub)
            if c.outer is not None:
                c.outer = self._subst(c.outer, sub)
            return c
        kids = e.children()
        if not kids:
            return e
        return self._clone_with(e, [self._subst(k, sub) for k in kids])

    def _subst_stmt(self, st, sub):
        """Parameter substitution inside an unbound SelectStmt AST."""
        st = copy.copy(st)
        st.items = [(al, self._subst(it, sub)) for al, it in st.items]
        if st.where is not None:
            st.where = self._subst(st.where, sub)
        if st.having is not None:
            st.having = self._subst(st.having, sub)
        st.group_by = [self._subst(g, sub) for g in st.group_by]
        st.order_by = [(self._subst(o, sub), d, nl)
                       for o, d, nl in st.order_by]
        return st

    def _type_const(self, c: Const):
        v = c.value
        if c.ctype is not None:
            c.typ = c.ctype
            return
        if v is None:
            c.typ = None
        elif isinstance(v, bool):
            c.typ = BOOL
        elif isinstance(v, int):
            c.typ = I32 if -(2 ** 31) < v < 2 ** 31 else I64
        elif isinstance(v, float):
            c.typ = F64
        elif isinstance(v, Decimal):
            c.typ = dec_t(18, -v.as_tuple().exponent)
        elif isinstance(v, str):
            c.typ = varchar()
        elif isinstance(v, datetime.datetime):
            from ..dtypes import TIMESTAMP as _TS
            c.typ = _TS
        elif isinstance(v, datetime.date):
            c.typ = DATE
        elif isinstance(v, datetime.time):
            from ..dtypes import TIME as _TIME
            c.typ = _TIME
        elif isinstance(v, tuple):
            c.typ = None
        else:
            raise BindError(f"cannot type constant {v!r}")

    def _retype(self, e: Expr):
        if isinstance(e, BinOp):
            lt, rt = e.left.typ, e.right.typ
            if isinstance(e.left, Const) and isinstance(e.right, Const):
                lv, rv = e.left.value, e.right.value
                if isinstance(lv, tuple) and isinstance(rv, tuple):
                    # interval ± interval: combine in a common unit
                    # (months for year-month, seconds for day-time)
                    la, lu = lv
                    ra, ru = rv
                    sgn = -1 if e.op == "-" else 1
                    month_u = {"year": 12, "quarter": 3, "month": 1}
                    sec_u = {"week": 604800, "day": 86400, "hour": 3600,
                             "minute": 60, "second": 1}
                    nv = None
                    if lu in month_u and ru in month_u:
                        nv = (la * month_u[lu] + sgn * ra * month_u[ru],
                              "month")
                    elif lu in sec_u and ru in sec_u:
                        nv = (la * sec_u[lu] + sgn * ra * sec_u[ru],
                              "second")
                    if nv is not None:
                        e.__class__ = Const
                        e.__dict__.clear()
                        e.__dict__.update(value=nv, ctype=None)
                        e.typ = None
                        return
                if isinstance(lv, datetime.time) and isinstance(rv, tuple):
                    # TIME ± interval: wraps mod 24h (mtime rules)
                    amt, unit = rv
                    if e.op == "-":
                        amt = -amt
                    us = {"hour": 3_600_000_000, "minute": 60_000_000,
                          "second": 1_000_000}.get(unit)
                    if us is not None:
                        cur = ((lv.hour * 60 + lv.minute) * 60
                               + lv.second) * 1_000_000 + lv.microsecond
                        tot = (cur + amt * us) % 86_400_000_000
                        sec, usp = divmod(tot, 1_000_000)
                        h, rem = divmod(sec, 3600)
                        m, sc = divmod(rem, 60)
                        from ..dtypes import TIME as _TIME
                        nv = datetime.time(int(h), int(m), int(sc),
                                           int(usp))
                        e.__class__ = Const
                        e.__dict__.clear()
                        e.__dict__.update(value=nv, ctype=_TIME)
                        e.typ = _TIME
                        return
                if isinstance(lv, datetime.date) and isinstance(rv, tuple):
                    amt, unit = rv
                    if e.op == "-":
                        amt = -amt
                    us = {"hour": 3_600_000_000, "minute": 60_000_000,
                          "second": 1_000_000}.get(unit)
                    if us is not None and not isinstance(
                            lv, datetime.datetime):
                        # DATE ± sub-day interval stays DATE: the delta
                        # applies at day granularity (mtime date rules)
                        unit = "day"
                        amt = int(amt * us / 86_400_000_000)
                    nv = add_interval(lv, amt, unit)
                    from ..dtypes import TIMESTAMP as _TS
                    ct = _TS if isinstance(nv, datetime.datetime) else DATE
                    e.__class__ = Const
                    e.__dict__.clear()
                    e.__dict__.update(value=nv, ctype=ct)
                    e.typ = ct
                    return
                if isinstance(lv, (int, float, Decimal)) and \
                        isinstance(rv, (int, float, Decimal)):
                    def _idiv(a, b):
                        # int/int divides like C: truncation toward zero
                        # (gdk_calc div; python // floors, which differs
                        # for negative quotients); /0 → 22012
                        if b == 0:
                            from ..ops.calc import CalcDivZero
                            raise CalcDivZero("22012!division by zero")
                        if not (isinstance(a, int) and isinstance(b, int)):
                            return a / b
                        q = a // b
                        if a % b != 0 and (a < 0) != (b < 0):
                            q += 1
                        return q

                    f = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
                         "*": lambda a, b: a * b, "/": _idiv}.get(e.op)
                    if f is not None:
                        nv = f(lv, rv)
                        e.__class__ = Const
                        e.__dict__.clear()
                        e.__dict__.update(value=nv, ctype=None)
                        self._type_const(e)
                        return
            if isinstance(e.right, Const) and isinstance(e.right.value, tuple) \
                    and lt is not None and \
                    lt.kind in (Kind.DATE, Kind.TIMESTAMP):
                # column ± interval: month/year intervals may keep DATE;
                # sub-day units promote DATE to TIMESTAMP
                amt, unit = e.right.value
                from ..dtypes import TIMESTAMP as _TS
                e.typ = _TS if (lt.kind == Kind.TIMESTAMP or
                                unit in ("hour", "minute", "second")) else DATE
                return
            if lt is None or rt is None:
                e.typ = lt or rt
                return
            if e.op == "||":
                e.typ = varchar()
                return
            if lt.kind == Kind.DATE and rt is not None and \
                    rt.kind == Kind.DATE and e.op == "-":
                e.typ = I32     # date difference in days (gdk_time.c)
                return
            if lt.kind == Kind.DATE and e.op in "+-":
                e.typ = DATE
                return
            if lt.kind == Kind.TIMESTAMP and e.op in "+-":
                from ..dtypes import TIMESTAMP as _TS
                e.typ = _TS
                return
            if e.op == "/":
                e.typ = (lt if lt.np_dtype.kind == "i" and
                         rt.np_dtype.kind == "i" and
                         lt.kind != Kind.DECIMAL and rt.kind != Kind.DECIMAL
                         else F64)
                return
            if lt.np_dtype.kind == "f" or rt.np_dtype.kind == "f":
                e.typ = F64
                return
            if lt.kind == Kind.DECIMAL or rt.kind == Kind.DECIMAL:
                ls = lt.scale if lt.kind == Kind.DECIMAL else 0
                rs = rt.scale if rt.kind == Kind.DECIMAL else 0
                e.typ = dec_t(18, ls + rs if e.op == "*" else max(ls, rs))
                return
            from ..dtypes import common_numeric
            e.typ = common_numeric(lt, rt)
            return
        if isinstance(e, (Cmp, BoolOp, Not, IsNull, Between, InList, Like)):
            e.typ = BOOL
            return
        if isinstance(e, Case):
            ts = [v.typ for _, v in e.whens if v.typ is not None]
            if e.default is not None and e.default.typ is not None:
                ts.append(e.default.typ)
            if not ts:
                e.typ = F64
            elif any(t.kind == Kind.STR for t in ts):
                e.typ = varchar()
            elif any(t.kind in (Kind.DATE, Kind.TIMESTAMP, Kind.TIME)
                     for t in ts):
                e.typ = next(t for t in ts
                             if t.kind in (Kind.DATE, Kind.TIMESTAMP,
                                           Kind.TIME))
            elif any(t.np_dtype.kind == "f" for t in ts):
                e.typ = F64
            elif any(t.kind == Kind.DECIMAL for t in ts):
                sc = max(t.scale if t.kind == Kind.DECIMAL else 0 for t in ts)
                e.typ = dec_t(18, sc)
            else:
                e.typ = max(ts, key=lambda t: t.np_dtype.itemsize)
            return
        if isinstance(e, Cast):
            e.typ = e.to
            return
        if isinstance(e, Func):
            if e.name in ("coalesce", "ifnull", "nvl", "greatest", "least",
                          "sql_max", "sql_min", "nullif"):
                ts = [a.typ for a in e.args if a.typ is not None]
                if e.name == "nullif":
                    ts = ts[:1]
                if not ts:
                    e.typ = None
                elif any(t.kind == Kind.STR for t in ts):
                    e.typ = varchar()
                elif any(t.kind in (Kind.DATE, Kind.TIMESTAMP, Kind.TIME)
                         for t in ts):
                    e.typ = next(t for t in ts
                                 if t.kind in (Kind.DATE, Kind.TIMESTAMP,
                                               Kind.TIME))
                elif any(t.np_dtype.kind == "f" for t in ts):
                    e.typ = F64
                elif any(t.kind == Kind.DECIMAL for t in ts):
                    sc = max(t.scale if t.kind == Kind.DECIMAL else 0
                             for t in ts)
                    e.typ = dec_t(18, sc)
                elif all(t.kind == Kind.BOOL for t in ts):
                    e.typ = BOOL
                else:
                    e.typ = max(ts, key=lambda t: t.np_dtype.itemsize)
                return
            if e.name in ("year", "month", "day", "dayofmonth", "quarter",
                          "dayofweek", "dayofyear", "weekofyear", "week",
                          "hour", "minute", "century", "decade"):
                e.typ = I32
                return
            if e.name == "second":
                e.typ = I32
                return
            if e.name == "epoch":
                e.typ = I64
                return
            if e.name == "date_trunc":
                e.typ = e.args[1].typ
                return
            if e.name.startswith("extract_"):
                e.typ = I64 if e.name == "extract_epoch" else I32
            elif e.name in ("substring", "upper", "ucase", "lower", "lcase",
                            "trim", "ltrim", "rtrim", "replace", "lpad",
                            "rpad", "concat", "left", "right", "repeat",
                            "reverse", "splitpart", "insert",
                            "regexp_replace", "md5"):
                e.typ = varchar()
            elif e.name in ("startswith", "endswith", "contains",
                            "isauuid", "inet_contains",
                            "inet_contained_or_equal"):
                e.typ = BOOL
            elif e.name == "uuid" or (e.name.startswith("get") and
                                      e.name[3:] in (
                    "protocol", "host", "domain", "file", "basename",
                    "anchor", "query", "user", "port", "context")):
                e.typ = varchar()
            elif e.name in ("length", "char_length", "character_length",
                            "octet_length",
                            "locate", "position", "ascii"):
                e.typ = I32
            elif e.name in ("levenshtein", "editdistance", "editdistance2",
                            "difference"):
                e.typ = I32
            elif e.name == "jarowinkler":
                e.typ = F64
            elif e.name in ("soundex", "qgramnormalize"):
                e.typ = varchar()
            elif e.name in ("json_filter", "json_text", "json_keyarray",
                            "json_valuearray"):
                e.typ = varchar()
            elif e.name == "json_isvalid":
                e.typ = BOOL
            elif e.name == "json_length":
                e.typ = I32
            elif e.name == "next_value_for":
                e.typ = I64
            elif e.name in ("st_x", "st_y", "st_distance",
                            "st_distance_geographic", "st_area",
                            "st_length", "st_perimeter", "st_xmin",
                            "st_ymin", "st_xmax", "st_ymax"):
                e.typ = F64
            elif e.name in ("st_contains", "st_intersects", "st_within",
                            "st_dwithin", "st_dwithingeographic",
                            "st_disjoint", "st_equals", "st_touches",
                            "st_crosses", "st_overlaps", "st_covers",
                            "st_coveredby", "st_isvalid", "st_issimple",
                            "st_isempty", "st_isclosed", "st_isring"):
                e.typ = BOOL
            elif e.name in ("st_astext", "st_centroid", "st_envelope",
                            "st_makepoint", "st_point", "st_geomfromtext",
                            "st_pointfromtext", "st_polygonfromtext",
                            "st_geometryfromtext", "st_mpolyfromtext",
                            "st_linefromtext", "st_setsrid",
                            "st_geometrytype", "st_geometryn",
                            "st_boundary", "st_convexhull", "st_buffer",
                            "st_pointonsurface", "st_startpoint",
                            "st_endpoint", "st_pointn", "st_exteriorring",
                            "st_interiorringn", "st_force2d",
                            "st_translate", "st_scale", "st_rotate",
                            "st_transform", "st_union", "st_intersection",
                            "st_difference", "st_symdifference",
                            "st_makeenvelope", "st_makeline",
                            "st_collect", "st_relate"):
                e.typ = varchar()
            elif e.name in ("st_numpoints", "st_npoints", "st_srid",
                            "st_dimension", "st_coorddim",
                            "st_numgeometries", "st_numinteriorrings"):
                e.typ = I32
            elif e.name == "str_to_date":
                e.typ = DATE
            elif e.name == "str_to_timestamp":
                e.typ = TIMESTAMP
            elif e.name == "str_to_time":
                from ..dtypes import TIME as _TIME
                e.typ = _TIME
            elif e.name in ("date_to_str", "timestamp_to_str",
                            "time_to_str"):
                e.typ = varchar()
            elif e.name in ("sqrt", "ln", "log10", "exp", "sin", "cos",
                            "tan", "power"):
                e.typ = F64
            elif e.name in ("floor", "ceil", "ceiling"):
                e.typ = F64
            elif e.name in ("neg", "abs"):
                e.typ = e.args[0].typ
            elif e.name in self.catalog.udfs:
                u = self.catalog.udfs[e.name]
                if len(e.args) != len(u.arg_names):
                    raise BindError(
                        f"function {e.name} expects {len(u.arg_names)} "
                        f"arguments, got {len(e.args)}")
                e.typ = u.ret_type
            else:
                e.typ = e.args[0].typ if e.args else F64
            return
        if isinstance(e, AggRef):
            e.typ = self._agg_type(e.func, e.arg)
            return
        if isinstance(e, WinRef):
            if e.func in ("row_number", "rank", "dense_rank", "ntile",
                          "count", "count_star"):
                e.typ = I64
            elif e.func in ("percent_rank", "cume_dist", "avg"):
                e.typ = F64
            elif e.func in ("lag", "lead", "first_value", "last_value",
                            "nth_value", "min", "max"):
                e.typ = e.arg.typ
            else:
                e.typ = self._agg_type(e.func, e.arg)
            return


def bind_select(catalog: Catalog, sql_or_stmt) -> Tuple[L.Rel, List[ColInfo]]:
    stmt = parse(sql_or_stmt) if isinstance(sql_or_stmt, str) else sql_or_stmt
    if not isinstance(stmt, A.SelectStmt):
        raise BindError("not a SELECT")
    rel, out_cols = Binder(catalog).bind(stmt)
    if catalog.merges or catalog.remotes or catalog.replicas:
        from .distribute import expand_distribution
        rel = expand_distribution(rel, catalog)
    return rel, out_cols

"""Analyzer: AST -> typed logical plan.

The analog of src/backend/parser/analyze.c + parse_expr.c + parse_agg.c:
binds names against the catalog, resolves types with implicit coercions,
extracts aggregates, rewrites IN-subqueries to semi-joins, and lowers
literals to physical representation (decimal = scaled int64, date = epoch
days, text patterns kept as python strings for dictionary resolution).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.catalog import Catalog
from opentenbase_tpu_torch.plan import texpr as E
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.sql import ast as A

AGG_FUNCS = {"sum", "count", "avg", "min", "max"}


class AnalyzeError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Scopes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ScopeCol:
    qualifier: Optional[str]
    name: str
    type: t.SqlType
    dict_id: Optional[str] = None


class Scope:
    def __init__(self, cols: list[ScopeCol]):
        self.cols = cols

    def resolve(self, name: str, qualifier: Optional[str]) -> tuple[int, ScopeCol]:
        matches = [
            (i, c)
            for i, c in enumerate(self.cols)
            if c.name == name and (qualifier is None or c.qualifier == qualifier)
        ]
        if not matches:
            q = f"{qualifier}." if qualifier else ""
            raise AnalyzeError(f'column "{q}{name}" does not exist')
        if len(matches) > 1:
            raise AnalyzeError(f'column reference "{name}" is ambiguous')
        return matches[0]

    def concat(self, other: "Scope") -> "Scope":
        return Scope(self.cols + other.cols)

    def out_schema(self) -> tuple[L.OutCol, ...]:
        return tuple(L.OutCol(c.name, c.type, c.dict_id) for c in self.cols)


def scope_from_schema(schema: tuple[L.OutCol, ...], qualifier: Optional[str]) -> Scope:
    return Scope([ScopeCol(qualifier, c.name, c.type, c.dict_id) for c in schema])


# ---------------------------------------------------------------------------
# Literal -> physical conversion
# ---------------------------------------------------------------------------

def _date_days(s: str) -> int:
    try:
        return int(np.datetime64(s, "D").astype("int64"))
    except Exception:
        raise AnalyzeError(f"invalid date literal {s!r}") from None


def _timestamp_us(s: str) -> int:
    try:
        return int(np.datetime64(s, "us").astype("int64"))
    except Exception:
        raise AnalyzeError(f"invalid timestamp literal {s!r}") from None


def literal_to_physical(value: object, ty: t.SqlType) -> object:
    """Convert a python literal to ``ty``'s physical representation.
    Raises AnalyzeError (never a bare ValueError) on malformed input so
    callers' coercion fallbacks work."""
    if value is None:
        return None
    tid = ty.id
    try:
        if tid == t.TypeId.DECIMAL:
            return round(float(value) * ty.decimal_factor)
        if tid == t.TypeId.DATE:
            return _date_days(str(value)) if isinstance(value, str) else int(value)
        if tid == t.TypeId.TIMESTAMP:
            return _timestamp_us(str(value)) if isinstance(value, str) else int(value)
        if tid in (t.TypeId.INT4, t.TypeId.INT8):
            iv = int(value)  # type: ignore[arg-type]
            if isinstance(value, float) and value != iv:
                raise AnalyzeError(f"invalid integer literal {value!r}")
            return iv
        if tid in (t.TypeId.FLOAT4, t.TypeId.FLOAT8):
            return float(value)  # type: ignore[arg-type]
        if tid == t.TypeId.BOOL:
            return bool(value)
        if tid == t.TypeId.TEXT:
            return str(value)
    except AnalyzeError:
        raise
    except (TypeError, ValueError):
        raise AnalyzeError(
            f"invalid literal {value!r} for type {ty}"
        ) from None
    raise AnalyzeError(f"cannot convert literal to {ty}")


@dataclass
class _Interval:
    """Analysis-time interval value (never reaches execution unfolded)."""

    months: int = 0
    days: int = 0
    usecs: int = 0


_INTERVAL_UNITS = {
    "year": ("months", 12), "years": ("months", 12),
    "month": ("months", 1), "months": ("months", 1), "mon": ("months", 1),
    "week": ("days", 7), "weeks": ("days", 7),
    "day": ("days", 1), "days": ("days", 1),
    "hour": ("usecs", 3_600_000_000), "hours": ("usecs", 3_600_000_000),
    "minute": ("usecs", 60_000_000), "minutes": ("usecs", 60_000_000),
    "second": ("usecs", 1_000_000), "seconds": ("usecs", 1_000_000),
}


def _parse_interval(text: str) -> _Interval:
    iv = _Interval()
    parts = text.split()
    if len(parts) % 2 != 0:
        raise AnalyzeError(f"cannot parse interval {text!r}")
    for i in range(0, len(parts), 2):
        try:
            qty = int(parts[i])
        except ValueError:
            raise AnalyzeError(f"cannot parse interval {text!r}") from None
        unit = parts[i + 1].lower()
        if unit not in _INTERVAL_UNITS:
            raise AnalyzeError(f"unknown interval unit {unit!r}")
        field_name, mult = _INTERVAL_UNITS[unit]
        setattr(iv, field_name, getattr(iv, field_name) + qty * mult)
    return iv


def _add_interval_to_days(days: int, iv: _Interval, sign: int) -> int:
    d = np.datetime64(int(days), "D")
    if iv.months:
        m = d.astype("datetime64[M]")
        day_of_month = (d - m.astype("datetime64[D]")).astype(int)
        m2 = m + np.timedelta64(sign * iv.months, "M")
        d = m2.astype("datetime64[D]") + np.timedelta64(int(day_of_month), "D")
    d = d + np.timedelta64(sign * iv.days, "D")
    return int(d.astype("int64"))


# ---------------------------------------------------------------------------
# Expression analysis
# ---------------------------------------------------------------------------

class ExprContext:
    """Controls leaf resolution. ``grouped`` carries (input_ctx, group key
    map, aggs list, agg offset fn) when analyzing above an Aggregate."""

    def __init__(
        self,
        scope: Scope,
        analyzer: "Analyzer",
        allow_aggs: bool = False,
        grouped: Optional["GroupedContext"] = None,
    ):
        self.scope = scope
        self.analyzer = analyzer
        self.allow_aggs = allow_aggs
        self.grouped = grouped


class GroupedContext:
    def __init__(self, input_ctx: ExprContext, group_texprs: list[E.TExpr]):
        self.input_ctx = input_ctx
        self.group_keys = {g.key(): i for i, g in enumerate(group_texprs)}
        self.group_texprs = group_texprs
        self.aggs: list[E.AggCall] = []

    def agg_col(self, call: E.AggCall) -> E.Col:
        # Offset by len(group_texprs), not the deduped key dict: the
        # Aggregate node outputs one __g column per group expression entry.
        base = len(self.group_texprs)
        k = call.key()
        for i, existing in enumerate(self.aggs):
            if existing.key() == k:
                return E.Col(base + i, existing.type)
        self.aggs.append(call)
        return E.Col(base + len(self.aggs) - 1, call.type)


def _bool_type(e: E.TExpr) -> E.TExpr:
    if e.type.id != t.TypeId.BOOL:
        raise AnalyzeError(f"expected boolean expression, got {e.type}")
    return e


_ARITH = {"+", "-", "*", "/", "%"}
_CMP = {"=", "<>", "<", "<=", ">", ">="}


def _contains_window_nested(e: A.Expr) -> bool:
    """True if a WindowCall appears BELOW the top level of ``e``."""
    def inner(x, top: bool) -> bool:
        if isinstance(x, A.WindowCall):
            if not top:
                return True
            return any(inner(a, False) for a in x.func.args)
        for f in getattr(x, "__dataclass_fields__", {}):
            v = getattr(x, f)
            vs = v if isinstance(v, (list, tuple)) else (v,)
            for y in vs:
                if isinstance(y, A.Expr) and inner(y, False):
                    return True
        return False

    return inner(e, True)


def _coerce_const_to(e: E.TExpr, ty: t.SqlType) -> Optional[E.TExpr]:
    """If ``e`` is a Const convertible to ``ty``, return the converted
    Const (constants fold through coercion, parse_coerce.c style)."""
    if not isinstance(e, E.Const):
        return None
    try:
        return E.Const(literal_to_physical(
            _unphysical(e), ty), ty)
    except AnalyzeError:
        return None


def _unphysical(c: E.Const) -> object:
    """Recover a python-level value from a physical Const (for re-coercion)."""
    if c.value is None:
        return None
    if c.type.id == t.TypeId.DECIMAL:
        return c.value / c.type.decimal_factor  # type: ignore[operator]
    return c.value


def _cast(e: E.TExpr, ty: t.SqlType) -> E.TExpr:
    if e.type == ty:
        return e
    folded = _coerce_const_to(e, ty)
    if folded is not None:
        return folded
    return E.CastE(e, ty)


def _common_input_type(lt: t.SqlType, rt: t.SqlType, op: str) -> t.SqlType:
    if lt == rt:
        return lt
    if lt.is_numeric and rt.is_numeric:
        return t.common_numeric_type(lt, rt)
    # date/timestamp mixing: promote date to timestamp
    ids = {lt.id, rt.id}
    if ids == {t.TypeId.DATE, t.TypeId.TIMESTAMP}:
        return t.TIMESTAMP
    raise AnalyzeError(f"operator {op} has incompatible types {lt} and {rt}")


class Analyzer:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self.subplans: list[L.LogicalPlan] = []

    # ------------------------------------------------------------------
    # Statements
    # ------------------------------------------------------------------
    def _table(self, name: str):
        try:
            return self.catalog.get(name)
        except ValueError as e:
            raise AnalyzeError(str(e)) from None

    def statement(self, stmt: A.Statement) -> L.StatementPlan:
        if isinstance(stmt, A.Select):
            root = self.select(stmt)
        elif isinstance(stmt, A.Insert):
            root = self._insert(stmt)
        elif isinstance(stmt, A.Update):
            root = self._update(stmt)
        elif isinstance(stmt, A.Delete):
            root = self._delete(stmt)
        else:
            raise AnalyzeError(f"cannot analyze {type(stmt).__name__}")
        return L.StatementPlan(root, self.subplans)

    # ------------------------------------------------------------------
    # SELECT
    # ------------------------------------------------------------------
    def select(self, sel: A.Select) -> L.LogicalPlan:
        if sel.ctes:
            # WITH needs no engine state — expanding here makes CTEs
            # work for every analyzer consumer, not just the session
            # pipeline (which also runs this; it is idempotent)
            from opentenbase_tpu_torch.plan.views import (
                ViewRecursionError,
                expand_ctes,
            )

            try:
                expand_ctes(sel)
            except ViewRecursionError as e:
                raise AnalyzeError(str(e)) from None
        if sel.set_ops:
            return self._set_ops(sel)
        return self._select_core(sel)

    def _set_ops(self, sel: A.Select) -> L.LogicalPlan:
        base = A.Select(
            items=sel.items, from_clause=sel.from_clause, where=sel.where,
            group_by=sel.group_by, having=sel.having, distinct=sel.distinct,
            values_rows=sel.values_rows,
        )
        plan = self._select_core(base)
        for op, branch_ast in sel.set_ops:
            branch = self.select(branch_ast)
            if len(branch.schema) != len(plan.schema):
                raise AnalyzeError("each UNION query must have the same number of columns")
            plan_c, branch_c = self._align_schemas(plan, branch)
            if op in ("union", "union all"):
                # prefer whichever side knows the dictionary — a
                # NULL-literal text column (grouping-set padding)
                # carries none
                schema = tuple(
                    ca if ca.dict_id is not None or cb.dict_id is None
                    else L.OutCol(ca.name, ca.type, cb.dict_id)
                    for ca, cb in zip(plan_c.schema, branch_c.schema)
                )
                u = L.Union((plan_c, branch_c), schema)
                plan = u if op == "union all" else L.Distinct(u, u.schema)
            elif op == "intersect":
                plan = self._setop_join(plan_c, branch_c, "semi")
            else:  # except
                plan = self._setop_join(plan_c, branch_c, "anti")
        plan = self._order_limit_over(plan, sel)
        return plan

    def _align_schemas(
        self, a: L.LogicalPlan, b: L.LogicalPlan
    ) -> tuple[L.LogicalPlan, L.LogicalPlan]:
        """Coerce two set-op branches to a common schema. A column that
        is a bare NULL literal on one side (PG's "unknown" type —
        grouping-set padding produces these) adopts the other side's
        type instead of forcing a common-type lookup."""
        def null_cols(p: L.LogicalPlan) -> set:
            if isinstance(p, L.Project):
                return {
                    i for i, e in enumerate(p.exprs)
                    if isinstance(e, E.Const) and e.value is None
                }
            if isinstance(p, L.Union):
                # a chained set-op output column is known-NULL when
                # every input's is
                out = null_cols(p.inputs[0])
                for q in p.inputs[1:]:
                    out &= null_cols(q)
                return out
            if isinstance(p, (L.Distinct, L.Sort, L.Limit)):
                return null_cols(p.children()[0])
            return set()

        na, nb = null_cols(a), null_cols(b)
        types = []
        for i, (ca, cb) in enumerate(zip(a.schema, b.schema)):
            if ca.type == cb.type:
                types.append(ca.type)
            elif i in na and i not in nb:
                types.append(cb.type)
            elif i in nb and i not in na:
                types.append(ca.type)
            else:
                types.append(
                    _common_input_type(ca.type, cb.type, "UNION")
                )

        def project_to(p: L.LogicalPlan) -> L.LogicalPlan:
            if all(c.type == ty for c, ty in zip(p.schema, types)):
                return p
            nulls = null_cols(p)
            # known-all-NULL columns re-project as typed NULL consts
            # (no runtime cast path needed for e.g. int4 -> text)
            exprs = tuple(
                E.Const(None, ty) if i in nulls
                else _cast(E.Col(i, c.type, c.name), ty)
                for i, (c, ty) in enumerate(zip(p.schema, types))
            )
            schema = tuple(
                L.OutCol(c.name, ty, c.dict_id if ty.id == t.TypeId.TEXT else None)
                for c, ty in zip(p.schema, types)
            )
            return L.Project(p, exprs, schema)

        return project_to(a), project_to(b)

    def _setop_join(self, left: L.LogicalPlan, right: L.LogicalPlan, jt: str) -> L.LogicalPlan:
        keys_l = tuple(E.Col(i, c.type, c.name) for i, c in enumerate(left.schema))
        keys_r = tuple(E.Col(i, c.type, c.name) for i, c in enumerate(right.schema))
        d = L.Distinct(left, left.schema)
        return L.Join(d, right, jt, keys_l, keys_r, None, d.schema)

    def _select_core(self, sel: A.Select) -> L.LogicalPlan:
        # FROM
        if sel.values_rows and not sel.items:
            plan, scope = self._values_stmt(sel)
        elif sel.from_clause is not None:
            plan, scope = self._from(sel.from_clause)
        else:
            plan, scope = self._no_from(sel)
        ctx = ExprContext(scope, self)

        # WHERE — IN/EXISTS subquery conjuncts become semi/anti joins
        # (the pull-up that PG does in pull_up_sublinks); the rest is a
        # vectorized Filter.
        if sel.where is not None:
            plain: list[A.Expr] = []
            pre_tes: list[E.TExpr] = []
            for c in _split_and(sel.where):
                # the parser emits NOT EXISTS as UnaryOp('not', Exists)
                if (
                    isinstance(c, A.UnaryOp) and c.op == "not"
                    and isinstance(c.operand, A.ExistsSubquery)
                ):
                    c = A.ExistsSubquery(
                        c.operand.query, not c.operand.negated
                    )
                if isinstance(c, A.InSubquery):
                    # correlated IN: rewrite to the EXISTS pull-up
                    # (x IN (SELECT e FROM ...) == EXISTS(... AND
                    # e = x), convert_ANY_sublink_to_join)
                    pulled = self._in_corr_pullup(plan, scope, c)
                    if pulled is not None:
                        plan = pulled
                        continue
                    plan = self._in_subquery_join(plan, scope, c)
                elif isinstance(c, A.ExistsSubquery):
                    # correlated EXISTS -> semi/anti join when every
                    # correlation is a top-level equality (the sublink
                    # pull-up, src/backend/optimizer/prep/prepjointree.c)
                    pulled = self._exists_subquery_join(plan, scope, c)
                    if pulled is not None:
                        plan = pulled
                        continue
                    # uncorrelated EXISTS -> scalar count subquery > 0
                    counted = A.Select(
                        items=[A.SelectItem(A.FuncCall("count", (), star=True))],
                        from_clause=A.SubqueryRef(c.query, "__exists"),
                    )
                    cmp = A.BinOp("=" if c.negated else ">", A.ScalarSubquery(counted), A.Literal(0))
                    plain.append(cmp)
                else:
                    # correlated scalar-aggregate comparison -> grouped
                    # LEFT join on the correlation keys
                    corr = self._try_corr_scalar(plan, scope, c)
                    if corr is not None:
                        plan, corr_te = corr
                        pre_tes.append(corr_te)
                        continue
                    plain.append(c)
            if plain or pre_tes:
                pred: Optional[E.TExpr] = None
                for c in plain:
                    te = _bool_type(self.expr(c, ctx))
                    pred = te if pred is None else E.BinE("and", pred, te, t.BOOL)
                for te in pre_tes:
                    te = _bool_type(te)
                    pred = te if pred is None else E.BinE("and", pred, te, t.BOOL)
                assert pred is not None
                plan = L.Filter(plan, pred, plan.schema)

        has_aggs = any(
            self._contains_agg(item.expr) for item in sel.items
        ) or (sel.having is not None) or bool(sel.group_by)
        has_windows = any(
            isinstance(item.expr, A.WindowCall) for item in sel.items
        )
        if has_windows and has_aggs:
            raise AnalyzeError(
                "window functions over grouped/aggregated queries are not"
                " yet supported"
            )
        if any(
            _contains_window_nested(item.expr) for item in sel.items
        ):
            raise AnalyzeError(
                "window functions are only supported as top-level SELECT"
                " expressions"
            )

        order_hidden: list[E.TExpr] = []
        if has_aggs:
            inplan, group_texprs, having_te, out_exprs, out_schema, gctx = (
                self._grouped(sel, plan, ctx)
            )
            post_scope = scope
        elif has_windows:
            plan, out_exprs, out_schema = self._windowed(sel, plan, ctx, scope)
            gctx = None
            post_scope = scope
        else:
            # BARE correlated scalar-aggregate subqueries as select
            # items decorrelate the same way WHERE conjuncts do; the
            # joined value column replaces the subquery expression
            pre_cols: dict = {}
            for ii, item in enumerate(sel.items):
                if isinstance(item.expr, A.ScalarSubquery):
                    out = self._decorr_scalar(plan, scope, item.expr)
                    if out is not None:
                        plan, te_col = out
                        # dict id resolved against the JOINED schema
                        # (a TEXT min/max value column keeps its
                        # table dictionary)
                        pre_cols[ii] = (
                            te_col,
                            _expr_dict_id(te_col, plan.schema),
                        )
            out_exprs, out_schema = self._select_items(
                sel.items, ctx, scope, pre_cols=pre_cols
            )
            gctx = None
            post_scope = scope

        # ORDER BY: resolve against output aliases/positions first, else
        # against the pre-projection scope (hidden junk columns). For
        # grouped queries this may append new aggregates to gctx.aggs, so
        # the Aggregate node is only built afterwards.
        sort_keys: list[L.SortKey] = []
        if sel.order_by:
            for si in sel.order_by:
                keyexpr = self._resolve_order_expr(
                    si.expr, sel, out_exprs, out_schema, ctx, gctx, order_hidden, post_scope
                )
                sort_keys.append(L.SortKey(keyexpr, si.descending, si.nulls_first))

        if has_aggs:
            plan = self._build_aggregate(
                inplan, group_texprs, gctx, having_te, ctx
            )

        nvisible = len(out_exprs)
        proj_exprs = tuple(out_exprs) + tuple(order_hidden)
        proj_schema = tuple(out_schema) + tuple(
            L.OutCol(f"__sort{i}", e.type, _expr_dict_id(e, plan.schema))
            for i, e in enumerate(order_hidden)
        )
        plan = L.Project(plan, proj_exprs, proj_schema)

        if sel.distinct:
            if order_hidden:
                raise AnalyzeError(
                    "for SELECT DISTINCT, ORDER BY expressions must appear in select list"
                )
            plan = L.Distinct(plan, plan.schema)

        if sort_keys:
            plan = L.Sort(plan, tuple(sort_keys), plan.schema)
        if order_hidden:
            exprs = tuple(
                E.Col(i, c.type, c.name) for i, c in enumerate(plan.schema[:nvisible])
            )
            plan = L.Project(plan, exprs, plan.schema[:nvisible])

        plan = self._limit_over(plan, sel)
        return plan

    def _order_limit_over(self, plan: L.LogicalPlan, sel: A.Select) -> L.LogicalPlan:
        """ORDER BY/LIMIT applied over a set-op result (output scope only)."""
        if sel.order_by:
            out_scope = scope_from_schema(plan.schema, None)
            keys = []
            for si in sel.order_by:
                if isinstance(si.expr, A.Literal) and isinstance(si.expr.value, int):
                    pos = si.expr.value
                    if not 1 <= pos <= len(plan.schema):
                        raise AnalyzeError(f"ORDER BY position {pos} is out of range")
                    c = plan.schema[pos - 1]
                    te: E.TExpr = E.Col(pos - 1, c.type, c.name)
                else:
                    te = self.expr(si.expr, ExprContext(out_scope, self))
                keys.append(L.SortKey(te, si.descending, si.nulls_first))
            plan = L.Sort(plan, tuple(keys), plan.schema)
        return self._limit_over(plan, sel)

    def _limit_over(self, plan: L.LogicalPlan, sel: A.Select) -> L.LogicalPlan:
        if sel.limit is None and sel.offset is None:
            return plan
        limit = self._const_int(sel.limit) if sel.limit is not None else None
        offset = self._const_int(sel.offset) if sel.offset is not None else 0
        return L.Limit(plan, limit, offset, plan.schema)

    def _const_int(self, e: A.Expr) -> int:
        if isinstance(e, A.Literal) and isinstance(e.value, int):
            return e.value
        raise AnalyzeError("LIMIT/OFFSET must be an integer constant")

    def _no_from(self, sel: A.Select) -> tuple[L.LogicalPlan, Scope]:
        """SELECT without FROM: one-row ValuesScan."""
        plan = L.ValuesScan(((),), ())
        return plan, Scope([])

    def _values_stmt(self, sel: A.Select) -> tuple[L.LogicalPlan, Scope]:
        """Standalone VALUES (...), (...): a ValuesScan with PG's
        column1..columnN names; column types unify across rows.
        Synthesizes the select list so projection/ORDER BY/set ops all
        run the ordinary path."""
        ectx = ExprContext(Scope([]), self)
        rows_te = []
        arity = len(sel.values_rows[0])
        for row in sel.values_rows:
            if len(row) != arity:
                raise AnalyzeError(
                    "VALUES lists must all be the same length"
                )
            rows_te.append([self.expr(v, ectx) for v in row])
        types = []
        for i in range(arity):
            ty = rows_te[0][i].type
            for r in rows_te[1:]:
                if r[i].type != ty:
                    ty = _common_input_type(ty, r[i].type, "VALUES")
            types.append(ty)
        rows_cast = tuple(
            tuple(_cast(v, ty) for v, ty in zip(r, types))
            for r in rows_te
        )
        schema = tuple(
            L.OutCol(f"column{i + 1}", ty)
            for i, ty in enumerate(types)
        )
        plan = L.ValuesScan(rows_cast, schema)
        scope = Scope([
            ScopeCol(None, c.name, c.type, c.dict_id) for c in schema
        ])
        sel.items = [
            A.SelectItem(A.ColumnRef(c.name, None)) for c in schema
        ]
        sel.values_rows = []
        return plan, scope

    # ------------------------------------------------------------------
    # FROM clause
    # ------------------------------------------------------------------
    def _from(self, ref: A.TableRef) -> tuple[L.LogicalPlan, Scope]:
        if isinstance(ref, A.RelRef):
            meta = self._table(ref.name)
            qualifier = ref.alias or ref.name
            schema = tuple(
                L.OutCol(
                    name, ty,
                    f"{ref.name}.{name}" if ty.id == t.TypeId.TEXT else None,
                )
                for name, ty in meta.schema.items()
            )
            plan = L.Scan(ref.name, tuple(meta.schema.keys()), schema)
            return plan, scope_from_schema(schema, qualifier)
        if isinstance(ref, A.SubqueryRef):
            sub = self.select(ref.query)
            return sub, scope_from_schema(sub.schema, ref.alias)
        if isinstance(ref, A.JoinRef):
            return self._join(ref)
        raise AnalyzeError(f"unsupported FROM item {type(ref).__name__}")

    def _join(self, ref: A.JoinRef) -> tuple[L.LogicalPlan, Scope]:
        lp, ls = self._from(ref.left)
        rp, rs = self._from(ref.right)
        scope = ls.concat(rs)
        jt = ref.join_type
        if jt == "cross":
            plan = L.Join(lp, rp, "inner", (), (), None, scope.out_schema())
            return plan, scope
        left_keys: list[E.TExpr] = []
        right_keys: list[E.TExpr] = []
        residual: Optional[E.TExpr] = None
        if ref.using:
            for name in ref.using:
                li, lc = ls.resolve(name, None)
                ri, rc = rs.resolve(name, None)
                ct = lc.type if lc.type == rc.type else _common_input_type(lc.type, rc.type, "USING")
                left_keys.append(_cast(E.Col(li, lc.type, name), ct))
                right_keys.append(_cast(E.Col(ri, rc.type, name), ct))
        elif ref.condition is not None:
            conjuncts = _split_and(ref.condition)
            for c in conjuncts:
                pair = self._equi_key(c, ls, rs)
                if pair is not None:
                    left_keys.append(pair[0])
                    right_keys.append(pair[1])
                else:
                    ctx = ExprContext(scope, self)
                    te = _bool_type(self.expr(c, ctx))
                    residual = te if residual is None else E.BinE("and", residual, te, t.BOOL)
        # empty key tuples = pure theta-join: cross join + residual filter
        plan = L.Join(lp, rp, jt, tuple(left_keys), tuple(right_keys), residual, scope.out_schema())
        return plan, scope

    def _equi_key(
        self, cond: A.Expr, ls: Scope, rs: Scope
    ) -> Optional[tuple[E.TExpr, E.TExpr]]:
        """If cond is `left_expr = right_expr` with sides cleanly split
        across the two inputs, return the coerced key pair."""
        if not (isinstance(cond, A.BinOp) and cond.op == "="):
            return None
        for a, b in ((cond.left, cond.right), (cond.right, cond.left)):
            mark = len(self.subplans)
            try:
                te_l = self.expr(a, ExprContext(ls, self))
                te_r = self.expr(b, ExprContext(rs, self))
            except AnalyzeError:
                del self.subplans[mark:]  # drop orphans of the failed try
                continue
            ct = (
                te_l.type
                if te_l.type == te_r.type
                else _common_input_type(te_l.type, te_r.type, "=")
            )
            return _cast(te_l, ct), _cast(te_r, ct)
        return None

    # ------------------------------------------------------------------
    # Select items / aggregation
    # ------------------------------------------------------------------
    def _select_items(
        self, items: list[A.SelectItem], ctx: ExprContext, scope: Scope,
        pre_cols=None,
    ) -> tuple[list[E.TExpr], list[L.OutCol]]:
        """``pre_cols``: item index -> pre-analyzed TExpr (decorrelated
        scalar subqueries whose value column already joined in)."""
        out_exprs: list[E.TExpr] = []
        out_schema: list[L.OutCol] = []
        for ii, item in enumerate(items):
            if pre_cols and ii in pre_cols:
                te, did = pre_cols[ii]
                name = item.alias or _default_name(item.expr)
                out_exprs.append(te)
                out_schema.append(L.OutCol(name, te.type, did))
                continue
            if isinstance(item.expr, A.Star):
                matched = 0
                for i, c in enumerate(scope.cols):
                    if item.expr.table is not None and c.qualifier != item.expr.table:
                        continue
                    out_exprs.append(E.Col(i, c.type, c.name))
                    out_schema.append(L.OutCol(c.name, c.type, c.dict_id))
                    matched += 1
                if not matched:
                    if item.expr.table is not None:
                        raise AnalyzeError(
                            f'missing FROM-clause entry for table "{item.expr.table}"'
                        )
                    raise AnalyzeError("SELECT * with no columns in scope")
                continue
            te = self.expr(item.expr, ctx)
            name = item.alias or _default_name(item.expr)
            out_exprs.append(te)
            out_schema.append(L.OutCol(name, te.type, _texpr_dict_id(te, scope)))
        return out_exprs, out_schema

    _WINDOW_FUNCS = {
        "row_number", "rank", "dense_rank", "count", "sum", "avg",
        "min", "max", "lag", "lead",
    }

    def _windowed(
        self, sel: A.Select, plan: L.LogicalPlan, ctx: ExprContext, scope
    ) -> tuple[L.LogicalPlan, list[E.TExpr], list[L.OutCol]]:
        """Plan window functions: a prep projection appends every window
        input (arg, partition keys, order keys) AFTER a passthrough of the
        child schema — so pre-existing scope column indexes stay valid —
        then one Window node computes the window columns, and the final
        select list reads them by position (nodeWindowAgg planning,
        planner.c's WindowClause targetlist juggling reduced to columnar
        positions)."""
        base_cols = [
            E.Col(i, c.type, c.name) for i, c in enumerate(plan.schema)
        ]
        extra: list[E.TExpr] = []
        extra_schema: list[L.OutCol] = []

        def appended(te: E.TExpr) -> int:
            # plain column refs are already in the passthrough prefix
            if isinstance(te, E.Col) and te.index < len(base_cols):
                return te.index
            # reuse an identical appended input otherwise
            for j, prev in enumerate(extra):
                if prev.key() == te.key():
                    return len(base_cols) + j
            extra.append(te)
            extra_schema.append(
                L.OutCol(
                    f"__w{len(extra) - 1}", te.type,
                    _texpr_dict_id(te, scope),
                )
            )
            return len(base_cols) + len(extra) - 1

        specs: list[L.WinSpec] = []
        out_exprs: list[E.TExpr] = []
        out_schema: list[L.OutCol] = []
        win_slots: list[Optional[int]] = []  # per select item: spec index
        for item in sel.items:
            if not isinstance(item.expr, A.WindowCall):
                tes, schemas = self._select_items([item], ctx, scope)
                out_exprs.extend(tes)
                out_schema.extend(schemas)
                win_slots.extend([None] * len(tes))
                continue
            wc = item.expr
            fn = wc.func
            kind = fn.name
            if kind not in self._WINDOW_FUNCS:
                raise AnalyzeError(f"unknown window function {kind}")
            arg_idx: Optional[int] = None
            offset = 1
            if kind in ("row_number", "rank", "dense_rank"):
                if fn.args or fn.star:
                    raise AnalyzeError(f"{kind}() takes no arguments")
                if kind in ("rank", "dense_rank") and not wc.order_by:
                    raise AnalyzeError(f"{kind}() requires ORDER BY")
                rty = t.INT8
            elif kind == "count":
                if fn.args:
                    arg_idx = appended(self.expr(fn.args[0], ctx))
                rty = t.INT8
            else:
                if not fn.args:
                    raise AnalyzeError(f"{kind}() requires an argument")
                arg_te = self.expr(fn.args[0], ctx)
                arg_idx = appended(arg_te)
                if kind in ("lag", "lead"):
                    if not wc.order_by:
                        raise AnalyzeError(f"{kind}() requires ORDER BY")
                    if len(fn.args) > 1:
                        off = self.expr(fn.args[1], ctx)
                        if not isinstance(off, E.Const) or not isinstance(
                            off.value, int
                        ):
                            raise AnalyzeError(
                                f"{kind} offset must be an integer constant"
                            )
                        offset = off.value
                    rty = arg_te.type
                elif kind == "avg":
                    if not arg_te.type.is_numeric:
                        raise AnalyzeError(
                            f"avg over {arg_te.type} is not defined"
                        )
                    rty = t.FLOAT8
                elif kind == "sum":
                    if not arg_te.type.is_numeric:
                        raise AnalyzeError(
                            f"sum over {arg_te.type} is not defined"
                        )
                    rty = (
                        t.INT8 if arg_te.type.is_integer else
                        t.decimal(38, arg_te.type.scale)
                        if arg_te.type.id == t.TypeId.DECIMAL
                        else t.FLOAT8
                    )
                else:  # min / max
                    rty = arg_te.type
            part = tuple(
                appended(self.expr(p, ctx)) for p in wc.partition_by
            )
            order = tuple(
                (appended(self.expr(si.expr, ctx)), si.descending)
                for si in wc.order_by
            )
            name = item.alias or kind
            dict_id = None
            if rty.is_text and arg_idx is not None:
                if arg_idx < len(base_cols):
                    dict_id = plan.schema[arg_idx].dict_id
                else:
                    dict_id = extra_schema[arg_idx - len(base_cols)].dict_id
            frame = getattr(wc, "frame", None)
            if frame is not None and kind not in (
                "count", "sum", "avg", "min", "max",
            ):
                raise AnalyzeError(
                    f"a ROWS frame is not meaningful for {kind}()"
                )
            spec = L.WinSpec(
                kind, arg_idx, part, order,
                L.OutCol(name, rty, dict_id), offset, frame,
            )
            win_slots.append(len(specs))
            specs.append(spec)
            out_exprs.append(E.Col(-1, rty, name))  # patched below
            out_schema.append(L.OutCol(name, rty, dict_id))

        prep_schema = tuple(plan.schema) + tuple(extra_schema)
        prep = L.Project(
            plan, tuple(base_cols) + tuple(extra), prep_schema
        )
        win_schema = prep_schema + tuple(s.out for s in specs)
        wplan = L.Window(prep, tuple(specs), win_schema)
        # patch window output references now positions are known
        for i, slot in enumerate(win_slots):
            if slot is not None:
                pos = len(prep_schema) + slot
                oc = out_schema[i]
                out_exprs[i] = E.Col(pos, oc.type, oc.name)
        return wplan, out_exprs, out_schema

    def _grouped(
        self, sel: A.Select, plan: L.LogicalPlan, ctx: ExprContext
    ) -> tuple[L.LogicalPlan, list[E.TExpr], list[L.OutCol], GroupedContext]:
        group_texprs = [self.expr(g, ctx) for g in sel.group_by]
        gctx = GroupedContext(ctx, group_texprs)
        agg_ctx = ExprContext(ctx.scope, self, allow_aggs=True, grouped=gctx)

        out_exprs: list[E.TExpr] = []
        out_schema: list[L.OutCol] = []
        for item in sel.items:
            if isinstance(item.expr, A.Star):
                raise AnalyzeError("SELECT * is not allowed with GROUP BY")
            te = self.expr(item.expr, agg_ctx)
            name = item.alias or _default_name(item.expr)
            out_exprs.append(te)
            out_schema.append(L.OutCol(name, te.type, _texpr_dict_id_grouped(te, gctx)))
        having_te = None
        if sel.having is not None:
            having_te = _bool_type(self.expr(sel.having, agg_ctx))

        # NB: the Aggregate node itself is built by the caller (after ORDER
        # BY resolution, which may append further aggregates to gctx.aggs).
        return plan, group_texprs, having_te, out_exprs, out_schema, gctx

    def _build_aggregate(
        self,
        plan: L.LogicalPlan,
        group_texprs: list[E.TExpr],
        gctx: GroupedContext,
        having_te: Optional[E.TExpr],
        ctx: ExprContext,
    ) -> L.LogicalPlan:
        agg_schema = tuple(
            [
                L.OutCol(f"__g{i}", g.type, _texpr_dict_id(g, ctx.scope))
                for i, g in enumerate(group_texprs)
            ]
            + [
                # min/max over TEXT output codes in the ARGUMENT's
                # dictionary — without it, decode reads the empty
                # literal dictionary (pre-round-5 latent bug)
                L.OutCol(
                    f"__a{i}", a.type,
                    _texpr_dict_id(a.arg, ctx.scope)
                    if a.func in ("min", "max") and a.arg is not None
                    else None,
                )
                for i, a in enumerate(gctx.aggs)
            ]
        )
        result: L.LogicalPlan = L.Aggregate(
            plan, tuple(group_texprs), tuple(gctx.aggs), agg_schema
        )
        if having_te is not None:
            result = L.Filter(result, having_te, result.schema)
        return result

    def _contains_agg(self, e: A.Expr) -> bool:
        if isinstance(e, A.FuncCall) and e.name in AGG_FUNCS:
            return True
        for attr in ("left", "right", "operand", "low", "high", "default"):
            child = getattr(e, attr, None)
            if isinstance(child, A.Expr) and self._contains_agg(child):
                return True
        if isinstance(e, A.FuncCall):
            return any(self._contains_agg(a) for a in e.args)
        if isinstance(e, A.CaseExpr):
            return any(
                self._contains_agg(c) or self._contains_agg(v) for c, v in e.whens
            ) or (e.default is not None and self._contains_agg(e.default))
        if isinstance(e, A.InList):
            return any(self._contains_agg(i) for i in e.items)
        return False

    def _resolve_order_expr(
        self,
        e: A.Expr,
        sel: A.Select,
        out_exprs: list[E.TExpr],
        out_schema: list[L.OutCol],
        ctx: ExprContext,
        gctx: Optional[GroupedContext],
        hidden: list[E.TExpr],
        post_scope: Scope,
    ) -> E.TExpr:
        # 1. ORDER BY <position>
        if isinstance(e, A.Literal) and isinstance(e.value, int):
            pos = e.value
            if not 1 <= pos <= len(out_exprs):
                raise AnalyzeError(f"ORDER BY position {pos} is out of range")
            c = out_schema[pos - 1]
            return E.Col(pos - 1, c.type, c.name)
        # 2. ORDER BY <output alias / output column name>
        if isinstance(e, A.ColumnRef) and e.table is None:
            for i, c in enumerate(out_schema):
                if c.name == e.name:
                    return E.Col(i, c.type, c.name)
        # 3. Arbitrary expression over the input — matched against an
        #    existing output expr if identical, else appended as hidden col.
        ectx = (
            ExprContext(ctx.scope, self, allow_aggs=True, grouped=gctx)
            if gctx is not None
            else ctx
        )
        te = self.expr(e, ectx)
        for i, oe in enumerate(out_exprs):
            if oe.key() == te.key():
                return E.Col(i, out_schema[i].type, out_schema[i].name)
        for j, he in enumerate(hidden):
            if he.key() == te.key():
                return E.Col(len(out_exprs) + j, he.type)
        hidden.append(te)
        return E.Col(len(out_exprs) + len(hidden) - 1, te.type)

    # ------------------------------------------------------------------
    # DML
    # ------------------------------------------------------------------
    def _insert(self, stmt: A.Insert) -> L.LogicalPlan:
        meta = self._table(stmt.table)
        columns = stmt.columns or list(meta.schema.keys())
        if not stmt.columns and stmt.values:
            # PG: VALUES shorter than the table maps to the LEADING
            # columns; the rest take defaults (NULL here) — what keeps
            # old INSERTs valid after ALTER TABLE ADD COLUMN
            arity = len(stmt.values[0])
            if arity < len(columns) and all(
                len(r) == arity for r in stmt.values
            ):
                columns = columns[:arity]
        for c in columns:
            meta.column_type(c)  # existence check
        target_types = [meta.schema[c] for c in columns]
        def target_dict_id(col: str, ty: t.SqlType):
            return f"{stmt.table}.{col}" if ty.id == t.TypeId.TEXT else None

        if stmt.query is not None:
            src = self.select(stmt.query)
            if len(src.schema) != len(columns):
                raise AnalyzeError("INSERT has a different number of columns than expressions")
            exprs = tuple(
                _cast(E.Col(i, c.type, c.name), ty)
                for i, (c, ty) in enumerate(zip(src.schema, target_types))
            )
            schema = tuple(
                L.OutCol(c, ty, target_dict_id(c, ty))
                for c, ty in zip(columns, target_types)
            )
            src = L.Project(src, exprs, schema)
        else:
            rows = []
            for row in stmt.values:
                if len(row) != len(columns):
                    raise AnalyzeError("INSERT has a different number of columns than values")
                trow = []
                for v, ty in zip(row, target_types):
                    if (
                        isinstance(v, A.Literal)
                        and type(v.value) is float
                        and ty.id in (t.TypeId.FLOAT4, t.TypeId.FLOAT8)
                    ):
                        # a float literal bound for a float column must
                        # keep ALL its bits: the general expr path types
                        # it DECIMAL first (scaled int64), which
                        # quantizes the low mantissa bits away — and
                        # the bulk INSERT->COPY rewrite (engine.py),
                        # which stores the literal exactly, would then
                        # diverge from this pipeline
                        trow.append(E.Const(float(v.value), ty))
                        continue
                    te = self.expr(v, ExprContext(Scope([]), self))
                    trow.append(_cast(te, ty))
                rows.append(tuple(trow))
            schema = tuple(
                L.OutCol(c, ty, target_dict_id(c, ty))
                for c, ty in zip(columns, target_types)
            )
            src = L.ValuesScan(tuple(rows), schema)
        return L.InsertPlan(stmt.table, src, tuple(columns))

    def _table_scope(self, table: str) -> Scope:
        meta = self._table(table)
        return Scope(
            [
                ScopeCol(
                    table, name, ty,
                    f"{table}.{name}" if ty.id == t.TypeId.TEXT else None,
                )
                for name, ty in meta.schema.items()
            ]
        )

    def _update(self, stmt: A.Update) -> L.LogicalPlan:
        meta = self._table(stmt.table)
        scope = self._table_scope(stmt.table)
        ctx = ExprContext(scope, self)
        pred = _bool_type(self.expr(stmt.where, ctx)) if stmt.where is not None else None
        assignments = []
        for name, ve in stmt.assignments:
            ty = meta.column_type(name)
            assignments.append((name, _cast(self.expr(ve, ctx), ty)))
        return L.UpdatePlan(stmt.table, pred, tuple(assignments))

    def _delete(self, stmt: A.Delete) -> L.LogicalPlan:
        scope = self._table_scope(stmt.table)
        ctx = ExprContext(scope, self)
        pred = _bool_type(self.expr(stmt.where, ctx)) if stmt.where is not None else None
        return L.DeletePlan(stmt.table, pred)

    # ==================================================================
    # Expressions
    # ==================================================================
    def expr(self, e: A.Expr, ctx: ExprContext) -> E.TExpr:
        # Grouped context: whole-expression match against GROUP BY items.
        # The speculative analysis may register scalar subplans; roll them
        # back if the attempt is discarded, else the orphans execute twice.
        if ctx.grouped is not None and not isinstance(e, A.Literal):
            g = ctx.grouped
            mark = len(self.subplans)
            try:
                te = self.expr(e, g.input_ctx)
            except AnalyzeError:
                te = None
            if te is not None and te.key() in g.group_keys:
                i = g.group_keys[te.key()]
                return E.Col(i, te.type)
            if isinstance(te, E.Const):
                return te
            del self.subplans[mark:]
        result = self._expr_inner(e, ctx)
        if isinstance(result, _Interval):
            raise AnalyzeError("interval value not allowed here")
        return result

    def _expr_inner(self, e: A.Expr, ctx: ExprContext):
        if isinstance(e, A.Literal):
            return self._literal(e.value)
        if isinstance(e, A.ColumnRef):
            if ctx.grouped is not None:
                raise AnalyzeError(
                    f'column "{e.name}" must appear in the GROUP BY clause '
                    "or be used in an aggregate function"
                )
            i, c = ctx.scope.resolve(e.name, e.table)
            return E.Col(i, c.type, c.name)
        if isinstance(e, A.Param):
            raise AnalyzeError("parameters require a prepared statement (unbound $n)")
        if isinstance(e, A.BinOp):
            return self._binop(e, ctx)
        if isinstance(e, A.UnaryOp):
            return self._unary(e, ctx)
        if isinstance(e, A.IsNull):
            return E.IsNullE(self.expr(e.operand, ctx), e.negated)
        if isinstance(e, A.Between):
            operand = self.expr(e.operand, ctx)
            low = self.expr(e.low, ctx)
            high = self.expr(e.high, ctx)
            ge = self._make_cmp(">=", operand, low)
            le = self._make_cmp("<=", operand, high)
            both = E.BinE("and", ge, le, t.BOOL)
            return E.UnaryE("not", both, t.BOOL) if e.negated else both
        if isinstance(e, A.InList):
            operand = self.expr(e.operand, ctx)
            items = []
            for item in e.items:
                it = self.expr(item, ctx)
                if not isinstance(it, E.Const):
                    # general fallback: OR of equalities
                    ors: Optional[E.TExpr] = None
                    for item2 in e.items:
                        eq = self._make_cmp("=", operand, self.expr(item2, ctx))
                        ors = eq if ors is None else E.BinE("or", ors, eq, t.BOOL)
                    assert ors is not None
                    return E.UnaryE("not", ors, t.BOOL) if e.negated else ors
                coerced = _coerce_const_to(it, operand.type)
                if coerced is None:
                    raise AnalyzeError(f"IN list item {it} does not match {operand.type}")
                items.append(coerced)
            return E.InListE(operand, tuple(items), e.negated)
        if isinstance(e, A.InSubquery) or isinstance(e, A.ExistsSubquery):
            raise AnalyzeError(
                "IN/EXISTS subqueries are only supported in WHERE as semi-joins"
            )
        if isinstance(e, A.ScalarSubquery):
            sub = Analyzer(self.catalog)
            sub.subplans = self.subplans  # share subplan list
            plan = sub.select(e.query)
            if len(plan.schema) != 1:
                raise AnalyzeError("scalar subquery must return one column")
            self.subplans.append(plan)
            return E.SubqueryParam(len(self.subplans) - 1, plan.schema[0].type)
        if isinstance(e, A.FuncCall):
            return self._func(e, ctx)
        if isinstance(e, A.Cast):
            return self._cast_expr(e, ctx)
        if isinstance(e, A.CaseExpr):
            return self._case(e, ctx)
        if isinstance(e, A.Extract):
            operand = self.expr(e.operand, ctx)
            if operand.type.id not in (t.TypeId.DATE, t.TypeId.TIMESTAMP):
                raise AnalyzeError("EXTRACT requires a date/timestamp")
            fld = e.field_name.lower()
            if fld not in ("year", "month", "day", "quarter", "dow", "doy"):
                raise AnalyzeError(f"unsupported EXTRACT field {fld}")
            return E.FuncE(f"extract_{fld}", (operand,), t.INT4)
        if isinstance(e, A.RowExpr):
            raise AnalyzeError(
                "row expressions are only supported in IN lists and "
                "=/<> comparisons"
            )
        raise AnalyzeError(f"unsupported expression {type(e).__name__}")

    def _literal(self, v: object) -> E.TExpr:
        if v is None:
            return E.Const(None, t.INT4)  # NULL: type refined by context
        if isinstance(v, bool):
            return E.Const(v, t.BOOL)
        if isinstance(v, int):
            return E.Const(v, t.INT4 if -(2**31) <= v < 2**31 else t.INT8)
        if isinstance(v, float):
            # numeric literal: analyze as decimal to keep exactness
            s = f"{v}"
            if "e" in s or "E" in s:
                return E.Const(v, t.FLOAT8)
            scale = len(s.split(".")[1]) if "." in s else 0
            ty = t.decimal(18, scale)
            return E.Const(round(v * ty.decimal_factor), ty)
        if isinstance(v, str):
            return E.Const(v, t.TEXT)
        raise AnalyzeError(f"unsupported literal {v!r}")

    def _binop(self, e: A.BinOp, ctx: ExprContext) -> E.TExpr:
        op = e.op
        if op in ("and", "or"):
            l = _bool_type(self.expr(e.left, ctx))
            r = _bool_type(self.expr(e.right, ctx))
            return E.BinE(op, l, r, t.BOOL)
        if op in ("like", "ilike"):
            operand = self.expr(e.left, ctx)
            pat = self.expr(e.right, ctx)
            if operand.type.id != t.TypeId.TEXT:
                raise AnalyzeError("LIKE requires a text operand")
            if not (isinstance(pat, E.Const) and isinstance(pat.value, str)):
                raise AnalyzeError("LIKE pattern must be a string constant")
            return E.LikeE(operand, pat.value, op == "ilike", False)
        if op == "||":
            # concatenation rides the dictionary-transform path
            # (ops/expr.py): constant segments fold into transform
            # extra args (one 1D table lookup per code); two
            # non-constant sides use a pairwise table (PairConcatParam)

            def s_of(c: E.Const) -> str:
                v = c.value
                if isinstance(v, bool):
                    return "true" if v else "false"
                if c.type.id == t.TypeId.DECIMAL:
                    # integer rendering keeps declared scale and full
                    # precision (no float round-trip)
                    scale = len(str(c.type.decimal_factor)) - 1
                    s = str(abs(v)).rjust(scale + 1, "0")
                    sign = "-" if v < 0 else ""
                    return f"{sign}{s[:-scale]}.{s[-scale:]}" if scale else str(v)
                if c.type.id == t.TypeId.DATE:
                    import datetime as _dt

                    return str(
                        _dt.date(1970, 1, 1) + _dt.timedelta(days=v)
                    )
                if c.type.id == t.TypeId.TIMESTAMP:
                    import datetime as _dt

                    dt = _dt.datetime(
                        1970, 1, 1, tzinfo=_dt.timezone.utc
                    ) + _dt.timedelta(microseconds=v)
                    return dt.strftime("%Y-%m-%d %H:%M:%S") + (
                        f".{dt.microsecond:06d}".rstrip("0")
                        if dt.microsecond else ""
                    )
                return str(v)

            # Flatten the whole || spine into constant segments and
            # non-constant exprs so one transform covers the chain
            # (a || ' ' || b becomes ONE pairwise table; 'x' || a ||
            # 'y' ONE 1D table) — no intermediate results ever
            # canonicalize through the shared literal pool.
            parts: list = []  # Const | TExpr, in order

            def walk(node):
                if isinstance(node, A.BinOp) and node.op == "||":
                    walk(node.left)
                    walk(node.right)
                else:
                    parts.append(self.expr(node, ctx))

            walk(e)
            # NULL anywhere folds the whole chain before operand-type
            # checks (PG: int_col || NULL is NULL, not an error)
            if any(
                isinstance(p, E.Const) and p.value is None
                for p in parts
            ):
                return E.Const(None, t.TEXT)
            merged: list = []
            for p in parts:
                if isinstance(p, E.Const):
                    s = s_of(p)
                    if merged and isinstance(merged[-1], str):
                        merged[-1] += s
                    else:
                        merged.append(s)
                else:
                    if not p.type.is_text:
                        raise AnalyzeError("|| needs a text operand")
                    merged.append(p)
            exprs = [p for p in merged if not isinstance(p, str)]
            if not exprs:
                return E.Const(merged[0] if merged else "", t.TEXT)

            def seg_after(idx):
                return (
                    merged[idx + 1]
                    if idx + 1 < len(merged)
                    and isinstance(merged[idx + 1], str) else ""
                )

            pre = merged[0] if isinstance(merged[0], str) else ""
            if len(exprs) == 1:
                i0 = merged.index(exprs[0])
                return E.FuncE(
                    "concat_seg",
                    (
                        exprs[0],
                        E.Const(pre, t.TEXT),
                        E.Const(seg_after(i0), t.TEXT),
                    ),
                    t.TEXT,
                )
            if len(exprs) == 2:
                # both pairwise axes must be stable column
                # dictionaries: a literal-pool axis would re-enumerate
                # its own past outputs and grow the pool every run
                from opentenbase_tpu_torch.ops import LITERAL_DICT
                from opentenbase_tpu_torch.ops.expr import _host_chain

                for side in exprs:
                    sbase, _steps = _host_chain(side)
                    if (
                        not isinstance(sbase, E.Col)
                        or _texpr_dict_id(sbase, ctx.scope)
                        in (None, LITERAL_DICT)
                    ):
                        raise AnalyzeError(
                            "|| of two computed text values is not "
                            "supported — make one side a column or "
                            "a constant"
                        )
                i0 = merged.index(exprs[0])
                i1 = merged.index(exprs[1], i0 + 1)
                return E.FuncE(
                    "concat_pair",
                    (
                        exprs[0],
                        exprs[1],
                        E.Const(pre, t.TEXT),
                        E.Const(seg_after(i0), t.TEXT),
                        E.Const(seg_after(i1), t.TEXT),
                    ),
                    t.TEXT,
                )
            raise AnalyzeError(
                "|| of more than two non-constant values is not "
                "supported"
            )
        # interval arithmetic
        li = self._maybe_interval(e.left, ctx)
        ri = self._maybe_interval(e.right, ctx)
        if isinstance(li, _Interval) or isinstance(ri, _Interval):
            return self._interval_arith(op, e, li, ri, ctx)
        l = self.expr(e.left, ctx)
        r = self.expr(e.right, ctx)
        if op in _CMP:
            return self._make_cmp(op, l, r)
        if op in _ARITH:
            return self._make_arith(op, l, r)
        if op in ("is distinct from", "is not distinct from"):
            # null-safe equality composed from existing machinery so
            # text operands get the same dictionary alignment ordinary
            # comparisons do: (l = r AND both NOT NULL) OR (both NULL)
            eq = self._make_cmp("=", l, r)
            ln = E.IsNullE(l, False)
            rn = E.IsNullE(r, False)
            both_nn = E.BinE(
                "and",
                E.UnaryE("not", ln, t.BOOL),
                E.UnaryE("not", rn, t.BOOL),
                t.BOOL,
            )
            # the raw = can be NULL when an operand is; COALESCE it to
            # FALSE so the AND/OR algebra below is two-valued
            eq2 = E.FuncE("coalesce", (eq, E.Const(False, t.BOOL)), t.BOOL)
            nse = E.BinE(
                "or",
                E.BinE("and", eq2, both_nn, t.BOOL),
                E.BinE("and", ln, rn, t.BOOL),
                t.BOOL,
            )
            return (
                E.UnaryE("not", nse, t.BOOL)
                if op == "is distinct from" else nse
            )
        raise AnalyzeError(f"unsupported operator {op}")

    def _maybe_interval(self, e: A.Expr, ctx: ExprContext):
        if isinstance(e, A.FuncCall) and e.name == "interval" and len(e.args) == 1:
            arg = e.args[0]
            if isinstance(arg, A.Literal) and isinstance(arg.value, str):
                return _parse_interval(arg.value)
        return None

    def _interval_arith(self, op, e: A.BinOp, li, ri, ctx: ExprContext) -> E.TExpr:
        if op not in ("+", "-"):
            raise AnalyzeError("intervals support only + and -")
        if isinstance(li, _Interval) and isinstance(ri, _Interval):
            raise AnalyzeError("interval +/- interval is unsupported")
        if isinstance(li, _Interval):
            if op == "-":
                raise AnalyzeError("interval - date is not defined")
            date_side, iv, sign = self.expr(e.right, ctx), li, 1
        else:
            date_side, iv, sign = self.expr(e.left, ctx), ri, (1 if op == "+" else -1)
        if date_side.type.id == t.TypeId.DATE:
            if isinstance(date_side, E.Const) and date_side.value is not None:
                return E.Const(
                    _add_interval_to_days(int(date_side.value), iv, sign), t.DATE
                )
            if iv.months == 0 and iv.usecs == 0:
                return E.FuncE(
                    "date_add_days", (date_side, E.Const(sign * iv.days, t.INT4)), t.DATE
                )
            raise AnalyzeError("month-granularity interval needs a constant date operand")
        if date_side.type.id == t.TypeId.TIMESTAMP:
            if iv.months == 0:
                delta = sign * (iv.days * 86_400_000_000 + iv.usecs)
                return E.FuncE(
                    "ts_add_usecs", (date_side, E.Const(delta, t.INT8)), t.TIMESTAMP
                )
            if isinstance(date_side, E.Const) and date_side.value is not None:
                us = int(date_side.value)
                days = us // 86_400_000_000
                rem = us % 86_400_000_000
                days2 = _add_interval_to_days(days, iv, sign)
                rem2 = rem + sign * iv.usecs
                return E.Const(days2 * 86_400_000_000 + rem2, t.TIMESTAMP)
            raise AnalyzeError("month-granularity interval needs a constant timestamp")
        raise AnalyzeError("interval arithmetic requires a date/timestamp operand")

    def _make_cmp(self, op: str, l: E.TExpr, r: E.TExpr) -> E.TExpr:
        # NULL literal propagates type from the other side
        if isinstance(l, E.Const) and l.value is None:
            l = E.Const(None, r.type)
        if isinstance(r, E.Const) and r.value is None:
            r = E.Const(None, l.type)
        lt, rt = l.type, r.type
        if lt.id == t.TypeId.TEXT and rt.id == t.TypeId.TEXT:
            return E.BinE(op, l, r, t.BOOL)
        if lt.id == t.TypeId.TEXT and isinstance(l, E.Const):
            coerced = _coerce_const_to(l, rt)
            if coerced is not None:
                return self._make_cmp(op, coerced, r)
        if rt.id == t.TypeId.TEXT and isinstance(r, E.Const):
            coerced = _coerce_const_to(r, lt)
            if coerced is not None:
                return self._make_cmp(op, l, coerced)
        if lt == rt:
            return E.BinE(op, l, r, t.BOOL)
        ct = _common_input_type(lt, rt, op)
        return E.BinE(op, _cast(l, ct), _cast(r, ct), t.BOOL)

    def _make_arith(self, op: str, l: E.TExpr, r: E.TExpr) -> E.TExpr:
        if not (l.type.is_numeric and r.type.is_numeric):
            # date +/- int = date
            if (
                l.type.id == t.TypeId.DATE
                and r.type.is_integer
                and op in ("+", "-")
            ):
                neg = E.UnaryE("-", _cast(r, t.INT4), t.INT4) if op == "-" else _cast(r, t.INT4)
                return E.FuncE("date_add_days", (l, neg), t.DATE)
            if l.type.id == t.TypeId.DATE and r.type.id == t.TypeId.DATE and op == "-":
                return E.BinE("-", E.CastE(l, t.INT4), E.CastE(r, t.INT4), t.INT4)
            raise AnalyzeError(f"operator {op} has non-numeric operand {l.type} / {r.type}")
        lt, rt = l.type, r.type
        # decimal arithmetic keeps exact integer representation
        if t.TypeId.DECIMAL in (lt.id, rt.id) and not (
            lt.id in (t.TypeId.FLOAT4, t.TypeId.FLOAT8)
            or rt.id in (t.TypeId.FLOAT4, t.TypeId.FLOAT8)
        ):
            ld = lt if lt.id == t.TypeId.DECIMAL else t.decimal(18, 0)
            rd = rt if rt.id == t.TypeId.DECIMAL else t.decimal(18, 0)
            l2 = _cast(l, ld) if lt.id != t.TypeId.DECIMAL else l
            r2 = _cast(r, rd) if rt.id != t.TypeId.DECIMAL else r
            if op in ("+", "-"):
                scale = max(ld.scale, rd.scale)
                ty = t.decimal(38, scale)
                return E.BinE(op, _cast(l2, ty), _cast(r2, ty), ty)
            if op == "*":
                ty = t.decimal(38, ld.scale + rd.scale)
                return E.BinE("*", l2, r2, ty)
            if op == "/":
                # decimal division produces float8 (documented delta from
                # PG numeric division)
                return E.BinE("/", _cast(l2, t.FLOAT8), _cast(r2, t.FLOAT8), t.FLOAT8)
            if op == "%":
                ty = t.decimal(38, max(ld.scale, rd.scale))
                return E.BinE("%", _cast(l2, ty), _cast(r2, ty), ty)
        ct = t.common_numeric_type(lt, rt)
        if op == "/" and ct.is_integer:
            # integer division truncates, like PG int4div
            return E.BinE("//", _cast(l, ct), _cast(r, ct), ct)
        out_ty = ct
        return E.BinE(op, _cast(l, ct), _cast(r, ct), out_ty)

    def _unary(self, e: A.UnaryOp, ctx: ExprContext) -> E.TExpr:
        operand = self.expr(e.operand, ctx)
        if e.op == "not":
            return E.UnaryE("not", _bool_type(operand), t.BOOL)
        if e.op == "-":
            if not operand.type.is_numeric:
                raise AnalyzeError("unary minus requires numeric operand")
            if isinstance(operand, E.Const) and operand.value is not None:
                return E.Const(-operand.value, operand.type)  # type: ignore[operator]
            return E.UnaryE("-", operand, operand.type)
        raise AnalyzeError(f"unsupported unary {e.op}")

    def _func(self, e: A.FuncCall, ctx: ExprContext) -> E.TExpr:
        name = e.name
        if name in AGG_FUNCS:
            return self._agg_call(e, ctx)
        args = tuple(self.expr(a, ctx) for a in e.args)
        return self._scalar_func(name, args)

    def _scalar_func(self, name: str, args: tuple[E.TExpr, ...]) -> E.TExpr:
        # Oracle-compat aliases (src/backend/oracle in the reference)
        if name == "nvl":
            name = "coalesce"
        if name == "abs":
            _need(args, 1, name)
            return E.FuncE("abs", args, args[0].type)
        if name in ("floor", "ceil", "ceiling"):
            _need(args, 1, name)
            n = "ceil" if name == "ceiling" else name
            return E.FuncE(n, (_cast(args[0], t.FLOAT8),), t.FLOAT8)
        if name == "round":
            if len(args) == 1:
                return E.FuncE("round", (_cast(args[0], t.FLOAT8), E.Const(0, t.INT4)), t.FLOAT8)
            if args[0].type.id == t.TypeId.DECIMAL and isinstance(args[1], E.Const):
                return E.FuncE("round_dec", args, args[0].type)
            return E.FuncE("round", (_cast(args[0], t.FLOAT8), args[1]), t.FLOAT8)
        if name == "sqrt":
            _need(args, 1, name)
            return E.FuncE("sqrt", (_cast(args[0], t.FLOAT8),), t.FLOAT8)
        if name == "sign":
            _need(args, 1, name)
            return E.FuncE("sign", (_cast(args[0], t.FLOAT8),), t.FLOAT8)
        if name == "power" or name == "pow":
            _need(args, 2, name)
            return E.FuncE(
                "power", (_cast(args[0], t.FLOAT8), _cast(args[1], t.FLOAT8)), t.FLOAT8
            )
        if name == "mod":
            _need(args, 2, name)
            return self._make_arith("%", args[0], args[1])
        if name == "coalesce":
            if not args:
                raise AnalyzeError("coalesce requires arguments")
            ty = args[0].type
            for a in args[1:]:
                if a.type != ty:
                    if a.type.is_numeric and ty.is_numeric:
                        ty = t.common_numeric_type(ty, a.type)
                    elif isinstance(a, E.Const) and a.value is None:
                        continue
                    else:
                        raise AnalyzeError("coalesce arguments must share a type")
            cast_args = tuple(_cast(a, ty) for a in args)
            return E.FuncE("coalesce", cast_args, ty)
        if name == "nullif":
            _need(args, 2, name)
            return E.FuncE("nullif", args, args[0].type)
        if name == "greatest" or name == "least":
            ty = args[0].type
            for a in args[1:]:
                ty = t.common_numeric_type(ty, a.type) if a.type != ty else ty
            return E.FuncE(name, tuple(_cast(a, ty) for a in args), ty)
        if name in ("length", "char_length"):
            _need(args, 1, name)
            if args[0].type.id != t.TypeId.TEXT:
                raise AnalyzeError("length requires text")
            return E.FuncE("length", args, t.INT4)
        if name in ("upper", "lower", "substr", "substring", "trim", "ltrim", "rtrim", "replace"):
            # host-evaluated dictionary transforms
            if args[0].type.id != t.TypeId.TEXT:
                raise AnalyzeError(f"{name} requires text")
            return E.FuncE(name, args, t.TEXT)
        if name == "date_trunc":
            _need(args, 2, name)
            if not (isinstance(args[0], E.Const) and isinstance(args[0].value, str)):
                raise AnalyzeError("date_trunc unit must be a string constant")
            return E.FuncE("date_trunc", args, args[1].type)
        if name == "now" or name == "current_timestamp":
            return E.FuncE("now", (), t.TIMESTAMP)
        if name == "interval":
            raise AnalyzeError("interval only valid in +/- arithmetic")
        if name in ("nextval", "currval", "setval"):
            # bound by the session before analysis (engine._expand_sequences)
            raise AnalyzeError(
                f"{name}() is only supported in INSERT VALUES and "
                "FROM-less SELECT"
            )
        out = self._oracle_func(name, args)
        if out is not None:
            return out
        raise AnalyzeError(f"unknown function {name}")

    def _oracle_func(
        self, name: str, args: tuple[E.TExpr, ...]
    ) -> Optional[E.TExpr]:
        """Oracle-compatibility shims (src/backend/oracle: others.c nvl2/
        decode/bitand/lnnvl/nanvl, datefce.c add_months/months_between/
        last_day, plvstr.c instr/lpad/rpad ...). Each lowers to existing
        typed-expression machinery, so kernels stay generic."""
        if name == "nvl2":
            _need(args, 3, name)
            a, b, c = args
            ty = b.type
            if c.type != ty:
                if c.type.is_numeric and ty.is_numeric:
                    ty = t.common_numeric_type(ty, c.type)
                elif not (isinstance(c, E.Const) and c.value is None):
                    raise AnalyzeError("nvl2 branches must share a type")
            return E.CaseE(
                ((E.IsNullE(a, True), _cast(b, ty)),), _cast(c, ty), ty
            )
        if name == "decode":
            if len(args) < 3:
                raise AnalyzeError("decode needs expr, search, result, ...")
            expr0, rest = args[0], list(args[1:])
            default = rest.pop() if len(rest) % 2 == 1 else None
            results = rest[1::2]
            ty = results[0].type
            for r in results[1:]:
                if r.type != ty and r.type.is_numeric and ty.is_numeric:
                    ty = t.common_numeric_type(ty, r.type)
            if default is not None and default.type != ty:
                if default.type.is_numeric and ty.is_numeric:
                    ty = t.common_numeric_type(ty, default.type)
            def decode_cond(search: E.TExpr) -> E.TExpr:
                # Oracle decode: NULL search matches NULL expr (others.c),
                # unlike SQL 3-valued '='
                if isinstance(search, E.Const) and search.value is None:
                    return E.IsNullE(expr0, False)
                return self._make_cmp("=", expr0, search)

            whens = tuple(
                (decode_cond(rest[i]), _cast(rest[i + 1], ty))
                for i in range(0, len(rest), 2)
            )
            return E.CaseE(
                whens, _cast(default, ty) if default is not None else None, ty
            )
        if name == "instr":
            if len(args) not in (2, 3):
                raise AnalyzeError("instr(text, text [, start])")
            if args[0].type.id != t.TypeId.TEXT:
                raise AnalyzeError("instr requires text")
            return E.FuncE("instr", args, t.INT4)
        if name in ("lpad", "rpad", "initcap", "reverse"):
            if name in ("initcap", "reverse"):
                _need(args, 1, name)
            elif len(args) not in (2, 3):
                raise AnalyzeError(f"{name}(text, length [, fill])")
            if args[0].type.id != t.TypeId.TEXT:
                raise AnalyzeError(f"{name} requires text")
            return E.FuncE(name, args, t.TEXT)
        if name == "add_months":
            _need(args, 2, name)
            if args[0].type.id not in (t.TypeId.DATE, t.TypeId.TIMESTAMP):
                raise AnalyzeError("add_months requires date/timestamp")
            return E.FuncE(
                "add_months", (args[0], _cast(args[1], t.INT4)), args[0].type
            )
        if name == "months_between":
            _need(args, 2, name)
            return E.FuncE(
                "months_between",
                (_cast(args[0], t.DATE), _cast(args[1], t.DATE)),
                t.FLOAT8,
            )
        if name == "last_day":
            _need(args, 1, name)
            return E.FuncE("last_day", (_cast(args[0], t.DATE),), t.DATE)
        if name == "trunc":
            if not args or len(args) > 2:
                raise AnalyzeError("trunc(value [, unit_or_digits])")
            if args[0].type.is_numeric:
                extra = ()
                if len(args) == 2:
                    if not isinstance(args[1], E.Const):
                        raise AnalyzeError("trunc digits must be a constant")
                    extra = (args[1],)
                return E.FuncE(
                    "trunc_num", (_cast(args[0], t.FLOAT8),) + extra, t.FLOAT8
                )
            unit = "day"
            if len(args) == 2:
                if not (isinstance(args[1], E.Const)
                        and isinstance(args[1].value, (str, int))):
                    raise AnalyzeError("trunc unit must be a constant")
                u = str(args[1].value).lower()
                unit = {"mm": "month", "month": "month", "mon": "month",
                        "yyyy": "year", "yy": "year", "year": "year",
                        "dd": "day", "day": "day", "ddd": "day"}.get(u)
                if unit is None:
                    raise AnalyzeError(f"unknown trunc unit {u!r}")
            return E.FuncE(
                f"trunc_date_{unit}", (_cast(args[0], t.DATE),), t.DATE
            )
        if name == "bitand":
            _need(args, 2, name)
            return E.FuncE(
                "bitand",
                (_cast(args[0], t.INT8), _cast(args[1], t.INT8)),
                t.INT8,
            )
        if name == "lnnvl":
            _need(args, 1, name)
            cond = _bool_type(args[0])
            return E.BinE(
                "or", E.UnaryE("not", cond, t.BOOL),
                E.IsNullE(args[0], False), t.BOOL,
            )
        if name == "nanvl":
            _need(args, 2, name)
            return E.FuncE(
                "nanvl",
                (_cast(args[0], t.FLOAT8), _cast(args[1], t.FLOAT8)),
                t.FLOAT8,
            )
        if name in ("to_date", "to_timestamp"):
            _need(args, 1, name)
            ty = t.DATE if name == "to_date" else t.TIMESTAMP
            if isinstance(args[0], E.Const):
                return _cast(args[0], ty)
            if args[0].type.id != t.TypeId.TEXT:
                raise AnalyzeError(f"{name} requires text")
            return E.FuncE(name, (args[0],), ty)
        if name == "to_number":
            _need(args, 1, name)
            if isinstance(args[0], E.Const):
                return _cast(args[0], t.FLOAT8)
            if args[0].type.id != t.TypeId.TEXT:
                raise AnalyzeError("to_number requires text")
            return E.FuncE("to_number", (args[0],), t.FLOAT8)
        return None

    def _agg_call(self, e: A.FuncCall, ctx: ExprContext) -> E.TExpr:
        if ctx.grouped is None:
            raise AnalyzeError(
                f"aggregate function {e.name}() not allowed here"
            )
        g = ctx.grouped
        if e.star:
            if e.name != "count":
                raise AnalyzeError(f"{e.name}(*) is not defined")
            return g.agg_col(E.AggCall("count", None, False, t.INT8))
        _need_ast(e.args, 1, e.name)
        arg = self.expr(e.args[0], g.input_ctx)
        name = e.name
        if name in ("count", "sum", "avg"):
            rty = self._agg_result_type(name, arg.type)
            return g.agg_col(E.AggCall(name, arg, e.distinct, rty))
        if name in ("min", "max"):
            return g.agg_col(E.AggCall(name, arg, False, arg.type))
        raise AnalyzeError(f"unknown aggregate {name}")

    def _cast_expr(self, e: A.Cast, ctx: ExprContext) -> E.TExpr:
        ty = t.type_from_name(e.type_name, e.type_args)
        operand = self.expr(e.operand, ctx)
        if ty.is_text and not operand.type.is_text:
            if isinstance(operand, E.Const):
                v = operand.value
                if v is None:
                    s = None
                elif isinstance(v, bool):
                    s = "true" if v else "false"  # PG boolout
                else:
                    s = str(v)
                return E.Const(s, ty)
            # dictionary-encoded text has no device rendering for
            # arbitrary numeric domains; reject instead of emitting
            # out-of-range dictionary codes
            raise AnalyzeError(
                f"cannot cast {operand.type.id.value} to text "
                "(only constants)"
            )
        return _cast(operand, ty)

    def _case(self, e: A.CaseExpr, ctx: ExprContext) -> E.TExpr:
        whens = []
        for cond_ast, val_ast in e.whens:
            if e.operand is not None:
                cond = self._make_cmp(
                    "=", self.expr(e.operand, ctx), self.expr(cond_ast, ctx)
                )
            else:
                cond = _bool_type(self.expr(cond_ast, ctx))
            whens.append((cond, self.expr(val_ast, ctx)))
        default = self.expr(e.default, ctx) if e.default is not None else None
        # result type: common across branches
        vals = [v for _, v in whens] + ([default] if default is not None else [])
        ty = vals[0].type
        for v in vals[1:]:
            if v.type != ty:
                if v.type.is_numeric and ty.is_numeric:
                    ty = t.common_numeric_type(ty, v.type)
                elif isinstance(v, E.Const) and v.value is None:
                    continue
                else:
                    raise AnalyzeError("CASE branches must share a type")
        whens2 = tuple((c, _cast(v, ty)) for c, v in whens)
        default2 = _cast(default, ty) if default is not None else None
        return E.CaseE(whens2, default2, ty)

    # ------------------------------------------------------------------
    # WHERE-clause subquery rewrites (semi/anti joins)
    # ------------------------------------------------------------------
    def _in_subquery_join(
        self, plan: L.LogicalPlan, scope: Scope, c: A.InSubquery
    ) -> L.LogicalPlan:
        sub = self.select(c.query)
        if len(sub.schema) != 1:
            raise AnalyzeError("IN subquery must return exactly one column")
        lk = self.expr(c.operand, ExprContext(scope, self))
        rk: E.TExpr = E.Col(0, sub.schema[0].type, sub.schema[0].name)
        if lk.type != rk.type:
            ct = _common_input_type(lk.type, rk.type, "IN")
            lk, rk = _cast(lk, ct), _cast(rk, ct)
        jt = "anti" if c.negated else "semi"
        return L.Join(plan, sub, jt, (lk,), (rk,), None, plan.schema)

    _CORR_AGGS = ("count", "sum", "min", "max", "avg")

    def _has_unresolved_ref(self, q: A.Select, inner_ctx) -> bool:
        """Any TOP-LEVEL ColumnRef of ``q`` that the inner scope does
        not capture (nested subqueries excluded — their own scopes
        resolve them, and if they correlate further the standalone
        path's error is the same one it raised before this feature)."""
        refs: list[A.ColumnRef] = []

        def walk_field(v):
            if isinstance(v, (list, tuple)):
                for x in v:
                    walk_field(x)  # nested tuples: CaseExpr.whens
            elif isinstance(v, A.SelectItem):
                walk(v.expr)
            elif isinstance(v, A.Expr):
                walk(v)

        def walk(node):
            if isinstance(node, (
                A.ScalarSubquery, A.InSubquery, A.ExistsSubquery,
            )):
                return
            if isinstance(node, A.ColumnRef):
                refs.append(node)
            import dataclasses

            if dataclasses.is_dataclass(node) and not isinstance(
                node, type
            ):
                for f in dataclasses.fields(node):
                    walk_field(getattr(node, f.name))

        for item in q.items:
            walk(item.expr)
        if q.where is not None:
            walk(q.where)
        for r in refs:
            mark = len(self.subplans)
            try:
                self.expr(r, inner_ctx)
            except AnalyzeError:
                del self.subplans[mark:]
                return True
        return False

    @staticmethod
    def _agg_result_type(name: str, arg_type) -> "t.SqlType":
        """THE aggregate result-typing rules — shared by the grouped
        path (_agg_call) and the decorrelated scalar path."""
        if name == "count":
            return t.INT8
        if name == "sum":
            if arg_type.is_integer:
                return t.INT8
            if arg_type.id == t.TypeId.DECIMAL:
                return t.decimal(38, arg_type.scale)
            if arg_type.id in (t.TypeId.FLOAT4, t.TypeId.FLOAT8):
                return t.FLOAT8
            raise AnalyzeError(f"sum over {arg_type} is not defined")
        if name == "avg":
            if not arg_type.is_numeric:
                raise AnalyzeError(
                    f"avg over {arg_type} is not defined"
                )
            return t.FLOAT8
        return arg_type  # min / max

    def _try_corr_scalar(self, plan, scope, c: A.Expr):
        """Decorrelate ``<outer> <cmp> (SELECT agg(x) FROM i WHERE
        eq-correlations [AND inner preds])``: _decorr_scalar builds
        the grouped LEFT join and this wrapper compares against the
        joined aggregate column. Returns (new_plan, conjunct_texpr)
        or None (caller falls back to the ordinary path, which handles
        uncorrelated scalars)."""
        if not (isinstance(c, A.BinOp) and c.op in _CMP):
            return None
        flipped = False
        outer_ast, sub = c.left, c.right
        if isinstance(outer_ast, A.ScalarSubquery):
            outer_ast, sub, flipped = sub, outer_ast, True
        if not isinstance(sub, A.ScalarSubquery):
            return None
        out = self._decorr_scalar(plan, scope, sub)
        if out is None:
            return None
        new_plan, sq_col = out
        outer_ctx = ExprContext(scope, self)
        m5 = len(self.subplans)
        try:
            outer_te = self.expr(outer_ast, outer_ctx)
        except AnalyzeError:
            del self.subplans[m5:]
            return None
        te = (
            self._make_cmp(c.op, sq_col, outer_te)
            if flipped
            else self._make_cmp(c.op, outer_te, sq_col)
        )
        return new_plan, te

    def _decorr_scalar(self, plan, scope, sub: A.ScalarSubquery):
        """The Kim-style aggregate decorrelation core: an equality-
        correlated scalar-aggregate subquery becomes a grouped
        aggregate LEFT-joined on the correlation keys. Returns
        (new_plan, value_texpr) — the value column the caller projects
        or compares — or None when the shape doesn't fit."""
        q = sub.query
        if (
            q.group_by or q.having is not None or q.limit is not None
            or q.offset is not None or q.distinct or q.set_ops
            or q.ctes or q.from_clause is None or q.where is None
            or len(q.items) != 1
        ):
            return None
        item = q.items[0].expr
        if not (
            isinstance(item, A.FuncCall)
            and item.name in self._CORR_AGGS
            and not item.distinct
        ):
            return None
        mark = len(self.subplans)

        def bail():
            del self.subplans[mark:]
            return None

        try:
            inner_plan, inner_scope = self._from(q.from_clause)
        except AnalyzeError:
            return bail()
        inner_ctx = ExprContext(inner_scope, self)
        # the standalone path must keep handling uncorrelated scalars:
        # engage only when some TOP-LEVEL column reference fails to
        # resolve against the inner scope (a cheap read-only walk —
        # re-analyzing the whole subquery here would double the work
        # for every uncorrelated scalar and compound with nesting)
        if not self._has_unresolved_ref(q, inner_ctx):
            return bail()
        outer_ctx = ExprContext(scope, self)
        lkeys: list[E.TExpr] = []
        rkeys: list[E.TExpr] = []
        inner_pred: Optional[E.TExpr] = None
        for conj in _split_and(q.where):
            m2 = len(self.subplans)
            try:
                te = _bool_type(self.expr(conj, inner_ctx))
                inner_pred = (
                    te if inner_pred is None
                    else E.BinE("and", inner_pred, te, t.BOOL)
                )
                continue
            except AnalyzeError:
                del self.subplans[m2:]
            if not (isinstance(conj, A.BinOp) and conj.op == "="):
                return bail()
            for a, b in ((conj.left, conj.right),
                         (conj.right, conj.left)):
                # same pull-up contract as EXISTS: the outer side must
                # be a bare column the inner scope does NOT capture
                if not isinstance(b, A.ColumnRef):
                    continue
                try:
                    self.expr(b, inner_ctx)
                    continue
                except AnalyzeError:
                    pass
                m3 = len(self.subplans)
                try:
                    ik = self.expr(a, inner_ctx)
                    ok_ = self.expr(b, outer_ctx)
                except AnalyzeError:
                    del self.subplans[m3:]
                    continue
                if ik.type != ok_.type:
                    ct = _common_input_type(ik.type, ok_.type, "=")
                    ik, ok_ = _cast(ik, ct), _cast(ok_, ct)
                lkeys.append(ok_)
                rkeys.append(ik)
                break
            else:
                return bail()
        if not lkeys:
            return bail()
        # the aggregate itself, typed with the ordinary agg rules
        name = item.name
        arg = None
        if item.star:
            if name != "count":
                return bail()
        else:
            if len(item.args) != 1:
                return bail()
            m4 = len(self.subplans)
            try:
                arg = self.expr(item.args[0], inner_ctx)
            except AnalyzeError:
                del self.subplans[m4:]
                return bail()
        try:
            rty = self._agg_result_type(
                name, arg.type if arg is not None else None
            )
        except AnalyzeError:
            return bail()
        aggcall = E.AggCall(name, arg, False, rty)
        inner = inner_plan
        if inner_pred is not None:
            inner = L.Filter(inner, inner_pred, inner.schema)
        sub_schema = tuple(
            [
                L.OutCol(
                    f"__ck{i}", k.type,
                    _expr_dict_id(k, inner_plan.schema),
                )
                for i, k in enumerate(rkeys)
            ]
            + [L.OutCol(
                "__sq", aggcall.type,
                _expr_dict_id(arg, inner_plan.schema)
                if arg is not None and name in ("min", "max")
                else None,
            )]
        )
        agg_node = L.Aggregate(
            inner, tuple(rkeys), (aggcall,), sub_schema
        )
        nbase = len(plan.schema)
        nkeys = len(rkeys)
        joined_schema = tuple(plan.schema) + sub_schema
        new_plan = L.Join(
            plan, agg_node, "left",
            tuple(lkeys),
            tuple(
                E.Col(i, rkeys[i].type) for i in range(nkeys)
            ),
            None,
            joined_schema,
        )
        sq_col: E.TExpr = E.Col(
            nbase + nkeys, aggcall.type, "__sq"
        )
        if name == "count":
            # COUNT over an empty correlated set is 0, not NULL — the
            # LEFT join's null-extension must coalesce
            sq_col = E.FuncE(
                "coalesce", (sq_col, E.Const(0, t.INT8)), t.INT8
            )
        return new_plan, sq_col

    def _in_corr_pullup(self, plan, scope, c: A.InSubquery):
        """Correlated IN: ``x IN (SELECT e FROM i WHERE corr)``
        rewrites to EXISTS(SELECT 1 FROM i WHERE corr AND e = x) and
        rides the EXISTS pull-up (convert_ANY_sublink_to_join).
        Engages only when the subquery is actually correlated — the
        plain membership path stays untouched otherwise — and the
        operand is a bare outer column (the same unambiguous-shape
        rule the EXISTS pull-up enforces). NOT IN is excluded: its
        NULL semantics (any NULL in the set nullifies the predicate)
        differ from an anti join — PG's convert_ANY_sublink_to_join
        applies only to non-negated ANY for the same reason."""
        if c.negated or not isinstance(c.operand, A.ColumnRef):
            return None
        q = c.query
        if (
            q.group_by or q.having is not None or q.limit is not None
            or q.offset is not None or q.distinct or q.set_ops
            or q.ctes or q.from_clause is None or q.where is None
            or len(q.items) != 1
            or self._contains_agg(q.items[0].expr)
        ):
            return None
        mark = len(self.subplans)
        try:
            _, inner_scope = self._from(q.from_clause)
        except AnalyzeError:
            del self.subplans[mark:]
            return None
        inner_ctx = ExprContext(inner_scope, self)
        correlated = self._has_unresolved_ref(q, inner_ctx)
        if correlated:
            # the spliced `e = x` conjunct resolves innermost-first:
            # if the inner scope CAPTURES the operand's name, the
            # equality would silently degenerate to an inner-only
            # tautology — bail to the pre-feature error instead
            m2 = len(self.subplans)
            try:
                self.expr(c.operand, inner_ctx)
                correlated = False  # capturable: ambiguous, bail
            except AnalyzeError:
                pass
            del self.subplans[m2:]
        del self.subplans[mark:]
        if not correlated:
            return None
        q2 = A.Select(
            items=[A.SelectItem(A.Literal(1))],
            from_clause=q.from_clause,
            where=A.BinOp(
                "and", q.where,
                A.BinOp("=", q.items[0].expr, c.operand),
            ),
        )
        return self._exists_subquery_join(
            plan, scope, A.ExistsSubquery(q2, c.negated)
        )

    def _exists_subquery_join(
        self, plan: L.LogicalPlan, scope: Scope, c: A.ExistsSubquery
    ) -> Optional[L.LogicalPlan]:
        """Correlated EXISTS pulled up to a semi/anti join. Applies when
        the subquery is a plain SELECT whose WHERE conjuncts are either
        fully inner-resolvable (they sink into the inner side) or
        inner = outer equalities (they become join keys). Returns None
        when the shape doesn't fit — the caller falls back to the
        uncorrelated count rewrite."""
        q = c.query
        if (
            q.group_by or q.having is not None or q.limit is not None
            or q.offset is not None or q.distinct or q.set_ops
            or q.from_clause is None or q.where is None
            # an ungrouped aggregate SELECT yields one row regardless of
            # matches, so EXISTS is unconditionally true — no join
            # semantics apply (convert_EXISTS_sublink's hasAggs check)
            or any(self._contains_agg(item.expr) for item in q.items)
        ):
            return None
        # every speculative analysis below rolls back subplan registration
        # on failure/abandonment, or orphan subqueries would execute on
        # every statement run (the mark/del pattern of _equi_key)
        outer_mark = len(self.subplans)
        try:
            inner_plan, inner_scope = self._from(q.from_clause)
        except AnalyzeError:
            del self.subplans[outer_mark:]
            return None
        inner_ctx = ExprContext(inner_scope, self)
        outer_ctx = ExprContext(scope, self)
        lkeys: list[E.TExpr] = []
        rkeys: list[E.TExpr] = []
        inner_pred: Optional[E.TExpr] = None

        def bail():
            del self.subplans[outer_mark:]
            return None

        for conj in _split_and(q.where):
            mark = len(self.subplans)
            try:
                te = _bool_type(self.expr(conj, inner_ctx))
                inner_pred = (
                    te if inner_pred is None
                    else E.BinE("and", inner_pred, te, t.BOOL)
                )
                continue
            except AnalyzeError:
                del self.subplans[mark:]
            if not (isinstance(conj, A.BinOp) and conj.op == "="):
                return bail()
            for a, b in ((conj.left, conj.right), (conj.right, conj.left)):
                # the outer side must be a BARE column reference that the
                # inner scope does NOT capture: a compound outer expr
                # like y + z could silently rebind z to an inner column
                # (SQL resolves innermost-first), so only the
                # unambiguous shape is pulled up
                if not isinstance(b, A.ColumnRef):
                    continue
                try:
                    self.expr(b, inner_ctx)
                    continue  # inner scope captures it: not a correlation
                except AnalyzeError:
                    pass
                mark = len(self.subplans)
                try:
                    ik = self.expr(a, inner_ctx)
                    ok_ = self.expr(b, outer_ctx)
                except AnalyzeError:
                    del self.subplans[mark:]
                    continue
                if ik.type != ok_.type:
                    ct = _common_input_type(ik.type, ok_.type, "EXISTS")
                    ik, ok_ = _cast(ik, ct), _cast(ok_, ct)
                lkeys.append(ok_)
                rkeys.append(ik)
                break
            else:
                return bail()
        if not lkeys:
            return bail()  # uncorrelated: the count rewrite handles it
        inner = inner_plan
        if inner_pred is not None:
            inner = L.Filter(inner, inner_pred, inner.schema)
        jt = "anti" if c.negated else "semi"
        return L.Join(
            plan, inner, jt, tuple(lkeys), tuple(rkeys), None, plan.schema
        )


def _split_and(e: A.Expr) -> list[A.Expr]:
    if isinstance(e, A.BinOp) and e.op == "and":
        return _split_and(e.left) + _split_and(e.right)
    return [e]


def _need(args, n: int, name: str) -> None:
    if len(args) != n:
        raise AnalyzeError(f"{name} requires {n} argument(s)")


def _need_ast(args, n: int, name: str) -> None:
    if len(args) != n:
        raise AnalyzeError(f"{name} requires {n} argument(s)")


def _default_name(e: A.Expr) -> str:
    if isinstance(e, A.ColumnRef):
        return e.name
    if isinstance(e, A.FuncCall):
        return e.name
    if isinstance(e, A.Extract):
        return "extract"
    if isinstance(e, A.Cast):
        return _default_name(e.operand)
    return "?column?"


def _computed_text_did(te: E.TExpr) -> Optional[str]:
    """Dictionary for a non-column TEXT expr: computed text
    (upper(col), col || 'x', CASE literals) is canonicalized into the
    session literal pool by the expr compiler (ops/expr.py: dst =
    want or LITERAL_DICT). A NULL literal stays dict-less so set-op
    alignment can adopt the other side's dictionary (grouping-set
    padding relies on this)."""
    from opentenbase_tpu_torch.ops import LITERAL_DICT

    if isinstance(te, E.Const) and te.value is None:
        return None
    return LITERAL_DICT


def _texpr_dict_id(te: E.TExpr, scope: Scope) -> Optional[str]:
    if te.type.id != t.TypeId.TEXT:
        return None
    if isinstance(te, E.Col) and te.index < len(scope.cols):
        return scope.cols[te.index].dict_id
    return _computed_text_did(te)


def _texpr_dict_id_grouped(te: E.TExpr, gctx: GroupedContext) -> Optional[str]:
    if te.type.id != t.TypeId.TEXT:
        return None
    if isinstance(te, E.Col) and te.index < len(gctx.group_texprs):
        inner = gctx.group_texprs[te.index]
        return _texpr_dict_id(inner, gctx.input_ctx.scope)
    return _computed_text_did(te)


def _expr_dict_id(te: E.TExpr, schema: tuple[L.OutCol, ...]) -> Optional[str]:
    if te.type.id != t.TypeId.TEXT:
        return None
    if isinstance(te, E.Col) and te.index < len(schema):
        return schema[te.index].dict_id
    return _computed_text_did(te)


# ---------------------------------------------------------------------------
# Public helpers
# ---------------------------------------------------------------------------

def analyze_statement(stmt: A.Statement, catalog: Catalog) -> L.StatementPlan:
    return Analyzer(catalog).statement(stmt)


def analyze_select(sql_or_ast, catalog: Catalog) -> L.StatementPlan:
    if isinstance(sql_or_ast, str):
        from opentenbase_tpu_torch.sql.parser import parse_one

        sql_or_ast = parse_one(sql_or_ast)
    return Analyzer(catalog).statement(sql_or_ast)

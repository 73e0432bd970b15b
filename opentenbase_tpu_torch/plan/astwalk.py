"""Shared AST walkers for statement rewriters (views, WITH, partitions).

One implementation of "every expression position of a Select" and "every
subquery inside an expression tree", so the rewrite passes cannot
silently diverge when the grammar grows."""

from __future__ import annotations

from opentenbase_tpu_torch.sql import ast as A


def select_exprs(sel: A.Select):
    """Yield every expression position of one SELECT (not recursive)."""
    for it in sel.items:
        yield it.expr
    if sel.from_clause is not None:
        pass  # table refs are walked by the rewriters themselves
    if sel.where is not None:
        yield sel.where
    if sel.having is not None:
        yield sel.having
    yield from sel.group_by
    for si in sel.order_by:
        yield si.expr
    for row in getattr(sel, "values_rows", ()):
        yield from row  # standalone VALUES rows may hold subqueries


def walk_expr_subqueries(e: A.Expr, fn) -> None:
    """Call ``fn(select)`` for every subquery Select inside ``e``."""
    if isinstance(e, (A.InSubquery, A.ExistsSubquery, A.ScalarSubquery)):
        fn(e.query)
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        vs = v if isinstance(v, (list, tuple)) else (v,)
        for x in vs:
            if isinstance(x, A.Expr):
                walk_expr_subqueries(x, fn)


def rename_relations(sel: A.Select, mapping: dict) -> int:
    """Replace base-relation references per ``mapping`` (recursive-CTE
    materialization: CTE name -> temp table), mutating ``sel``.
    Renamed refs keep the original name as their alias so qualified
    column refs still resolve; CTE-local names shadow outer mappings.
    Returns the number of references replaced."""
    import dataclasses

    count = [0]
    local: set = set()
    for name, _al, body in getattr(sel, "ctes", ()):
        eff = {k: v for k, v in mapping.items() if k not in local}
        if eff:
            count[0] += rename_relations(body, eff)
        local.add(name)
    eff = {k: v for k, v in mapping.items() if k not in local}
    if not eff:
        return count[0]

    def from_ref(r):
        if isinstance(r, A.RelRef):
            if r.name in eff:
                count[0] += 1
                return A.RelRef(eff[r.name], r.alias or r.name)
            return r
        if isinstance(r, A.JoinRef):
            return dataclasses.replace(
                r, left=from_ref(r.left), right=from_ref(r.right)
            )
        if isinstance(r, A.SubqueryRef):
            count[0] += rename_relations(r.query, eff)
            return r
        return r

    if sel.from_clause is not None:
        sel.from_clause = from_ref(sel.from_clause)
    for _op, sub in sel.set_ops:
        count[0] += rename_relations(sub, eff)
    for e in select_exprs(sel):
        walk_expr_subqueries(
            e, lambda q: count.__setitem__(
                0, count[0] + rename_relations(q, eff)
            )
        )
    return count[0]


def relation_names(sel: A.Select, acc: set | None = None) -> set:
    """All base-relation names a SELECT references (recursively through
    joins, derived tables, set ops, and expression subqueries) — the
    dependency set pg_depend tracks for views."""
    if acc is None:
        acc = set()
    # CTE names are statement-LOCAL: their bodies' references are real
    # dependencies, the names themselves are not (PostgreSQL's
    # pg_depend records through the CTE the same way)
    local: set = set()
    for _name, _aliases, body in getattr(sel, "ctes", ()):
        inner = relation_names(body)
        acc |= inner - local
        local.add(_name)
    here: set = set()

    def from_ref(r):
        if isinstance(r, A.RelRef):
            here.add(r.name)
        elif isinstance(r, A.JoinRef):
            from_ref(r.left)
            from_ref(r.right)
        elif isinstance(r, A.SubqueryRef):
            relation_names(r.query, here)

    if sel.from_clause is not None:
        from_ref(sel.from_clause)
    for _op, sub in sel.set_ops:
        relation_names(sub, here)
    for e in select_exprs(sel):
        walk_expr_subqueries(e, lambda q: relation_names(q, here))
    acc |= here - local
    return acc

"""View expansion — the rewriter (src/backend/rewrite/rewriteHandler.c).

A view is a named, durable SELECT; references expand to derived tables
before analysis, exactly like the reference's rule-based rewrite. The
stored AST template is never handed out directly: every expansion deep-
copies it, because downstream rewrites (partition expansion) mutate
trees in place.
"""

from __future__ import annotations

import copy

from opentenbase_tpu_torch.sql import ast as A

MAX_DEPTH = 32


class ViewRecursionError(ValueError):
    pass


def rewrite_views(sel: A.Select, views: dict, depth: int = 0) -> A.Select:
    """Mutates ``sel`` in place, replacing view references with derived
    tables (SubqueryRef over a fresh copy of the view's SELECT, itself
    view-expanded)."""
    if depth > MAX_DEPTH:
        raise ViewRecursionError(
            "infinite recursion detected in view expansion"
        )

    def expand_ref(ref):
        if isinstance(ref, A.RelRef) and ref.name in views:
            body = copy.deepcopy(views[ref.name][0])
            # a view body may carry WITH; its CTE bodies may in turn
            # reference other views — expand CTEs first so the view
            # rewrite below reaches inside them
            expand_ctes(body, depth + 1)
            rewrite_views(body, views, depth + 1)
            return A.SubqueryRef(body, ref.alias or ref.name)
        if isinstance(ref, A.JoinRef):
            import dataclasses

            return dataclasses.replace(
                ref, left=expand_ref(ref.left), right=expand_ref(ref.right)
            )
        if isinstance(ref, A.SubqueryRef):
            rewrite_views(ref.query, views, depth + 1)
            return ref
        return ref

    if sel.from_clause is not None:
        sel.from_clause = expand_ref(sel.from_clause)
    for _op, sub in sel.set_ops:
        rewrite_views(sub, views, depth + 1)
    from opentenbase_tpu_torch.plan.astwalk import (
        select_exprs,
        walk_expr_subqueries,
    )

    for e in select_exprs(sel):
        walk_expr_subqueries(
            e, lambda q: rewrite_views(q, views, depth + 1)
        )
    return sel


def _expr_subqueries(e, views: dict, depth: int) -> None:
    """Expand views inside the subqueries of one expression tree (for
    statements that carry bare expressions, e.g. DML WHERE clauses)."""
    from opentenbase_tpu_torch.plan.astwalk import walk_expr_subqueries

    walk_expr_subqueries(e, lambda q: rewrite_views(q, views, depth + 1))


def expand_ctes(sel: A.Select, depth: int = 0) -> A.Select:
    """Expand WITH clauses throughout ``sel`` (mutating): each CTE is a
    statement-scoped view — parse_analyze's CTE-as-subquery planning
    (parse_cte.c) done as the same inline substitution view expansion
    uses. PostgreSQL scoping holds: a CTE sees only EARLIER CTEs in
    its WITH list, and a CTE name shadows any same-named table or view
    (the caller runs this before view expansion)."""
    if depth > MAX_DEPTH:
        raise ViewRecursionError(
            "infinite recursion detected in WITH expansion"
        )
    # INNER subqueries first: a subquery's own WITH must expand (and
    # shadow) before this level's CTE names substitute into it
    from opentenbase_tpu_torch.plan.astwalk import (
        select_exprs,
        walk_expr_subqueries,
    )

    def from_ref(ref):
        if isinstance(ref, A.SubqueryRef):
            expand_ctes(ref.query, depth + 1)
        elif isinstance(ref, A.JoinRef):
            from_ref(ref.left)
            from_ref(ref.right)

    if sel.from_clause is not None:
        from_ref(sel.from_clause)
    for _op, sub in sel.set_ops:
        expand_ctes(sub, depth + 1)
    for e in select_exprs(sel):
        walk_expr_subqueries(
            e, lambda q: expand_ctes(q, depth + 1)
        )
    if sel.ctes:
        cte_views: dict = {}
        for name, aliases, body in sel.ctes:
            if name in cte_views:
                raise ViewRecursionError(
                    f'WITH query name "{name}" specified more '
                    "than once"
                )
            from opentenbase_tpu_torch.plan.astwalk import relation_names

            if name in relation_names(body):
                # the session materializes top-level recursive CTEs
                # before this runs — one reaching here would silently
                # resolve against a same-named base table
                raise ViewRecursionError(
                    f'recursive WITH query "{name}" is only '
                    "supported at the top level of a statement"
                )
            body = copy.deepcopy(body)
            expand_ctes(body, depth + 1)  # nested WITH in the body
            rewrite_views(body, cte_views, depth + 1)
            if aliases:
                if body.values_rows and not body.items:
                    # a VALUES body names its columns at analysis
                    # time (column1..N); aliasing goes through a
                    # wrapping projection
                    if len(aliases) != len(body.values_rows[0]):
                        raise ViewRecursionError(
                            f'CTE "{name}" has {len(aliases)} column '
                            "aliases but "
                            f"{len(body.values_rows[0])} output "
                            "columns"
                        )
                    body = A.Select(
                        items=[
                            A.SelectItem(
                                A.ColumnRef(f"column{i + 1}", None),
                                alias,
                            )
                            for i, alias in enumerate(aliases)
                        ],
                        from_clause=A.SubqueryRef(body, "__v"),
                    )
                elif len(aliases) != len(body.items):
                    raise ViewRecursionError(
                        f'CTE "{name}" has {len(aliases)} column '
                        f"aliases but {len(body.items)} output columns"
                    )
                else:
                    import dataclasses

                    body.items = [
                        dataclasses.replace(item, alias=alias)
                        for item, alias in zip(body.items, aliases)
                    ]
            cte_views[name] = (body, "")
        sel.ctes = []
        rewrite_views(sel, cte_views, depth + 1)
    return sel

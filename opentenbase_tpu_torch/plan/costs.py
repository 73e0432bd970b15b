"""Cardinality estimation for the distributed planner.

The slice of the reference's costsize.c / selfuncs.c that a columnar
engine needs: row-count estimates per logical subtree and distinct-value
estimates per output column, driven by ANALYZE statistics
(``TableMeta.stats`` — pg_class.reltuples / pg_statistic analogs).
Consumers: the join-reorder pass (plan/optimize.py) and the
broadcast-vs-redistribute motion decision (plan/distribute.py) — the
same decisions the reference takes in make_join_rel/redistribute_path
(src/backend/optimizer/util/pathnode.c:1469).

All numbers are estimates; correctness never depends on them.
"""

from __future__ import annotations

from typing import Optional

from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan import texpr as E

DEFAULT_ROWS = 1000.0
DEFAULT_NDV = 200.0
SEL_EQ = 0.05       # equality with unknown NDV
SEL_RANGE = 0.33    # >, <, between (one-sided)
SEL_OTHER = 0.25    # anything else


def estimate_rows(plan: L.LogicalPlan, catalog, memo=None) -> float:
    """Memoized on node identity: join estimates recurse into both
    children AND per-key ndv lookups, which without a memo is
    exponential in join depth."""
    if memo is None:
        memo = {}
    key = id(plan)
    got = memo.get(key)
    if got is None:
        got = _est(plan, catalog, memo)
        memo[key] = got
    return got


def _est(plan: L.LogicalPlan, catalog, memo) -> float:
    if isinstance(plan, L.Scan):
        meta = _meta(catalog, plan.table)
        if meta is not None and meta.stats.get("rows") is not None:
            return max(float(meta.stats["rows"]), 1.0)
        return DEFAULT_ROWS
    if isinstance(plan, L.ValuesScan):
        return max(float(len(plan.rows)), 1.0)
    if isinstance(plan, L.Filter):
        base = estimate_rows(plan.child, catalog, memo)
        return max(base * _selectivity(plan.predicate, plan.child, catalog, memo), 1.0)
    if isinstance(plan, L.Project):
        return estimate_rows(plan.child, catalog, memo)
    if isinstance(plan, L.Join):
        lrows = estimate_rows(plan.left, catalog, memo)
        rrows = estimate_rows(plan.right, catalog, memo)
        if plan.join_type in ("semi", "anti"):
            return max(lrows * 0.5, 1.0)
        if not plan.left_keys:
            return lrows * rrows  # cross join
        # |L|*|R| / max(ndv(lk), ndv(rk)) per equated pair (selfuncs.c
        # eqjoinsel); take the most selective pair
        out = lrows * rrows
        best = 1.0
        for lk, rk in zip(plan.left_keys, plan.right_keys):
            nl = expr_ndv(lk, plan.left, catalog, memo) or DEFAULT_NDV
            nr = expr_ndv(rk, plan.right, catalog, memo) or DEFAULT_NDV
            best = max(best, max(nl, nr))
        out = out / best
        if plan.join_type == "left":
            out = max(out, lrows)
        if plan.residual is not None:
            out *= SEL_OTHER
        return max(out, 1.0)
    if isinstance(plan, L.Aggregate):
        base = estimate_rows(plan.child, catalog, memo)
        if not plan.group_exprs:
            return 1.0
        groups = 1.0
        for g in plan.group_exprs:
            groups *= expr_ndv(g, plan.child, catalog, memo) or DEFAULT_NDV
        return max(min(base, groups), 1.0)
    if isinstance(plan, L.Distinct):
        return max(estimate_rows(plan.child, catalog, memo) * 0.5, 1.0)
    if isinstance(plan, L.Limit):
        base = estimate_rows(plan.child, catalog, memo)
        if plan.limit is not None:
            return float(min(base, plan.limit + plan.offset))
        return base
    if isinstance(plan, (L.Sort, L.Window)):
        return estimate_rows(plan.child, catalog, memo)
    if isinstance(plan, L.Union):
        return sum(estimate_rows(i, catalog, memo) for i in plan.inputs)
    return DEFAULT_ROWS


def _meta(catalog, table: str):
    try:
        return catalog.get(table)
    except Exception:
        return None


def expr_ndv(
    e: E.TExpr, plan: L.LogicalPlan, catalog, memo=None
) -> Optional[float]:
    """Distinct-value estimate of an expression over a subtree's output,
    traced through Project/Filter/Join down to base-table stats."""
    bc = e
    while isinstance(bc, E.CastE):
        bc = bc.operand
    if not isinstance(bc, E.Col):
        return None
    ndv = _col_ndv(plan, bc.index, catalog)
    if ndv is None:
        return None
    return min(ndv, estimate_rows(plan, catalog, memo))


def _col_ndv(plan: L.LogicalPlan, idx: int, catalog) -> Optional[float]:
    if isinstance(plan, L.Scan):
        meta = _meta(catalog, plan.table)
        if meta is None:
            return None
        ndv = meta.stats.get("ndv", {}).get(plan.columns[idx])
        return float(ndv) if ndv else None
    if isinstance(plan, L.Filter):
        return _col_ndv(plan.child, idx, catalog)
    if isinstance(plan, L.Project):
        ex = plan.exprs[idx]
        while isinstance(ex, E.CastE):
            ex = ex.operand
        if isinstance(ex, E.Col):
            return _col_ndv(plan.child, ex.index, catalog)
        return None
    if isinstance(plan, L.Join):
        nleft = len(plan.left.schema)
        if idx < nleft or plan.join_type in ("semi", "anti"):
            return _col_ndv(plan.left, idx, catalog)
        return _col_ndv(plan.right, idx - nleft, catalog)
    if isinstance(plan, (L.Sort, L.Limit, L.Distinct)):
        return _col_ndv(plan.child, idx, catalog)
    return None


def _selectivity(
    pred: E.TExpr, child: L.LogicalPlan, catalog, memo=None
) -> float:
    sel = 1.0
    for c in E.conjuncts(pred):
        sel *= _conj_selectivity(c, child, catalog, memo)
    return max(sel, 1e-6)


def _conj_selectivity(c: E.TExpr, child, catalog, memo=None) -> float:
    if isinstance(c, E.BinE):
        if c.op == "=":
            for a, b in ((c.left, c.right), (c.right, c.left)):
                if isinstance(b, E.Const):
                    ndv = expr_ndv(a, child, catalog, memo)
                    return 1.0 / ndv if ndv else SEL_EQ
            return SEL_EQ
        if c.op in ("<", "<=", ">", ">="):
            return SEL_RANGE
        if c.op == "or":
            a = _conj_selectivity(c.left, child, catalog, memo)
            b = _conj_selectivity(c.right, child, catalog, memo)
            return min(a + b, 1.0)
    if isinstance(c, E.InListE):
        ndv = expr_ndv(c.operand, child, catalog, memo)
        k = len(c.items)
        s = k / ndv if ndv else min(SEL_EQ * k, 1.0)
        return min(1.0 - s, 1.0) if c.negated else min(s, 1.0)
    return SEL_OTHER

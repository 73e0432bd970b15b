"""Per-query memory estimation for admission control.

Rides the planner's existing cardinality machinery (plan/costs.py —
the costsize.c slice): estimated output rows of every plan node times
its schema width, maxed over the tree, approximates the largest batch
the executor will materialize. Like every cost number, it's an
estimate; correctness never depends on it — WLM uses it only to charge
group memory budgets, and DistExecutor reports actually-observed bytes
back into ``pg_stat_wlm.peak_memory``.
"""

from __future__ import annotations

from opentenbase_tpu_torch import types as t

# bytes per output column by storage dtype; TEXT is int32 codes on
# device but the host-side dictionary makes its true footprint larger
_WIDTH = {
    t.TypeId.BOOL: 1,
    t.TypeId.INT4: 4,
    t.TypeId.INT8: 8,
    t.TypeId.FLOAT4: 4,
    t.TypeId.FLOAT8: 8,
    t.TypeId.TEXT: 32,
}

# fallback when a statement can't be planned for estimation (system
# view not yet materialized, DML write set, ...)
DEFAULT_ESTIMATE = 64 * 1024


def _schema_width(plan) -> int:
    total = 0
    for col in getattr(plan, "schema", ()) or ():
        total += _WIDTH.get(getattr(col.type, "id", None), 8)
    return max(total, 8)


def _plan_peak_bytes(plan, catalog, memo) -> float:
    """Max over the plan tree of (estimated rows x schema width): the
    widest batch any operator materializes."""
    from opentenbase_tpu_torch.plan.costs import estimate_rows

    peak = estimate_rows(plan, catalog, memo) * _schema_width(plan)
    for child in plan.children():
        peak = max(peak, _plan_peak_bytes(child, catalog, memo))
    return peak


def estimate_statement_memory(stmt, catalog, work_mem: int = 0) -> int:
    """Admission-control memory estimate (bytes) for a statement.

    SELECTs plan through the analyzer and take the widest estimated
    batch; DML charges a small flat write-set allowance (its scans are
    short positional passes). Any analysis failure falls back to
    DEFAULT_ESTIMATE — admission must never reject a statement the
    executor could run just because estimation choked.

    ``work_mem`` (the session GUC, bytes) floors every estimate: PG
    grants each statement's sort/hash scratch up to work_mem before
    spilling, so admission charges at least that much per statement —
    raising work_mem honestly shrinks how many statements a
    memory-budgeted group admits at once.

    Cost note: this analyzes the statement a second time (execution
    re-analyzes); only sessions in a group with memory_limit > 0 pay
    it. Reusing the analyzed tree across admission and execution would
    need the planner's partition/sequence rewrites to stop mutating
    ASTs in place — not worth it until memory-budgeted groups are hot.
    """
    from opentenbase_tpu_torch.sql import ast as A

    if isinstance(stmt, A.CreateMatview) and isinstance(
        stmt.query, A.Select
    ):
        # matview population is its defining query's read
        stmt = stmt.query
    floor = max(int(work_mem or 0), 0)
    if isinstance(stmt, A.Select):
        try:
            from opentenbase_tpu_torch.plan import analyze_statement

            splan = analyze_statement(stmt, catalog)
            memo: dict = {}
            peak = _plan_peak_bytes(splan.root, catalog, memo)
            for sub in getattr(splan, "subplans", ()) or ():
                peak = max(peak, _plan_peak_bytes(sub, catalog, memo))
            return max(int(peak), floor, 1)
        except Exception:
            return max(DEFAULT_ESTIMATE, floor)
    if isinstance(stmt, A.Insert):
        nrows = len(stmt.values) if stmt.values else 1000
        return max(nrows * 64, DEFAULT_ESTIMATE, floor)
    return max(DEFAULT_ESTIMATE, floor)

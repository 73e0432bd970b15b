"""Logical plan operators.

The analog of PG's Plan tree (src/include/nodes/plannodes.h) flattened to
the vectorized-operator set the TPU executor supports. Every node exposes
``schema`` — an ordered list of (name, SqlType) describing its output batch
— and ``key()``, a stable structural string used to cache compiled device
fragments (the plan-cache analog of src/backend/utils/cache/plancache.c).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.plan.texpr import AggCall, TExpr


@dataclass(frozen=True)
class OutCol:
    name: str
    type: t.SqlType
    # For TEXT columns: "table.column" identifying the dictionary that the
    # int32 codes index into (resolved via the catalog at execution time).
    dict_id: Optional[str] = None


class LogicalPlan:
    __slots__ = ()
    schema: tuple[OutCol, ...]

    def children(self) -> tuple["LogicalPlan", ...]:
        return ()

    def key(self) -> str:
        raise NotImplementedError

    def col_names(self) -> list[str]:
        return [c.name for c in self.schema]

    def col_types(self) -> list[t.SqlType]:
        return [c.type for c in self.schema]


@dataclass(frozen=True)
class Scan(LogicalPlan):
    """Sequential scan of a base table; projection pushed down to the
    column subset actually used (nodeSeqscan equivalent; there are no
    secondary indexes — columnar scans + pruning replace the btree AMs)."""

    table: str
    columns: tuple[str, ...]
    schema: tuple[OutCol, ...]

    def key(self) -> str:
        return f"scan({self.table}:{','.join(self.columns)})"


@dataclass(frozen=True)
class ValuesScan(LogicalPlan):
    """Literal rows (VALUES / SELECT-without-FROM)."""

    rows: tuple[tuple[TExpr, ...], ...]
    schema: tuple[OutCol, ...]

    def key(self) -> str:
        r = ";".join(",".join(e.key() for e in row) for row in self.rows)
        return f"values({r})"


@dataclass(frozen=True)
class Filter(LogicalPlan):
    child: LogicalPlan
    predicate: TExpr  # boolean
    schema: tuple[OutCol, ...]

    def children(self):
        return (self.child,)

    def key(self) -> str:
        return f"filter({self.child.key()},{self.predicate.key()})"


@dataclass(frozen=True)
class Project(LogicalPlan):
    child: LogicalPlan
    exprs: tuple[TExpr, ...]
    schema: tuple[OutCol, ...]

    def children(self):
        return (self.child,)

    def key(self) -> str:
        return f"proj({self.child.key()},{','.join(e.key() for e in self.exprs)})"


@dataclass(frozen=True)
class Aggregate(LogicalPlan):
    """Hash aggregate: group by ``group_exprs`` (over child output),
    compute ``aggs``. Output = group cols then agg results (nodeAgg
    equivalent; always hashed — no grouping-sets/ordered mode)."""

    child: LogicalPlan
    group_exprs: tuple[TExpr, ...]
    aggs: tuple[AggCall, ...]
    schema: tuple[OutCol, ...]

    def children(self):
        return (self.child,)

    def key(self) -> str:
        g = ",".join(e.key() for e in self.group_exprs)
        a = ",".join(a.key() for a in self.aggs)
        return f"agg({self.child.key()},[{g}],[{a}])"


@dataclass(frozen=True)
class Join(LogicalPlan):
    """Equi-join on key pairs + optional residual predicate over the
    concatenated output (left cols then right cols). join_type in
    inner/left/right/full/semi/anti (nodeHashjoin equivalent)."""

    left: LogicalPlan
    right: LogicalPlan
    join_type: str
    left_keys: tuple[TExpr, ...]
    right_keys: tuple[TExpr, ...]
    residual: Optional[TExpr]
    schema: tuple[OutCol, ...]

    def children(self):
        return (self.left, self.right)

    def key(self) -> str:
        lk = ",".join(e.key() for e in self.left_keys)
        rk = ",".join(e.key() for e in self.right_keys)
        res = self.residual.key() if self.residual else ""
        return f"join({self.join_type},{self.left.key()},{self.right.key()},[{lk}],[{rk}],{res})"


@dataclass(frozen=True)
class SortKey:
    expr: TExpr
    descending: bool = False
    nulls_first: Optional[bool] = None

    def key(self) -> str:
        return f"{self.expr.key()}{'D' if self.descending else 'A'}{self.nulls_first}"


@dataclass(frozen=True)
class Sort(LogicalPlan):
    child: LogicalPlan
    keys: tuple[SortKey, ...]
    schema: tuple[OutCol, ...]

    def children(self):
        return (self.child,)

    def key(self) -> str:
        return f"sort({self.child.key()},{','.join(k.key() for k in self.keys)})"


@dataclass(frozen=True)
class WinSpec:
    """One window column (a WindowFunc with its WindowClause resolved to
    physical child column positions)."""

    kind: str  # row_number|rank|dense_rank|count|sum|avg|min|max|lag|lead
    arg: Optional[int]  # child column position of the argument (or None)
    partition: tuple[int, ...]
    order: tuple[tuple[int, bool], ...]  # (child col, descending)
    out: OutCol = OutCol("", None)  # type: ignore[arg-type]
    offset: int = 1  # lag/lead distance
    # ROWS frame (start, end): None = unbounded, negative = PRECEDING,
    # 0 = CURRENT ROW, positive = FOLLOWING; frame=None = default
    frame: Optional[tuple] = None

    def key(self) -> str:
        o = ",".join(f"{c}{'D' if d else 'A'}" for c, d in self.order)
        return (
            f"{self.kind}({self.arg})p[{','.join(map(str, self.partition))}]"
            f"o[{o}]+{self.offset}f{self.frame}"
        )


@dataclass(frozen=True)
class Window(LogicalPlan):
    """Window-function evaluation (nodeWindowAgg): child columns pass
    through, one appended column per spec. Aggregate kinds use the whole
    partition when the spec has no ORDER BY and the cumulative
    peers-inclusive running frame (PG's default RANGE UNBOUNDED
    PRECEDING) when it does."""

    child: LogicalPlan
    specs: tuple[WinSpec, ...]
    schema: tuple[OutCol, ...]

    def children(self):
        return (self.child,)

    def key(self) -> str:
        return (
            f"window({self.child.key()};"
            f"{';'.join(s.key() for s in self.specs)})"
        )


@dataclass(frozen=True)
class Limit(LogicalPlan):
    child: LogicalPlan
    limit: Optional[int]
    offset: int
    schema: tuple[OutCol, ...]

    def children(self):
        return (self.child,)

    def key(self) -> str:
        return f"limit({self.child.key()},{self.limit},{self.offset})"


@dataclass(frozen=True)
class Distinct(LogicalPlan):
    """SELECT DISTINCT — grouped dedup over all output columns."""

    child: LogicalPlan
    schema: tuple[OutCol, ...]

    def children(self):
        return (self.child,)

    def key(self) -> str:
        return f"distinct({self.child.key()})"


@dataclass(frozen=True)
class Union(LogicalPlan):
    """UNION ALL of schema-compatible children (Append equivalent)."""

    inputs: tuple[LogicalPlan, ...]
    schema: tuple[OutCol, ...]

    def children(self):
        return self.inputs

    def key(self) -> str:
        return f"union({','.join(c.key() for c in self.inputs)})"


# ---------------------------------------------------------------------------
# DML plans (ModifyTable equivalents)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InsertPlan(LogicalPlan):
    table: str
    # Source of rows: a plan producing columns in table-column order for
    # ``columns`` (missing table columns become NULL/default).
    source: LogicalPlan
    columns: tuple[str, ...]
    schema: tuple[OutCol, ...] = ()

    def children(self):
        return (self.source,)

    def key(self) -> str:
        return f"insert({self.table},{self.source.key()})"


@dataclass(frozen=True)
class UpdatePlan(LogicalPlan):
    table: str
    # Predicate over the table's columns selecting rows to update
    predicate: Optional[TExpr]
    # (column name, value expr over table columns)
    assignments: tuple[tuple[str, TExpr], ...]
    schema: tuple[OutCol, ...] = ()

    def key(self) -> str:
        p = self.predicate.key() if self.predicate else ""
        a = ",".join(f"{c}={e.key()}" for c, e in self.assignments)
        return f"update({self.table},{p},{a})"


@dataclass(frozen=True)
class DeletePlan(LogicalPlan):
    table: str
    predicate: Optional[TExpr]
    schema: tuple[OutCol, ...] = ()

    def key(self) -> str:
        p = self.predicate.key() if self.predicate else ""
        return f"delete({self.table},{p})"


@dataclass
class StatementPlan:
    """A fully analyzed statement: the root plan plus uncorrelated
    subplans referenced by SubqueryParam (InitPlans)."""

    root: LogicalPlan
    subplans: list[LogicalPlan] = field(default_factory=list)

    def key(self) -> str:
        subs = ";".join(s.key() for s in self.subplans)
        return f"{self.root.key()}|{subs}"


def explain_tree(plan: LogicalPlan, indent: int = 0) -> str:
    """Human-readable plan tree (EXPLAIN text output)."""
    pad = "  " * indent
    name = type(plan).__name__
    detail = ""
    if isinstance(plan, Scan):
        detail = f" on {plan.table} [{', '.join(plan.columns)}]"
    elif isinstance(plan, Filter):
        detail = f" ({plan.predicate})"
    elif isinstance(plan, Aggregate):
        groups = ", ".join(map(str, plan.group_exprs))
        aggs = ", ".join(map(str, plan.aggs))
        detail = f" groups=[{groups}] aggs=[{aggs}]"
    elif isinstance(plan, Join):
        keys = ", ".join(
            f"{l}={r}" for l, r in zip(plan.left_keys, plan.right_keys)
        )
        detail = f" {plan.join_type} on {keys}"
    elif isinstance(plan, Sort):
        detail = " " + ", ".join(
            f"{k.expr}{' DESC' if k.descending else ''}" for k in plan.keys
        )
    elif isinstance(plan, Limit):
        detail = f" limit={plan.limit} offset={plan.offset}"
    elif isinstance(plan, Project):
        detail = f" [{', '.join(map(str, plan.exprs))}]"
    lines = [f"{pad}{name}{detail}"]
    for c in plan.children():
        lines.append(explain_tree(c, indent + 1))
    return "\n".join(lines)

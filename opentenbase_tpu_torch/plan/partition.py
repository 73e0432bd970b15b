"""Range / interval table partitioning.

The reference extends CREATE TABLE with interval partitioning
(``PARTITION BY RANGE (col) BEGIN (v) STEP (s [unit]) PARTITIONS (n)``,
src/backend/parser/gram.y:4172, parsenodes.h:880): a parent table whose
rows live in N physical range partitions, routed by a begin/step rule and
pruned at plan time.

Here each partition is a real child table (``parent$pK`` — the columnar
analog of a partition's own heap), the parent is a catalog-only shell,
and the engine:

- splits INSERT batches by the routing rule (vectorized searchsorted),
- rewrites parent references in SELECT into a UNION ALL over the
  children that survive WHERE-clause pruning (the planner-side
  partition pruning of the reference), and
- fans UPDATE/DELETE/TRUNCATE out over surviving children in one
  transaction.

Boundaries are precomputed as internal int64 values (µs for timestamps,
days for dates, raw ints otherwise); calendar units (month/year) use real
calendar arithmetic at boundary-build time so "1 month" steps land on
month starts, exactly like the reference's interval partitions.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field

import numpy as np

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.sql import ast as A

_CAL_UNITS = {"month", "months", "year", "years"}
_FIXED_US = {
    "second": 1_000_000, "seconds": 1_000_000,
    "minute": 60_000_000, "minutes": 60_000_000,
    "hour": 3_600_000_000, "hours": 3_600_000_000,
    "day": 86_400_000_000, "days": 86_400_000_000,
}


class PartitionError(ValueError):
    pass


_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _naive_utc_us(dt: datetime.datetime) -> int:
    """Naive datetimes are UTC (the engine stores naive-UTC µs via
    np.datetime64) — never route through the host timezone."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return int((dt - _EPOCH).total_seconds() * 1_000_000)


def to_internal(value, ty: t.SqlType) -> int:
    """Literal -> the storage representation partition math runs in."""
    if ty.id == t.TypeId.TIMESTAMP:
        if isinstance(value, str):
            return _naive_utc_us(datetime.datetime.fromisoformat(value))
        if isinstance(value, datetime.datetime):
            return _naive_utc_us(value)
        return int(value)
    if ty.id == t.TypeId.DATE:
        if isinstance(value, str):
            d = datetime.date.fromisoformat(value)
            return (d - datetime.date(1970, 1, 1)).days
        if isinstance(value, datetime.date):
            return (value - datetime.date(1970, 1, 1)).days
        return int(value)
    return int(value)


def _add_calendar(base: datetime.datetime, n_units: int, unit: str):
    months = n_units * (12 if unit.startswith("year") else 1)
    y, m = divmod((base.year * 12 + base.month - 1) + months, 12)
    import calendar as _cal

    day = min(base.day, _cal.monthrange(y, m + 1)[1])
    return base.replace(year=y, month=m + 1, day=day)


@dataclass
class PartitionSpec:
    parent: str
    column: str
    key_type: t.SqlType
    nparts: int
    spec: dict  # the parsed clause, JSON-serializable (for WAL/checkpoint)
    boundaries: np.ndarray = field(default_factory=lambda: np.empty(0))

    @classmethod
    def build(cls, parent: str, clause: dict, key_type: t.SqlType) -> "PartitionSpec":
        n = int(clause.get("partitions", 0))
        if n <= 0:
            raise PartitionError("PARTITIONS (n) must be positive")
        begin = clause.get("begin")
        step = clause.get("step")
        if begin is None or step is None:
            raise PartitionError("partitioned table needs BEGIN and STEP")
        unit = (clause.get("step_unit") or "").lower()
        b = to_internal(begin, key_type)
        bounds = [b]
        if unit in _CAL_UNITS:
            if key_type.id not in (t.TypeId.TIMESTAMP, t.TypeId.DATE):
                raise PartitionError(
                    f"calendar STEP unit {unit!r} needs a date/timestamp key"
                )
            if key_type.id == t.TypeId.TIMESTAMP:
                base = datetime.datetime(1970, 1, 1) + datetime.timedelta(
                    microseconds=b
                )
            else:
                base = datetime.datetime(1970, 1, 1) + datetime.timedelta(days=b)
            for i in range(1, n + 1):
                nxt = _add_calendar(base, int(step) * i, unit)
                bounds.append(to_internal(
                    nxt if key_type.id == t.TypeId.TIMESTAMP else nxt.date(),
                    key_type,
                ))
        else:
            if unit and key_type.id == t.TypeId.TIMESTAMP:
                if unit not in _FIXED_US:
                    raise PartitionError(f"unknown STEP unit {unit!r}")
                inc = int(step) * _FIXED_US[unit]
            elif unit and key_type.id == t.TypeId.DATE:
                if not unit.startswith("day"):
                    raise PartitionError(
                        f"STEP unit {unit!r} unsupported for date keys"
                    )
                inc = int(step)
            else:
                inc = to_internal(step, t.INT8)
            if inc <= 0:
                raise PartitionError("STEP must be positive")
            for i in range(1, n + 1):
                bounds.append(b + inc * i)
        return cls(
            parent, clause["column"], key_type, n, dict(clause),
            np.asarray(bounds, dtype=np.int64),
        )

    # -- naming ----------------------------------------------------------
    def child(self, i: int) -> str:
        return f"{self.parent}$p{i}"

    def children(self) -> list[str]:
        return [self.child(i) for i in range(self.nparts)]

    # -- routing (locate_shard_insert analog, per-partition) -------------
    def route(self, values: np.ndarray, validity=None) -> np.ndarray:
        """Row -> partition index; raises on NULL or out-of-range keys."""
        v = np.asarray(values, dtype=np.int64)
        if validity is not None and not bool(np.all(validity)):
            raise PartitionError(
                f"null partition key in table {self.parent!r}"
            )
        idx = np.searchsorted(self.boundaries, v, side="right") - 1
        bad = (idx < 0) | (idx >= self.nparts)
        if bad.any():
            raise PartitionError(
                f"value out of range for partitions of {self.parent!r}"
            )
        return idx

    # -- pruning (plan-time partition elimination) -----------------------
    def prune(self, where: A.Expr | None, names: set[str]) -> list[int]:
        """Surviving partition indices under the WHERE clause. ``names``
        = identifiers the partition column may appear under (column name,
        alias-qualified). Conservative: anything unrecognized keeps all."""
        lo, hi = 0, self.nparts  # [lo, hi)
        for op, val in self._quals(where, names):
            try:
                v = to_internal(val, self.key_type)
            except (ValueError, TypeError):
                continue
            i = int(np.searchsorted(self.boundaries, v, side="right") - 1)
            if op == "=":
                if i < 0 or i >= self.nparts:
                    return []
                lo, hi = max(lo, i), min(hi, i + 1)
            elif op in ("<", "<="):
                hi = min(hi, max(i + 1, 0))
            elif op in (">", ">="):
                lo = max(lo, max(i, 0))
        return list(range(lo, max(lo, hi)))

    def _quals(self, e: A.Expr | None, names: set[str]):
        """Yield (op, literal) conjuncts on the partition column."""
        if e is None:
            return
        if isinstance(e, A.BinOp):
            if e.op == "and":
                yield from self._quals(e.left, names)
                yield from self._quals(e.right, names)
                return
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
            if e.op in flip:
                left, right, op = e.left, e.right, e.op
                if isinstance(right, A.ColumnRef) and isinstance(left, A.Literal):
                    left, right, op = right, left, flip[op]
                if (
                    isinstance(left, A.ColumnRef)
                    and isinstance(right, A.Literal)
                    and left.name == self.column
                    and (left.table is None or left.table in names)
                    and right.value is not None
                ):
                    yield op, right.value


def rewrite_select(sel: A.Select, partitions: dict) -> A.Select:
    """Replace references to partitioned parents with a pruned UNION ALL
    subquery over the children (mutates the freshly-parsed AST in place;
    at least one child survives so the result schema is preserved).
    Covers FROM (incl. joins and derived tables), set-operation branches,
    and subqueries inside expressions."""

    def expand_ref(ref, where):
        if isinstance(ref, A.RelRef) and ref.name in partitions:
            spec = partitions[ref.name]
            alias = ref.alias or ref.name
            keep = spec.prune(where, {alias, ref.name})
            if not keep:
                keep = [0]  # empty child: schema without rows

            def child_sel(i):
                return A.Select(
                    items=[A.SelectItem(A.Star())],
                    from_clause=A.RelRef(spec.child(i), None),
                )

            first = child_sel(keep[0])
            first.set_ops = [("union all", child_sel(i)) for i in keep[1:]]
            return A.SubqueryRef(first, alias)
        if isinstance(ref, A.JoinRef):
            import dataclasses

            return dataclasses.replace(
                ref,
                left=expand_ref(ref.left, where),
                right=expand_ref(ref.right, where),
            )
        if isinstance(ref, A.SubqueryRef):
            rewrite_select(ref.query, partitions)
            return ref
        return ref

    if sel.from_clause is not None:
        sel.from_clause = expand_ref(sel.from_clause, sel.where)
    for _op, sub in sel.set_ops:
        rewrite_select(sub, partitions)
    from opentenbase_tpu_torch.plan.astwalk import select_exprs, walk_expr_subqueries

    for e in select_exprs(sel):
        walk_expr_subqueries(e, lambda q: rewrite_select(q, partitions))
    return sel


def _rewrite_expr_subqueries(e: A.Expr, partitions: dict) -> None:
    """Expand partitioned parents inside the subqueries of one bare
    expression tree (DML WHERE clauses)."""
    from opentenbase_tpu_torch.plan.astwalk import walk_expr_subqueries

    walk_expr_subqueries(e, lambda q: rewrite_select(q, partitions))

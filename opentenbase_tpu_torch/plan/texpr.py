"""Typed expression IR.

The analyzer lowers parser AST expressions (sql/ast.py) into this IR with
every node carrying a resolved SqlType and column references bound to
positions in the child operator's output — the analog of PG's Var/Const/
OpExpr trees after parse analysis (src/backend/parser/parse_expr.c), except
values are already in physical representation (decimal = scaled int64,
date = epoch days, text constants = python str resolved to dictionary codes
at execution time).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from opentenbase_tpu_torch import types as t


class TExpr:
    __slots__ = ()
    type: t.SqlType

    def children(self) -> tuple["TExpr", ...]:
        return ()

    def key(self) -> str:
        """Stable structural key (plan-cache component)."""
        raise NotImplementedError


@dataclass(frozen=True)
class Col(TExpr):
    """Reference to child output column by position."""

    index: int
    type: t.SqlType
    name: str = ""

    def key(self) -> str:
        return f"c{self.index}"

    def __str__(self):
        return self.name or f"#{self.index}"


@dataclass(frozen=True)
class Const(TExpr):
    """A literal in physical representation (None = NULL)."""

    value: object
    type: t.SqlType

    def key(self) -> str:
        return f"k({self.value!r}:{self.type})"

    def __str__(self):
        return "NULL" if self.value is None else repr(self.value)


@dataclass(frozen=True)
class BinE(TExpr):
    """Binary op: arithmetic (+ - * / %), comparison (= <> < <= > >=),
    boolean (and or). Operands already coerced to a common input type."""

    op: str
    left: TExpr
    right: TExpr
    type: t.SqlType

    def children(self):
        return (self.left, self.right)

    def key(self) -> str:
        return f"({self.left.key()}{self.op}{self.right.key()})"

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class UnaryE(TExpr):
    op: str  # '-' | 'not'
    operand: TExpr
    type: t.SqlType

    def children(self):
        return (self.operand,)

    def key(self) -> str:
        return f"({self.op}{self.operand.key()})"

    def __str__(self):
        return f"({self.op} {self.operand})"


@dataclass(frozen=True)
class FuncE(TExpr):
    """Scalar function call (abs, round, coalesce, like, extract_year...)."""

    name: str
    args: tuple[TExpr, ...]
    type: t.SqlType

    def children(self):
        return self.args

    def key(self) -> str:
        return f"{self.name}({','.join(a.key() for a in self.args)})"

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class CaseE(TExpr):
    whens: tuple[tuple[TExpr, TExpr], ...]  # (bool cond, value)
    default: Optional[TExpr]
    type: t.SqlType

    def children(self):
        out: list[TExpr] = []
        for c, v in self.whens:
            out += [c, v]
        if self.default is not None:
            out.append(self.default)
        return tuple(out)

    def key(self) -> str:
        w = ";".join(f"{c.key()}:{v.key()}" for c, v in self.whens)
        d = self.default.key() if self.default else ""
        return f"case({w}|{d})"


@dataclass(frozen=True)
class CastE(TExpr):
    operand: TExpr
    type: t.SqlType

    def children(self):
        return (self.operand,)

    def key(self) -> str:
        return f"cast({self.operand.key()}:{self.type})"


@dataclass(frozen=True)
class IsNullE(TExpr):
    operand: TExpr
    negated: bool
    type: t.SqlType = t.BOOL

    def children(self):
        return (self.operand,)

    def key(self) -> str:
        return f"isnull({self.operand.key()},{self.negated})"


@dataclass(frozen=True)
class InListE(TExpr):
    operand: TExpr
    items: tuple[TExpr, ...]  # all Const, coerced to operand's type
    negated: bool
    type: t.SqlType = t.BOOL

    def children(self):
        return (self.operand, *self.items)

    def key(self) -> str:
        return f"in({self.operand.key()},{','.join(i.key() for i in self.items)},{self.negated})"


@dataclass(frozen=True)
class LikeE(TExpr):
    """LIKE/ILIKE on a dictionary-encoded TEXT operand. The pattern is a
    python string; the executor resolves it to a device code-membership
    test against the column's dictionary (types.py module docstring)."""

    operand: TExpr
    pattern: str
    ilike: bool
    negated: bool
    type: t.SqlType = t.BOOL

    def children(self):
        return (self.operand,)

    def key(self) -> str:
        return f"like({self.operand.key()},{self.pattern!r},{self.ilike},{self.negated})"


@dataclass(frozen=True)
class SubqueryParam(TExpr):
    """Placeholder for an uncorrelated scalar subquery's result; the
    executor runs subplan ``index`` first and binds its scalar here (the
    InitPlan/Param mechanism, src/backend/executor/nodeSubplan.c)."""

    index: int
    type: t.SqlType

    def key(self) -> str:
        return f"subq({self.index})"


@dataclass(frozen=True)
class AggCall:
    """One aggregate: func in sum/count/avg/min/max, arg=None for count(*)."""

    func: str
    arg: Optional[TExpr]
    distinct: bool
    type: t.SqlType  # result type

    def key(self) -> str:
        a = self.arg.key() if self.arg is not None else "*"
        return f"{self.func}({'D' if self.distinct else ''}{a})"

    def __str__(self):
        a = str(self.arg) if self.arg is not None else "*"
        d = "distinct " if self.distinct else ""
        return f"{self.func}({d}{a})"


def walk(e: TExpr):
    yield e
    for c in e.children():
        yield from walk(c)


def max_col_index(e: TExpr) -> int:
    m = -1
    for n in walk(e):
        if isinstance(n, Col):
            m = max(m, n.index)
    return m


def is_const(e: TExpr) -> bool:
    return isinstance(e, Const)


def conjuncts(e: "TExpr"):
    """Flatten an AND tree into its conjuncts (shared by the pushdown
    pass and the distributor's qual classification)."""
    if isinstance(e, BinE) and e.op == "and":
        yield from conjuncts(e.left)
        yield from conjuncts(e.right)
    else:
        yield e

"""Compile typed expressions (plan/texpr.py) to functions over torch
columns (subset of the reference's opentenbase_tpu/ops/expr.py).

A column value is a pair ``(data, valid)``: ``data`` a tensor, ``valid`` a
bool tensor or ``None`` (statically all-valid). NULL semantics are SQL's
three-valued logic: comparisons and arithmetic are NULL if any operand
is; AND/OR are Kleene.

Numeric and date literals are always lifted into runtime parameters
(the reference's ``lift_consts=True``): the compiler records a
``ScalarConstParam`` per distinct literal and the caller binds the values
with ``resolve_param`` on every run, so a compiled function serves every
query that differs only in its literals.

The subset: column references, lifted literals, NULL, the six
comparisons, AND/OR/NOT, unary minus, ``+ - *`` (decimals in scaled-int64
form, a product typed at the sum of the scales), and casts that widen
integers or rescale to a decimal. Anything else raises NotPorted.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from typing import Callable

import numpy as np
import torch

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.plan import texpr as E


@dataclass(frozen=True)
class ScalarConstParam:
    """A lifted numeric/date literal bound at call time."""

    value: object
    type: t.SqlType


ColVal = tuple  # (data: torch.Tensor, valid: torch.Tensor | None)
CompiledExpr = Callable  # (cols: tuple[ColVal, ...], params: tuple) -> ColVal


def torch_dtype(ty: t.SqlType) -> torch.dtype:
    """The tensor dtype of a SQL type's physical form."""
    return torch.from_numpy(np.zeros(0, dtype=ty.np_dtype)).dtype


def _and_valid(*valids):
    """Combine optional validity masks (None = all valid)."""
    vs = [v for v in valids if v is not None]
    if not vs:
        return None
    return reduce(lambda a, b: a & b, vs)


def _promote(a: torch.Tensor, b: torch.Tensor):
    """Both operands at their common dtype, promoted by dtype alone (as
    numpy and jnp promote): torch would otherwise let a dimensioned
    int32 column narrow a 0-d int64 literal."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


_CMP = {
    "=": torch.eq,
    "<>": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


class ExprCompiler:
    """Compiles one or more TExprs sharing a single param list, for
    columns on ``device``."""

    def __init__(self, device) -> None:
        self.params: list[ScalarConstParam] = []
        self.device = torch.device(device)

    def _param(self, spec: ScalarConstParam) -> int:
        # identical specs share one bind
        for i, p in enumerate(self.params):
            if p == spec:
                return i
        self.params.append(spec)
        return len(self.params) - 1

    def compile(self, expr: E.TExpr) -> CompiledExpr:
        """A function ``(cols, params) -> (data, valid)``; ``cols[i]`` is
        input column i as a (data, valid) pair."""
        return self._c(expr)

    def _c(self, e: E.TExpr) -> CompiledExpr:
        if isinstance(e, E.Col):
            idx = e.index
            return lambda cols, params: cols[idx]
        if isinstance(e, E.Const):
            return self._const(e)
        if isinstance(e, E.BinE):
            return self._bin(e)
        if isinstance(e, E.UnaryE):
            cf = self._c(e.operand)
            if e.op == "-":
                def run_neg(cols, params):
                    d, v = cf(cols, params)
                    return (-d, v)
                return run_neg
            if e.op == "not":
                def run_not(cols, params):
                    d, v = cf(cols, params)
                    return (~d, v)
                return run_not
            raise NotPorted(f"unary operator {e.op!r}")
        if isinstance(e, E.CastE):
            return self._cast(e)
        raise NotPorted(f"expression {type(e).__name__}")

    def _const(self, e: E.Const) -> CompiledExpr:
        if e.value is None:
            zero = torch.zeros((), dtype=torch_dtype(e.type),
                               device=self.device)
            null = torch.zeros((), dtype=torch.bool, device=self.device)
            return lambda cols, params: (zero, null)
        if e.type.is_text:
            raise NotPorted("TEXT literal")
        pi = self._param(ScalarConstParam(e.value, e.type))
        return lambda cols, params: (params[pi], None)

    def _bin(self, e: E.BinE) -> CompiledExpr:
        op = e.op
        if e.left.type.is_text or e.right.type.is_text:
            raise NotPorted("TEXT comparison")
        lf, rf = self._c(e.left), self._c(e.right)
        if op == "and":
            def run_and(cols, params):
                ld, lv = lf(cols, params)
                rd, rv = rf(cols, params)
                if lv is None and rv is None:
                    return (ld & rd, None)
                lF = ~ld if lv is None else (lv & ~ld)
                rF = ~rd if rv is None else (rv & ~rd)
                valid = _and_valid(lv, rv)
                defl = lF | rF  # a definite FALSE decides an AND
                valid = defl if valid is None else (valid | defl)
                return ((ld & rd) & ~defl, valid)
            return run_and
        if op == "or":
            def run_or(cols, params):
                ld, lv = lf(cols, params)
                rd, rv = rf(cols, params)
                if lv is None and rv is None:
                    return (ld | rd, None)
                lT = ld if lv is None else (lv & ld)
                rT = rd if rv is None else (rv & rd)
                valid = _and_valid(lv, rv)
                deft = lT | rT  # a definite TRUE decides an OR
                valid = deft if valid is None else (valid | deft)
                return ((ld | rd) | deft, valid)
            return run_or
        if op in _CMP:
            fn = _CMP[op]

            def run_cmp(cols, params):
                ld, lv = lf(cols, params)
                rd, rv = rf(cols, params)
                return (fn(*_promote(ld, rd)), _and_valid(lv, rv))
            return run_cmp
        if op in ("+", "-", "*"):
            # decimals are scaled int64: + and - meet at one scale (the
            # analyzer casts), and the analyzer types a product at the
            # sum of the scales, so all three are raw integer ops
            fn = {"+": torch.add, "-": torch.sub, "*": torch.mul}[op]

            def run_arith(cols, params):
                ld, lv = lf(cols, params)
                rd, rv = rf(cols, params)
                return (fn(*_promote(ld, rd)), _and_valid(lv, rv))
            return run_arith
        raise NotPorted(f"operator {op!r}")

    def _cast(self, e: E.CastE) -> CompiledExpr:
        cf = self._c(e.operand)
        src, dst = e.operand.type, e.type
        ints = (t.TypeId.INT4, t.TypeId.INT8, t.TypeId.BOOL)
        if src.id == dst.id and src.scale == dst.scale:
            return cf
        if dst.id == t.TypeId.DECIMAL and src.id == t.TypeId.DECIMAL:
            if dst.scale < src.scale:
                raise NotPorted("decimal cast to a smaller scale")
            factor = 10 ** (dst.scale - src.scale)
        elif dst.id == t.TypeId.DECIMAL and src.id in ints:
            factor = dst.decimal_factor
        elif dst.id in (t.TypeId.INT4, t.TypeId.INT8) and src.id in ints:
            factor = 1
        else:
            raise NotPorted(f"cast {src.id.value} -> {dst.id.value}")
        dt = torch_dtype(dst)

        def run_cast(cols, params):
            d, v = cf(cols, params)
            d = d.to(dt)
            return (d * factor if factor != 1 else d, v)

        return run_cast


def resolve_param(spec: ScalarConstParam, device) -> torch.Tensor:
    """The runtime value of a lifted literal: a 0-d tensor of its type's
    dtype on ``device``."""
    if not isinstance(spec, ScalarConstParam):
        raise TypeError(f"unknown param spec {spec}")
    arr = np.asarray(spec.value, dtype=spec.type.np_dtype)
    return torch.from_numpy(arr.reshape(())).to(device)

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

TEXT values are int32 codes into a host-side dictionary; the compiler
resolves TEXT constants against the dictionary of the column they meet
(``dict_ids[i]`` names input column i's), through params bound per run:
a ``TextCodeParam`` (the constant's code, -1 when the dictionary lacks
it, so equality matches nothing) or a ``CodeMaskParam`` (a per-code
boolean mask computed on the host, for an ordered comparison or an IN
list: codes follow insertion order, not collation).

The subset: column references, lifted literals, NULL, the six
comparisons, AND/OR/NOT, unary minus, ``+ - *`` (decimals in scaled-int64
form, a product typed at the sum of the scales), casts that widen
integers or rescale to a decimal, IN lists, and TEXT: a value-producing
literal, comparison of a column with a constant, and equality of two
columns of one dictionary. Anything else raises NotPorted.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from typing import Callable, Optional

import numpy as np
import torch

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.ops import LITERAL_DICT
from opentenbase_tpu_torch.ops.filter import bucket_size
from opentenbase_tpu_torch.plan import texpr as E


@dataclass(frozen=True)
class ScalarConstParam:
    """A lifted numeric/date literal bound at call time."""

    value: object
    type: t.SqlType


@dataclass(frozen=True)
class ArrayConstParam:
    """A lifted IN list: values padded to a power of two (repeating the
    first, harmless for membership) so the list's length does not change
    the compiled function."""

    values: tuple
    type: t.SqlType


@dataclass(frozen=True)
class TextCodeParam:
    """Scalar int32 code of a TEXT constant in dictionary ``dict_id``
    (-1 when the string is absent: equality then matches nothing)."""

    dict_id: str
    value: str


@dataclass(frozen=True)
class TextEncodeParam:
    """Scalar int32 code of a TEXT constant *inserted* into ``dict_id``
    (value-producing position: the string must exist so results decode)."""

    dict_id: str
    value: str


@dataclass(frozen=True)
class CodeMaskParam:
    """Per-code bool membership mask over dictionary ``dict_id``, padded
    to a power of two: ``values`` exact strings (an IN list), or ``cmp``
    an ordered comparison (op, reference string) in Python's string
    order. Exactly one is set."""

    dict_id: str
    values: tuple = ()
    cmp: tuple = ()


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
        self.params: list = []
        self.device = torch.device(device)

    def _param(self, spec) -> int:
        # identical specs share one bind
        for i, p in enumerate(self.params):
            if p == spec:
                return i
        self.params.append(spec)
        return len(self.params) - 1

    def compile(
        self, expr: E.TExpr, dict_ids=None, want_did: Optional[str] = None,
    ) -> CompiledExpr:
        """A function ``(cols, params) -> (data, valid)``; ``cols[i]`` is
        input column i as a (data, valid) pair. ``dict_ids[i]`` is input
        column i's dictionary id (None for non-TEXT); ``want_did``, for a
        TEXT-valued expression, the dictionary its output codes index."""
        return self._c(expr, tuple(dict_ids or ()), want_did)

    def _c(self, e: E.TExpr, dids, want=None) -> CompiledExpr:
        if isinstance(e, E.Col):
            idx = e.index
            if e.type.is_text and want is not None:
                src = (dids[idx] if idx < len(dids) else None) or LITERAL_DICT
                if src != want:
                    raise NotPorted("TEXT column translated across "
                                    "dictionaries")
            return lambda cols, params: cols[idx]
        if isinstance(e, E.Const):
            return self._const(e, want)
        if isinstance(e, E.BinE):
            return self._bin(e, dids)
        if isinstance(e, E.InListE):
            return self._in_list(e, dids)
        if isinstance(e, E.UnaryE):
            cf = self._c(e.operand, dids)
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
            return self._cast(e, dids)
        raise NotPorted(f"expression {type(e).__name__}")

    def _const(self, e: E.Const, want=None) -> CompiledExpr:
        if e.value is None:
            zero = torch.zeros((), dtype=torch_dtype(e.type),
                               device=self.device)
            null = torch.zeros((), dtype=torch.bool, device=self.device)
            return lambda cols, params: (zero, null)
        if e.type.is_text:
            # value-producing TEXT constant: encoded into the target (or
            # the session literal) dictionary so the result decodes
            pi = self._param(TextEncodeParam(want or LITERAL_DICT,
                                             str(e.value)))
            return lambda cols, params: (params[pi], None)
        pi = self._param(ScalarConstParam(e.value, e.type))
        return lambda cols, params: (params[pi], None)

    def _bin(self, e: E.BinE, dids) -> CompiledExpr:
        op = e.op
        if op not in ("and", "or") and (
            e.left.type.is_text or e.right.type.is_text
        ):
            return self._text_cmp(e, dids)
        lf, rf = self._c(e.left, dids), self._c(e.right, dids)
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

    # -- TEXT comparisons, on dictionary codes ---------------------------
    def _expr_dict_id(self, e: E.TExpr, dids) -> Optional[str]:
        if isinstance(e, E.Col):
            return dids[e.index] if e.index < len(dids) else None
        if isinstance(e, E.CastE):
            return self._expr_dict_id(e.operand, dids)
        return None

    def _text_cmp(self, e: E.BinE, dids) -> CompiledExpr:
        """Equality works on codes directly; an ordered comparison with a
        constant reads a per-code mask the host computes (codes follow
        insertion order, not collation)."""
        op = e.op
        if isinstance(e.right, E.Const):
            col_e, const_e, flip = e.left, e.right, False
        elif isinstance(e.left, E.Const):
            col_e, const_e, flip = e.right, e.left, True
        else:
            # column to column: sound on codes only as equality within
            # one dictionary
            if op not in ("=", "<>"):
                raise NotPorted("ordered TEXT column-to-column comparison")
            ldid = self._expr_dict_id(e.left, dids)
            rdid = self._expr_dict_id(e.right, dids)
            if ldid is None or ldid != rdid:
                raise NotPorted("TEXT equality across dictionaries")
            lf, rf = self._c(e.left, dids), self._c(e.right, dids)

            def run_cc(cols, params):
                ld, lv = lf(cols, params)
                rd, rv = rf(cols, params)
                d = (ld == rd) if op == "=" else (ld != rd)
                return (d, _and_valid(lv, rv))

            return run_cc
        did = self._expr_dict_id(col_e, dids)
        if did is None:
            raise NotPorted("comparison of computed TEXT")
        cf = self._c(col_e, dids)
        if const_e.value is None:
            def run_nullcmp(cols, params):
                d, _v = cf(cols, params)
                z = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
                return (z, z)

            return run_nullcmp
        if op in ("=", "<>"):
            pi = self._param(TextCodeParam(did, str(const_e.value)))

            def run_eq(cols, params):
                d, v = cf(cols, params)
                code = params[pi]
                return ((d == code) if op == "=" else (d != code), v)

            return run_eq
        if op not in ("<", "<=", ">", ">="):
            raise NotPorted(f"TEXT operator {op!r}")
        if flip:
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[op]
        pi = self._param(CodeMaskParam(did, cmp=(op, str(const_e.value))))

        def run_ord(cols, params):
            d, v = cf(cols, params)
            return (_mask_lookup(params[pi], d), v)

        return run_ord

    def _in_list(self, e: E.InListE, dids) -> CompiledExpr:
        cf = self._c(e.operand, dids)
        # three-valued: a NULL in the list makes every non-match NULL
        has_null = any(i.value is None for i in e.items)
        vals = tuple(i.value for i in e.items if i.value is not None)
        if e.operand.type.is_text:
            did = self._expr_dict_id(e.operand, dids)
            if did is None:
                raise NotPorted("TEXT IN over computed TEXT")
            pi = self._param(CodeMaskParam(did, values=tuple(
                str(v) for v in vals)))

            def member(d, params):
                return _mask_lookup(params[pi], d)
        elif vals:
            pi = self._param(ArrayConstParam(vals, e.operand.type))

            def member(d, params):
                return torch.isin(d, params[pi].to(d.dtype))
        else:
            def member(d, params):
                return torch.zeros(d.shape, dtype=torch.bool,
                                   device=d.device)

        def run_in(cols, params):
            d, v = cf(cols, params)
            match = member(d, params)
            out = ~match if e.negated else match
            if has_null:
                v = match if v is None else (v & match)
            return (out, v)

        return run_in

    def _cast(self, e: E.CastE, dids) -> CompiledExpr:
        cf = self._c(e.operand, dids)
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


def _mask_lookup(mask: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``mask[codes]`` with the codes clamped into the mask: a CUDA
    gather faults on an index out of range where jnp.take clamps, and a
    NULL slot's code (0) or a padded one must not fault."""
    return mask[codes.long().clamp(0, mask.shape[0] - 1)]


def resolve_param_host(spec, dictionary=None) -> np.ndarray:
    """The runtime value of a param spec as a numpy array (0-d for a
    scalar). ``dictionary``: dict_id -> Dictionary (a function), for the
    TEXT params."""
    if isinstance(spec, ScalarConstParam):
        return np.asarray(spec.value, dtype=spec.type.np_dtype).reshape(())
    if isinstance(spec, ArrayConstParam):
        vals = list(spec.values)
        vals += [vals[0]] * (bucket_size(len(vals), 1) - len(vals))
        return np.asarray(vals, dtype=spec.type.np_dtype)
    if isinstance(spec, TextCodeParam):
        code = dictionary(spec.dict_id).get_code(spec.value)
        return np.asarray(-1 if code is None else code, dtype=np.int32)
    if isinstance(spec, TextEncodeParam):
        code = dictionary(spec.dict_id).encode_one(spec.value)
        return np.asarray(code, dtype=np.int32)
    if isinstance(spec, CodeMaskParam):
        d = dictionary(spec.dict_id)
        vals = d.values
        mask = np.zeros(bucket_size(len(vals), 1), dtype=np.bool_)
        if spec.cmp:
            op, ref = spec.cmp
            cmpf = {
                "<": lambda s: s < ref,
                "<=": lambda s: s <= ref,
                ">": lambda s: s > ref,
                ">=": lambda s: s >= ref,
            }[op]
            for i, s in enumerate(vals):
                mask[i] = cmpf(s)
        else:
            for v in spec.values:
                code = d.get_code(v)
                if code is not None:
                    mask[code] = True
        return mask
    raise TypeError(f"unknown param spec {spec}")


def resolve_param(spec, device, dictionary=None) -> torch.Tensor:
    """The runtime value of a param spec as a tensor on ``device`` (a 0-d
    tensor of its type's dtype for a scalar literal)."""
    return torch.from_numpy(resolve_param_host(spec, dictionary)).to(
        device)

"""Compile typed expressions (plan/texpr.py) to functions over torch
columns (a port of the reference's opentenbase_tpu/ops/expr.py).

A column value is a pair ``(data, valid)``: ``data`` a tensor, ``valid`` a
bool tensor or ``None`` (statically all-valid). NULL semantics are SQL's
three-valued logic: comparisons and arithmetic are NULL if any operand
is; AND/OR are Kleene; division by zero is NULL.

Numeric and date literals are always lifted into runtime parameters
(the reference's ``lift_consts=True``): the compiler records a
``ScalarConstParam`` per distinct literal and the caller binds the values
with ``resolve_param`` on every run, so a compiled function serves every
query that differs only in its literals.

Types follow the reference on its device: FLOAT8 *computed* by an
expression (a cast, a quotient) is float32 (``_dev_dtype``), while a raw
FLOAT8 column stays float64; operands promote by dtype alone, as jnp
promotes them (a dimensioned float32 column meeting a 0-d float64 literal
becomes float64).

TEXT values are int32 codes into a host-side dictionary; the compiler
resolves TEXT constants against the dictionary of the column they meet
(``dict_ids[i]`` names input column i's), through params bound per run:
a ``TextCodeParam`` (the constant's code, -1 when the dictionary lacks
it, so equality matches nothing), a ``CodeMaskParam`` (a per-code
boolean mask computed on the host, for an ordered comparison, an IN list
or a LIKE pattern: codes follow insertion order, not collation) or a
``DictTranslateParam`` (codes of one dictionary mapped to another's).

A scalar subquery's value (``SubqueryParam``) binds as a (value,
valid) pair from the list of subplan results the executor passes to
``resolve_param``.

String functions stay off the device: a ``StrTransformParam`` is a
per-code table the host builds once over the base argument's dictionary
(upper, substr, lpad, length, to_date, ... composed innermost-first into
one chain), and the device gathers from it at each row's code; ``||`` of
two non-constant TEXT values is a ``PairConcatParam``, a 2-D table over
the two source dictionaries. Either table carries a validity table: a
value the host function refuses (an unparseable date) is NULL.

The subset: column references, lifted literals, NULL, the six
comparisons, AND/OR/NOT, unary minus, ``+ - * / // %`` (decimals in
scaled-int64 form), IS [NOT] NULL, CASE, casts between the numeric,
decimal, date and timestamp types, IN lists, LIKE/ILIKE, every scalar
function of the reference's compiler (numeric, date, Oracle shims, the
dictionary-transform text functions and ``concat_pair``); TEXT compared
with a constant, equality of two columns of one dictionary, and TEXT
values carried across dictionaries. Anything else raises NotPorted, as
the reference's compiler refuses it.
"""

from __future__ import annotations

import datetime as _dt
import os
import re
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
    to a power of two: ``patterns`` LIKE patterns (ORed; ``ilike``
    ignores case), ``values`` exact strings (an IN list), or ``cmp`` an
    ordered comparison (op, reference string) in Python's string order.
    Exactly one is set. A pattern is matched once per dictionary value
    on the host; the device only tests code membership."""

    dict_id: str
    patterns: tuple = ()
    values: tuple = ()
    ilike: bool = False
    cmp: tuple = ()


@dataclass(frozen=True)
class DictTranslateParam:
    """int32 table mapping codes of dictionary ``src`` to the codes of the
    same strings in ``dst`` (minted there where missing), padded to a
    power of two: aligns TEXT values of different dictionaries under one
    output column (a CASE mixing a column with literals)."""

    src: str
    dst: str


@dataclass(frozen=True)
class StrTransformParam:
    """Per-code table of a host string function chain over dictionary
    ``src``'s values, padded to a power of two, with a validity table (a
    value the chain refuses is NULL). A TEXT-valued chain (upper, substr,
    lpad, ...) encodes its results into dictionary ``dst``; a
    scalar-valued one (length, instr, to_date, ...) has ``dst`` None and
    its values in ``out_dtype``. ``steps`` ((fn, args), ...) applies
    innermost-first over the BASE dictionary, so upper(lower(x)) is one
    table over x's codes; ``fn``/``args`` name the outermost step."""

    src: str
    dst: object  # str | None
    fn: str
    args: tuple = ()
    out_dtype: str = "int32"
    steps: tuple = ()


@dataclass(frozen=True)
class PairConcatParam:
    """2-D int32 table for ``pre || a || mid || b || post`` over two
    non-constant TEXT values: entry [code_a, code_b] is the ``dst`` code
    of the joined string, both axes padded to powers of two, with a
    validity table. ``steps_a``/``steps_b`` are host chains applied to
    each axis first (upper(x) || y). Built on the host and cached on the
    ``dst`` dictionary by the source sizes (dictionaries only grow);
    refused past OTB_CONCAT_PAIR_MAX entries (default 2^20)."""

    src_a: str
    src_b: str
    dst: str
    segs: tuple = ("", "", "")  # (pre, mid, post)
    steps_a: tuple = ()
    steps_b: tuple = ()


@dataclass(frozen=True)
class SubqueryScalarParam:
    """The value of uncorrelated subplan ``index`` (an InitPlan's scalar),
    bound as a 0-d (value, valid) pair from the executor's value list."""

    index: int
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
                    pi = self._param(DictTranslateParam(src, want))

                    def run_xlate(cols, params):
                        d, v = cols[idx]
                        return (_lookup(params[pi], d), v)

                    return run_xlate
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
            return self._cast(e, dids, want)
        if isinstance(e, E.IsNullE):
            cf = self._c(e.operand, dids)

            def run_isnull(cols, params):
                d, v = cf(cols, params)
                if v is None:
                    out = torch.zeros(d.shape, dtype=torch.bool,
                                      device=d.device)
                else:
                    out = ~v
                return (~out if e.negated else out, None)

            return run_isnull
        if isinstance(e, E.CaseE):
            return self._case(e, dids, want)
        if isinstance(e, E.LikeE):
            return self._like(e, dids)
        if isinstance(e, E.FuncE):
            return self._func(e, dids, want)
        if isinstance(e, E.SubqueryParam):
            pi = self._param(SubqueryScalarParam(e.index, e.type))
            return lambda cols, params: params[pi]
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
        if op not in ("/", "//", "%"):
            raise NotPorted(f"operator {op!r}")
        res_t = e.type
        decimal = res_t.id == t.TypeId.DECIMAL
        factor = res_t.decimal_factor
        # PG truncates integer quotients toward zero; a float quotient
        # is a true division
        int_div = op == "//" or res_t.is_integer

        def run_div(cols, params):
            ld, lv = lf(cols, params)
            rd, rv = rf(cols, params)
            nz = rd != 0
            valid = _and_valid(lv, rv, nz)  # x / 0 is NULL
            safe = torch.where(nz, rd, torch.ones_like(rd))
            if decimal and op == "/":
                num, den = _promote(ld * factor, safe)
                return (_div_round(num, den), valid)
            if op == "%" or int_div:
                a, b = _promote(ld, safe)
                mag = a.abs() % b.abs() if op == "%" else (
                    a.abs() // b.abs())
                sign = a.sign() if op == "%" else a.sign() * b.sign()
                # the result takes the dividend's dtype (jnp's astype)
                return ((sign * mag).to(ld.dtype), valid)
            if not (ld.dtype.is_floating_point
                    or rd.dtype.is_floating_point):
                # jnp divides integers in float64 (torch would take its
                # default float32)
                ld, safe = ld.to(torch.float64), safe.to(torch.float64)
            return (torch.div(*_promote(ld, safe)), valid)
        return run_div

    # -- TEXT comparisons, on dictionary codes ---------------------------
    def _expr_dict_id(self, e: E.TExpr, dids) -> Optional[str]:
        if isinstance(e, E.Col):
            return dids[e.index] if e.index < len(dids) else None
        if isinstance(e, E.CastE):
            return self._expr_dict_id(e.operand, dids)
        if isinstance(e, E.CaseE):
            for _c, v in e.whens:
                d = self._expr_dict_id(v, dids)
                if d:
                    return d
            if e.default is not None:
                return self._expr_dict_id(e.default, dids)
        if isinstance(e, E.FuncE) and e.name == "coalesce":
            for a in e.args:
                d = self._expr_dict_id(a, dids)
                if d:
                    return d
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
            # computed TEXT (a CASE over literals): its codes are
            # canonicalised through the literal dictionary, compared there
            did = LITERAL_DICT
            cf = self._c(col_e, dids, LITERAL_DICT)
        else:
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
            return (_lookup(params[pi], d), v)

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
                return _lookup(params[pi], d)
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

    def _like(self, e: E.LikeE, dids) -> CompiledExpr:
        """LIKE/ILIKE on codes: the pattern is matched against every
        dictionary value on the host (``CodeMaskParam``), the device
        reads the mask at each row's code."""
        did = self._expr_dict_id(e.operand, dids)
        if did is None:
            raise NotPorted("LIKE over computed TEXT")
        cf = self._c(e.operand, dids)
        pi = self._param(CodeMaskParam(did, patterns=(e.pattern,),
                                       ilike=e.ilike))

        def run_like(cols, params):
            d, v = cf(cols, params)
            out = _lookup(params[pi], d)
            return (~out if e.negated else out, v)

        return run_like

    def _case(self, e: E.CaseE, dids, want=None) -> CompiledExpr:
        vwant = (want or LITERAL_DICT) if e.type.is_text else None
        whenfs = [
            (self._c(c, dids), self._c(v, dids, vwant)) for c, v in e.whens
        ]
        deff = (self._c(e.default, dids, vwant)
                if e.default is not None else None)
        dt = torch_dtype(e.type)

        def run_case(cols, params):
            if deff is not None:
                out, outv = deff(cols, params)
            else:
                out = torch.zeros((), dtype=dt, device=self.device)
                outv = torch.zeros((), dtype=torch.bool, device=self.device)
            # evaluated in reverse: an earlier WHEN overrides a later one
            for cf, vf in reversed(whenfs):
                cd, cv = cf(cols, params)
                hit = cd if cv is None else (cd & cv)
                vd, vv = vf(cols, params)
                out = torch.where(hit, *_promote(vd, out))
                if outv is not None or vv is not None:
                    o = torch.ones_like(hit) if outv is None else outv
                    nv = torch.ones_like(hit) if vv is None else vv
                    outv = torch.where(hit, nv, o)
            return (out, outv)

        return run_case

    def _func(self, e: E.FuncE, dids, want=None) -> CompiledExpr:
        name = e.name
        if name == "concat_pair":
            return self._concat_pair(e, dids, want)
        if name in _HOST_TEXT_FNS:
            # its argument's codes stay in the SOURCE dictionary
            return self._text_func(e, dids, want)
        if name not in _FUNCS:
            raise NotPorted(f"function {name}")
        # a TEXT-valued function passes its target dictionary on
        vwant = (want or LITERAL_DICT) if e.type.is_text else None
        argfs = [self._c(a, dids, vwant) for a in e.args]
        if name == "coalesce":
            def run_coalesce(cols, params):
                d, v = argfs[0](cols, params)
                for f in argfs[1:]:
                    if v is None:
                        return (d, None)
                    nd, nv = f(cols, params)
                    d = torch.where(v, *_promote(d, nd))
                    v = v | (torch.ones_like(v) if nv is None else nv)
                return (d, v)
            return run_coalesce
        if name == "nullif":
            def run_nullif(cols, params):
                ad, av = argfs[0](cols, params)
                bd, bv = argfs[1](cols, params)
                eq = torch.eq(*_promote(ad, bd))
                if bv is not None:
                    eq = eq & bv
                return (ad, ~eq if av is None else (av & ~eq))
            return run_nullif
        if name in _UNARY:
            fn = _UNARY[name]

            def run_unary(cols, params):
                d, v = argfs[0](cols, params)
                return (fn(d), v)
            return run_unary
        if name == "round":
            return self._round(e, argfs)
        if name in ("extract_year", "extract_month", "extract_day"):
            part = ("year", "month", "day").index(name.split("_")[1])
            is_ts = e.args[0].type.id == t.TypeId.TIMESTAMP

            def run_extract(cols, params):
                d, v = argfs[0](cols, params)
                days = (_floor_div(d, _US_DAY) if is_ts else d).to(
                    torch.int32)
                return (_civil_from_days(days)[part].to(torch.int32), v)
            return run_extract
        if name == "date_trunc_year":
            def run_trunc_year(cols, params):
                d, v = argfs[0](cols, params)
                y, _m, _d = _civil_from_days(d.to(torch.int32))
                one = torch.ones_like(y)
                return (_days_from_civil(y, one, one).to(torch.int32), v)
            return run_trunc_year
        if name in ("greatest", "least"):
            red = torch.maximum if name == "greatest" else torch.minimum

            def run_gl(cols, params):
                d, v = argfs[0](cols, params)
                for f in argfs[1:]:
                    nd, nv = f(cols, params)
                    d = red(*_promote(d, nd))
                    v = _and_valid(v, nv)
                return (d, v)
            return run_gl
        if name == "date_add_days":
            # date +/- an integer the analyzer left unfolded
            def run_dad(cols, params):
                d, v = argfs[0](cols, params)
                nd, nv = argfs[1](cols, params)
                return ((d + nd).to(torch.int32), _and_valid(v, nv))
            return run_dad
        if name == "power":
            def run_pow(cols, params):
                ad, av = argfs[0](cols, params)
                bd, bv = argfs[1](cols, params)
                return (torch.pow(*_promote(ad, bd)), _and_valid(av, bv))
            return run_pow
        if name == "trunc_num":
            digits = 0
            if len(e.args) > 1 and isinstance(e.args[1], E.Const):
                digits = int(e.args[1].value)
            factor = 10.0 ** digits

            def run_trunc(cols, params):
                d, v = argfs[0](cols, params)
                if digits == 0:
                    return (torch.trunc(d), v)
                return (torch.trunc(d * factor) / factor, v)
            return run_trunc
        if name == "bitand":
            def run_bitand(cols, params):
                ad, av = argfs[0](cols, params)
                bd, bv = argfs[1](cols, params)
                return (torch.bitwise_and(*_promote(ad, bd)),
                        _and_valid(av, bv))
            return run_bitand
        if name == "nanvl":
            def run_nanvl(cols, params):
                ad, av = argfs[0](cols, params)
                bd, bv = argfs[1](cols, params)
                nan = torch.isnan(ad)
                if bv is not None:
                    a_ok = torch.ones_like(nan) if av is None else av
                    av = torch.where(nan, bv, a_ok)
                return (torch.where(nan, *_promote(bd, ad)), av)
            return run_nanvl
        if name == "add_months":
            return self._add_months(e, argfs)
        if name == "months_between":
            def run_mb(cols, params):
                ad, av = argfs[0](cols, params)
                bd, bv = argfs[1](cols, params)
                y1, m1, d1 = _civil_from_days(ad.to(torch.int32))
                y2, m2, d2 = _civil_from_days(bd.to(torch.int32))
                y1, m1, d1, y2, m2, d2 = torch.broadcast_tensors(
                    y1, m1, d1, y2, m2, d2)
                # Oracle: a whole number when the days of the month are
                # equal or both are their months' last days
                whole = (d1 == d2) | ((d1 == _month_len(y1, m1))
                                      & (d2 == _month_len(y2, m2)))
                f64 = torch.float64  # jnp's int32 with a Python float
                frac = torch.where(whole, torch.zeros((), dtype=f64),
                                   (d1 - d2).to(f64) / 31.0)
                out = (y1 - y2).to(f64) * 12.0 + (m1 - m2).to(f64) + frac
                return (out.to(torch.float32), _and_valid(av, bv))
            return run_mb
        if name == "last_day":
            def run_last_day(cols, params):
                d, v = argfs[0](cols, params)
                y, m, _d = _civil_from_days(d.to(torch.int32))
                ny, nm = _next_month(y, m)
                out = _days_from_civil(ny, nm, torch.ones_like(nm)) - 1
                return (out.to(torch.int32), v)
            return run_last_day
        # trunc_date_day / _month / _year
        unit = name.rsplit("_", 1)[1]

        def run_trunc_date(cols, params):
            d, v = argfs[0](cols, params)
            days = d.to(torch.int32)
            if unit == "day":
                return (days, v)
            y, m, _d = _civil_from_days(days)
            one = torch.ones_like(m)
            out = _days_from_civil(y, m if unit == "month" else one, one)
            return (out.to(torch.int32), v)
        return run_trunc_date

    def _round(self, e: E.FuncE, argfs) -> CompiledExpr:
        """round(x[, digits]): a DECIMAL stays exact (half away from zero
        at the digit, over its scale); a float rounds half to even, with
        digits through a power of ten in its own dtype."""
        arg_t = e.args[0].type
        if arg_t.id == t.TypeId.DECIMAL:
            digits = 0
            if len(e.args) > 1 and isinstance(e.args[1], E.Const):
                digits = int(e.args[1].value)
            shift = 10 ** max(arg_t.scale - digits, 0)

            def run_round_dec(cols, params):
                d, v = argfs[0](cols, params)
                if shift == 1:
                    return (d, v)
                return (_div_round(d, shift) * shift, v)
            return run_round_dec

        def run_round(cols, params):
            d, v = argfs[0](cols, params)
            if len(argfs) > 1:
                nd, _nv = argfs[1](cols, params)
                # jnp's 10.0 ** digits is a weakly typed float: it takes
                # a float operand's own dtype
                dt = (d.dtype if d.dtype.is_floating_point
                      else torch.float64)
                f = torch.pow(torch.tensor(10.0, dtype=torch.float64,
                                           device=nd.device),
                              nd.to(torch.float64)).to(dt)
                return (torch.round(d.to(dt) * f) / f, v)
            return (torch.round(d), v)
        return run_round

    def _add_months(self, e: E.FuncE, argfs) -> CompiledExpr:
        """add_months: the day clamped to the target month's length
        (Oracle); a TIMESTAMP keeps its time of day."""
        is_ts = e.args[0].type.id == t.TypeId.TIMESTAMP

        def run_add_months(cols, params):
            d, v = argfs[0](cols, params)
            nd, nv = argfs[1](cols, params)
            days = (_floor_div(d, _US_DAY) if is_ts else d).to(torch.int32)
            y, m, dd = _civil_from_days(days)
            total = y * 12 + (m - 1) + nd.to(torch.int32)
            ny = _floor_div(total, 12)
            nm = total - ny * 12 + 1
            cd = torch.minimum(dd, _month_len(ny, nm))
            out = _days_from_civil(ny, nm, cd)
            if is_ts:
                rem = d - days.to(torch.int64) * _US_DAY
                out = out.to(torch.int64) * _US_DAY + rem
            else:
                out = out.to(torch.int32)
            return (out, _and_valid(v, nv))
        return run_add_months

    # -- || of two non-constant TEXT values --------------------------------
    def _concat_pair(self, e: E.FuncE, dids, want) -> CompiledExpr:
        """pre || a || mid || b || post: a gather from a 2-D table over
        the two source dictionaries (``PairConcatParam``); a host chain
        on a side (upper(x) || y) composes into the table over its BASE
        dictionary."""
        segs = tuple(a.value for a in e.args[2:]) or ("", "", "")
        fns, srcs, chains = [], [], []
        for a in e.args[:2]:
            base, steps = _host_chain(a)
            src = self._text_src_did(base, dids)
            if src is None:
                # a computed side that is no chain (a CASE): its codes
                # canonicalised through the literal dictionary
                src = LITERAL_DICT
                fns.append(self._c(a, dids, src))
                steps = ()
            else:
                fns.append(self._c(base, dids, None))
            srcs.append(src)
            chains.append(steps)
        pi = self._param(PairConcatParam(
            srcs[0], srcs[1], want or LITERAL_DICT, segs, chains[0],
            chains[1]))

        def run_pair(cols, params):
            a, av = fns[0](cols, params)
            b, bv = fns[1](cols, params)
            tbl, tvalid = params[pi]
            ia = a.long().clamp(0, tbl.shape[0] - 1)
            ib = b.long().clamp(0, tbl.shape[1] - 1)
            return (tbl[ia, ib], _and_valid(av, bv, tvalid[ia, ib]))

        return run_pair

    # -- host-evaluated text functions (dictionary transforms) ---------------
    def _text_func(self, e: E.FuncE, dids, want) -> CompiledExpr:
        """A host function chain as a per-code table over the base
        argument's dictionary (``StrTransformParam``), read on the device
        at each row's code."""
        textual = e.type.is_text
        base, steps = _host_chain(e)
        if not steps:
            raise NotPorted(
                f"{e.name}: non-constant arguments beyond the first")
        src = self._text_src_did(base, dids)
        if src is None:
            src = want or LITERAL_DICT
            argf = self._c(base, dids, src)
        else:
            argf = self._c(base, dids, None)
        dst = (want or LITERAL_DICT) if textual else None
        out_dtype = "int32"
        if not textual:
            out_dtype = {t.TypeId.TIMESTAMP: "int64",
                         t.TypeId.FLOAT8: "float64"}.get(e.type.id, "int32")
        pi = self._param(StrTransformParam(
            src, dst, e.name, steps[-1][1], out_dtype, steps))

        def run_text(cols, params):
            d, v = argf(cols, params)
            tbl, tvalid = params[pi]
            idx = d.long().clamp(0, tbl.shape[0] - 1)
            return (tbl[idx], _and_valid(v, tvalid[idx]))

        return run_text

    @staticmethod
    def _text_src_did(a: E.TExpr, dids):
        """The dictionary a chain's base reads its codes in: a column's
        own, the literal dictionary for a constant; None for anything
        computed."""
        if isinstance(a, E.Col):
            did = dids[a.index] if a.index < len(dids) else None
            return did or LITERAL_DICT
        if isinstance(a, E.Const):
            return LITERAL_DICT
        return None

    def _cast(self, e: E.CastE, dids, want=None) -> CompiledExpr:
        src, dst = e.operand.type, e.type
        if src.is_text or dst.is_text:
            if src.id != dst.id:
                raise NotPorted(f"cast {src.id.value} -> {dst.id.value}")
            return self._c(e.operand, dids, want)
        cf = self._c(e.operand, dids)

        def run_cast(cols, params):
            d, v = cf(cols, params)
            return (_cast_data(d, src, dst), v)

        return run_cast


_UNARY = {
    "abs": torch.abs,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "ceiling": torch.ceil,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "ln": torch.log,
    # jnp's sign keeps a NaN, torch's gives 0
    "sign": lambda d: torch.where(torch.isnan(d), d, torch.sign(d))
    if d.dtype.is_floating_point else torch.sign(d),
}
# the reference's ``_func`` (ops/expr.py), beside the text functions of
# _HOST_TEXT_FNS and concat_pair: every other name is refused there too
_FUNCS = frozenset((
    "coalesce", "nullif", *_UNARY, "round", "extract_year",
    "extract_month", "extract_day", "date_trunc_year", "greatest", "least",
    "date_add_days", "power", "trunc_num", "bitand", "nanvl", "add_months",
    "months_between", "last_day", "trunc_date_day", "trunc_date_month",
    "trunc_date_year",
))
_US_DAY = 86_400_000_000


def _floor_div(a, b):
    """Integer division rounding toward minus infinity (jnp's ``//``)."""
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z):
    """(year, month, day) of int32 day numbers since 1970-01-01 (Howard
    Hinnant's civil_from_days, as the reference vectorizes it): the
    proleptic Gregorian calendar, before 1970 and past 2100 alike."""
    z = z.to(torch.int32) + 719468
    era = _floor_div(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floor_div(doe - _floor_div(doe, 1460) + _floor_div(doe, 36524)
                     - _floor_div(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floor_div(yoe, 4) - _floor_div(yoe, 100))
    mp = _floor_div(5 * doy + 2, 153)
    d = doy - _floor_div(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    """Day numbers since 1970-01-01 of (year, month, day) tensors, the
    inverse of ``_civil_from_days``."""
    y = y - (m <= 2).to(y.dtype)
    era = _floor_div(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _floor_div(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floor_div(yoe, 4) - _floor_div(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _next_month(y, m):
    return (torch.where(m == 12, y + 1, y), torch.where(m == 12, 1, m + 1))


def _month_len(y, m):
    ny, nm = _next_month(y, m)
    one = torch.ones_like(m)
    return _days_from_civil(ny, nm, one) - _days_from_civil(y, m, one)


def _dev_dtype(ty: t.SqlType) -> torch.dtype:
    """The dtype a value of ``ty`` is computed in on the device: FLOAT8
    computes as float32, as the reference's device does (its types.py
    rationale; ``_dev_dtype`` there), so both packages round alike."""
    if ty.id == t.TypeId.FLOAT8:
        return torch.float32
    return torch_dtype(ty)


def _div_round(num, den):
    """Integer division rounding half away from zero (PG numeric)."""
    half = den // 2
    return (num + torch.where(num >= 0, half, -half)) // den


def _cast_data(d: torch.Tensor, src: t.SqlType, dst: t.SqlType):
    """The reference's ``_cast_data`` on torch (FLOAT8 results in
    float32, ``_dev_dtype``)."""
    T = t.TypeId
    if src.id == dst.id and src.scale == dst.scale:
        return d
    if dst.id == T.DECIMAL:
        if src.id == T.DECIMAL:
            if dst.scale >= src.scale:
                return d * (10 ** (dst.scale - src.scale))
            return _div_round(d, 10 ** (src.scale - dst.scale))
        if src.is_integer or src.id == T.BOOL:
            return d.to(torch.int64) * dst.decimal_factor
        # float -> decimal (round half to even, as jnp.round)
        return torch.round(d.to(torch.float64) * dst.decimal_factor).to(
            torch.int64)
    if src.id == T.DECIMAL:
        if dst.is_integer:
            return _div_round(d, src.decimal_factor).to(torch_dtype(dst))
        # divided in float64 (jnp's int64 / int), then rounded once more
        return (d.to(torch.float64) / src.decimal_factor).to(
            _dev_dtype(dst))
    if src.id == T.DATE and dst.id == T.TIMESTAMP:
        return d.to(torch.int64) * _US_DAY
    if src.id == T.TIMESTAMP and dst.id == T.DATE:
        return torch.div(d, _US_DAY, rounding_mode="floor").to(torch.int32)
    if dst.is_integer and src.id in (T.FLOAT4, T.FLOAT8):
        return torch.trunc(d).to(torch_dtype(dst))
    return d.to(_dev_dtype(dst))


def _like_to_regex(pattern: str) -> str:
    """A LIKE pattern as an anchored regular expression (``%`` any run,
    ``_`` one character, a backslash escapes the next one)."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def _lookup(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``table[codes]`` (a code mask or a translation table) with the
    codes clamped into it: a CUDA gather faults on an index out of range
    where jnp.take clamps, and a NULL slot's code (0) or a padded one
    must not fault."""
    return table[codes.long().clamp(0, table.shape[0] - 1)]


def _py_pad(s: str, n, fill=" ", left=True):
    n = int(n)
    if n <= 0:
        return None  # Oracle: NULL for a target length below one
    fill = str(fill) or " "
    if len(s) >= n:
        return s[:n]
    pad = (fill * ((n - len(s)) // len(fill) + 1))[: n - len(s)]
    return pad + s if left else s + pad


def _py_substr(s: str, start, length=None) -> str:
    start = int(start)
    if start > 0:
        i = start - 1
    elif start == 0:
        i = 0
    else:
        i = max(len(s) + start, 0)
    if length is None:
        return s[i:]
    return s[i: i + max(int(length), 0)]


def _py_instr(s: str, sub, start=1) -> int:
    sub, start = str(sub), int(start)
    if start < 0:
        # Oracle: a negative position searches backward; the match must
        # start at or before len(s) + start
        return s.rfind(sub, 0, len(s) + start + 1) + 1
    return s.find(sub, max(start - 1, 0)) + 1


def _py_to_date(s: str) -> int:
    d = _dt.date.fromisoformat(s.strip()[:10])
    return (d - _dt.date(1970, 1, 1)).days


def _py_to_timestamp(s: str) -> int:
    ts = _dt.datetime.fromisoformat(s.strip())
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=_dt.timezone.utc)
    epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
    return int((ts - epoch).total_seconds() * 1_000_000)


# The dictionary-transform functions, on the host: each takes the string
# and its constant extra arguments and gives the new value (None: NULL).
_HOST_TEXT_FNS = {
    "upper": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "initcap": lambda s: s.title(),
    "reverse": lambda s: s[::-1],
    "trim": lambda s, ch=None: s.strip(ch),
    "ltrim": lambda s, ch=None: s.lstrip(ch),
    "rtrim": lambda s, ch=None: s.rstrip(ch),
    "replace": lambda s, a, b: s.replace(str(a), str(b)),
    "substr": _py_substr,
    "substring": _py_substr,
    "lpad": lambda s, n, fill=" ": _py_pad(s, n, fill, left=True),
    "rpad": lambda s, n, fill=" ": _py_pad(s, n, fill, left=False),
    "length": len,
    "char_length": len,
    "instr": _py_instr,
    # the constant segments of x || 'c' (the analyzer stringifies them)
    "concat_seg": lambda s, pre, post: pre + s + post,
    "to_number": lambda s: float(s),
    "to_date": _py_to_date,
    "to_timestamp": _py_to_timestamp,
}


def _host_chain(e):
    """(base expression, steps): the nested host text functions with
    constant extra arguments peeled off ``e``, ``steps`` ((fn, extras),
    ...) innermost first. Inner links are TEXT-valued (each feeds the
    next one's string); the outermost may be scalar (length, to_date).
    A bare column or constant gives (e, ())."""
    steps = []
    cur = e
    while (
        isinstance(cur, E.FuncE)
        and cur.name in _HOST_TEXT_FNS
        and cur.args
        and all(isinstance(a, E.Const) for a in cur.args[1:])
        and (cur is e or cur.type.is_text)
    ):
        steps.append((cur.name, tuple(a.value for a in cur.args[1:])))
        cur = cur.args[0]
    steps.reverse()
    return cur, tuple(steps)


def _run_chain(value, steps):
    """A string threaded through a host chain (None once a step gives
    NULL)."""
    for fname, fargs in steps:
        value = _HOST_TEXT_FNS[fname](value, *fargs)
        if value is None:
            return None
    return value


def _chain_values(values, steps) -> list:
    """Each value through the chain, with try_cast semantics: the table
    covers every dictionary entry, rows a WHERE clause drops and the
    NULL placeholder '' too, so a value the chain refuses is NULL rather
    than an error."""
    out = []
    for v in values:
        try:
            out.append(_run_chain(v, steps))
        except (ValueError, TypeError, OverflowError):
            out.append(None)
    return out


def _str_transform_table(spec: StrTransformParam, dictionary):
    """The (table, validity) pair of ``spec``, cached on the source
    dictionary by its size: dictionaries only grow, so the table over
    the same values is the same (its TEXT results already hold their
    codes in ``dst``, the dictionary object the entry names)."""
    src = dictionary(spec.src)
    dst = dictionary(spec.dst) if spec.dst is not None else None
    cache = getattr(src, "_pair_cache", None)
    if cache is None:
        cache = {}
        try:
            src._pair_cache = cache
        except AttributeError:
            cache = None
    ckey = (spec, len(src.values))
    hit = cache.get(ckey) if cache is not None else None
    if hit is not None and hit[0] is dst:
        return hit[1]
    out = _build_str_transform(spec, src, dst)
    if cache is not None:
        if len(cache) > 32:
            cache.clear()
        cache[ckey] = (dst, out)
    return out


def _build_str_transform(spec: StrTransformParam, src, dst):
    outs = _chain_values(src.values, spec.steps or ((spec.fn, spec.args),))
    n = bucket_size(len(outs), 1)
    valid = np.zeros(n, dtype=np.bool_)
    valid[: len(outs)] = [o is not None for o in outs]
    if dst is not None:  # TEXT results: codes in dst
        table = np.zeros(n, dtype=np.int32)
        if outs:
            table[: len(outs)] = dst.encode(
                ["" if o is None else str(o) for o in outs])
    else:
        table = np.zeros(n, dtype=np.dtype(spec.out_dtype))
        for i, o in enumerate(outs):
            if o is not None:
                table[i] = o
    return table, valid


def _pair_concat_table(spec: PairConcatParam, dictionary):
    da, db = dictionary(spec.src_a), dictionary(spec.src_b)
    dst = dictionary(spec.dst)
    na, nb = len(da.values), len(db.values)
    if na == 0 or nb == 0:
        return (np.zeros((1, 1), dtype=np.int32),
                np.zeros((1, 1), dtype=np.bool_))
    # append-only dictionaries make the table a function of (spec, na,
    # nb): cached on the dst dictionary
    cache = getattr(dst, "_pair_cache", None)
    if cache is None:
        cache = {}
        try:
            dst._pair_cache = cache
        except AttributeError:
            cache = None
    ckey = (spec, na, nb)
    if cache is not None and ckey in cache:
        return cache[ckey]
    cap = int(os.environ.get("OTB_CONCAT_PAIR_MAX", str(1 << 20)))
    if na * nb > cap:
        raise RuntimeError(
            f"|| of two columns needs a {na}x{nb} pairwise table, over "
            f"OTB_CONCAT_PAIR_MAX={cap}")
    pre, mid, post = spec.segs
    ta = _chain_values(da.values, spec.steps_a)
    tb = _chain_values(db.values, spec.steps_b)
    table = np.zeros((bucket_size(na, 1), bucket_size(nb, 1)),
                     dtype=np.int32)
    valid = np.zeros(table.shape, dtype=np.bool_)
    joined, slots = [], []
    for i, a in enumerate(ta):
        if a is None:
            continue
        for j, b in enumerate(tb):
            if b is not None:
                joined.append(pre + a + mid + b + post)
                slots.append((i, j))
    if joined:
        ii, jj = np.asarray(slots, dtype=np.int64).T
        table[ii, jj] = dst.encode(joined)
        valid[ii, jj] = True
    out = (table, valid)
    if cache is not None:
        if len(cache) > 32:
            cache.clear()
        cache[ckey] = out
    return out


def resolve_param_host(spec, dictionary=None):
    """The runtime value of a param spec as a numpy array (0-d for a
    scalar; a (table, validity) pair for a text transform or a pairwise
    concatenation). ``dictionary``: dict_id -> Dictionary (a function),
    for the TEXT params."""
    if isinstance(spec, StrTransformParam):
        return _str_transform_table(spec, dictionary)
    if isinstance(spec, PairConcatParam):
        return _pair_concat_table(spec, dictionary)
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
    if isinstance(spec, DictTranslateParam):
        vals = list(dictionary(spec.src).values)
        table = np.zeros(bucket_size(len(vals), 1), dtype=np.int32)
        if vals:
            table[: len(vals)] = dictionary(spec.dst).encode(vals)
        return table
    if isinstance(spec, CodeMaskParam):
        d = dictionary(spec.dict_id)
        vals = d.values
        mask = np.zeros(bucket_size(len(vals), 1), dtype=np.bool_)
        if spec.patterns:
            flags = re.IGNORECASE if spec.ilike else 0
            for p in spec.patterns:
                rx = re.compile(_like_to_regex(p), flags)
                for i, s in enumerate(vals):
                    if rx.match(s):
                        mask[i] = True
        elif spec.cmp:
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


def resolve_param(spec, device, dictionary=None, subquery_values=None):
    """The runtime value of a param spec as a tensor on ``device`` (a 0-d
    tensor of its type's dtype for a scalar literal); a subquery's value
    as a 0-d (value, valid) pair from ``subquery_values`` (a list of
    (python value or None, SqlType))."""
    if isinstance(spec, SubqueryScalarParam):
        assert subquery_values is not None, "subquery params not bound"
        value, ty = subquery_values[spec.index]
        data = np.asarray(0 if value is None else value,
                          dtype=ty.np_dtype).reshape(())
        return (torch.from_numpy(data).to(device),
                torch.tensor(value is not None, device=device))
    host = resolve_param_host(spec, dictionary)
    if isinstance(host, tuple):
        return tuple(torch.from_numpy(a).to(device) for a in host)
    return torch.from_numpy(host).to(device)

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

The subset: column references, lifted literals, NULL, the six
comparisons, AND/OR/NOT, unary minus, ``+ - * / // %`` (decimals in
scaled-int64 form), IS [NOT] NULL, CASE, casts between the numeric,
decimal, date and timestamp types, IN lists, LIKE/ILIKE, coalesce,
nullif and date_add_days; TEXT compared
with a constant, equality of two columns of one dictionary, and TEXT
values carried across dictionaries. Anything else raises NotPorted.
"""

from __future__ import annotations

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
        # date_add_days: date +/- an integer the analyzer left unfolded
        def run_dad(cols, params):
            d, v = argfs[0](cols, params)
            nd, nv = argfs[1](cols, params)
            return ((d + nd).to(torch.int32), _and_valid(v, nv))
        return run_dad

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


_FUNCS = frozenset(("coalesce", "nullif", "date_add_days"))
_US_DAY = 86_400_000_000


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


def resolve_param(spec, device, dictionary=None) -> torch.Tensor:
    """The runtime value of a param spec as a tensor on ``device`` (a 0-d
    tensor of its type's dtype for a scalar literal)."""
    return torch.from_numpy(resolve_param_host(spec, dictionary)).to(
        device)

"""The port's expression compiler and scalar reduce against the
reference's, on the same seeded columns with NULLs: three-valued
AND/OR/NOT, the six comparisons against lifted literals, decimal
arithmetic, integer casts, IN lists; division and modulo (by zero:
NULL), IS NULL, CASE, coalesce/nullif and date arithmetic, casts to
and from FLOAT8 (float32 where computed, as jnp's, float64 for a raw
column); LIKE/ILIKE; TEXT on dictionary codes (equality,
inequality, ordered comparison and BETWEEN against a constant, a
literal the dictionary lacks, IN and OR of equalities, equality of two
columns of one dictionary, a value-producing literal); sum/count/min/max
over masked rows. The same expression tree is built twice, once from
each package's texpr module, and the results compare exactly (integer
and boolean work)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from opentenbase_tpu import types as rt
from opentenbase_tpu.ops import agg as ref_agg
from opentenbase_tpu.ops import expr as ref_expr
from opentenbase_tpu.plan import texpr as RE
from opentenbase_tpu.storage.column import Dictionary as RefDictionary
from opentenbase_tpu_torch import NotPorted
from opentenbase_tpu_torch import types as pt
from opentenbase_tpu_torch.ops import agg as port_agg
from opentenbase_tpu_torch.ops import expr as port_expr
from opentenbase_tpu_torch.plan import texpr as PE
from opentenbase_tpu_torch.storage.column import Dictionary

N = 4000


def _columns(seed=21):
    """(data, valid) per column: int4, int8, bool, decimal(12,2),
    decimal(4,2), date, float8; every column has NULLs."""
    rng = np.random.default_rng(seed)
    cols = [
        rng.integers(-50, 50, N).astype(np.int32),
        rng.integers(-(10**9), 10**9, N).astype(np.int64),
        rng.random(N) > 0.5,
        rng.integers(-(10**7), 10**7, N).astype(np.int64),
        rng.integers(0, 11, N).astype(np.int64),
        (8036 + rng.integers(0, 2556, N)).astype(np.int32),
    ]
    valids = [rng.random(N) > 0.15 for _ in cols]
    # the raw FLOAT8 column (float64 in both packages), drawn after the
    # others so their values stay what they were
    cols.append(rng.normal(0.0, 1e4, N))
    valids.append(rng.random(N) > 0.15)
    return cols, valids


def _types(T):
    return [T.INT4, T.INT8, T.BOOL, T.SqlType(T.TypeId.DECIMAL, 12, 2),
            T.SqlType(T.TypeId.DECIMAL, 4, 2), T.DATE, T.FLOAT8]


def _exprs(E, T):
    """name -> expression tree built from the texpr module ``E``."""
    ty = _types(T)
    B = T.BOOL

    def C(i):
        return E.Col(i, ty[i])

    def K(v, t_):
        return E.Const(v, t_)

    def cmp(op, a, b):
        return E.BinE(op, a, b, B)

    dec14 = T.SqlType(T.TypeId.DECIMAL, 16, 4)
    dec_a = cmp("<", C(0), K(10, T.INT4))
    dec_b = cmp(">=", C(1), K(0, T.INT8))
    out = {
        "and": E.BinE("and", dec_a, dec_b, B),
        "or": E.BinE("or", dec_a, C(2), B),
        "not": E.UnaryE("not", E.BinE("and", C(2), dec_b, B), B),
        "nested": E.BinE(
            "or", E.UnaryE("not", dec_a, B),
            E.BinE("and", C(2), cmp("=", C(4), K(5, ty[4])), B), B,
        ),
        "and_null_literal": E.BinE("and", dec_a, K(None, B), B),
        "or_null_literal": E.BinE("or", K(None, B), dec_b, B),
        "dec_times": E.BinE("*", C(3), C(4), dec14),
        "dec_plus": E.BinE("+", C(3), K(12345, ty[3]), ty[3]),
        "int_minus": E.BinE(
            "-", E.CastE(C(0), T.INT8), C(1), T.INT8
        ),
        "neg": E.UnaryE("-", C(1), T.INT8),
        "cast_int_dec": E.CastE(C(0), T.SqlType(T.TypeId.DECIMAL, 10, 2)),
        "cast_dec_up": E.CastE(C(4), T.SqlType(T.TypeId.DECIMAL, 8, 4)),
        "cast_bool_int": E.CastE(C(2), T.INT4),
        "int32_vs_wide_literal": cmp("<", C(0), K(5_000_000_000, T.INT8)),
        "date_range": E.BinE(
            "and", cmp(">=", C(5), K(8766, T.DATE)),
            cmp("<", C(5), K(9131, T.DATE)), B,
        ),
    }
    for op in ("=", "<>", "<", "<=", ">", ">="):
        out[f"cmp{op}"] = cmp(op, C(4), K(5, ty[4]))
    # division and modulo (column 0 holds zeros: x / 0 is NULL), in the
    # forms the analyzer writes: // for integers, FLOAT8 operands for a
    # decimal quotient, % at one decimal scale
    F8 = T.FLOAT8
    dec2 = T.SqlType(T.TypeId.DECIMAL, 38, 2)
    i8 = E.CastE(C(0), T.INT8)
    out.update({
        "div_int": E.BinE("//", C(1), i8, T.INT8),
        "div_int_neg": E.BinE("//", E.UnaryE("-", C(1), T.INT8), i8, T.INT8),
        "mod_int": E.BinE("%", C(1), i8, T.INT8),
        "mod_dec": E.BinE("%", E.CastE(C(3), dec2), E.CastE(C(4), dec2),
                          dec2),
        "div_float8": E.BinE("/", E.CastE(C(1), F8), E.CastE(C(0), F8), F8),
        "div_dec_float8": E.BinE("/", E.CastE(C(3), F8), E.CastE(C(4), F8),
                                 F8),
        "mod_float8": E.BinE("%", C(6), E.CastE(C(4), F8), F8),
        "is_null": E.IsNullE(C(0), False),
        "is_not_null": E.IsNullE(C(6), True),
        "is_null_of_sum": E.IsNullE(E.BinE("+", C(3), C(3), ty[3]), False),
        "case": E.CaseE(
            ((cmp("<", C(0), K(0, T.INT4)), C(1)),
             (C(2), E.CastE(C(0), T.INT8))), K(-1, T.INT8), T.INT8),
        "case_no_else": E.CaseE(
            ((cmp(">", C(4), K(5, ty[4])), C(3)),), None, ty[3]),
        "case_float8": E.CaseE(
            ((C(2), E.CastE(C(1), F8)),), C(6), F8),
        # casts to and from FLOAT8: float32 when computed, float64 raw
        "cast_int4_float8": E.CastE(C(0), F8),
        "cast_int8_float8": E.CastE(C(1), F8),
        "cast_dec_float8": E.CastE(C(3), F8),
        "cast_float8_int8": E.CastE(C(6), T.INT8),
        "cast_float8_dec": E.CastE(C(6), T.SqlType(T.TypeId.DECIMAL, 18, 2)),
        "cast_computed_float8_int4": E.CastE(E.CastE(C(3), F8), T.INT4),
        "cast_dec_down": E.CastE(C(3), T.SqlType(T.TypeId.DECIMAL, 12, 0)),
        "cast_dec_int8": E.CastE(C(3), T.INT8),
        "float8_times_literal": E.BinE("*", C(6), K(2.5, F8), F8),
        "float32_plus_float8": E.BinE("+", E.CastE(C(1), F8), C(6), F8),
        "float32_vs_literal": cmp("<", E.CastE(C(3), F8), K(0.5, F8)),
        "coalesce": E.FuncE("coalesce", (C(1), E.CastE(C(0), T.INT8),
                                         K(3, T.INT8)), T.INT8),
        "nullif": E.FuncE("nullif", (C(4), K(5, ty[4])), ty[4]),
        "date_add_days": E.FuncE("date_add_days",
                                 (C(5), K(-90, T.INT4)), T.DATE),
    })
    return out


NAMES = sorted(_exprs(PE, pt))


def _ref_eval(e, cols, valids):
    comp = ref_expr.ExprCompiler(lift_consts=True)
    fn = comp.compile(e, [None] * len(cols))
    params = tuple(ref_expr.resolve_param(s, {}, None) for s in comp.params)
    env = [(jnp.asarray(d), jnp.asarray(v)) for d, v in zip(cols, valids)]
    d, v = fn(env, params)
    d = np.broadcast_to(np.asarray(d), (N,))
    v = np.ones(N, bool) if v is None else np.broadcast_to(np.asarray(v), (N,))
    return d, v


def _port_eval(e, cols, valids):
    comp = port_expr.ExprCompiler("cpu")
    fn = comp.compile(e)
    params = tuple(port_expr.resolve_param(s, "cpu") for s in comp.params)
    env = [(torch.from_numpy(d.copy()), torch.from_numpy(v.copy()))
           for d, v in zip(cols, valids)]
    d, v = fn(env, params)
    d = d.expand(N).numpy()
    v = np.ones(N, bool) if v is None else v.expand(N).numpy()
    return d, v


@pytest.mark.parametrize("name", NAMES)
def test_expr_matches_reference(name):
    cols, valids = _columns()
    want_d, want_v = _ref_eval(_exprs(RE, rt)[name], cols, valids)
    got_d, got_v = _port_eval(_exprs(PE, pt)[name], cols, valids)
    assert np.array_equal(got_v, want_v)
    # data only matters where the value is valid
    assert np.array_equal(got_d[want_v], want_d[want_v])
    assert got_d.dtype == want_d.dtype


# a dictionary whose insertion order is not string order; 'MFGR#222' and
# 'MFGR#223' fall outside BETWEEN 'MFGR#2221' AND 'MFGR#2228' by string
# order though their brand numbers are inside
WORDS = ["MFGR#2228", "MFGR#121", "MFGR#2221", "b", "a", "MFGR#2229",
         "MFGR#22", "MFGR#222", "MFGR#223", "MFGR#2224", "aa", ""]


def _text_exprs(E, T):
    """name -> expression over two TEXT columns of dictionary 'x.c' (a
    third column, int4, for IN lists)."""
    B = T.BOOL
    c, c2 = E.Col(0, T.TEXT), E.Col(1, T.TEXT)

    def K(v):
        return E.Const(v, T.TEXT)

    def cmp(op, a, b):
        return E.BinE(op, a, b, B)

    out = {
        "eq": cmp("=", c, K("MFGR#2221")),
        "ne": cmp("<>", c, K("a")),
        "absent_eq": cmp("=", c, K("zzz")),
        "absent_ne": cmp("<>", c, K("zzz")),
        "between": E.BinE("and", cmp(">=", c, K("MFGR#2221")),
                          cmp("<=", c, K("MFGR#2228")), B),
        "const_left": cmp(">", K("b"), c),
        "or_of_eq": E.BinE("or", cmp("=", c, K("a")), cmp("=", c, K("b")),
                           B),
        "in": E.InListE(c, (K("a"), K("MFGR#22"), K("nope")), False),
        "not_in_with_null": E.InListE(c, (K("a"), K(None)), True),
        "col_eq_col": cmp("=", c, c2),
        "col_ne_col": cmp("<>", c, c2),
        "eq_null": cmp("=", c, K(None)),
        "int_in": E.InListE(E.Col(2, T.INT4),
                            (E.Const(3, T.INT4), E.Const(-7, T.INT4)), False),
    }
    for op in ("<", "<=", ">", ">="):
        out[f"ord{op}"] = cmp(op, c, K("MFGR#222"))
    # LIKE/ILIKE: matched against the dictionary on the host, a code
    # mask on the device
    out.update({
        "like_prefix": E.LikeE(c, "MFGR#22%", False, False),
        "like_underscore": E.LikeE(c, "MFGR#_2_", False, False),
        "like_one_char": E.LikeE(c, "_", False, False),
        "not_like": E.LikeE(c, "%2%", False, True),
        "ilike": E.LikeE(c, "A%", True, False),
        "not_ilike": E.LikeE(c, "mfgr#2%", True, True),
        "like_escaped": E.LikeE(c, "MFGR\\#22", False, False),
        "like_all": E.LikeE(c, "%", False, False),
    })
    return out


TEXT_NAMES = sorted(_text_exprs(PE, pt))


def _text_columns(seed=8):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, len(WORDS), N).astype(np.int32),
            rng.integers(0, len(WORDS), N).astype(np.int32),
            rng.integers(-9, 9, N).astype(np.int32)]
    valids = [rng.random(N) > 0.1 for _ in cols]
    return cols, valids


@pytest.mark.parametrize("name", TEXT_NAMES)
def test_text_expr_matches_reference(name):
    cols, valids = _text_columns()
    dids = ["x.c", "x.c", None]
    rcomp = ref_expr.ExprCompiler(lift_consts=True)
    rfn = rcomp.compile(_text_exprs(RE, rt)[name], dids)
    rparams = tuple(ref_expr.resolve_param(s, {"x.c": RefDictionary(WORDS)},
                                           None) for s in rcomp.params)
    wd, wv = rfn([(jnp.asarray(d), jnp.asarray(v))
                  for d, v in zip(cols, valids)], rparams)
    pcomp = port_expr.ExprCompiler("cpu")
    pfn = pcomp.compile(_text_exprs(PE, pt)[name], dids)
    pparams = tuple(port_expr.resolve_param(s, "cpu", {"x.c": Dictionary(
        WORDS)}.__getitem__) for s in pcomp.params)
    gd, gv = pfn([(torch.from_numpy(d.copy()), torch.from_numpy(v.copy()))
                  for d, v in zip(cols, valids)], pparams)
    wv = np.ones(N, bool) if wv is None else np.broadcast_to(
        np.asarray(wv), (N,))
    gv = np.ones(N, bool) if gv is None else gv.expand(N).numpy()
    wd = np.broadcast_to(np.asarray(wd), (N,))
    gd = gd.expand(N).numpy()
    assert np.array_equal(gv, wv)
    assert np.array_equal(gd[wv], wd[wv])
    if name.startswith("absent_eq"):
        assert not gd[wv].any()
    if name == "between":  # string order, not the brand number
        hit = {WORDS[i] for i in cols[0][wv & gd]}
        assert hit == {"MFGR#2221", "MFGR#2224", "MFGR#2228"}


def test_text_literal_encodes_into_target_dictionary():
    """A value-producing TEXT literal takes its code in the dictionary
    the output names, minted there when missing, in both packages."""
    rd, pd = RefDictionary(WORDS), Dictionary(WORDS)
    rcomp = ref_expr.ExprCompiler(lift_consts=True)
    rfn = rcomp.compile(RE.Const("new", rt.TEXT), [], "x.c")
    pcomp = port_expr.ExprCompiler("cpu")
    pfn = pcomp.compile(PE.Const("new", pt.TEXT), [], "x.c")
    (rs,), (ps,) = rcomp.params, pcomp.params
    want = rfn([], (ref_expr.resolve_param(rs, {"x.c": rd}, None),))[0]
    got = pfn([], (port_expr.resolve_param(ps, "cpu", {"x.c": pd}.get),))[0]
    assert int(got) == int(want) == len(WORDS)
    assert pd.values == rd.values


def test_outside_the_subset_raises_not_ported():
    ty = _types(pt)
    comp = port_expr.ExprCompiler("cpu")
    with pytest.raises(NotPorted):  # a host string function
        comp.compile(PE.FuncE("upper", (PE.Col(0, pt.TEXT),), pt.TEXT),
                     ["x.c"])
    with pytest.raises(NotPorted):  # a scalar subquery's value
        comp.compile(PE.SubqueryParam(0, ty[1]))
    with pytest.raises(NotPorted):  # TEXT cast to a number
        comp.compile(PE.CastE(PE.Col(0, pt.TEXT), ty[1]), ["x.c"])


SPECS = ("sum", "count", "count_star", "min", "max")


@pytest.mark.parametrize("col", [0, 1, 3])
@pytest.mark.parametrize("mask_kind", ["some", "none"])
def test_scalar_reduce_matches_reference(col, mask_kind):
    cols, valids = _columns(33)
    rng = np.random.default_rng(34)
    mask = rng.random(N) > 0.4 if mask_kind == "some" else np.zeros(N, bool)
    d, v = cols[col], valids[col]
    want = ref_agg._scalar_reduce_impl(
        [None if s == "count_star" else (jnp.asarray(d), jnp.asarray(v))
         for s in SPECS],
        jnp.asarray(mask), SPECS,
    )
    got = port_agg.scalar_reduce(
        [None if s == "count_star" else
         (torch.from_numpy(d.copy()), torch.from_numpy(v.copy()))
         for s in SPECS],
        torch.from_numpy(mask), SPECS,
    )
    for s, (wd, wv), (gd, gv) in zip(SPECS, want, got):
        assert bool(gv) == bool(np.asarray(wv)), s
        if bool(gv):
            assert int(gd) == int(np.asarray(wd)), s

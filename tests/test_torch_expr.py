"""The port's expression compiler and scalar reduce against the
reference's, on the same seeded columns with NULLs: three-valued
AND/OR/NOT, the six comparisons against lifted literals, decimal
arithmetic, integer casts; sum/count/min/max over masked rows. The same
expression tree is built twice, once from each package's texpr module,
and the results compare exactly (integer and boolean work)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from opentenbase_tpu import types as rt
from opentenbase_tpu.ops import agg as ref_agg
from opentenbase_tpu.ops import expr as ref_expr
from opentenbase_tpu.plan import texpr as RE
from opentenbase_tpu_torch import NotPorted
from opentenbase_tpu_torch import types as pt
from opentenbase_tpu_torch.ops import agg as port_agg
from opentenbase_tpu_torch.ops import expr as port_expr
from opentenbase_tpu_torch.plan import texpr as PE

N = 4000


def _columns(seed=21):
    """(data, valid) per column: int4, int8, bool, decimal(12,2),
    decimal(4,2), date; every column has NULLs."""
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
    return cols, valids


def _types(T):
    return [T.INT4, T.INT8, T.BOOL, T.SqlType(T.TypeId.DECIMAL, 12, 2),
            T.SqlType(T.TypeId.DECIMAL, 4, 2), T.DATE]


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


def test_outside_the_subset_raises_not_ported():
    ty = _types(pt)
    comp = port_expr.ExprCompiler("cpu")
    with pytest.raises(NotPorted):
        comp.compile(PE.BinE("/", PE.Col(1, ty[1]), PE.Col(1, ty[1]),
                             ty[1]))
    with pytest.raises(NotPorted):
        comp.compile(PE.IsNullE(PE.Col(0, ty[0]), False))


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

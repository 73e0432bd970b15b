"""The scalar and text functions of the port's expression compiler
against the reference's (``opentenbase_tpu/ops/expr.py`` ``_func``,
``_text_func``, ``_concat_pair``), on the same seeded numpy columns with
NULLs: the numeric functions, round on floats and exactly on DECIMAL,
the date functions over days before 1970 and past 2100 (DATE and
TIMESTAMP), every dictionary-transform text function and chains of them,
and ``||`` of two columns through the pairwise table. Then the two
civil-date helpers under hypothesis, and ``tests/test_functions.py``'s
session cases on both packages.

Tolerances: integers, booleans, dates, timestamps, decimals and TEXT
compare exactly, as do the validity masks and the dtypes; FLOAT8
(float32 where computed, float64 for a raw column, as the reference's
``_dev_dtype``) within a relative 1e-6."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import opentenbase_tpu.engine  # noqa: F401  (the reference's x64 mode)
import jax.numpy as jnp
from opentenbase_tpu import types as rt
from opentenbase_tpu.engine import Cluster as RefCluster
from opentenbase_tpu.ops import expr as ref_expr
from opentenbase_tpu.plan import texpr as RE
from opentenbase_tpu.storage.column import Dictionary as RefDictionary
from opentenbase_tpu_torch import Cluster, NotPorted
from opentenbase_tpu_torch import types as pt
from opentenbase_tpu_torch.ops import expr as port_expr
from opentenbase_tpu_torch.plan import texpr as PE
from opentenbase_tpu_torch.storage.column import Dictionary

N = 3000
US_DAY = 86_400_000_000
FLOAT_REL = 1e-6  # FLOAT8's tolerance; everything else is exact

# day numbers the calendar gets wrong first: leap days, century years,
# the year 2100 (no leap day), days around 1970 and far before it
EDGE_DAYS = np.array([
    -719468, -719162, -25567, -1, 0, 1, 58, 59, 60, 10956, 11016, 11017,
    47540, 47541, 47542, 47481, 47482, 73048, 73049, 73108, -800000,
    800000, 19782, 19722, 19783, -36524, -36525, -36466,
], dtype=np.int32)


def _columns(seed=5):
    """(data, valid) per column: 0 int4, 1 int8, 2 raw float8 with NaNs,
    3 decimal(12,2), 4 date, 5 timestamp, 6 int4 month offsets, 7 a
    second date, 8 positive raw float8."""
    rng = np.random.default_rng(seed)
    days = rng.integers(-800_000, 800_000, N).astype(np.int32)
    days[: len(EDGE_DAYS)] = EDGE_DAYS
    f = rng.normal(0.0, 50.0, N)
    f[rng.random(N) < 0.05] = np.nan
    cols = [
        rng.integers(-50, 50, N).astype(np.int32),
        rng.integers(-(10**12), 10**12, N).astype(np.int64),
        f,
        rng.integers(-(10**7), 10**7, N).astype(np.int64),
        days,
        days.astype(np.int64) * US_DAY + rng.integers(0, US_DAY, N),
        rng.integers(-30, 30, N).astype(np.int32),
        rng.integers(-20_000, 40_000, N).astype(np.int32),
        np.abs(rng.normal(0.0, 1e3, N)) + 1e-3,
    ]
    valids = [rng.random(N) > 0.1 for _ in cols]
    return cols, valids


def _types(T):
    dec = T.SqlType(T.TypeId.DECIMAL, 12, 2)
    return [T.INT4, T.INT8, T.FLOAT8, dec, T.DATE, T.TIMESTAMP, T.INT4,
            T.DATE, T.FLOAT8]


def _exprs(E, T):
    """name -> a function call over the columns, built from the texpr
    module ``E`` in the forms the analyzer writes (arguments cast to
    FLOAT8 where it casts them), plus round over a DECIMAL."""
    ty = _types(T)
    F8, I4, I8 = T.FLOAT8, T.INT4, T.INT8
    dec = ty[3]

    def C(i):
        return E.Col(i, ty[i])

    def K(v, t_):
        return E.Const(v, t_)

    def F(name, args, t_):
        return E.FuncE(name, tuple(args), t_)

    def f8(e):
        return E.CastE(e, F8)

    out = {
        "abs_int4": F("abs", [C(0)], I4),
        "abs_int8": F("abs", [C(1)], I8),
        "abs_decimal": F("abs", [C(3)], dec),
        "abs_float8": F("abs", [C(2)], F8),
        "floor_computed": F("floor", [f8(C(3))], F8),
        "floor_raw": F("floor", [C(2)], F8),
        "ceil": F("ceil", [f8(C(3))], F8),
        "ceiling": F("ceiling", [C(2)], F8),
        "sqrt": F("sqrt", [C(8)], F8),
        "sqrt_computed": F("sqrt", [f8(C(0))], F8),
        "exp": F("exp", [f8(E.BinE("//", C(0), K(4, I4), I4))], F8),
        "ln": F("ln", [C(8)], F8),
        "sign_computed": F("sign", [f8(C(3))], F8),
        "sign_raw": F("sign", [C(2)], F8),
        "power": F("power", [C(8), K(0.5, F8)], F8),
        "power_computed": F("power", [f8(C(0)), f8(K(3, I4))], F8),
        "round_float": F("round", [C(2), K(0, I4)], F8),
        "round_digits": F("round", [C(2), K(1, I4)], F8),
        "round_computed": F("round", [f8(C(3)), K(2, I4)], F8),
        "round_decimal": F("round", [C(3), K(0, I4)], dec),
        "round_decimal_1": F("round", [C(3), K(1, I4)], dec),
        "round_decimal_2": F("round", [C(3), K(2, I4)], dec),
        "date_trunc_year": F("date_trunc_year", [C(4)], T.DATE),
        "greatest_int": F("greatest", [E.CastE(C(0), I8), C(1)], I8),
        "least_int": F("least", [E.CastE(C(0), I8), C(1),
                                 K(7, I8)], I8),
        "greatest_float": F("greatest", [C(2), f8(C(0))], F8),
        "least_float": F("least", [C(2), C(8)], F8),
        "trunc_num": F("trunc_num", [C(2)], F8),
        "trunc_num_digits": F("trunc_num", [C(2), K(2, I4)], F8),
        "bitand": F("bitand", [C(1), E.CastE(C(0), I8)], I8),
        "nanvl_const": F("nanvl", [C(2), K(99.0, F8)], F8),
        "nanvl_col": F("nanvl", [C(2), C(8)], F8),
        "add_months_date": F("add_months", [C(4), C(6)], T.DATE),
        "add_months_timestamp": F("add_months", [C(5), C(6)],
                                  T.TIMESTAMP),
        "add_months_literal": F("add_months", [C(4), K(13, I4)], T.DATE),
        "months_between": F("months_between", [C(4), C(7)], F8),
        "last_day": F("last_day", [C(4)], T.DATE),
        "date_add_days": F("date_add_days", [C(4), K(-90, I4)], T.DATE),
        "coalesce": F("coalesce", [C(1), E.CastE(C(0), I8)], I8),
        "nullif": F("nullif", [C(0), K(3, I4)], I4),
    }
    for part in ("year", "month", "day"):
        out[f"extract_{part}"] = F(f"extract_{part}", [C(4)], I4)
        out[f"extract_{part}_timestamp"] = F(f"extract_{part}", [C(5)], I4)
        out[f"trunc_date_{part}"] = F(f"trunc_date_{part}", [C(4)], T.DATE)
    return out


NAMES = sorted(_exprs(PE, pt))


def _compare(got, want, float_type: bool):
    """(data, valid) of the port against the reference's."""
    (gd, gv), (wd, wv) = got, want
    assert np.array_equal(gv, wv)
    assert gd.dtype == wd.dtype
    gd, wd = gd[wv], wd[wv]
    if float_type:
        assert np.array_equal(np.isnan(gd), np.isnan(wd))
        ok = ~np.isnan(wd)
        np.testing.assert_allclose(gd[ok], wd[ok], rtol=FLOAT_REL, atol=0)
    else:
        assert np.array_equal(gd, wd)


def _ref_run(e, env, dids=(), dicts=None, want=None, n=N):
    comp = ref_expr.ExprCompiler(lift_consts=True)
    fn = comp.compile(e, list(dids), want)
    params = tuple(ref_expr.resolve_param(s, dicts or {}, None)
                   for s in comp.params)
    d, v = fn([(jnp.asarray(a), jnp.asarray(b)) for a, b in env], params)
    d = np.broadcast_to(np.asarray(d), (n,))
    v = np.ones(n, bool) if v is None else np.broadcast_to(
        np.asarray(v), (n,))
    return d, v


def _port_run(e, env, dids=(), dicts=None, want=None, n=N):
    comp = port_expr.ExprCompiler("cpu")
    fn = comp.compile(e, list(dids), want)
    params = tuple(port_expr.resolve_param(
        s, "cpu", (dicts or {}).__getitem__) for s in comp.params)
    d, v = fn([(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
               for a, b in env], params)
    d = d.expand(n).numpy()
    v = np.ones(n, bool) if v is None else v.expand(n).numpy()
    return d, v


@pytest.mark.parametrize("name", NAMES)
def test_function_matches_reference(name):
    cols, valids = _columns()
    env = list(zip(cols, valids))
    pe = _exprs(PE, pt)[name]
    got = _port_run(pe, env)
    want = _ref_run(_exprs(RE, rt)[name], env)
    _compare(got, want, pe.type.id in (pt.TypeId.FLOAT8, pt.TypeId.FLOAT4))


# -- the dictionary-transform text functions ----------------------------

WORDS = ["héllo world", "  Abc  ", "2024-03-05", "not-a-date", "42.5", "",
         "abcabc", "x", "2024-02-29 13:45:00", "MiXeD cAsE", "xxabcxx",
         "-17", "1969-12-31", "naïve café"]
WORDS_B = ["one", "", "Two", "3", "héllo"]


def _text_cases(E, T):
    """name -> (expression over TEXT column 0 (dictionary 'w.v') and
    column 1 ('w.b'), the output's dictionary or None for a scalar)."""
    c, c2 = E.Col(0, T.TEXT), E.Col(1, T.TEXT)

    def K(v, t_=T.TEXT):
        return E.Const(v, t_)

    def F(name, args, t_=T.TEXT):
        return E.FuncE(name, tuple(args), t_)

    I4 = T.INT4
    out = {
        "upper": F("upper", [c]), "lower": F("lower", [c]),
        "initcap": F("initcap", [c]), "reverse": F("reverse", [c]),
        "trim": F("trim", [c]), "ltrim": F("ltrim", [c]),
        "rtrim": F("rtrim", [c]), "trim_chars": F("trim", [c, K("x")]),
        "replace": F("replace", [c, K("a"), K("0")]),
        "substr_from": F("substr", [c, K(2, I4)]),
        "substr_len": F("substr", [c, K(2, I4), K(3, I4)]),
        "substr_negative": F("substr", [c, K(-3, I4)]),
        "substring": F("substring", [c, K(1, I4), K(2, I4)]),
        "lpad": F("lpad", [c, K(8, I4), K("*")]),
        "lpad_short": F("lpad", [c, K(3, I4)]),
        "lpad_null_length": F("lpad", [c, K(-1, I4)]),
        "rpad": F("rpad", [c, K(9, I4), K("ab")]),
        "concat_seg": F("concat_seg", [c, K("<"), K(">")]),
        "length": (F("length", [c], I4), None),
        "char_length": (F("char_length", [c], I4), None),
        "instr": (F("instr", [c, K("b")], I4), None),
        "instr_backward": (F("instr", [c, K("a"), K(-1, I4)], I4), None),
        "to_number": (F("to_number", [c], T.FLOAT8), None),
        "to_date": (F("to_date", [c], T.DATE), None),
        "to_timestamp": (F("to_timestamp", [c], T.TIMESTAMP), None),
        "chain_upper_trim": F("upper", [F("trim", [c])]),
        "chain_length_of_upper": (F("length", [F("upper", [c])], I4), None),
        "chain_seg_of_lower": F("concat_seg", [F("lower", [c]), K(""),
                                               K("!")]),
        "concat_pair": F("concat_pair", [c, c2, K(""), K(" - "), K("")]),
        "concat_pair_segments": F("concat_pair", [c2, c, K("["), K("|"),
                                                  K("]")]),
        "concat_pair_chain": F("concat_pair", [F("upper", [c]),
                                               F("trim", [c2]), K(""),
                                               K(""), K(".")]),
    }
    return {k: v if isinstance(v, tuple) else (v, "w.out")
            for k, v in out.items()}


TEXT_NAMES = sorted(_text_cases(PE, pt))


def _text_columns(seed=9):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, len(WORDS), N).astype(np.int32),
            rng.integers(0, len(WORDS_B), N).astype(np.int32)]
    valids = [rng.random(N) > 0.1 for _ in cols]
    return cols, valids


@pytest.mark.parametrize("name", TEXT_NAMES)
def test_text_function_matches_reference(name):
    """The same host function table in both packages: the TEXT results
    decoded from each package's output dictionary (which both fill in
    the same order, so the codes agree too), the scalar ones
    compared as values; a value the function refuses (to_date of
    'not-a-date') is NULL in both."""
    cols, valids = _text_columns()
    env = list(zip(cols, valids))
    dids = ("w.v", "w.b")
    rdicts = {"w.v": RefDictionary(WORDS), "w.b": RefDictionary(WORDS_B),
              "w.out": RefDictionary(["seed"])}
    pdicts = {"w.v": Dictionary(WORDS), "w.b": Dictionary(WORDS_B),
              "w.out": Dictionary(["seed"])}
    pe, want_did = _text_cases(PE, pt)[name]
    re_, _ = _text_cases(RE, rt)[name]
    got = _port_run(pe, env, dids, pdicts, want_did)
    want = _ref_run(re_, env, dids, rdicts, want_did)
    if want_did is None:
        _compare(got, want, pe.type.id == pt.TypeId.FLOAT8)
        return
    _compare(got, want, False)
    assert pdicts["w.out"].values == rdicts["w.out"].values
    gd, gv = got
    decoded = pdicts["w.out"].decode_array(gd[gv])
    assert list(decoded) == list(rdicts["w.out"].decode_array(
        np.asarray(want[0])[want[1]]))


def test_pair_table_refused_past_its_size(monkeypatch):
    """The pairwise table is refused past OTB_CONCAT_PAIR_MAX entries,
    in both packages alike."""
    monkeypatch.setenv("OTB_CONCAT_PAIR_MAX", "16")
    spec = dict(src_a="w.v", src_b="w.b", dst="w.out",
                segs=("", "", ""))
    with pytest.raises(RuntimeError, match="OTB_CONCAT_PAIR_MAX=16"):
        ref_expr.resolve_param(ref_expr.PairConcatParam(**spec), {
            "w.v": RefDictionary(WORDS), "w.b": RefDictionary(WORDS_B),
            "w.out": RefDictionary()}, None)
    pd = {"w.v": Dictionary(WORDS), "w.b": Dictionary(WORDS_B),
          "w.out": Dictionary()}
    with pytest.raises(RuntimeError, match="OTB_CONCAT_PAIR_MAX=16"):
        port_expr.resolve_param(port_expr.PairConcatParam(**spec), "cpu",
                                pd.__getitem__)


def test_text_table_cached_until_the_dictionary_grows(monkeypatch):
    """A text transform's table is built once per size of its source
    dictionary: a second bind reuses it, a new source value rebuilds it
    (and the new value gets its result)."""
    built = []
    orig = port_expr._build_str_transform
    monkeypatch.setattr(port_expr, "_build_str_transform",
                        lambda *a: built.append(1) or orig(*a))
    dicts = {"w.v": Dictionary(WORDS), "w.out": Dictionary()}
    spec = port_expr.StrTransformParam(
        "w.v", "w.out", "upper", (), "int32", (("upper", ()),))
    first = port_expr.resolve_param(spec, "cpu", dicts.__getitem__)
    again = port_expr.resolve_param(spec, "cpu", dicts.__getitem__)
    assert len(built) == 1
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    code = dicts["w.v"].encode_one("fresh")
    table, valid = port_expr.resolve_param(spec, "cpu", dicts.__getitem__)
    assert len(built) == 2 and bool(valid[code])
    assert dicts["w.out"].decode(int(table[code])) == "FRESH"


@pytest.mark.parametrize("name", ["round_dec", "date_trunc", "now",
                                  "ts_add_usecs", "extract_quarter"])
def test_functions_the_reference_refuses_stay_refused(name):
    """A name the analyzer emits and the reference's compiler refuses
    (NotImplementedError there) raises NotPorted by name here."""
    args = (PE.Col(0, pt.DATE),)
    with pytest.raises(NotPorted, match=f"function {name}"):
        port_expr.ExprCompiler("cpu").compile(
            PE.FuncE(name, args, pt.DATE), [None])
    with pytest.raises(NotImplementedError, match=f"function {name}"):
        ref_expr.ExprCompiler().compile(
            RE.FuncE(name, (RE.Col(0, rt.DATE),), rt.DATE), [None])


# -- the civil-date helpers --------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(-800_000, 800_000), min_size=1, max_size=64))
def test_civil_helpers_match_reference(days):
    """``_civil_from_days`` and ``_days_from_civil`` against the
    reference's, exactly, and each the other's inverse from 0000-03-01
    (day -719 468) on: before it the reference's era rounds down twice
    (a floor division over an already shifted day), a day off, and the
    port keeps its answers (ROADMAP C)."""
    z = np.asarray(days, dtype=np.int32)
    want = [np.asarray(a) for a in ref_expr._civil_from_days(
        jnp.asarray(z), jnp)]
    got = port_expr._civil_from_days(torch.from_numpy(z))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
        assert g.dtype == torch.int32
    back = port_expr._days_from_civil(*got)
    ok = z >= -719468
    assert np.array_equal(back.numpy()[ok], z[ok])
    wback = ref_expr._days_from_civil(*[jnp.asarray(w) for w in want],
                                      jnp)
    assert np.array_equal(np.asarray(wback), back.numpy())


# -- tests/test_functions.py's session cases on both packages ---------------

SESSION_DDL = [
    "create table t (k bigint, v text, x float8, d date)"
    " distribute by shard(k)",
    "insert into t values (1,'héllo world',1.5,'2024-01-31'),"
    " (2,null,-2.75,'2024-02-29'), (3,'Abc',0.0,'2023-12-15')",
    "create table raw (k bigint, sv text) distribute by shard(k)",
    "insert into raw values (1,'2024-03-05'),(2,'not-a-date'),(3,null)",
    "create table s6 (k bigint, sv text) distribute by shard(k)",
    "insert into s6 values (1,'abcabc')",
    "create table p1 (k bigint, sv text) distribute by shard(k)",
    "insert into p1 values (1,'x')",
    "create table w (k bigint, g bigint, v bigint, w text)"
    " distribute by shard(k)",
    "insert into w values (1,1,10,'ab'),(2,1,20,'cd'),(3,2,30,null),"
    " (4,2,5,'a%b')",
]

SESSION_QUERIES = {
    "text_functions": "select upper(v), lower(v), substr(v, 1, 5),"
    " length(v), replace(v, 'o', '0'), reverse(v), initcap(v) from t"
    " order by k",
    "pad_trim_instr": "select lpad(v, 5, '*'), rpad(v, 5, '.'),"
    " instr(v, 'b'), trim(v), instr(v, 'zz') from t order by k",
    "nvl": "select nvl(v, 'missing') from t order by k",
    "nvl2": "select nvl2(v, 'has', 'none') from t order by k",
    "decode": "select decode(k, 1, 'one', 2, 'two', 'other') from t"
    " order by k",
    "numeric_oracle": "select trunc(x), sign(x), bitand(12, 10),"
    " nanvl(x, 99.0), to_number('42.5') from t order by k",
    "date_oracle": "select add_months(d, 1), last_day(d), trunc(d, 'MM'),"
    " months_between(d, date '2023-12-31'), to_date('2024-03-05')"
    " from t order by k",
    "text_fn_in_where": "select k from t where upper(v) = 'ABC'",
    "text_fn_group_by": "select length(v), count(*) from t where v is"
    " not null group by length(v) order by length(v)",
    "lnnvl": "select k from t where lnnvl(v = 'Abc') order by k",
    "try_cast_to_date": "select k, to_date(sv) from raw order by k",
    "try_cast_to_number": "select to_number(sv) from raw order by k",
    "decode_null": "select decode(v, null, 'is_null', 'has') from t"
    " order by k",
    "trunc_digits": "select trunc(123.456, 2) from t where k = 1",
    "instr_negative": "select instr(sv, 'a', -1) from s6",
    "lpad_oracle": "select lpad(sv, 5, 'ab'), lpad(sv, -1) from p1",
    "months_between_whole": "select months_between(date '2020-03-31',"
    " date '2020-02-29') from t where k = 1",
    "extract": "select extract(year from d), extract(month from d),"
    " extract(day from d) from t order by k",
    "group_by_extract": "select extract(month from d), count(*) from t"
    " group by extract(month from d) order by 1",
    "math": "select abs(x), floor(x), ceil(x), round(x, 1), sqrt(abs(x)),"
    " power(x, 2), greatest(x, 0.5), least(k, 2) from t order by k",
    "concat": "select v || '!', '<' || v || '>', v || ' ' || v from t"
    " order by k",
    "concat_columns_of_two_tables": "select t.v || '/' || w.w from t"
    " join w on t.k = w.k order by t.k",
    "sugar_distinct_from": "select k from w where w is distinct from 'ab'"
    " order by k",
    "sugar_substring_from_for": "select substring(w from 1 for 1) from w"
    " order by k limit 2",
    "sugar_filter": "select g, count(*) filter (where v > 10),"
    " sum(v) filter (where v < 15) from w group by g order by g",
    "sugar_like_escape": "select k from w where w like 'a!%%' escape '!'"
    " order by k",
    "cast_to_text": "select cast(42 as text), cast(true as text)",
}


@pytest.fixture(scope="module")
def sessions():
    rs = RefCluster(num_datanodes=2, shard_groups=16).session()
    ps = Cluster(num_datanodes=2, shard_groups=16, device="cpu").session()
    for sql in SESSION_DDL:
        rs.execute(sql)
        ps.execute(sql)
    return rs, ps


def _approx_rows(got, want):
    """Rows equal, floats within FLOAT_REL (the reference's device
    computes FLOAT8 in float32, the port likewise)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                assert a == pytest.approx(b, rel=FLOAT_REL, nan_ok=True)
            else:
                assert a == b


@pytest.mark.parametrize("name", sorted(SESSION_QUERIES))
@pytest.mark.parametrize("fused", ["on", "off"])
def test_session_matches_reference(sessions, name, fused):
    rs, ps = sessions
    sql = SESSION_QUERIES[name]
    for s in (rs, ps):
        s.execute(f"set enable_fused_execution = {fused}")
    _approx_rows(ps.query(sql), rs.query(sql))


@pytest.mark.parametrize("sql,match", [
    ("select v || x from t", "needs a text operand"),
    ("select coalesce(v, 'x') || v from t", "two computed text values"),
    ("select v || v || v from t", "more than two"),
])
def test_concat_refusals_match_reference(sessions, sql, match):
    """``||`` shapes the reference's analyzer refuses, refused alike."""
    rs, ps = sessions
    for s in (rs, ps):
        with pytest.raises(Exception, match=match):
            s.query(sql)


def _refused_shapes(E, T):
    """name -> an expression over TEXT columns 0 ('w.v') and 1 ('w.b')
    that both compilers refuse on dictionary codes."""
    c, c2 = E.Col(0, T.TEXT), E.Col(1, T.TEXT)
    up = E.FuncE("upper", (c,), T.TEXT)
    return {
        "ordered TEXT column-to-column comparison":
            E.BinE("<", c, c2, T.BOOL),
        "TEXT equality across dictionaries": E.BinE("=", c, c2, T.BOOL),
        "TEXT IN over computed TEXT":
            E.InListE(up, (E.Const("A", T.TEXT),), False),
        "LIKE over computed TEXT": E.LikeE(up, "A%", False, False),
    }


@pytest.mark.parametrize("what", sorted(_refused_shapes(PE, pt)))
def test_text_refusals_kept(what):
    """The shapes the reference's compiler refuses on codes stay refused,
    by name here: an ordered TEXT comparison of two columns, TEXT
    equality across two dictionaries, IN and LIKE over computed TEXT."""
    with pytest.raises(NotImplementedError):
        ref_expr.ExprCompiler().compile(_refused_shapes(RE, rt)[what],
                                        ["w.v", "w.b"])
    with pytest.raises(NotPorted, match=what):
        port_expr.ExprCompiler("cpu").compile(
            _refused_shapes(PE, pt)[what], ["w.v", "w.b"])

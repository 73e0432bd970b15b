"""The port's scan-aggregate module (opentenbase_tpu_torch/ops/scan_agg.py)
held against the reference's Pallas kernel (opentenbase_tpu/ops/
pallas_scan.py) on the same seeded inputs.

- the copied certifier makes the reference's decisions;
- the plain PyTorch version gives exactly the sums and counts of
  ``build_partials(..., interpret=True)`` + ``combine_partials``;
- compact [S, 1] and full [S, Rmax] MVCC planes give the same result.

Tolerance: exact equality (both sides compute exact integer sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opentenbase_tpu import types as jt
from opentenbase_tpu.ops import pallas_scan as ps
from opentenbase_tpu.plan import texpr as JE
from opentenbase_tpu_torch import types as tt
from opentenbase_tpu_torch.ops import scan_agg as sa
from opentenbase_tpu_torch.plan import texpr as TE

# ---------------------------------------------------------------------------
# expressions, built once per package (each side needs its own TExprs)
# ---------------------------------------------------------------------------


def _price_disc(E, t):
    return E.BinE("*", E.Col(1, t.INT8), E.Col(0, t.INT8), t.INT8)


def _q6_pred(E, t):
    ship = E.Col(2, t.INT8)
    disc = E.Col(0, t.INT8)

    def cmp(op, a, v):
        return E.BinE(op, a, E.Const(v, t.INT8), t.BOOL)

    def and_(a, b):
        return E.BinE("and", a, b, t.BOOL)

    return and_(
        and_(cmp(">=", ship, 8766), cmp("<", ship, 9131)),
        and_(cmp(">=", disc, 5), cmp("<=", disc, 7)),
    )


PREDICATES = {
    "q6": _q6_pred,
    "cast_cmp": lambda E, t: E.BinE(
        "<", E.CastE(E.Col(0, t.INT4), t.INT8), E.Const(24, t.INT8), t.BOOL
    ),
    "not_in_list": lambda E, t: E.UnaryE(
        "not",
        E.InListE(E.Col(0, t.INT8),
                  (E.Const(1, t.INT8), E.Const(3, t.INT8)), False),
        t.BOOL,
    ),
    "negated_in_list": lambda E, t: E.InListE(
        E.Col(0, t.INT8), (E.Const(2, t.INT8),), True
    ),
    "or_arith": lambda E, t: E.BinE(
        "or",
        E.BinE("<>", E.BinE("-", E.Col(0, t.INT8), E.Col(2, t.INT8), t.INT8),
               E.Const(0, t.INT8), t.BOOL),
        E.BinE(">", E.UnaryE("-", E.Col(0, t.INT8), t.INT8),
               E.Const(-3, t.INT8), t.BOOL),
        t.BOOL,
    ),
    "operand_beyond_2p24": lambda E, t: E.BinE(
        "<", E.Col(1, t.INT8), E.Const(1 << 25, t.INT8), t.BOOL
    ),
    "float_column": lambda E, t: E.BinE(
        "<", E.Col(3, t.FLOAT8), E.Const(1, t.INT8), t.BOOL
    ),
    "null_const": lambda E, t: E.BinE(
        "=", E.Col(0, t.INT8), E.Const(None, t.INT8), t.BOOL
    ),
}

VALUES = {
    "limb_product": _price_disc,
    "narrow": lambda E, t: E.Col(0, t.INT8),
    "sum_of_cols": lambda E, t: E.BinE(
        "+", E.Col(0, t.INT8), E.Col(2, t.INT8), t.INT8
    ),
    "negated": lambda E, t: E.UnaryE("-", E.Col(2, t.INT8), t.INT8),
    "wide_times_wide": lambda E, t: E.BinE(
        "*", E.Col(1, t.INT8), E.Col(1, t.INT8), t.INT8
    ),
    "float": lambda E, t: E.Col(3, t.FLOAT8),
}

# |max| per column: disc, price (~1e7), ship, a float column
BOUNDS = [10.0, 9_999_999.0, 9500.0, None]


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_certify_predicate_matches_reference(name):
    build = PREDICATES[name]
    want = ps.certify_predicate(build(JE, jt), BOUNDS)
    assert sa.certify_predicate(build(TE, tt), BOUNDS) == want


@pytest.mark.parametrize("name", sorted(VALUES))
def test_decompose_value_matches_reference(name):
    build = VALUES[name]
    ref = ps.decompose_value(build(JE, jt), BOUNDS)
    got = sa.decompose_value(build(TE, tt), BOUNDS)
    assert ps.bound(build(JE, jt), BOUNDS) == sa.bound(build(TE, tt), BOUNDS)
    if ref is None:
        assert got is None
    else:
        assert [s for _f, s in ref] == [s for _e, s in got]


@pytest.mark.parametrize(
    "ranges",
    [
        [(0, 2), (0, 1)],        # Q1: joint domain 6
        [(-2, 3), (5, 6)],       # offset keys
        [(0, 40), (0, 1)],       # domain beyond the cap
        [(0, 1 << 25), (0, 1)],  # key beyond the f32-exact bound
        [None, (0, 1)],          # unknown range
    ],
)
def test_plan_group_keys_matches_reference(ranges):
    def keys(E, t):
        return [E.Col(0, t.INT4), E.Col(1, t.INT4)]

    try:
        _fn, ref_dec, ref_g = ps.plan_group_keys(keys(JE, jt), ranges)
    except ps.PallasUnsupported:
        with pytest.raises(sa.PallasUnsupported):
            sa.plan_group_keys(keys(TE, tt), ranges)
        return
    _e, dec, g = sa.plan_group_keys(keys(TE, tt), ranges)
    assert (dec, g) == (ref_dec, ref_g)


# ---------------------------------------------------------------------------
# plain version vs build_partials(interpret=True) + combine_partials
# ---------------------------------------------------------------------------


def _reference_partials(cols, pred, vals, key=None):
    """Run the reference kernel in interpret mode on one shard."""
    layout, val_fns = [], []
    for e, v in enumerate(vals):
        for fn, scale in ps.decompose_value(v, BOUNDS + [4.0, 4.0]):
            val_fns.append(fn)
            layout.append((e, scale))
    pf = ps.compile_f32(pred)
    key_fn, n_groups = None, 1
    if key is not None:
        key_fn, _dec, n_groups = ps.plan_group_keys(key[0], key[1])
    run = ps.build_partials(
        len(cols) + 1, pf, val_fns, interpret=True,
        key_fn=key_fn, n_groups=n_groups,
    )
    n = len(cols[0])
    blk = [jnp.asarray(c, jnp.float32) for c in cols]
    blk.append(jnp.ones(n, jnp.float32))
    out = np.asarray(run(blk))[None]
    return ps.combine_partials(out, layout, len(vals), n_groups)


def _port(cols, pred, vals, key=None, n_groups=1):
    spec = sa.compile_spec([pred], key, vals, n_groups)
    planes = [torch.from_numpy(cols[i][None, :]) for i in spec.cols]
    n = len(cols[0])
    xmin = torch.zeros((1, 1), dtype=torch.int64)
    xmax = torch.full((1, 1), 2**62, dtype=torch.int64)
    nrows = torch.tensor([n], dtype=torch.int64)
    before = sa.scan_agg.launches
    sums, counts = sa.scan_agg(planes, xmin, xmax, nrows, 2**61, spec)
    assert sa.scan_agg.launches == before  # CPU tensors: the plain version
    return sums.numpy(), counts.numpy()


def _lineitem_like(n, seed):
    rng = np.random.default_rng(seed)
    disc = rng.integers(0, 11, n).astype(np.int64)
    price = rng.integers(90000, 10_000_000, n).astype(np.int64)
    ship = rng.integers(8000, 9500, n).astype(np.int32)
    return disc, price, ship, rng


def test_plain_matches_interpret_kernel_limb_product():
    """The shapes of tests/test_pallas_scan.py's exactness test: 100k
    rows, a wide-product SUM that the reference limb-splits, and a
    count."""
    disc, price, ship, _ = _lineitem_like(100_000, 7)
    cols = [disc, price, ship]
    ref_s, ref_c = _reference_partials(
        cols, _q6_pred(JE, jt), [_price_disc(JE, jt)]
    )
    sums, counts = _port(cols, _q6_pred(TE, tt), [_price_disc(TE, tt)])
    assert sums[:, 0].tolist() == ref_s[:, 0].tolist()
    assert counts[:, 0].tolist() == ref_c[:, 0].tolist()
    mask = (ship >= 8766) & (ship < 9131) & (disc >= 5) & (disc <= 7)
    assert int(sums[0, 0, 0]) == int(np.sum(price[mask] * disc[mask]))


def test_plain_matches_interpret_kernel_grouped_g6():
    """Q1's shape: two small-domain keys (joint domain 6), three sums
    (one limb-split product) and a count."""
    disc, price, ship, rng = _lineitem_like(30_000, 11)
    flag = rng.integers(0, 3, len(disc)).astype(np.int32)
    status = rng.integers(0, 2, len(disc)).astype(np.int32)
    cols = [disc, price, ship, np.zeros(len(disc)), flag, status]

    def pred(E, t):
        return E.BinE("<=", E.Col(2, t.INT8), E.Const(9300, t.INT8), t.BOOL)

    def vals(E, t):
        return [E.Col(0, t.INT8), E.Col(1, t.INT8), _price_disc(E, t)]

    ranges = [None, None, None, None, (0, 2), (0, 1)]
    ref_keys = [JE.Col(4, jt.INT4), JE.Col(5, jt.INT4)]
    ref_s, ref_c = _reference_partials(
        cols, pred(JE, jt), vals(JE, jt), key=(ref_keys, ranges)
    )
    key_expr, _dec, g = sa.plan_group_keys(
        [TE.Col(4, tt.INT4), TE.Col(5, tt.INT4)], ranges
    )
    sums, counts = _port(cols, pred(TE, tt), vals(TE, tt), key_expr, g)
    assert g == 6
    assert sums.tolist() == ref_s.tolist()
    assert counts.tolist() == ref_c.tolist()


# ---------------------------------------------------------------------------
# MVCC planes
# ---------------------------------------------------------------------------


def _mvcc_case(seed=3, S=3, R=4096):
    rng = np.random.default_rng(seed)
    c0 = torch.from_numpy(rng.integers(-50, 50, (S, R)).astype(np.int32))
    c1 = torch.from_numpy(rng.integers(0, 10**6, (S, R)).astype(np.int64))
    nrows = torch.tensor([R - 7, 0, 1000], dtype=torch.int64)
    pred = TE.BinE("<", TE.Col(0, tt.INT4), TE.Const(20, tt.INT8), tt.BOOL)
    key = sa.key_expr_from_decoders([(2, -50, 100, 1)], [TE.Col(0, tt.INT4)])
    spec = sa.compile_spec(
        [pred], None,
        [TE.BinE("*", TE.Col(1, tt.INT8), TE.Col(0, tt.INT4), tt.INT8)],
    )
    return [c0, c1], nrows, spec, key


def test_compact_and_full_mvcc_planes_agree():
    cols, nrows, spec, _ = _mvcc_case()
    S, R = cols[0].shape
    xmin = torch.tensor([[5], [5], [9]], dtype=torch.int64)
    xmax = torch.full((S, 1), 2**62, dtype=torch.int64)
    planes = [cols[i] for i in spec.cols]
    a = sa.scan_agg(planes, xmin, xmax, nrows, 7, spec)
    b = sa.scan_agg(
        planes, xmin.expand(S, R).contiguous(),
        xmax.expand(S, R).contiguous(), nrows, 7, spec,
    )
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # shard 2 committed after the snapshot, shard 1 is empty
    assert a[1][1:].sum() == 0 and a[1][0, 0] > 0


def test_full_mvcc_planes_match_numpy_visibility():
    cols, nrows, spec, _ = _mvcc_case(seed=4)
    S, R = cols[0].shape
    rng = np.random.default_rng(5)
    xmin = rng.choice([1, 10, 20], (S, R)).astype(np.int64)
    xmax = rng.choice([2**62, 10, 11, 15], (S, R)).astype(np.int64)
    snap = 10
    planes = [cols[i] for i in spec.cols]
    sums, counts = sa.scan_agg(
        planes, torch.from_numpy(xmin), torch.from_numpy(xmax), nrows,
        snap, spec,
    )
    c0, c1 = cols[0].numpy().astype(np.int64), cols[1].numpy()
    live = (
        (np.arange(R)[None, :] < nrows.numpy()[:, None])
        & (xmin <= snap) & (snap < xmax) & (c0 < 20)
    )
    assert counts[:, 0].tolist() == live.sum(axis=1).tolist()
    assert sums[:, 0, 0].tolist() == np.where(live, c1 * c0, 0).sum(
        axis=1).tolist()


def test_program_compiler_limits():
    deep = TE.Col(0, tt.INT8)
    for _ in range(20):
        deep = TE.BinE("+", TE.Const(1, tt.INT8), deep, tt.INT8)
    with pytest.raises(sa.PallasUnsupported):
        sa.compile_spec([], None, [deep])
    with pytest.raises(sa.PallasUnsupported):
        sa.compile_spec([], None, [TE.Col(0, tt.INT8)] * 9)


def _bytes_case():
    """One shard of 64 rows: an int64 predicate column that passes rows 0
    and 40 only, and an int64 value-only column."""
    c0 = torch.zeros((1, 64), dtype=torch.int64)
    c0[0, [0, 40]] = 1
    c1 = torch.arange(64, dtype=torch.int64)[None, :]
    spec = sa.compile_spec(
        [TE.BinE("=", TE.Col(0, tt.INT8), TE.Const(1, tt.INT8), tt.BOOL)],
        None, [TE.Col(1, tt.INT8)],
    )
    return [[c0, c1][i] for i in spec.cols], spec


def test_spec_bytes_charges_value_columns_per_passing_sector():
    cols, spec = _bytes_case()
    nrows = torch.tensor([64], dtype=torch.int64)
    xmin = torch.tensor([[1]], dtype=torch.int64)
    xmax = torch.tensor([[2**62]], dtype=torch.int64)
    # predicate column: 64 rows x 8 B; value column: the two 32-byte
    # sectors holding rows 0 and 40; compact MVCC 2 x 8 B; nrows 8 B;
    # outputs one sum and one count
    assert sa.spec_bytes(cols, xmin, xmax, nrows, 5, spec) == (
        512 + 64 + 16 + 8 + 16
    )


def test_spec_bytes_full_planes_count_what_visibility_reads():
    cols, spec = _bytes_case()
    nrows = torch.tensor([48], dtype=torch.int64)
    xmin = torch.full((1, 64), 1, dtype=torch.int64)
    xmin[0, 32:] = 9  # rows 32.. committed after the snapshot
    xmax = torch.full((1, 64), 2**62, dtype=torch.int64)
    # predicate column: the 32 visible rows; value column: row 0's
    # sector (row 40 is invisible); xmin: the 48 real rows; xmax: the
    # 32 rows with xmin <= snap
    assert sa.spec_bytes(cols, xmin, xmax, nrows, 5, spec) == (
        256 + 32 + 384 + 256 + 8 + 16
    )


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card (skips on a
    machine without CUDA; chip_smoke.py runs the same comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cols, nrows, spec, key = _mvcc_case()
    S, R = cols[0].shape
    dev = torch.device("cuda", 0)
    # a 16-group key over c0 in [-50, 50): rows past the domain count
    # in no group
    grouped = sa.compile_spec([], key, [TE.Col(1, tt.INT8)], 16)
    rng = np.random.default_rng(9)
    xmin = torch.from_numpy(rng.choice([1, 20], (S, R)).astype(np.int64))
    xmax = torch.full((S, R), 2**62, dtype=torch.int64)
    for sp in (spec, grouped):
        planes = [cols[i].to(dev) for i in sp.cols]
        args = (planes, xmin.to(dev), xmax.to(dev), nrows.to(dev), 10, sp)
        k = sa.scan_agg(*args)
        p = sa.scan_agg_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


# ---------------------------------------------------------------------------
# the kernel's host side: slots, lowering, column classes, plan, schedule
# ---------------------------------------------------------------------------


def _chain(idx, tys=None):
    """c[i0] + (c[i1] + (...)): a program of stack depth len(idx)."""
    ty = (lambda i: tys[i]) if tys else (lambda i: tt.INT8)
    e = TE.Col(idx[-1], ty(idx[-1]))
    for i in reversed(idx[:-1]):
        e = TE.BinE("+", TE.Col(i, ty(i)), e, tt.INT8)
    return e


def _widest_spec():
    """The largest spec compile_spec accepts: 16 columns, a predicate of
    stack depth 16, 16 groups, 8 values (one of depth 16)."""
    pred = TE.BinE(">", _chain(list(range(16))), TE.Const(-5, tt.INT8),
                   tt.BOOL)
    key = sa.key_expr_from_decoders(
        [(10, 0, 4, 1), (11, 0, 4, 4)],
        [TE.Col(10, tt.INT4), TE.Col(11, tt.INT4)])
    vals = [TE.Col(i, tt.INT8) for i in (0, 12, 14)] + [
        TE.BinE("*", TE.Col(1, tt.INT8), TE.Col(13, tt.INT8), tt.INT8),
        TE.UnaryE("-", TE.Col(2, tt.INT8), tt.INT8),
        TE.BinE("-", TE.Col(3, tt.INT8), TE.Const(5, tt.INT8), tt.INT8),
        TE.BinE("*", TE.Col(4, tt.INT8), TE.Col(5, tt.INT8), tt.INT8),
        _chain([6, 7, 8, 9, 0, 1, 2, 3, 4, 5, 12, 13, 14, 15, 10, 11]),
    ]
    return sa.compile_spec([pred], key, vals, 16)


def _file_specs():
    """Every spec this file builds: the certifiable predicates and values
    of the tables above, Q6's and Q1's shapes, the MVCC and bytes cases,
    the 16-group spec of the card test and the widest spec."""
    out = {}
    for name, build in PREDICATES.items():
        e = build(TE, tt)
        if sa.certify_predicate(e, BOUNDS):
            out[f"pred {name}"] = sa.compile_spec([e], None,
                                                  [TE.Col(0, tt.INT8)])
    for name, build in VALUES.items():
        if sa.decompose_value(build(TE, tt), BOUNDS) is not None:
            out[f"value {name}"] = sa.compile_spec(
                [_q6_pred(TE, tt)], None, [build(TE, tt)])
    ranges = [None, None, None, None, (0, 2), (0, 1)]
    key, _dec, g = sa.plan_group_keys(
        [TE.Col(4, tt.INT4), TE.Col(5, tt.INT4)], ranges)
    out["q1 shape"] = sa.compile_spec(
        [TE.BinE("<=", TE.Col(2, tt.INT8), TE.Const(9300, tt.INT8),
                 tt.BOOL)],
        key, [TE.Col(0, tt.INT8), TE.Col(1, tt.INT8),
              _price_disc(TE, tt)], g)
    _cols, _nrows, spec, mkey = _mvcc_case()
    out["mvcc case"] = spec
    out["sixteen groups"] = sa.compile_spec([], mkey, [TE.Col(1, tt.INT8)],
                                            16)
    out["bytes case"] = _bytes_case()[1]
    out["count only"] = sa.compile_spec([_q6_pred(TE, tt)], None, [])
    out["widest"] = _widest_spec()
    return out


def _spec_columns(spec, n=3000, seed=21):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-12, 12, n).astype(np.int64))
            for _ in spec.cols]


def _eval_slots(spec, prog, cols):
    """Run a program by its recorded slots: no stack, one register per
    slot, as the kernel does."""
    start, n = prog
    reg = {}
    binops = {
        sa.OP_ADD: lambda a, b: a + b, sa.OP_SUB: lambda a, b: a - b,
        sa.OP_MUL: lambda a, b: a * b, sa.OP_AND: lambda a, b: a & b,
        sa.OP_OR: lambda a, b: a | b,
        sa.OP_EQ: lambda a, b: (a == b).long(),
        sa.OP_NE: lambda a, b: (a != b).long(),
        sa.OP_LT: lambda a, b: (a < b).long(),
        sa.OP_LE: lambda a, b: (a <= b).long(),
        sa.OP_GT: lambda a, b: (a > b).long(),
        sa.OP_GE: lambda a, b: (a >= b).long(),
    }
    for (op, arg), s in zip(spec.code[start:start + n],
                            spec.slots[start:start + n]):
        if op == sa.OP_COL:
            reg[s] = cols[arg]
        elif op == sa.OP_CONST:
            reg[s] = torch.full_like(cols[0], spec.consts[arg])
        elif op == sa.OP_NEG:
            reg[s] = -reg[s]
        elif op == sa.OP_NOT:
            reg[s] = 1 - reg[s]
        else:
            reg[s] = binops[op](reg[s], reg[s + 1])
    return reg[0]


@pytest.mark.parametrize("name", sorted(_file_specs()))
def test_slots_reproduce_eval_program_and_depths(name):
    spec = _file_specs()[name]
    assert len(spec.slots) == len(spec.code)
    cols = _spec_columns(spec)
    progs = [(spec.pred, spec.pred_depth), (spec.key, spec.key_depth)]
    progs += list(zip(spec.values, spec.value_depths))
    for prog, depth in progs:
        if prog is None:
            assert depth == 0
            continue
        heights = []
        want = sa._eval_program(spec, prog, cols, heights)
        got = _eval_slots(spec, prog, cols)
        assert torch.equal(got + torch.zeros_like(cols[0]),
                           want + torch.zeros_like(cols[0]))
        assert depth == max(heights)
        start, n = prog
        # each result lands on the top of the stack
        assert list(spec.slots[start:start + n]) == [h - 1 for h in heights]


_BIN = {
    sa.OP_ADD: lambda a, b: a + b, sa.OP_SUB: lambda a, b: a - b,
    sa.OP_MUL: lambda a, b: a * b, sa.OP_AND: lambda a, b: a & b,
    sa.OP_OR: lambda a, b: a | b,
    sa.OP_EQ: lambda a, b: (a == b).long(),
    sa.OP_NE: lambda a, b: (a != b).long(),
    sa.OP_LT: lambda a, b: (a < b).long(),
    sa.OP_LE: lambda a, b: (a <= b).long(),
    sa.OP_GT: lambda a, b: (a > b).long(),
    sa.OP_GE: lambda a, b: (a >= b).long(),
}


def _run_kernel_code(spec, cols, live, G):
    """The kernel's one program over a flat set of rows, in torch terms:
    ``live`` the visible real rows. Returns (sums [G, E], counts [G])."""
    words, depth, _rows = sa.kernel_code(spec)
    gathered = set(sa.column_classes(spec)[1])
    reg = {}
    passing = live.clone()
    grp = torch.zeros_like(cols[0])
    E = spec.n_values
    sums = torch.zeros((G, E), dtype=torch.int64)
    counts = torch.zeros(G, dtype=torch.int64)
    for w in words:
        op, arg, s, aux = w & 0xff, (w >> 8) & 0xff, (w >> 16) & 0xff, w >> 24
        assert s < depth
        if op in (sa.OP_PASS, sa.OP_KEY, sa.OP_ACC):
            assert s == 0  # the kernel reads slot 0 for these
        if op == sa.OP_PASS:
            passing &= reg[s] != 0
        elif op == sa.OP_KEY:
            ok = (reg[s] >= 0) & (reg[s] < G)
            passing &= ok
            grp = torch.where(ok, reg[s], 0)
        elif op == sa.OP_COUNT:
            counts.index_add_(0, grp[passing], torch.ones_like(grp[passing]))
        elif op == sa.OP_ACC:
            sums[:, arg].index_add_(0, grp[passing], reg[s][passing])
        elif op == sa.OP_ANY:
            pass  # a skip when no row passes: the same sums
        elif op == sa.OP_ACCN:
            counts.index_add_(0, grp[passing], torch.ones_like(grp[passing]))
            for e in range(arg):
                sums[:, e].index_add_(0, grp[passing], reg[e][passing])
        elif op >= sa.OP_FILT:
            passing &= _BIN[op - sa.OP_FILT](cols[aux],
                                              spec.consts[arg]) != 0
        elif op >= sa.OP_K:
            reg[s] = _BIN[op - sa.OP_K](reg[s], spec.consts[arg])
        elif op in (sa.OP_COL, sa.OP_GCOL):
            # gathered columns are exactly the value-only ones
            assert (op == sa.OP_GCOL) == (arg in gathered)
            reg[s] = cols[arg]
        elif op == sa.OP_CONST:
            reg[s] = torch.full_like(cols[0], spec.consts[arg])
        elif op == sa.OP_NEG:
            reg[s] = -reg[s]
        elif op == sa.OP_NOT:
            reg[s] = 1 - reg[s]
        else:
            reg[s] = _BIN[op](reg[s], reg[s + 1])
    return sums, counts


@pytest.mark.parametrize("name", sorted(_file_specs()))
def test_kernel_code_matches_plain_version(name):
    """The lowered program (value programs stacked or one after another,
    OP_PASS/OP_KEY/OP_COUNT/OP_ACC) gives the plain version's sums."""
    spec = _file_specs()[name]
    words, depth, rows = sa.kernel_code(spec)
    assert (depth, rows) in sa.VARIANTS and len(words) <= sa.MAX_KCODE
    n = 3000
    rng = np.random.default_rng(4)
    cols = [torch.from_numpy(rng.integers(-3, 5, n).astype(np.int64))
            for _ in spec.cols]
    live = torch.from_numpy(rng.random(n) > 0.2)
    got = _run_kernel_code(spec, cols, live, spec.n_groups)
    xmin = torch.where(live, 1, 9)[None, :].to(torch.int64)
    xmax = torch.full((1, n), 2**62, dtype=torch.int64)
    want = sa.scan_agg_plain([c[None, :] for c in cols], xmin, xmax,
                             torch.tensor([n]), 5, spec)
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1],
                                                           want[1][0])


def test_value_programs_stack_when_the_depth_allows():
    """Q1's values stack above one another (all gathered loads of a tile
    in flight together); the widest spec's depth-16 value does not fit
    and runs its programs one after another."""
    specs = _file_specs()
    words, depth, _ = sa.kernel_code(specs["q1 shape"])
    ops = [w & 0xff for w in words]
    assert depth == 4 and sa.OP_ACC not in ops and sa.OP_COUNT not in ops
    assert words[-1] == sa.OP_ACCN | 3 << 8
    assert ops.index(sa.OP_ANY) == ops.index(sa.OP_KEY) + 1
    words, depth, _ = sa.kernel_code(specs["widest"])
    accs = [(w >> 8 & 0xff, w >> 16 & 0xff) for w in words
            if w & 0xff == sa.OP_ACC]
    assert depth == 16 and accs == [(e, 0) for e in range(8)]


def test_conjuncts_of_column_and_constant_become_filters():
    """Q6's predicate is five column-constant comparisons under AND: five
    OP_FILT words and nothing else, and its key-free program is ten
    words in all; x - 0 and x * 1 in Q1's key vanish."""
    spec = sa.compile_spec([_q6_pred(TE, tt)], None, [_price_disc(TE, tt)])
    words, _depth, _ = sa.kernel_code(spec)
    ops = [w & 0xff for w in words]
    assert ops[:4] == [sa.OP_FILT + o for o in (
        sa.OP_GE, sa.OP_LT, sa.OP_GE, sa.OP_LE)]
    assert sa.OP_PASS not in ops and ops[4] == sa.OP_ANY
    words, _depth, _ = sa.kernel_code(_file_specs()["q1 shape"])
    ops = [w & 0xff for w in words]
    key = ops[ops.index(sa.OP_FILT + sa.OP_LE) + 1:ops.index(sa.OP_KEY)]
    assert key == [sa.OP_COL, sa.OP_COL, sa.OP_K + sa.OP_MUL, sa.OP_ADD]
    vals = ops[ops.index(sa.OP_ANY) + 1:ops.index(sa.OP_ACCN)]
    assert vals == [sa.OP_GCOL] * 4 + [sa.OP_MUL]


@pytest.mark.parametrize("name", sorted(_file_specs()))
def test_staged_and_gathered_classes_are_spec_bytes_classes(name):
    """Predicate and key slots are staged (spec_bytes charges them for
    every visible or keyed row); value-only slots are gathered (charged
    for counted rows only), and only staged slots get a stage offset."""
    spec = _file_specs()[name]
    staged, gathered = sa.column_classes(spec)
    pred = sa._program_slots(spec, spec.pred)
    key = sa._program_slots(spec, spec.key)
    assert set(staged) == pred | key
    assert set(gathered) == set(range(len(spec.cols))) - pred - key
    plan = sa.launch_plan(spec, [8] * len(spec.cols), False)
    assert {i for i, o in enumerate(plan.col_smem) if o >= 0} == set(staged)


def test_spec_bytes_charges_gathered_columns_per_counted_sector():
    """The bytes case's value-only column is gathered, and spec_bytes
    charges it two sectors (rows 0 and 40), not its 64 rows."""
    cols, spec = _bytes_case()
    staged, gathered = sa.column_classes(spec)
    assert [spec.cols[i] for i in staged] == [0]
    assert [spec.cols[i] for i in gathered] == [1]
    nrows = torch.tensor([64], dtype=torch.int64)
    xmin = torch.tensor([[1]], dtype=torch.int64)
    xmax = torch.tensor([[2**62]], dtype=torch.int64)
    full = sa.spec_bytes(cols, xmin, xmax, nrows, 5, spec)
    assert full - (512 + 16 + 8 + 16) == 2 * sa.SECTOR


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("width", [1, 4, 8])
def test_launch_plan_fits_shared_memory_for_the_largest_spec(width, full):
    spec = _widest_spec()
    plan = sa.launch_plan(spec, [width] * 16, full)
    assert plan.smem_bytes <= sa.SMEM_BLOCK_MAX
    assert plan.stages >= 2 and plan.tile == sa.THREADS * plan.rows
    assert plan.tile % 16 == 0 and plan.depth == 16
    assert (plan.depth, plan.rows) in sa.VARIANTS
    staged = 16 * width + (16 if full else 0)
    assert plan.stage_bytes >= plan.tile * staged
    lanes = 16 * 9
    acc = lanes * (sa.THREADS if plan.acc_private else sa.THREADS // 32)
    assert (sa.SMEM_HEAD + plan.stages * plan.stage_bytes + acc * 8
            == plan.smem_bytes)
    # stages and the regions inside them stay 16-byte aligned
    assert plan.stage_bytes % 128 == 0
    assert all(o % 128 == 0 for o in plan.col_smem if o >= 0)


def test_launch_plan_q6_and_q1_share_a_multiprocessor():
    """Q6's and Q1's shapes run tiles of 2048 rows, two blocks to a
    multiprocessor (lineitem's widths: int64 discount, price and
    quantity, int32 ship date, return flag and line status)."""
    specs = {"q6": sa.compile_spec([_q6_pred(TE, tt)], None,
                                   [_price_disc(TE, tt)]),
             "q1": _file_specs()["q1 shape"]}
    width = {0: 8, 1: 8, 2: 4, 3: 8, 4: 4, 5: 4}
    for name, spec in specs.items():
        widths = [width[c] for c in spec.cols]
        plan = sa.launch_plan(spec, widths, False)
        assert plan.tile == 2048, name
        assert plan.smem_bytes <= sa.SMEM_HALF_SM, name


def tile_schedule(nrows, visible, tile: int, tiles_per_shard: int,
                  grid: int) -> list:
    """The kernel's walk over the tiles (csrc/scan_agg.cu next_tile),
    mirrored: per block, the (shard, first row, end row) of each tile it
    evaluates. Block b
    takes flat tiles b, b + grid, ... of S x tiles_per_shard; a tile at
    or past its shard's nrows, or of an invisible shard, is skipped."""
    S = len(nrows)
    out = []
    for b in range(grid):
        mine = []
        t = b
        while t < S * tiles_per_shard:
            s, j = divmod(t, tiles_per_shard)
            n = int(nrows[s]) if visible[s] else 0
            if j * tile < n:
                mine.append((s, j * tile, min((j + 1) * tile, n)))
                t += grid
            else:  # on to the block's first tile of the next shard
                nxt = (s + 1) * tiles_per_shard
                t = nxt + (b - nxt) % grid
        out.append(mine)
    return out


SCHEDULES = {
    "ragged shards": ([65413, 0, 40000], [1, 1, 1], 2048, 264),
    "short shards": ([100, 0, 1], [1, 1, 1], 2048, 264),
    "one invisible shard": ([5000, 7000, 9000], [1, 0, 1], 512, 7),
    "tile multiples": ([4096, 8192], [1, 1], 2048, 3),
    "more blocks than tiles": ([3000], [1], 1024, 50),
    "one block": ([70000, 123, 0, 33], [1, 1, 1, 1], 256, 1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_tile_schedule_covers_every_row_once(name):
    nrows, visible, tile, grid = SCHEDULES[name]
    rmax = 1 << 17
    tps = -(-rmax // tile)
    sched = tile_schedule(nrows, visible, tile, tps, grid)
    assert len(sched) == grid
    seen = [np.zeros(n, dtype=np.int64) for n in nrows]
    for b, tiles in enumerate(sched):
        for s, r0, r1 in tiles:
            assert r0 % tile == 0 and 0 < r1 - r0 <= tile
            assert (s * tps + r0 // tile) % grid == b  # the block's stride
            seen[s][r0:r1] += 1
    for s, n in enumerate(nrows):
        want = 1 if visible[s] else 0
        assert (seen[s] == want).all()


def test_decode_program_fills_what_each_word_reads():
    """The records the kernel runs: a filter carries its column's stage
    offset and type and its constant (32-bit compare for an int32 column
    and a constant within int32, not for an int64 column or a constant
    beyond int32); a gathered load carries the plane's address; the
    accumulate word carries the number of values."""
    ship = TE.Col(2, tt.INT4)
    pred = TE.BinE(
        "and",
        TE.BinE("and",
                TE.BinE(">=", ship, TE.Const(8766, tt.INT8), tt.BOOL),
                TE.BinE("<", ship, TE.Const(1 << 40, tt.INT8), tt.BOOL),
                tt.BOOL),
        TE.BinE("<=", TE.Col(0, tt.INT8), TE.Const(7, tt.INT8), tt.BOOL),
        tt.BOOL,
    )
    spec = sa.compile_spec([pred], None, [_price_disc(TE, tt)])
    words, _depth, _rows = sa.kernel_code(spec)
    dtypes = [0 if spec.cols[i] == 2 else 1 for i in range(len(spec.cols))]
    plan = sa.launch_plan(spec, [4 if d == 0 else 8 for d in dtypes], False)
    addrs = [0x1000 * (i + 1) for i in range(len(spec.cols))]
    recs = sa.decode_program(words, spec.consts, plan.col_smem, dtypes,
                             addrs)
    assert len(recs) == len(words)
    by_op = [(r[0], r) for r in recs]
    filt = [r for op, r in by_op if op >= sa.OP_FILT]
    assert [(r[0] - sa.OP_FILT, r[3], r[4]) for r in filt] == [
        (sa.OP_GE, 0 | sa.NARROW, 8766), (sa.OP_LT, 0, 1 << 40),
        (sa.OP_LE, 1, 7)]
    ship_slot = spec.cols.index(2)
    assert {r[2] for r in filt[:2]} == {plan.col_smem[ship_slot]}
    price = spec.cols.index(1)
    (gcol,) = [r for op, r in by_op if op == sa.OP_GCOL]
    assert plan.col_smem[price] == -1 and gcol[4] == addrs[price]
    assert recs[-1][:1] == (sa.OP_ACCN,) and recs[-1][3] == 1

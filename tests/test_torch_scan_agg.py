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

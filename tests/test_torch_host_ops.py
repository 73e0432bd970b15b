"""The host executor's device operators against the reference's jnp
functions, on the same seeded numpy inputs, exactly: the multi-key
stable sort (``ops/sort.order_indices``: NaN and NULL keys, ASC and DESC
under NULLS FIRST, LAST and the default, a live mask), and the join
primitives of ``ops/join.py`` (``encode_keys`` over integer, float and
NULL keys; ``match_counts``; ``emit_pairs`` inner and outer, with empty
sides and int64 offsets; ``probe_radix_bounds`` and
``radix_match_counts``, the overflow flag included), plus the extended
``compact_indices`` / ``gather_cols`` contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentenbase_tpu.ops import filter as ref_filter
from opentenbase_tpu.ops import join as ref_join
from opentenbase_tpu.ops import sort as ref_sort
from opentenbase_tpu_torch.ops import filter as port_filter
from opentenbase_tpu_torch.ops import join as port_join
from opentenbase_tpu_torch.ops import sort as port_sort
from opentenbase_tpu_torch.plan import batchplan

N = 700


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _pair(a):
    """The same numpy array as a jnp array and a torch tensor."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _key(rng, kind):
    if kind == "int":
        return rng.integers(-6, 6, N).astype(np.int64)
    if kind == "int32":
        return rng.integers(-(2**31), 2**31 - 1, N).astype(np.int32)
    if kind == "bool":
        return rng.random(N) > 0.5
    d = rng.choice([-1.5, -0.0, 0.0, 2.25, np.nan, np.inf, 7.0], N)
    return d.astype(np.float32 if kind == "float32" else np.float64)


@pytest.mark.parametrize("nulls_first", [None, True, False])
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("kind", ["int", "int32", "bool", "float32",
                                  "float64"])
def test_order_indices_matches_reference(kind, desc, nulls_first):
    rng = np.random.default_rng(hash((kind, desc, nulls_first)) % 2**31)
    k1 = _key(rng, kind)
    v1 = rng.random(N) > 0.2
    k2 = rng.integers(0, 4, N).astype(np.int64)
    mask = rng.random(N) > 0.1
    rk1, pk1 = _pair(k1)
    rv1, pv1 = _pair(v1)
    rk2, pk2 = _pair(k2)
    rm, pm = _pair(mask)
    want = ref_sort.order_indices(
        [(rk2, None, False, None), (rk1, rv1, desc, nulls_first)], rm)
    got = port_sort.order_indices(
        [(pk2, None, False, None), (pk1, pv1, desc, nulls_first)], pm)
    assert _np(got).tolist() == _np(want).tolist()
    # one key, no mask, no NULLs
    assert _np(port_sort.order_indices([(pk1, None, desc, None)])).tolist() \
        == _np(ref_sort.order_indices([(rk1, None, desc, None)])).tolist()


def _join_keys(rng, nb, npr, kinds):
    """Build and probe key columns (data, valid) per kind, probes drawn
    half from the build side's values."""
    bk, pk = [], []
    for kind in kinds:
        b = _key(rng, kind)[:nb] if nb <= N else None
        p = _key(rng, kind)[:npr]
        if nb and npr:
            take = rng.integers(0, nb, npr // 2)
            p[: len(take)] = b[take]
        bk.append((b, rng.random(nb) > 0.1))
        pk.append((p, rng.random(npr) > 0.1))
    return bk, pk


@pytest.mark.parametrize("kinds", [("int",), ("int", "float64"),
                                   ("float32",), ("int32", "int")],
                         ids=lambda k: "+".join(k))
def test_encode_and_match_counts_match_reference(kinds):
    rng = np.random.default_rng(len(kinds) * 7 + len(kinds[0]))
    nb, npr = 300, 500
    bk, pk = _join_keys(rng, nb, npr, kinds)
    bm, pm = rng.random(nb) > 0.05, rng.random(npr) > 0.05
    r_ids = ref_join.encode_keys(
        [(jnp.asarray(d), jnp.asarray(v)) for d, v in bk],
        [(jnp.asarray(d), jnp.asarray(v)) for d, v in pk],
        jnp.asarray(bm), jnp.asarray(pm))
    p_ids = port_join.encode_keys(
        [(torch.from_numpy(d), torch.from_numpy(v)) for d, v in bk],
        [(torch.from_numpy(d), torch.from_numpy(v)) for d, v in pk],
        torch.from_numpy(bm), torch.from_numpy(pm))
    for r, p in zip(r_ids, p_ids):
        assert _np(p).tolist() == _np(r).tolist()
    want = ref_join.match_counts(*r_ids)
    got = port_join.match_counts(*p_ids)
    for r, p in zip(want, got):
        assert _np(p).tolist() == _np(r).tolist()
    assert int(got[3]) > 0


def _counts_case(rng, nb, npr):
    b_ids = rng.integers(0, 40, nb).astype(np.int32)
    p_ids = rng.integers(0, 60, npr).astype(np.int32)
    return b_ids, p_ids


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("sizes", [(200, 300), (0, 50), (50, 0), (0, 0)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_emit_pairs_matches_reference(sizes, outer):
    rng = np.random.default_rng(sum(sizes) + outer)
    b_ids, p_ids = _counts_case(rng, *sizes)
    rb, pb = _pair(b_ids)
    rp, pp = _pair(p_ids)
    r_bo, r_lo, r_cnt, r_tot = ref_join.match_counts(rb, rp)
    p_bo, p_lo, p_cnt, p_tot = port_join.match_counts(pb, pp)
    total = int(p_tot) + (int((_np(p_cnt) == 0).sum()) if outer else 0)
    assert int(r_tot) == int(p_tot)
    out_size = max(16, 1 << max(total - 1, 0).bit_length())
    want = ref_join.emit_pairs(r_bo, r_lo, r_cnt, out_size, outer)
    got = port_join.emit_pairs(p_bo, p_lo, p_cnt, out_size, outer)
    for r, p in zip(want, got):
        assert _np(p).tolist() == _np(r).tolist()


def test_emit_pairs_int64_offsets():
    """tests/test_join_device.py's shape: three probe rows each claiming
    2^30 matches; an int32 prefix sum would wrap at the third."""
    counts = np.full(3, 2**30, np.int32)
    lo = np.zeros(3, np.int32)
    order = np.zeros(8, np.int32)
    want = ref_join.emit_pairs(jnp.asarray(order), jnp.asarray(lo),
                               jnp.asarray(counts), 16)
    got = port_join.emit_pairs(torch.from_numpy(order),
                               torch.from_numpy(lo),
                               torch.from_numpy(counts), 16)
    assert _np(got[0]).tolist() == [0] * 16
    assert bool(_np(got[2]).all()) and bool(_np(got[3]).all())
    for r, p in zip(want, got):
        assert _np(p).tolist() == _np(r).tolist()


@pytest.mark.parametrize("case", ["dense", "spread", "dups", "overflow"])
def test_radix_bounds_and_counts_match_reference(case):
    rng = np.random.default_rng(len(case))
    nb, npr = 400, 900
    if case == "dense":
        bk = np.arange(nb, dtype=np.int64)
    elif case == "spread":
        bk = rng.integers(-(2**62), 2**62, nb).astype(np.int64)
    else:
        bk = rng.integers(0, 60, nb).astype(np.int64)
    pk = np.concatenate([bk[rng.integers(0, nb, npr - 100)],
                         rng.integers(-(10**9), 10**9, 100)])
    breal = rng.random(nb) > 0.1
    preal = rng.random(npr) > 0.1
    plan = batchplan.plan_radix_join(nb, npr,
                                     batchplan.DEFAULT_EXCHANGE_BUDGET)
    bucket = 8 if case == "overflow" else plan.bucket
    r_args = [jnp.asarray(x) for x in (bk, breal, pk, preal)]
    p_args = [torch.from_numpy(x) for x in (bk, breal, pk, preal)]
    want = ref_join.radix_match_counts(*r_args, plan.partitions, bucket)
    got = port_join.radix_match_counts(*p_args, plan.partitions, bucket)
    assert bool(got[4]) == bool(want[4]) == (case == "overflow")
    for r, p in zip(want[:4], got[:4]):
        assert _np(p).tolist() == _np(r).tolist()
    # the bounds alone, over the reference's table
    tk, tv, _ti, _dup, _ovf = ref_join.build_radix_table(
        r_args[0], r_args[1], plan.partitions, bucket)
    rb = ref_join.probe_radix_bounds(tk, tv, r_args[2], r_args[3],
                                     plan.partitions, bucket)
    pb = port_join.probe_radix_bounds(
        torch.from_numpy(np.array(tk)), torch.from_numpy(np.array(tv)),
        p_args[2], p_args[3], plan.partitions, bucket)
    for r, p in zip(rb, pb):
        assert _np(p).tolist() == _np(r).tolist()


def test_join_mode_reads_the_environment(monkeypatch):
    monkeypatch.setenv("OTB_JOIN_MODE", "SortMerge")
    assert port_join.JOIN_MODE() == ref_join.JOIN_MODE() == "sortmerge"
    monkeypatch.delenv("OTB_JOIN_MODE")
    assert port_join.JOIN_MODE() == ref_join.JOIN_MODE() == "auto"


@pytest.mark.parametrize("out_size", [8, 64])
def test_compact_and_gather_to_a_static_size(out_size):
    rng = np.random.default_rng(out_size)
    mask = rng.random(40) > 0.6
    d = rng.integers(0, 100, 40)
    v = rng.random(40) > 0.2
    ridx, rvalid = ref_filter.compact_indices(jnp.asarray(mask), out_size)
    pidx, pvalid = port_filter.compact_indices(torch.from_numpy(mask),
                                               out_size)
    assert _np(pidx).tolist() == _np(ridx).tolist()
    assert _np(pvalid).tolist() == _np(rvalid).tolist()
    want = ref_filter.gather_cols(
        [(jnp.asarray(d), jnp.asarray(v)), (jnp.asarray(d), None)],
        ridx, rvalid)
    got = port_filter.gather_cols(
        [(torch.from_numpy(d), torch.from_numpy(v)),
         (torch.from_numpy(d), None)], pidx, pvalid)
    for (rd, rv), (gd, gv) in zip(want, got):
        assert _np(gd).tolist() == _np(rd).tolist()
        assert _np(gv).tolist() == _np(rv).tolist()

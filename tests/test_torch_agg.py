"""The port's sort-based grouping (ops/agg.py) against the reference's
jnp functions on the same seeded columns: ``group_ids`` against
``_group_ids_impl`` (the permutation, each row's group, the group
count), ``group_reduce`` against ``_group_reduce_impl`` for every spec,
and the fused DAG's grouping step (``_group_visible``: the visible rows
compacted, then one sort of the packed key, or one per key part)
against the reference's grouped mode over the whole plane (pack, sort,
invisible rows last, reduce). Cases: NULL keys, a mask with dead rows,
an all-dead mask, float keys holding -0.0, +0.0 and NaNs, a boolean key.
Exact: integer and boolean outputs compare equal, float outputs bit for
bit where valid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentenbase_tpu.executor import fused_dag as ref_dag
from opentenbase_tpu.ops import agg as ref_agg
from opentenbase_tpu_torch.executor import fused_dag as port_dag
from opentenbase_tpu_torch.ops import agg as port_agg

N = 3000
SPECS = ("sum", "count", "count_star", "min", "max", "any")


def _keys(kind, rng):
    """(data, valid) key columns for one case."""
    if kind == "int_nulls":
        return [(rng.integers(-3, 4, N).astype(np.int32), rng.random(N) > .2),
                (rng.integers(0, 5, N).astype(np.int64), None)]
    if kind == "float_zero_nan":
        f = rng.choice([-0.0, 0.0, 1.5, -2.25, np.nan, 1e300], N)
        f[rng.random(N) < 0.05] = -np.nan  # a NaN of the other sign
        return [(f.astype(np.float64), rng.random(N) > .1),
                (rng.choice([-0.0, 0.0, np.nan, 3.0], N).astype(np.float32),
                 None)]
    if kind == "bool_and_int":
        return [(rng.random(N) > .5, None),
                (rng.integers(-(2**40), 2**40, N) // 2**38,
                 rng.random(N) > .3)]
    raise ValueError(kind)


def _vals(rng):
    """(data, valid) per spec: int32, int64, float64 and bool values."""
    cols = [
        (rng.integers(-1000, 1000, N).astype(np.int32), rng.random(N) > .3),
        (rng.integers(-(10**12), 10**12, N).astype(np.int64), None),
        None,
        (rng.standard_normal(N), rng.random(N) > .2),
        (rng.random(N) > .5, rng.random(N) > .4),
        (rng.integers(0, 10**6, N).astype(np.int64), rng.random(N) > .5),
    ]
    return cols


def _mask(kind, rng):
    return {"dead": rng.random(N) > .35, "none": None,
            "all_dead": np.zeros(N, bool)}[kind]


def _jx(pair):
    d, v = pair
    return (jnp.asarray(d), None if v is None else jnp.asarray(v))


def _tx(pair):
    d, v = pair
    return (torch.from_numpy(np.ascontiguousarray(d)),
            None if v is None else torch.from_numpy(v.copy()))


CASES = [(k, m) for k in ("int_nulls", "float_zero_nan", "bool_and_int")
         for m in ("dead", "none", "all_dead")]


@pytest.mark.parametrize("kind,mask_kind", CASES)
def test_group_ids_and_reduce_match_reference(kind, mask_kind):
    rng = np.random.default_rng(CASES.index((kind, mask_kind)))
    keys, vals, mask = _keys(kind, rng), _vals(rng), _mask(mask_kind, rng)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    rperm, rseg, rng_ = ref_agg._group_ids_impl([_jx(k) for k in keys],
                                                jmask)
    pperm, pseg, png = port_agg.group_ids([_tx(k) for k in keys], tmask)
    assert int(png) == int(rng_)
    assert np.array_equal(pperm.numpy(), np.asarray(rperm))
    assert np.array_equal(pseg.numpy(), np.asarray(rseg))
    if mask_kind == "all_dead":
        assert int(png) == 0
    cap = 1 << max(int(png), 1).bit_length()
    rk, rv, rgv = ref_agg._group_reduce_impl(
        [_jx(k) for k in keys], [None if v is None else _jx(v) for v in vals],
        rperm, rseg, cap, SPECS)
    pk, pv, pgv = port_agg.group_reduce(
        [_tx(k) for k in keys], [None if v is None else _tx(v) for v in vals],
        pperm, pseg, cap, SPECS)
    gv = np.asarray(rgv)
    assert np.array_equal(pgv.numpy(), gv)
    for name, (wd, wv), (gd, gv_) in zip(
        [f"key{i}" for i in range(len(keys))] + list(SPECS),
        list(rk) + list(rv), list(pk) + list(pv),
    ):
        wv = np.asarray(wv)
        assert np.array_equal(gv_.numpy(), wv), name
        wd, gd = np.asarray(wd)[wv], gd.numpy()[wv]
        if wd.dtype.kind == "f":  # bit for bit, NaNs included
            wd, gd = wd.view(f"i{wd.itemsize}"), gd.view(f"i{gd.itemsize}")
        assert gd.dtype == wd.dtype, name
        assert np.array_equal(gd, wd), name


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_float_key_parts_match_reference(dt):
    rng = np.random.default_rng(5)
    f = rng.choice([-0.0, 0.0, 2.5, np.nan, -np.nan, np.inf, -1e300,
                    1e-310], N)
    with np.errstate(over="ignore"):  # -1e300 is -inf in float32
        f = f.astype(dt)
    want = ref_agg.float_key_parts(jnp.asarray(f))
    got = port_agg.float_key_parts(torch.from_numpy(f))
    assert len(got) == len(want) == (2 if dt == np.float64 else 1)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _ref_grouped(keys, vals, mask, cap, specs, packed):
    """The reference's grouped mode over the whole plane
    (fused_dag._compile_final): pack the keys, or sort per key part."""
    jk = [_jx(k) for k in keys]
    jm = jnp.asarray(mask)
    if packed:
        jp, ok = ref_dag._pack_group_keys(jk, jm)
        assert bool(ok)
        perm, seg, ng = ref_agg._group_ids_impl([(jp, None)], jm)
    else:
        perm, seg, ng = ref_agg._group_ids_impl(jk, jm)
    rk, rv, gv = ref_agg._group_reduce_impl(
        jk, [None if v is None else _jx(v) for v in vals], perm, seg, cap,
        specs)
    return rk, rv, gv, ng


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("mask_kind", ["dead", "none", "all_dead"])
def test_dag_grouping_matches_whole_plane(mask_kind, packed):
    """The visible rows compacted and grouped (packed integer and
    NULL-able keys, as the DAG packs them; or one sort per part): the
    same groups in the same order, the same count, the same reductions
    as the reference's sort of every row."""
    rng = np.random.default_rng(17)
    keys = [(rng.integers(1992, 1999, N).astype(np.int32), None),
            (rng.integers(0, 40, N).astype(np.int32), rng.random(N) > .1),
            (rng.integers(-5, 5, N).astype(np.int64), None)]
    vals = _vals(rng)
    mask = _mask(mask_kind, rng)
    mask = np.ones(N, bool) if mask is None else mask
    cap = 1024
    rk, rv, rgv, rng_ = _ref_grouped(keys, vals, mask, cap, SPECS, packed)
    pk, pv, pgv, png, ok = port_dag._group_visible(
        [_tx(k) for k in keys], [None if v is None else _tx(v) for v in vals],
        torch.from_numpy(mask), cap, SPECS, packed)
    assert (ok is not None) == packed and (ok is None or bool(ok))
    assert int(png) == int(rng_)
    gv = np.asarray(rgv)
    assert np.array_equal(pgv.numpy(), gv)
    for (wd, wv), (gd, gv_) in zip(list(rk) + list(rv), list(pk) + list(pv)):
        wv = np.asarray(wv)
        assert np.array_equal(gv_.numpy(), wv)
        wd, gd = np.asarray(wd)[wv], gd.numpy()[wv]
        if wd.dtype.kind == "f":
            wd, gd = wd.view(f"i{wd.itemsize}"), gd.view(f"i{gd.itemsize}")
        assert np.array_equal(gd, wd)


def test_packed_key_range_overflow_flags():
    """Two keys spanning 2^40 each: their packed range passes 2^62 and
    both packers clear ``ok``."""
    k = np.array([-(2**40), 0, 2**40] * 10, dtype=np.int64)
    mask = np.ones(len(k), bool)
    _jp, jok = ref_dag._pack_group_keys([(jnp.asarray(k), None)] * 2,
                                        jnp.asarray(mask))
    _tp, tok = port_dag._pack_group_keys(
        [(torch.from_numpy(k), None)] * 2, torch.from_numpy(mask))
    assert bool(tok) == bool(jok) is False

"""The radix hash join of the port against the reference: the torch murmur
hash against ``hash32_np``, ``build_radix_table`` against the reference's
(all seven scenarios of tests/test_join_device.py), the plain probe
against the reference's ``probe_radix_first`` and its Pallas probe in
interpret mode, and the multi-pass ``_lookup_radix`` against the
reference's sorted lookup. Inputs are made with numpy from a seed and
handed to both packages; the tolerance is exact equality (all of it is
integer work)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from opentenbase_tpu.executor import fused_dag as ref_dag
from opentenbase_tpu.ops import join as ref_join
from opentenbase_tpu.ops import pallas_join as ref_pj
from opentenbase_tpu.plan import batchplan as ref_batchplan
from opentenbase_tpu.utils.hashing import hash32_np
from opentenbase_tpu_torch.executor import fused_dag
from opentenbase_tpu_torch.ops import join as join_ops
from opentenbase_tpu_torch.ops import radix_probe as rp
from opentenbase_tpu_torch.plan import batchplan
from opentenbase_tpu_torch.utils.hashing import hash32_torch
from test_join_device import SCENARIOS


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def _seed(name: str) -> int:
    return sorted(SCENARIOS).index(name) * 1000 + 17


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------


def _hash_inputs():
    rng = np.random.default_rng(5)
    edge = np.array(
        [0, 1, -1, 2**31 - 1, -(2**31), 2**32, -(2**32), 2**62, -(2**62),
         2**63 - 1, -(2**63)], dtype=np.int64,
    )
    return {
        "int64": np.concatenate([
            rng.integers(-(2**63), 2**63 - 1, 20_000, dtype=np.int64), edge,
        ]),
        "int32": rng.integers(-(2**31), 2**31 - 1, 20_000).astype(np.int32),
        "bool": rng.random(1000) > 0.5,
        "yyyymmdd": (19920101 + rng.integers(0, 70_000, 5000)).astype(
            np.int32),
    }


@pytest.mark.parametrize("kind", sorted(_hash_inputs()))
def test_hash32_torch_bit_identical(kind):
    a = _hash_inputs()[kind]
    want = hash32_np(a).astype(np.int64)
    got = hash32_torch(_t(a)).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


def test_radix_parts_hash_the_int64_value():
    """An int32 key and the same value as int64 land in one partition,
    the one the host router (hash32_np) gives."""
    k32 = np.arange(-500, 500, dtype=np.int32) * 7919
    p32 = join_ops.radix_parts(_t(k32), 256).numpy()
    p64 = join_ops.radix_parts(_t(k32.astype(np.int64)), 256).numpy()
    assert np.array_equal(p32, p64)
    assert np.array_equal(p32, (hash32_np(k32) & 255).astype(np.int64))


# ---------------------------------------------------------------------------
# build_radix_table
# ---------------------------------------------------------------------------


def _plan(nb, npr):
    plan = batchplan.plan_radix_join(
        nb, npr, batchplan.DEFAULT_EXCHANGE_BUDGET
    )
    # the planner declines an empty build; the table handles it anyway
    return (plan.partitions, plan.bucket) if plan is not None else (1, 8)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_build_radix_table_equals_reference(name):
    rng = np.random.default_rng(_seed(name))
    bk, breal, pk, _preal = SCENARIOS[name](rng)
    P, B = _plan(len(bk), len(pk))
    assert (P, B) == (
        (lambda p: (p.partitions, p.bucket) if p else (1, 8))(
            ref_batchplan.plan_radix_join(
                len(bk), len(pk), ref_batchplan.DEFAULT_EXCHANGE_BUDGET
            )
        )
    )
    want = ref_join.build_radix_table(
        jnp.asarray(bk), jnp.asarray(breal), P, B
    )
    got = join_ops.build_radix_table(_t(bk), _t(breal), P, B)
    names = ("tkeys", "tvalid", "tbidx", "dup", "overflow")
    for n, w, g in zip(names, want, got):
        assert np.array_equal(_np(w), g.numpy()), (name, n)
        assert g.dtype == {
            "tkeys": torch.int64, "tvalid": torch.bool,
            "tbidx": torch.int32,
        }.get(n, torch.bool)


def test_build_radix_table_flags_fire():
    """The scenarios above include a duplicated key set and a skewed
    bucket: both flags must actually fire there."""
    for name, flag in (("duplicates", 3), ("skewed_build", 4)):
        rng = np.random.default_rng(_seed(name))
        bk, breal, pk, _ = SCENARIOS[name](rng)
        P, B = _plan(len(bk), len(pk))
        out = join_ops.build_radix_table(_t(bk), _t(breal), P, B)
        assert bool(out[flag]), name


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def _probe_case(seed: int, key_dtype=np.int64):
    """The reference probe test's data (tests/test_join_device.py:176)."""
    rng = np.random.default_rng(seed)
    nb, npr = 1500, 4000
    bk = (rng.permutation(np.arange(5000))[:nb] * 9 - 10**10).astype(
        np.int64
    )
    if key_dtype == np.int32:
        bk = (bk + 10**10).astype(np.int32)
    breal = rng.random(nb) > 0.1
    pk = np.concatenate([
        bk[rng.integers(0, nb, npr - 300)],
        rng.integers(-(10**9), 10**9, 300).astype(key_dtype),
    ]).astype(key_dtype)
    preal = rng.random(npr) > 0.1
    plan = batchplan.plan_radix_join(
        nb, npr, batchplan.DEFAULT_EXCHANGE_BUDGET
    )
    return bk, breal, pk, preal, plan.partitions, plan.bucket


def test_plain_probe_matches_reference_and_pallas_interpret():
    bk, breal, pk, preal, P, B = _probe_case(7)
    assert ref_pj.eligible(len(bk), P, B)
    tk, tv, ti, dup, ovf = ref_join.build_radix_table(
        jnp.asarray(bk), jnp.asarray(breal), P, B
    )
    assert not bool(dup) and not bool(ovf)
    m_x, b_x = ref_join.probe_radix_first(
        tk, tv, ti, jnp.asarray(pk), jnp.asarray(preal), P, B
    )
    m_p, b_p = ref_pj.probe_radix_pallas(
        tk, tv, ti, jnp.asarray(pk), jnp.asarray(preal), P, B,
        interpret=True,
    )
    m, bi = rp.radix_probe_plain(
        _t(tk), _t(tv), _t(ti), _t(pk), _t(preal), P, B
    )
    m, bi = m.numpy(), bi.numpy()
    m_x, m_p = _np(m_x), _np(m_p)
    assert m.any(), "the probe must actually hit"
    assert np.array_equal(m, m_x) and np.array_equal(m, m_p)
    assert np.array_equal(bi[m], _np(b_x)[m])
    assert np.array_equal(bi[m], _np(b_p)[m])
    assert not bi[~m].any(), "the plain probe writes 0 on a miss"


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_probe_radix_first_equals_reference(name):
    """The port's contract function equals the reference's everywhere,
    ``bidx`` on misses included; the wrapper (CPU: the plain version)
    equals it where matched and is 0 elsewhere."""
    rng = np.random.default_rng(_seed(name) + 1)
    bk, breal, pk, preal = SCENARIOS[name](rng)
    if len(pk) and len(bk):
        pk = pk.copy()
        pk[: len(pk) // 2] = bk[rng.integers(0, len(bk), len(pk) // 2)]
    P, B = _plan(len(bk), len(pk))
    table = ref_join.build_radix_table(
        jnp.asarray(bk), jnp.asarray(breal), P, B
    )[:3]
    want_m, want_b = ref_join.probe_radix_first(
        *table, jnp.asarray(pk), jnp.asarray(preal), P, B
    )
    tt = [_t(x) for x in table]
    m, bi = join_ops.probe_radix_first(*tt, _t(pk), _t(preal), P, B)
    assert np.array_equal(m.numpy(), _np(want_m))
    assert np.array_equal(bi.numpy(), _np(want_b))
    n0 = rp.radix_probe.launches
    wm, wb = rp.radix_probe(*tt, _t(pk), _t(preal), P, B)
    assert rp.radix_probe.launches == n0, "the CPU runs no kernel"
    assert np.array_equal(wm.numpy(), m.numpy())
    assert np.array_equal(wb.numpy(), np.where(m.numpy(), bi.numpy(), 0))


def test_int32_probe_keys_match_int64():
    bk, breal, pk, preal, P, B = _probe_case(9, np.int32)
    tk, tv, ti, _d, _o = join_ops.build_radix_table(
        _t(bk), _t(breal), P, B
    )
    m32, b32 = rp.radix_probe(tk, tv, ti, _t(pk), _t(preal), P, B)
    m64, b64 = rp.radix_probe(
        tk, tv, ti, _t(pk.astype(np.int64)), _t(preal), P, B
    )
    assert m32.any()
    assert torch.equal(m32, m64) and torch.equal(b32, b64)


def test_wrapper_checks_its_arguments():
    bk, breal, pk, preal, P, B = _probe_case(3)
    tk, tv, ti, _d, _o = join_ops.build_radix_table(
        _t(bk), _t(breal), P, B
    )
    with pytest.raises(TypeError):
        rp.radix_probe(tk, tv, ti.long(), _t(pk), _t(preal), P, B)
    with pytest.raises(ValueError):
        rp.radix_probe(tk, tv, ti, _t(pk), _t(preal), P, B + 1)
    with pytest.raises(ValueError):
        rp.radix_probe(tk, tv, ti, _t(pk), _t(preal), P + 1, B)
    with pytest.raises(TypeError):
        rp.radix_probe(tk, tv, ti, _t(pk).double(), _t(preal), P, B)


# ---------------------------------------------------------------------------
# the kernel's host side: 16-byte access, ragged and offset probes
# ---------------------------------------------------------------------------


def test_vector_access_needs_every_array_aligned():
    """16-byte accesses only where every row array starts on a 16-byte
    boundary: a probe that starts at an offset view takes per-row
    accesses."""
    pk = torch.zeros(1000, dtype=torch.int32)
    real = torch.zeros(1000, dtype=torch.bool)
    assert rp.vector_ok(pk, real)
    assert not rp.vector_ok(pk[3:], real[3:])
    assert not rp.vector_ok(pk, real[5:])
    assert rp.vector_ok(pk[4:], real[16:])


EDGES = {
    "ragged n": (0, 80_003),
    "offset view": (3, 4000),
    "offset view, ragged n": (5, 70_001),
    "n below one warp's rows": (0, 300),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_wrapper_on_ragged_and_offset_probes_equals_contract(name):
    """The probe shapes the kernel handles apart from its 16-byte path
    (n not a multiple of 512 rows, views that start at an offset) give
    ``probe_radix_first``'s answer, bidx 0 on a miss."""
    start, n = EDGES[name]
    bk, breal, pk, preal, P, B = _probe_case(13, np.int32)
    reps = -(-(start + n) // len(pk))
    pk = _t(np.tile(pk, reps))[start:start + n]
    preal = _t(np.tile(preal, reps))[start:start + n]
    table = join_ops.build_radix_table(_t(bk), _t(breal), P, B)[:3]
    m, bi = rp.radix_probe(*table, pk, preal, P, B)
    want_m, want_b = join_ops.probe_radix_first(*table, pk, preal, P, B)
    assert m.shape == (n,) and m.any()
    assert torch.equal(m, want_m)
    assert torch.equal(bi, torch.where(want_m, want_b, 0))


# ---------------------------------------------------------------------------
# the DAG's radix lookup, single- and multi-pass
# ---------------------------------------------------------------------------


def test_multipass_lookup_radix_matches_reference_lookup():
    """tests/test_join_device.py:239's data: a budget small enough to
    split the build side into several passes."""
    rng = np.random.default_rng(3)
    nb, npr = 4000, 9000
    bk = (rng.permutation(np.arange(20000))[:nb]).astype(np.int64)
    pk = np.concatenate([
        bk[rng.integers(0, nb, npr - 500)],
        rng.integers(30000, 60000, 500),
    ]).astype(np.int64)
    bmask = rng.random(nb) > 0.2
    pmask = rng.random(npr) > 0.2
    want = ref_dag._lookup(
        (jnp.asarray(pk), None), jnp.asarray(pmask),
        (jnp.asarray(bk), None), jnp.asarray(bmask), check_dup=True,
    )
    plan = None
    budget = 37_500
    while plan is None:
        budget *= 2
        plan = batchplan.plan_radix_join(nb, npr, budget)
    assert plan.passes > 1, plan
    got = fused_dag._lookup_radix(
        (_t(pk), None), _t(pmask), (_t(bk), None), _t(bmask), budget,
        fused_dag._lookup,
    )
    single = fused_dag._lookup(
        (_t(pk), None), _t(pmask), (_t(bk), None), _t(bmask),
        check_dup=True,
    )
    assert not bool(got[2]) and not bool(_np(want[2]))
    m = _np(want[0])
    assert m.any()
    for port in (got, single):
        assert np.array_equal(port[0].numpy(), m)
        assert np.array_equal(port[1].numpy()[m], _np(want[1])[m])


def test_lookup_radix_flags_duplicates_across_passes():
    """A key present in two build chunks matches in two passes: the
    flag must fire (the DAG then retries with sort-merge)."""
    rng = np.random.default_rng(4)
    bk = rng.permutation(np.arange(4000)).astype(np.int64)
    bk[3999] = bk[0]  # first and last chunk share a key
    pk = bk[rng.integers(0, 4000, 6000)]
    budget = 37_500
    plan = None
    while plan is None:
        budget *= 2
        plan = batchplan.plan_radix_join(4000, 6000, budget)
    assert plan.passes > 1
    ones = torch.ones
    got = fused_dag._lookup_radix(
        (_t(pk), None), ones(6000, dtype=torch.bool), (_t(bk), None),
        ones(4000, dtype=torch.bool), budget, fused_dag._lookup,
    )
    assert bool(got[2])


# ---------------------------------------------------------------------------
# the kernel, on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    for key_dtype in (np.int64, np.int32):
        bk, breal, pk, preal, P, B = _probe_case(11, key_dtype)
        tk, tv, ti, _d, _o = join_ops.build_radix_table(
            _t(bk).to(dev), _t(breal).to(dev), P, B
        )
        args = (tk, tv, ti, _t(pk).to(dev), _t(preal).to(dev), P, B)
        n0 = rp.radix_probe.launches
        km, kb = rp.radix_probe(*args)
        pm, pb = rp.radix_probe_plain(*args)
        torch.cuda.synchronize()
        assert rp.radix_probe.launches == n0 + 1
        assert km.any()
        assert torch.equal(km, pm) and torch.equal(kb, pb)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(EDGES))
def test_kernel_on_ragged_and_offset_probes_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    start, n = EDGES[name]
    bk, breal, pk, preal, P, B = _probe_case(13, np.int32)
    reps = -(-(start + n) // len(pk))
    pk = _t(np.tile(pk, reps)).to(dev)[start:start + n]
    preal = _t(np.tile(preal, reps)).to(dev)[start:start + n]
    table = join_ops.build_radix_table(_t(bk).to(dev), _t(breal).to(dev),
                                       P, B)[:3]
    km, kb = rp.radix_probe(*table, pk, preal, P, B)
    pm, pb = rp.radix_probe_plain(*table, pk, preal, P, B)
    torch.cuda.synchronize()
    assert torch.equal(km, pm) and torch.equal(kb, pb)

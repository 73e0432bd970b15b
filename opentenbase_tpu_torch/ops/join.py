"""Bucket-padded radix hash join, plain PyTorch (subset of the reference's
opentenbase_tpu/ops/join.py, the RADIX PATH).

For a single integer-family key the build side sorts ONCE by
(partition, key, row) into a [P, B] bucket-padded table (nodeHash.c's
bucketed table in the reference, shapes kept static by the bucket
quantum); each probe row then searches only its own bucket. The probe
itself has a hand-written kernel (ops/radix_probe.py); the functions here
are the contract it is held to.

The host executor's joins (executor/local.py) use the rest of the
reference's module: ``encode_keys`` replaces both sides' key tuples by
dense int32 ids (equal tuples equal ids, NULL and invisible rows
non-matching sentinels), ``match_counts`` gives each probe row its
contiguous match range [lo, lo + count) over the build side sorted by
id, and ``emit_pairs`` expands the ranges into (probe, build) row pairs
at a size the caller fixes, with int64 offsets, so the pairs stay exact
past 2^31. For a single integer-family key, ``radix_match_counts``
returns the same contract from the radix table (``probe_radix_bounds``),
so ``emit_pairs`` consumes either. These are torch ops, not a kernel:
the reference reaches no Pallas kernel on this path.
"""

from __future__ import annotations

import os

import torch

from opentenbase_tpu_torch.ops.agg import float_key_parts
from opentenbase_tpu_torch.utils.hashing import hash32_torch

_NO_MATCH_A = -2  # build-side NULL key or invisible row
_NO_MATCH_B = -3  # probe-side NULL key or invisible row


def JOIN_MODE() -> str:
    """The host executor's join formulation: 'auto' (radix for a single
    integer-family key), 'radix' or 'sortmerge', from ``OTB_JOIN_MODE``
    (read per call, so tests can force either path)."""
    return os.environ.get("OTB_JOIN_MODE", "auto").lower()


def _stable_order(k: torch.Tensor) -> torch.Tensor:
    return torch.sort(k, stable=True).indices


def encode_keys(build_keys, probe_keys, build_mask, probe_mask):
    """Jointly encode key tuples as dense int32 ids.

    build_keys/probe_keys: lists of (data, valid_or_None), equal arity,
    dtypes compatible pairwise; masks: visible rows or None. Returns
    (build_ids, probe_ids): equal tuples across the sides share an id;
    a row with a NULL key or outside its mask gets a sentinel that
    matches nothing. Float keys compare through ``float_key_parts``
    (-0.0 equal to 0.0, every NaN one value)."""
    nb = build_keys[0][0].shape[0]
    parts = []
    for (bd, _bv), (pd, _pv) in zip(build_keys, probe_keys):
        if bd.dtype.is_floating_point or pd.dtype.is_floating_point:
            target = torch.promote_types(bd.dtype, pd.dtype)
            pieces = zip(float_key_parts(bd.to(target)),
                         float_key_parts(pd.to(target)))
        else:
            pieces = [(bd, pd)]
        for bpart, ppart in pieces:
            parts.append(torch.cat([bpart.to(torch.int64),
                                    ppart.to(torch.int64)]))
    n = parts[0].shape[0]
    dev = parts[0].device
    perm = torch.arange(n, device=dev)
    for d in reversed(parts):
        perm = perm[_stable_order(d[perm])]
    boundary = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        boundary[0] = True
    for d in parts:
        ds = d[perm]
        boundary[1:] |= ds[1:] != ds[:-1]
    seg = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    ids[perm] = seg  # a permutation: every position written once
    build_ids, probe_ids = ids[:nb], ids[nb:]
    bnull = torch.zeros(nb, dtype=torch.bool, device=dev)
    pnull = torch.zeros(n - nb, dtype=torch.bool, device=dev)
    for (_bd, bv), (_pd, pv) in zip(build_keys, probe_keys):
        if bv is not None:
            bnull = bnull | ~bv
        if pv is not None:
            pnull = pnull | ~pv
    if build_mask is not None:
        bnull = bnull | ~build_mask
    if probe_mask is not None:
        pnull = pnull | ~probe_mask
    build_ids = torch.where(bnull, _NO_MATCH_A, build_ids)
    probe_ids = torch.where(pnull, _NO_MATCH_B, probe_ids)
    return build_ids.to(torch.int32), probe_ids.to(torch.int32)


def match_counts(build_ids, probe_ids):
    """Sort the build ids; per probe row its match range [lo, lo+count).
    Returns (build_order int32, lo int32, counts int32, total 0-d int64)."""
    build_order = _stable_order(build_ids)
    sorted_ids = build_ids[build_order]
    lo = torch.searchsorted(sorted_ids, probe_ids)
    hi = torch.searchsorted(sorted_ids, probe_ids, right=True)
    counts = (hi - lo).to(torch.int32)
    total = torch.sum(counts, dtype=torch.int64)
    return (build_order.to(torch.int32), lo.to(torch.int32), counts,
            total)


def emit_pairs(build_order, lo, counts, out_size: int, outer: bool = False):
    """Expand match ranges into row-index pairs at ``out_size`` lanes.

    Returns (probe_idx, build_idx, matched, valid): gather indices into
    the uncompacted probe and build batches (build_idx 0 where not
    matched); ``matched[j]`` the pair is a real key match (False on the
    null-extended row an outer join emits for a probe row without one);
    ``valid[j]`` lane j is a real output row. The offsets are int64
    prefix sums: an int32 sum wraps past 2^31 pairs."""
    dev = counts.device
    npr, nb = counts.shape[0], build_order.shape[0]
    if npr == 0 or nb == 0:
        z32 = torch.zeros(out_size, dtype=torch.int32, device=dev)
        zb = torch.zeros(out_size, dtype=torch.bool, device=dev)
        if npr > 0 and outer:
            # no build rows: every probe row still null-extends once
            lanes = torch.arange(out_size, device=dev)
            probe_idx = torch.clamp(lanes, 0, npr - 1).to(torch.int32)
            return probe_idx, z32, zb, lanes < npr
        return z32, z32, zb, zb
    eff = (torch.clamp(counts, min=1) if outer else counts).to(torch.int64)
    offsets = torch.cumsum(eff, 0) - eff  # exclusive prefix sum
    total = offsets[-1] + eff[-1]
    j = torch.arange(out_size, dtype=torch.int64, device=dev)
    # the probe row of lane j: the last i with offsets[i] <= j
    probe_idx = torch.clamp(
        torch.searchsorted(offsets, j, right=True) - 1, 0, npr - 1)
    k = j - offsets[probe_idx]
    cnt_j = counts[probe_idx].to(torch.int64)
    matched = k < cnt_j
    pos = lo[probe_idx].to(torch.int64) + torch.minimum(
        k, torch.clamp(cnt_j - 1, min=0))
    build_idx = build_order[torch.clamp(pos, 0, nb - 1)]
    build_idx = torch.where(matched, build_idx, 0).to(torch.int32)
    return probe_idx.to(torch.int32), build_idx, matched, j < total


def radix_parts(keys: torch.Tensor, partitions: int) -> torch.Tensor:
    """Radix partition of each key (int64): the murmur mix of the key
    widened to int64, masked to the power-of-two partition count — the
    same hash the host router uses (utils/hashing.hash32_np)."""
    return hash32_torch(keys.to(torch.int64)) & (partitions - 1)


def build_radix_table(build_key, build_real, partitions: int, bucket: int):
    """Bucket-padded hash table over the build side.

    ``build_key``: integer-family key column; ``build_real``: the row
    participates (visible AND key non-NULL). Returns (tkeys [P*B+1]
    int64, tvalid [P*B+1] bool, tbidx [P*B+1] int32, dup 0-d bool,
    overflow 0-d bool):

    - slot p*B+r holds the r-th smallest real key of partition p (one
      sort by (partition, key, row): ranks in key order, ties in row
      order), and its row in ``tbidx``; the valid slots of a bucket are
      a prefix of it;
    - the trailing slot is a dump for dead and overflowed rows; it holds
      the last such row in sorted order (the reference's scatter, where
      the last write wins) and is never valid;
    - ``dup``: two real build rows share a key;
    - ``overflow``: some partition holds more than ``bucket`` real rows,
      so the table dropped rows and the caller must not use it."""
    nb = build_key.shape[0]
    dev = build_key.device
    P, B = partitions, bucket
    key64 = build_key.to(torch.int64)
    part = torch.where(
        build_real, radix_parts(key64, P), torch.full_like(key64, P)
    )  # dead rows route past every real partition
    # (partition, key, row) order from two stable sorts: rows start in
    # row order, the key sort keeps it among equal keys, the partition
    # sort keeps (key, row) order inside each partition
    order = torch.argsort(key64, stable=True)
    order = order[torch.argsort(part[order], stable=True)]
    spart, skey = part[order], key64[order]
    sreal = spart < P
    # rank within partition = sorted position - the partition's start
    counts = torch.bincount(spart, minlength=P + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(nb, dtype=torch.int64, device=dev)
    rank = pos_sorted - starts[spart]
    if nb > 1:
        dup = torch.any(
            sreal[1:] & sreal[:-1]
            & (spart[1:] == spart[:-1]) & (skey[1:] == skey[:-1])
        )
    else:
        dup = torch.zeros((), dtype=torch.bool, device=dev)
    overflow = torch.any(sreal & (rank >= B))
    slot_ok = sreal & (rank < B)
    n_slots = P * B + 1
    tkeys = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    tvalid = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    tbidx = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    slots = (spart * B + rank)[slot_ok]
    tkeys[slots] = skey[slot_ok]
    tvalid[slots] = True
    tbidx[slots] = order[slot_ok].to(torch.int32)
    if nb:
        last = torch.amax(torch.where(slot_ok, -1, pos_sorted))
        has = last >= 0
        at = last.clamp(min=0)
        tkeys[P * B] = torch.where(has, skey[at], 0)
        tbidx[P * B] = torch.where(has, order[at].to(torch.int32), 0)
    return tkeys, tvalid, tbidx, dup, overflow


def _bucket_bound(tkeys, tvalid, base, key, bucket: int,
                  side: str = "left"):
    """Per probe row, the first slot offset in [0, bucket] whose key is
    >= (``side`` 'left') or > ('right') the probe key: a binary search
    over the bucket in which invalid (padding) slots compare as
    +infinity — they only trail the valid ones, so the order stays
    total."""
    n = key.shape[0]
    lo = torch.zeros(n, dtype=torch.int64, device=key.device)
    hi = torch.full((n,), bucket, dtype=torch.int64, device=key.device)
    for _ in range(max(int(bucket).bit_length(), 1)):
        active = lo < hi
        mid = (lo + hi) >> 1
        at = base + mid
        v = tkeys[at]
        go = tvalid[at] & ((v < key) if side == "left" else (v <= key))
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


def probe_radix_bounds(tkeys, tvalid, probe_key, probe_real,
                       partitions: int, bucket: int):
    """Per probe row, the contiguous table range [lo, lo + count) of the
    matching build slots: ``match_counts``'s contract over the table, so
    ``emit_pairs`` consumes either. Returns (lo int32, counts int32)."""
    P, B = partitions, bucket
    key64 = probe_key.to(torch.int64)
    base = radix_parts(key64, P) * B
    lo_rel = _bucket_bound(tkeys, tvalid, base, key64, B, "left")
    hi_rel = _bucket_bound(tkeys, tvalid, base, key64, B, "right")
    counts = torch.where(probe_real, hi_rel - lo_rel, 0)
    return (base + lo_rel).to(torch.int32), counts.to(torch.int32)


def radix_match_counts(build_key, build_real, probe_key, probe_real,
                       partitions: int, bucket: int):
    """The radix counterpart of ``encode_keys`` + ``match_counts`` for a
    single integer-family key: (build_order, lo, counts, total,
    overflow). The first three feed ``emit_pairs`` unchanged; a True
    ``overflow`` (0-d bool) means a bucket overfilled and the result is
    unusable: the caller retries with a bigger bucket or the sort
    path."""
    tkeys, tvalid, tbidx, _dup, overflow = build_radix_table(
        build_key, build_real, partitions, bucket)
    lo, counts = probe_radix_bounds(tkeys, tvalid, probe_key, probe_real,
                                    partitions, bucket)
    total = torch.sum(counts, dtype=torch.int64)
    return tbidx, lo, counts, total, overflow


def probe_radix_first(
    tkeys, tvalid, tbidx, probe_key, probe_real, partitions: int,
    bucket: int,
):
    """Existence probe for a unique build side: (matched [n] bool, bidx
    [n] int32 row of the table's build side). One lower-bound search in
    the probe row's bucket and two gathers. On a miss ``bidx`` is the
    table entry the search stopped at, as in the reference."""
    P, B = partitions, bucket
    key64 = probe_key.to(torch.int64)
    base = radix_parts(key64, P) * B
    lo_rel = _bucket_bound(tkeys, tvalid, base, key64, B, "left")
    at = torch.clamp(base + lo_rel, max=P * B)  # lo_rel == B: full miss
    hit = (lo_rel < B) & tvalid[at] & (tkeys[at] == key64) & probe_real
    return hit, tbidx[at]

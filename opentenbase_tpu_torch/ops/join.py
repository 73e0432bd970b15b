"""Bucket-padded radix hash join, plain PyTorch (subset of the reference's
opentenbase_tpu/ops/join.py, the RADIX PATH).

For a single integer-family key the build side sorts ONCE by
(partition, key, row) into a [P, B] bucket-padded table (nodeHash.c's
bucketed table in the reference, shapes kept static by the bucket
quantum); each probe row then searches only its own bucket. The probe
itself has a hand-written kernel (ops/radix_probe.py); the functions here
are the contract it is held to.
"""

from __future__ import annotations

import torch

from opentenbase_tpu_torch.utils.hashing import hash32_torch


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


def _bucket_bound(tkeys, tvalid, base, key, bucket: int):
    """Per probe row, the first slot offset in [0, bucket] whose key is
    >= the probe key: a binary search over the bucket in which invalid
    (padding) slots compare as +infinity — they only trail the valid
    ones, so the order stays total."""
    n = key.shape[0]
    lo = torch.zeros(n, dtype=torch.int64, device=key.device)
    hi = torch.full((n,), bucket, dtype=torch.int64, device=key.device)
    for _ in range(max(int(bucket).bit_length(), 1)):
        active = lo < hi
        mid = (lo + hi) >> 1
        at = base + mid
        go = tvalid[at] & (tkeys[at] < key)
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


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
    lo_rel = _bucket_bound(tkeys, tvalid, base, key64, B)
    at = torch.clamp(base + lo_rel, max=P * B)  # lo_rel == B: full miss
    hit = (lo_rel < B) & tvalid[at] & (tkeys[at] == key64) & probe_real
    return hit, tbidx[at]

"""Aggregation over masked columns, plain PyTorch (the reference's
opentenbase_tpu/ops/agg.py: the ungrouped reduce, the sort-based
grouping and the hash-addressed grouping).

Sort-based grouping, as in the reference: rows sort stably by their key
parts, segment boundaries label groups in ascending key order (NULL keys
after the non-NULL ones, rows outside the mask last), and every
aggregate is one segment reduction (``index_add_`` for sums and counts,
``scatter_reduce`` for min and max) into a static group capacity plus an
overflow bin that swallows the invisible rows. Integer sums are exact
int64.

Hash-addressed grouping (``hash_slots``): each row goes straight to a
slot ``hash(key) & (cap - 1)`` with the reference's 64-bit FNV mix, so
the same keys take the same slots in both packages; a slot holding two
keys (a collision, or more groups than slots) is detected exactly and
the caller climbs its capacity ladder. ``group_reduce`` then reduces by
slot as it does by sorted segment.

A query with few groups sends every row's atomic update to a handful of
addresses, so the reductions whose result does not depend on the order
of the rows (integer sums and counts, min, max) go through a
[blocks, groups] table of partials first: no more than ``_SEG_BLOCK``
rows contend for one accumulator.
"""

from __future__ import annotations

import torch

from opentenbase_tpu_torch.ops.filter import mask_count

_I64_MAX = 2**62  # sentinels safely inside int64
_I64_MIN = -(2**62)
# group id of an invisible row: far above any real group, so the clamp in
# group_reduce routes it to the overflow bin at any capacity
_DEAD_SEG = 2**30

_SENTINEL = {
    "min": {torch.int32: 2**31 - 1, torch.int64: 2**63 - 1},
    "max": {torch.int32: -(2**31), torch.int64: -(2**63)},
}


def scalar_reduce(vals, mask: torch.Tensor, specs: tuple):
    """Ungrouped aggregation over one batch: per aggregate a 0-d
    ``(value, valid)`` pair. ``specs`` name the functions ('sum',
    'count', 'count_star', 'min', 'max'); ``vals`` holds each one's
    (data, valid) argument (None for count_star); ``mask`` marks the
    rows that take part. Integer sums are exact int64; a sum, min or max
    over no rows is NULL, a count is 0."""
    out = []
    for spec, val in zip(specs, vals):
        if spec == "count_star":
            c = mask_count(mask)
            out.append((c, torch.ones((), dtype=torch.bool,
                                      device=mask.device)))
            continue
        data, valid = val
        vvalid = mask if valid is None else (mask & valid)
        cnt = mask_count(vvalid)
        if spec == "count":
            out.append((cnt, torch.ones((), dtype=torch.bool,
                                        device=mask.device)))
        elif spec == "sum":
            if not data.dtype.is_floating_point:
                data = data.to(torch.int64)
            s = torch.sum(torch.where(vvalid, data, torch.zeros_like(data)))
            out.append((s, cnt > 0))
        elif spec in ("min", "max"):
            d = data
            if d.dtype.is_floating_point:
                sent = float("inf") if spec == "min" else float("-inf")
            elif d.dtype == torch.bool:
                d = d.to(torch.int32)
                sent = 2 if spec == "min" else -1
            elif d.dtype in _SENTINEL[spec]:
                sent = _SENTINEL[spec][d.dtype]
            else:
                raise TypeError(f"{spec} over {d.dtype}")
            dd = torch.where(vvalid, d, torch.full_like(d, sent))
            if not dd.numel():  # no rows: the sentinel, flagged NULL
                r = torch.full((), sent, dtype=d.dtype, device=d.device)
            else:
                r = torch.amin(dd) if spec == "min" else torch.amax(dd)
            out.append((r, cnt > 0))
        else:
            raise ValueError(f"unknown scalar agg {spec}")
    return out


def float_key_parts(d: torch.Tensor) -> list:
    """Equality-preserving int32 views of a float column for grouping:
    -0.0 folds into +0.0 and every NaN collapses to one bit pattern (SQL
    groups NaNs together). float64 splits double-float style into hi and
    lo float32 parts, as the reference does (its TPU could not bitcast 64
    bits), so both packages group and order identically."""
    d = torch.where(d == 0, torch.zeros((), dtype=d.dtype, device=d.device),
                    d)
    d = torch.where(torch.isnan(d),
                    torch.full((), float("nan"), dtype=d.dtype,
                               device=d.device), d)
    if d.dtype == torch.float64:
        hi = d.to(torch.float32)
        lo = (d - hi.to(torch.float64)).to(torch.float32)
        lo = torch.where(torch.isfinite(d), lo,
                         torch.zeros((), dtype=torch.float32,
                                     device=d.device))
        return [hi.view(torch.int32), lo.view(torch.int32)]
    return [d.to(torch.float32).view(torch.int32)]


def _key_parts(keys) -> list:
    """Flatten (data, valid) group keys into comparable integer parts,
    NULL payloads canonicalised to 0."""
    parts = []
    for data, valid in keys:
        if data.dtype.is_floating_point:
            for piece in float_key_parts(data):
                if valid is not None:
                    piece = torch.where(valid, piece, 0)
                parts.append((piece, valid))
            continue
        d = data.to(torch.int32) if data.dtype == torch.bool else data
        if valid is not None:
            d = torch.where(valid, d, 0)
        parts.append((d, valid))
    return parts


def _label_segments(parts, perm, vis):
    """(seg, ngroups) of sorted rows: a group starts at the first row and
    wherever a key part or its validity changes; invisible rows get
    ``_DEAD_SEG``."""
    n = perm.shape[0]
    dev = perm.device
    boundary = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        boundary[0] = True
    for d, v in parts:
        for x in (d,) if v is None else (d, v):
            xs = x[perm]
            boundary[1:] |= xs[1:] != xs[:-1]
    boundary &= vis
    seg = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
    ngroups = torch.sum(boundary, dtype=torch.int32)
    seg = torch.where(vis, seg, torch.full((), _DEAD_SEG, dtype=torch.int32,
                                           device=dev))
    return seg, ngroups


def group_ids(keys, mask):
    """Sort rows by keys (+ validity) and label segments (the reference's
    ``_group_ids_impl``): one stable sort per key part, NULLs after the
    non-NULL keys, then the rows outside ``mask`` last.

    keys: list of (data, valid_or_None); mask: visible rows or None.
    Returns (perm, seg, ngroups): ``perm`` the sort permutation,
    ``seg[i]`` the group of sorted row i (``_DEAD_SEG`` for an invisible
    row), ``ngroups`` the number of visible groups (0-d int32)."""
    parts = _key_parts(keys)
    n = parts[0][0].shape[0] if parts else (
        mask.shape[0] if mask is not None else 0)
    dev = parts[0][0].device if parts else mask.device
    perm = torch.arange(n, device=dev)
    for d, v in reversed(parts):
        perm = perm[torch.argsort(d[perm], stable=True)]
        if v is not None:
            # CUDA sorts no bool: NULLs (1) after the valid keys (0)
            perm = perm[torch.argsort((~v[perm]).to(torch.uint8),
                                      stable=True)]
    if mask is not None:
        perm = perm[torch.argsort((~mask[perm]).to(torch.uint8),
                                  stable=True)]
        vis = mask[perm]
    else:
        vis = torch.ones(n, dtype=torch.bool, device=dev)
    seg, ngroups = _label_segments(parts, perm, vis)
    return perm, seg, ngroups


# rows per block of a segment reduction's partial table, and its bound
_SEG_BLOCK = 4096
_SEG_TABLE_MAX = 1 << 22


def _segment_reducer(seg: torch.Tensor, nseg: int):
    """``reduce(x, op='sum', init=0)``: x reduced by ``seg`` into
    ``nseg`` bins starting from ``init`` (``op``: 'sum', 'amin' or
    'amax'). Blocked as the module docstring says, except float sums,
    whose rounding would follow the blocking; the blocked ids are built
    once for every reduction over the same segments."""
    n = seg.shape[0]
    blocks = max(1, min(-(-n // _SEG_BLOCK), _SEG_TABLE_MAX // nseg))
    bseg = seg if blocks == 1 else (
        torch.arange(n, device=seg.device) // -(-n // blocks) * nseg + seg)

    def reduce(x, op="sum", init=0):
        nb, idx = (1, seg) if op == "sum" and x.dtype.is_floating_point \
            else (blocks, bseg)
        t = torch.full((nb * nseg,), init, dtype=x.dtype, device=x.device)
        if op == "sum":
            t.index_add_(0, idx, x)
        else:
            t.scatter_reduce_(0, idx, x, op, include_self=True)
        if nb == 1:
            return t
        t = t.view(nb, nseg)
        if op == "sum":
            return t.sum(0, dtype=x.dtype)
        return t.amin(0) if op == "amin" else t.amax(0)

    return reduce


def group_reduce(keys, vals, perm, seg, num_groups: int, specs: tuple):
    """Segment reductions into a static group capacity (the reference's
    ``_group_reduce_impl``).

    keys/vals: lists of (data, valid_or_None) in unsorted row order;
    ``seg[i]`` the group of sorted row i, ``perm`` the sort permutation
    (None: the rows are not sorted, ``seg`` is each row's group, as a
    hash slot is); specs: per val 'sum' | 'count' | 'count_star' (val
    None) | 'min' | 'max' | 'any' (the group's first row). Rows whose
    group is at or past ``num_groups`` fall into one overflow bin and
    are dropped. Returns (out_keys, out_vals, group_valid): lists of
    (data, valid) of length ``num_groups``, and which groups exist."""
    nseg = num_groups + 1
    n = seg.shape[0]
    dev = seg.device
    seg = torch.clamp(seg.to(torch.int64), max=nseg - 1)
    # each group's representative: its first sorted row (an int32 min
    # where it fits: CUDA has no native int64 atomic min)
    pos = torch.arange(n, device=dev,
                       dtype=torch.int32 if n < 2**31 else torch.int64)
    reduce = _segment_reducer(seg, nseg)
    first_sorted = reduce(pos, "amin", n).to(torch.int64)
    got = first_sorted < n
    if n:
        # a gather faults on an index out of range (jnp.take clamps)
        first_row = torch.clamp(first_sorted, max=n - 1)
        if perm is not None:
            first_row = perm[first_row]
    else:
        first_row = torch.zeros(nseg, dtype=torch.int64, device=dev)

    def take_first(data, valid):
        if n:
            d = data[first_row][:num_groups]
        else:
            d = torch.zeros(num_groups, dtype=data.dtype, device=dev)
        if valid is None or not n:
            return (d, got[:num_groups])
        return (d, (valid[first_row] & got)[:num_groups])

    out_keys = [take_first(d, v) for d, v in keys]
    if perm is not None:
        seg_unsorted = torch.empty_like(seg)
        seg_unsorted[perm] = seg
        reduce = _segment_reducer(seg_unsorted, nseg)
    # a row outside the groups reduces into the overflow bin, which is
    # dropped: only NULL arguments need masking
    row_cnt = None  # rows per group, shared by the mask-less arguments

    def count(valid):
        nonlocal row_cnt
        if valid is not None:
            return reduce(valid.to(torch.int64))
        if row_cnt is None:
            row_cnt = reduce(torch.ones(n, dtype=torch.int64, device=dev))
        return row_cnt

    out_vals = []
    for spec, val in zip(specs, vals):
        if spec == "count_star":
            c = count(None)
            out_vals.append((c[:num_groups], got[:num_groups]))
            continue
        data, valid = val
        if spec == "count":
            c = count(valid)
            out_vals.append((c[:num_groups], got[:num_groups]))
            continue
        if spec == "any":
            out_vals.append(take_first(data, valid))
            continue
        cnt = count(valid)
        if spec == "sum":
            if not data.dtype.is_floating_point:
                data = data.to(torch.int64)  # exact: no int32 wrap
            d = data if valid is None else torch.where(
                valid, data, torch.zeros((), dtype=data.dtype, device=dev))
            s = reduce(d)
            out_vals.append((s[:num_groups], (cnt > 0)[:num_groups]))
            continue
        if spec in ("min", "max"):
            if data.dtype.is_floating_point:
                sent = float("inf") if spec == "min" else float("-inf")
            elif data.dtype == torch.bool:
                data = data.to(torch.int32)
                sent = 2 if spec == "min" else -1
            elif data.element_size() < 8:
                # an int64 sentinel would wrap in a narrower lane
                info = torch.iinfo(data.dtype)
                sent = info.max if spec == "min" else info.min
            else:
                sent = _I64_MAX if spec == "min" else _I64_MIN
            d = data if valid is None else torch.where(
                valid, data, torch.full((), sent, dtype=data.dtype,
                                        device=dev))
            m = reduce(d, "amin" if spec == "min" else "amax", sent)
            out_vals.append((m[:num_groups], (cnt > 0)[:num_groups]))
            continue
        raise ValueError(f"unknown agg spec {spec}")
    return out_keys, out_vals, got[:num_groups]


_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211


def hash_slot_ids(keys, mask, cap: int):
    """Row -> slot in [0, cap) by mixing the key parts (the reference's
    ``_hash_slot_ids``): a 64-bit FNV mix over every part and validity
    bit, int64 products wrapping as jnp's do, then ``h ^ (h >> 29)``
    (arithmetic shift) so the low bits feel the high ones. Rows outside
    ``mask`` get slot ``cap``. Returns (slot int32, the mixed parts as
    (int64 part, whether it was int64), visibility or None)."""
    assert cap & (cap - 1) == 0, "group capacity must be a power of two"
    parts = _key_parts(keys)
    n = parts[0][0].shape[0] if parts else mask.shape[0]
    dev = parts[0][0].device if parts else mask.device
    h = torch.full((n,), _FNV_OFFSET, dtype=torch.int64, device=dev)
    mixed: list = []
    for d, v in parts:
        for x in (d,) if v is None else (d, v):
            x64 = x.to(torch.int64)
            mixed.append((x64, x.dtype == torch.int64))
            h = (h ^ x64) * _FNV_PRIME
    h = h ^ (h >> 29)
    slot = (h & (cap - 1)).to(torch.int32)
    if mask is None:
        return slot, mixed, None
    return torch.where(mask, slot, cap), mixed, mask


def hash_slots(keys, mask, cap: int):
    """Hash-addressed grouping (the reference's ``_hash_slots_impl``):
    (slot, ngroups, collision). Exact: a visible row that differs from
    its slot's mean, floored, in any mixed part is a collision (two keys
    in one slot, or more groups than ``cap``): a slot whose rows differ
    has its largest value above the mean. int64 parts go as two 32-bit
    halves, so no sum wraps; every sum is an ``index_add_`` (where the
    reference keeps per-slot minimums, which on CUDA would be int64
    compare-and-swap loops). Invisible rows take slot ``cap``, the
    overflow bin of ``group_reduce``, and are never compared."""
    slot, mixed, vis = hash_slot_ids(keys, mask, cap)
    dev = slot.device
    sl = slot.to(torch.int64)
    reduce = _segment_reducer(sl, cap + 1)
    cnt = reduce(torch.ones(sl.shape[0], dtype=torch.int64, device=dev))
    safe = torch.clamp(cnt, min=1)
    collision = torch.zeros((), dtype=torch.bool, device=dev)
    for x, wide in mixed:
        for p in (x >> 32, x & 0xFFFFFFFF) if wide else (x,):
            differs = p != (reduce(p) // safe)[sl]
            if vis is not None:
                differs = differs & vis
            collision = collision | torch.any(differs)
    return slot, torch.sum(cnt[:cap] > 0, dtype=torch.int32), collision

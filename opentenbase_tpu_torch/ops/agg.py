"""Aggregation over masked columns, plain PyTorch (subset of the
reference's opentenbase_tpu/ops/agg.py: the ungrouped reduce and the
sort-based grouping).

Grouping is sort-based, as in the reference: rows sort stably by their
key parts, segment boundaries label groups in ascending key order (NULL
keys after the non-NULL ones, rows outside the mask last), and every
aggregate is one segment reduction (``index_add_`` for sums and counts,
``scatter_reduce`` for min and max) into a static group capacity plus an
overflow bin that swallows the invisible rows. Integer sums are exact
int64.
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


def _seg_sum(x: torch.Tensor, seg: torch.Tensor, nseg: int) -> torch.Tensor:
    out = torch.zeros(nseg, dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


def group_reduce(keys, vals, perm, seg, num_groups: int, specs: tuple):
    """Segment reductions into a static group capacity (the reference's
    ``_group_reduce_impl``).

    keys/vals: lists of (data, valid_or_None) in unsorted row order;
    specs: per val 'sum' | 'count' | 'count_star' (val None) | 'min' |
    'max' | 'any' (the group's first row). Rows whose group is at or
    past ``num_groups`` fall into one overflow bin and are dropped.
    Returns (out_keys, out_vals, group_valid): lists of (data, valid) of
    length ``num_groups``, and which groups exist."""
    nseg = num_groups + 1
    n = perm.shape[0]
    dev = perm.device
    seg = torch.clamp(seg.to(torch.int64), max=nseg - 1)
    # each group's representative: its first sorted row
    first_sorted = torch.full((nseg,), n, dtype=torch.int64, device=dev)
    first_sorted.scatter_reduce_(
        0, seg, torch.arange(n, device=dev), "amin", include_self=True)
    got = first_sorted < n
    if n:
        # a gather faults on an index out of range (jnp.take clamps)
        first_row = perm[torch.clamp(first_sorted, max=n - 1)]
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
    seg_unsorted = torch.empty_like(seg)
    seg_unsorted[perm] = seg
    live = seg_unsorted < num_groups
    out_vals = []
    for spec, val in zip(specs, vals):
        if spec == "count_star":
            c = _seg_sum(live.to(torch.int64), seg_unsorted, nseg)
            out_vals.append((c[:num_groups], got[:num_groups]))
            continue
        data, valid = val
        vvalid = live if valid is None else (live & valid)
        if spec == "count":
            c = _seg_sum(vvalid.to(torch.int64), seg_unsorted, nseg)
            out_vals.append((c[:num_groups], got[:num_groups]))
            continue
        if spec == "any":
            out_vals.append(take_first(data, valid))
            continue
        cnt = _seg_sum(vvalid.to(torch.int32), seg_unsorted, nseg)
        if spec == "sum":
            if not data.dtype.is_floating_point:
                data = data.to(torch.int64)  # exact: no int32 wrap
            d = torch.where(vvalid, data, torch.zeros((), dtype=data.dtype,
                                                      device=dev))
            s = _seg_sum(d, seg_unsorted, nseg)
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
            d = torch.where(vvalid, data, torch.full((), sent,
                                                     dtype=data.dtype,
                                                     device=dev))
            m = torch.full((nseg,), sent, dtype=data.dtype, device=dev)
            m.scatter_reduce_(0, seg_unsorted, d,
                              "amin" if spec == "min" else "amax",
                              include_self=True)
            out_vals.append((m[:num_groups], (cnt > 0)[:num_groups]))
            continue
        raise ValueError(f"unknown agg spec {spec}")
    return out_keys, out_vals, got[:num_groups]

"""Aggregation over masked columns, plain PyTorch (subset of the
reference's opentenbase_tpu/ops/agg.py: the ungrouped reduce)."""

from __future__ import annotations

import torch

from opentenbase_tpu_torch.ops.filter import mask_count

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

"""Selection helpers (the reference's opentenbase_tpu/ops/filter.py).

Predicates produce boolean masks that the operators consume directly;
operators that want dense input compact through ``compact_indices`` and
``gather_cols``. ``bucket_size`` fixes the padded widths the device
planes are stacked at.
"""

from __future__ import annotations

import torch


def bucket_size(n: int, floor: int = 16) -> int:
    """Static-shape bucket: next power of two >= n (sizes the planes)."""
    p = floor
    while p < n:
        p <<= 1
    return p


def mask_count(mask: torch.Tensor) -> torch.Tensor:
    """Number of True lanes, as a 0-d int64 tensor on the mask's device."""
    return torch.sum(mask, dtype=torch.int64)


def compact_indices(mask: torch.Tensor, out_size: int | None = None):
    """Indices of the True lanes, in order, padded to ``out_size``:
    (idx, valid). Padded lanes point at row 0 with valid False, so the
    gathers after them stay in bounds. Without ``out_size`` the result
    is exactly the True lanes (one host sync sizes it) and every lane
    is valid."""
    idx = torch.nonzero(mask, as_tuple=True)[0]
    k = idx.shape[0]
    if out_size is None or out_size == k:
        return idx, torch.ones(k, dtype=torch.bool, device=mask.device)
    out = torch.zeros(out_size, dtype=idx.dtype, device=mask.device)
    out[: min(k, out_size)] = idx[:out_size]
    valid = torch.arange(out_size, device=mask.device) < k
    return out, valid


def gather_cols(cols, idx: torch.Tensor, row_valid=None):
    """Gather (data, valid) column pairs at row indices ``idx``. With
    ``row_valid`` the lanes it clears are NULL in every column (a
    column without a validity mask takes ``row_valid`` as its mask);
    without it every index is a real row and a column without a mask
    stays without one. A 0-d column (a constant) broadcasts to the
    gathered width."""
    n = idx.shape[0]

    def take(x):
        return x.expand(n) if x.dim() == 0 else x[idx]

    out = []
    for d, v in cols:
        if row_valid is None:
            out.append((take(d), None if v is None else take(v)))
        else:
            out.append((take(d), row_valid if v is None
                        else take(v) & row_valid))
    return out

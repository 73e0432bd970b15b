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


def compact_indices(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the True lanes, in order (the reference's
    ``compact_indices`` without its static padding: eager torch sizes
    the result, at one host sync for the count)."""
    return torch.nonzero(mask, as_tuple=True)[0]


def gather_cols(cols, idx: torch.Tensor):
    """Gather (data, valid) column pairs at row indices ``idx`` (the
    reference's ``gather_cols``; every index is a real row here, so a
    column without a validity mask stays without one). A 0-d column (a
    constant) broadcasts to the gathered width."""
    n = idx.shape[0]

    def take(x):
        return x.expand(n) if x.dim() == 0 else x[idx]

    return [(take(d), None if v is None else take(v)) for d, v in cols]

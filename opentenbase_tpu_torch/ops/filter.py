"""Selection helpers (subset of the reference's opentenbase_tpu/ops/filter.py).

Predicates produce boolean masks that the operators consume directly;
``bucket_size`` fixes the padded widths the device planes are stacked at.
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

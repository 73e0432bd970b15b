"""Multi-key stable sort (the reference's opentenbase_tpu/ops/sort.py).

Iterated stable argsort passes from the least significant key to the
most, each over the whole column: ``torch.sort(stable=True)`` is the
counterpart of the reference's stable argsort (``torch.argsort`` without
``stable=True`` is not, and would reorder ties). A DESC key sorts its
negation, so NaN, which sorts after every number, stays last in both
directions. NULLs go by a dedicated stable pass on their flag (PG's
defaults: NULLS LAST for ASC, NULLS FIRST for DESC), never by their
padded payload. TEXT keys arrive as dictionary ranks, never raw codes.
"""

from __future__ import annotations

import torch


def order_indices(keys, nrows_mask=None) -> torch.Tensor:
    """Stable lexicographic order over ``keys``.

    keys: list of (data, valid_or_None, descending, nulls_first), the
    most significant first. ``nrows_mask``: optional bool mask; rows
    outside it sort to the very end. Returns an int64 permutation."""
    n = keys[0][0].shape[0]
    perm = torch.arange(n, device=keys[0][0].device)
    for data, valid, desc, nulls_first in reversed(keys):
        k = _rankable(data[perm])
        perm = perm[_stable_order(-k if desc else k)]
        if valid is not None:
            nf = nulls_first if nulls_first is not None else desc
            null = ~valid[perm]
            perm = perm[_stable_order((~null if nf else null).to(torch.uint8))]
    if nrows_mask is not None:
        perm = perm[_stable_order((~nrows_mask[perm]).to(torch.uint8))]
    return perm


def _stable_order(k: torch.Tensor) -> torch.Tensor:
    return torch.sort(k, stable=True).indices


def _rankable(k: torch.Tensor) -> torch.Tensor:
    """A key of the same order that the sort takes: bool (which CUDA
    does not sort) as int32; every other dtype as it is."""
    if k.dtype == torch.bool:
        return k.to(torch.int32)
    return k

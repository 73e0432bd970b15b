"""Deterministic hashing of distribution keys (numpy host path).

The reference hashes distribution keys with per-type hash funcs
(compute_hash, src/backend/pgxc/locator/locator.c). Here every key is first
reduced to its physical integer representation (TEXT via the dictionary's
string-hash table), then mixed with the murmur3 32-bit finalizer. The same
formula is bit-identical to the reference package's numpy path, so
placement decisions agree with it.
"""

from __future__ import annotations

import numpy as np

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B1


def _fmix32(x, xp):
    """murmur3 fmix32. ``x`` must be a uint32 array of module ``xp``."""
    x = x ^ (x >> 16)
    x = x * xp.uint32(_C1)
    x = x ^ (x >> 13)
    x = x * xp.uint32(_C2)
    x = x ^ (x >> 16)
    return x


def hash32_np(data: np.ndarray) -> np.ndarray:
    """Hash an integer/bool/float column to uint32 (numpy host path)."""
    return _hash32(data, np)


def _hash32(data, xp):
    dt = data.dtype
    if dt == xp.bool_:
        u = data.astype(xp.uint32)
    elif dt.kind == "f":
        data = data.astype(xp.float32)  # hash f64 via f32 (placement only)
        # Normalize -0.0 -> +0.0 so SQL-equal keys co-locate (PG's
        # hashfloat8 does the same).
        data = xp.where(data == 0, xp.float32(0.0), data)
        u = data.view(xp.uint32)
    else:
        # All integer widths go through the sign-extended 64-bit path so an
        # int32 key and the same value as int64 hash identically.
        u64 = data.astype(xp.int64).astype(xp.uint64)
        lo = (u64 & xp.uint64(0xFFFFFFFF)).astype(xp.uint32)
        hi = (u64 >> xp.uint64(32)).astype(xp.uint32)
        u = lo ^ (hi * xp.uint32(_GOLDEN))
    return _fmix32(u, xp)


def combine_hashes(hashes: list, xp=np):
    """Combine multi-column key hashes (boost hash_combine style)."""
    acc = hashes[0]
    for h in hashes[1:]:
        acc = acc ^ (h + xp.uint32(_GOLDEN) + (acc << 6) + (acc >> 2))
    return acc


def hash_strings(values: list[str]) -> np.ndarray:
    """Stable 32-bit hash of python strings (dictionary hash table).
    FNV-1a over utf-8 bytes, then fmix32."""
    out = np.empty(len(values), dtype=np.uint32)
    for i, s in enumerate(values):
        h = 0x811C9DC5
        for b in s.encode("utf-8"):
            h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
        out[i] = h
    return _fmix32(out, np)

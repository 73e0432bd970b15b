"""Host-side columnar primitives: dictionaries and columns.

Replaces the reference's tuple-at-a-time heap representation
(src/backend/access/heap, src/include/access/htup_details.h) with Arrow-style
columns. Strings are dictionary-encoded: the device only ever sees int32
codes; the dictionary lives host-side and is owned by the catalog so codes
are consistent across every shard of a table (a requirement the reference
does not have, since it ships raw datums between nodes via squeue).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from opentenbase_tpu_torch import types as t


class Dictionary:
    """An append-only string dictionary: code <-> value.

    Thread-safe on insert: datanode executors encode concurrently during
    distributed COPY. Codes are dense int32 starting at 0.

    Lock-free reads are DELIBERATE and safe by the append-only
    invariant (the 8 entries PR 13 baselined as burn-down debt, now
    documented in place): ``_values`` only ever grows (append under
    ``_lock``; no slot is ever reassigned or removed) and ``_index``
    only ever gains keys, each pointing at an already-published slot —
    CPython's dict/list reads are atomic w.r.t. a concurrent append,
    so a reader sees either the pre- or post-append state, both
    self-consistent: a decode of any code the reader legitimately
    holds (codes travel only AFTER the encode that minted them
    returned) always finds its value, and an encode miss re-checks
    under the lock before minting. The delta-scan work removed the
    other half of the risk: scans no longer fold (mutate) stores, so
    reader threads touch dictionaries only through these append-only
    paths.
    """

    # _pair_cache: pairwise-concat and text-transform tables cached by
    # resolve_param (ops/expr.py PairConcatParam, StrTransformParam) —
    # lazily set, keyed by source sizes
    __slots__ = ("_values", "_index", "_lock", "_hashes", "_pair_cache")

    def __init__(self, values: list[str] | None = None):
        self._values: list[str] = list(values) if values else []
        self._index: dict[str, int] = {v: i for i, v in enumerate(self._values)}
        self._lock = threading.RLock()
        self._hashes: np.ndarray | None = None  # lazy per-code string hashes

    def __len__(self) -> int:
        return len(self._values)  # otb_race: ignore[race-guard-mismatch] -- append-only lock-free read (class docstring): _values/_index only grow under _lock and published slots are immutable, so an unguarded read sees a self-consistent pre- or post-append state

    @property
    def values(self) -> list[str]:
        return self._values  # otb_race: ignore[race-guard-mismatch] -- append-only lock-free read (class docstring): _values/_index only grow under _lock and published slots are immutable, so an unguarded read sees a self-consistent pre- or post-append state

    def get_code(self, value: str) -> int | None:
        return self._index.get(value)  # otb_race: ignore[race-guard-mismatch] -- append-only lock-free read (class docstring): _values/_index only grow under _lock and published slots are immutable, so an unguarded read sees a self-consistent pre- or post-append state

    def decode(self, code: int) -> str:
        return self._values[code]  # otb_race: ignore[race-guard-mismatch] -- append-only lock-free read (class docstring): _values/_index only grow under _lock and published slots are immutable, so an unguarded read sees a self-consistent pre- or post-append state

    def encode_one(self, value: str) -> int:
        code = self._index.get(value)  # otb_race: ignore[race-guard-mismatch] -- append-only lock-free read (class docstring): _values/_index only grow under _lock and published slots are immutable, so an unguarded read sees a self-consistent pre- or post-append state; a miss re-checks under _lock before minting
        if code is not None:
            return code
        with self._lock:
            code = self._index.get(value)
            if code is None:
                code = len(self._values)
                self._values.append(value)
                self._index[value] = code
            return code

    def encode(self, values) -> np.ndarray:
        """Vectorized encode of an iterable of python strings."""
        out = np.empty(len(values), dtype=np.int32)
        index = self._index  # otb_race: ignore[race-guard-mismatch] -- append-only lock-free read (class docstring): _values/_index only grow under _lock and published slots are immutable, so an unguarded read sees a self-consistent pre- or post-append state; misses re-encode under _lock
        misses = []
        for i, v in enumerate(values):
            code = index.get(v)
            if code is None:
                misses.append(i)
                out[i] = -1
            else:
                out[i] = code
        if misses:
            with self._lock:
                for i in misses:
                    out[i] = self.encode_one(values[i])
        return out

    def decode_array(self, codes: np.ndarray) -> np.ndarray:
        arr = np.asarray(self._values, dtype=object)  # otb_race: ignore[race-guard-mismatch] -- append-only lock-free read (class docstring): _values/_index only grow under _lock and published slots are immutable, so an unguarded read sees a self-consistent pre- or post-append state
        return arr[codes]

    def hash_array(self) -> np.ndarray:
        """uint32 string-hash per code. Equal strings hash equally across
        *different* dictionaries — required so hash distribution of TEXT
        keys agrees between tables (locator.c's per-type compute_hash
        analog). Cached; extended lazily as codes are appended."""
        from opentenbase_tpu_torch.utils.hashing import hash_strings

        if self._hashes is None or len(self._hashes) < len(self._values):  # otb_race: ignore[race-guard-mismatch] -- append-only lock-free read (class docstring); the _hashes refresh is an idempotent recompute two racing readers may both perform, publishing equal arrays
            self._hashes = hash_strings(self._values)
        return self._hashes


@dataclass
class Column:
    """A typed host-side column: data + validity (True = non-NULL)."""

    type: t.SqlType
    data: np.ndarray
    validity: np.ndarray | None = None  # None means all-valid
    dictionary: Dictionary | None = field(default=None, repr=False)

    def __post_init__(self):
        want = self.type.np_dtype
        if self.data.dtype != want:
            self.data = self.data.astype(want)

    def __len__(self) -> int:
        return len(self.data)

    @property
    def valid_mask(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(len(self.data), dtype=np.bool_)
        return self.validity

    def take(self, idx: np.ndarray) -> "Column":
        return Column(
            self.type,
            self.data[idx],
            None if self.validity is None else self.validity[idx],
            self.dictionary,
        )

    def to_python(self) -> list:
        """Decode to python objects (for result delivery / golden tests)."""
        vm = self.valid_mask
        ty = self.type
        if ty.id == t.TypeId.TEXT and self.dictionary is not None:
            # decode only the valid slots: a NULL slot's code-0 fill may
            # not exist in the dictionary (an all-NULL column never
            # minted an entry), and must never be dereferenced
            out: list = [None] * len(self.data)
            idx = np.nonzero(vm)[0]
            if len(idx):
                dec = self.dictionary.decode_array(
                    np.clip(self.data[idx], 0, None)
                )
                for j, i in enumerate(idx):
                    out[i] = dec[j]
            return out
        if ty.id == t.TypeId.DECIMAL:
            f = ty.decimal_factor
            return [
                (int(x) / f if ty.scale else int(x)) if v else None
                for x, v in zip(self.data.tolist(), vm.tolist())
            ]
        if ty.id == t.TypeId.DATE:
            base = np.datetime64("1970-01-01", "D")
            return [
                str(base + np.timedelta64(int(x), "D")) if v else None
                for x, v in zip(self.data.tolist(), vm.tolist())
            ]
        if ty.id == t.TypeId.TIMESTAMP:
            base = np.datetime64("1970-01-01T00:00:00", "us")
            return [
                str(base + np.timedelta64(int(x), "us")) if v else None
                for x, v in zip(self.data.tolist(), vm.tolist())
            ]
        return [x if v else None for x, v in zip(self.data.tolist(), vm.tolist())]


def column_from_python(values: list, ty: t.SqlType, dictionary: Dictionary | None = None) -> Column:
    """Build a Column from python literals (None = NULL)."""
    n = len(values)
    validity = np.asarray([v is not None for v in values], dtype=np.bool_)
    all_valid = bool(validity.all())
    filled = values
    if not all_valid:
        filled = [0 if v is None else v for v in values]
    if ty.id == t.TypeId.TEXT:
        dictionary = dictionary if dictionary is not None else Dictionary()
        if all_valid:
            data = dictionary.encode([str(v) for v in values])
        else:
            # NULL slots stay code 0 and never enter the dictionary —
            # the general pipeline's convention (a '' entry minted into
            # a TABLE's shared dict would shift code assignment and
            # diverge union-branch dictionary merges downstream)
            data = np.zeros(n, dtype=np.int32)
            idx = np.nonzero(validity)[0]
            if len(idx):
                data[idx] = dictionary.encode(
                    [str(values[i]) for i in idx]
                )
    elif ty.id == t.TypeId.DECIMAL:
        f = ty.decimal_factor
        data = np.asarray([round(float(v) * f) for v in filled], dtype=np.int64)
    elif ty.id == t.TypeId.DATE:
        data = (
            np.asarray(filled, dtype="datetime64[D]").astype("int64").astype("int32")
            if n
            else np.empty(0, np.int32)
        )
    elif ty.id == t.TypeId.TIMESTAMP:
        data = (
            np.asarray(filled, dtype="datetime64[us]").astype("int64")
            if n
            else np.empty(0, np.int64)
        )
    else:
        data = np.asarray(filled, dtype=ty.np_dtype)
    return Column(ty, data, None if all_valid else validity, dictionary)

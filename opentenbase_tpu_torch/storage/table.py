"""Columnar batches and the per-datanode shard store (heap equivalent).

The reference stores rows in 8KB heap pages with per-tuple MVCC headers and a
shard id in the tuple header (src/include/access/htup_details.h:170 t_shardid,
heap_form_tuple_shard src/backend/access/heap/heaptuple.c). Here a table
shard is a set of append-only columns plus two hidden MVCC timestamp columns:

- ``xmin_ts``: commit timestamp (GTS) of the inserting transaction.
- ``xmax_ts``: commit timestamp of the deleting transaction, or INF_TS.

Visibility is a vectorized predicate over these columns evaluated on device
(see txn/mvcc.py — the direct analog of HeapTupleSatisfiesMVCC,
src/backend/utils/time/tqual.c:2274). Uncommitted (prepared but not yet
committed) inserts carry xmin_ts = PENDING_TS, which is > any snapshot
timestamp, so they are invisible until the 2PC coordinator stamps the commit
timestamp — the same "stamp at commit-prepared" flow the reference drives
from pgxc_node_remote_commit (src/backend/pgxc/pool/execRemote.c:4862).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.fault import FAULT
from opentenbase_tpu_torch.storage.column import Column, Dictionary, column_from_python

# Timestamp sentinels (int64). Real GTS values are positive and far below.
INF_TS = np.int64(2**62)  # "never deleted" / "not yet committed"
PENDING_TS = np.int64(2**62)
# xmax reservation by a PREPAREd transaction: still above every snapshot
# (row stays visible — the delete is undecided) but distinct from INF so
# concurrent writers conflict against it. The row-lock-held-across-PREPARE
# of the reference, as a timestamp (heap_lock_tuple + twophase.c).
RESERVED_TS = np.int64(2**62 - 1)


@dataclass
class ColumnBatch:
    """An immutable batch of named columns with equal length."""

    columns: dict[str, Column]
    nrows: int

    @staticmethod
    def from_columns(columns: dict[str, Column]) -> "ColumnBatch":
        n = len(next(iter(columns.values()))) if columns else 0
        for name, col in columns.items():
            if len(col) != n:
                raise ValueError(f"column {name} length {len(col)} != {n}")
        return ColumnBatch(columns, n)

    @staticmethod
    def from_pydict(
        data: dict[str, list],
        schema: dict[str, t.SqlType],
        dictionaries: dict[str, Dictionary] | None = None,
    ) -> "ColumnBatch":
        cols = {}
        for name, ty in schema.items():
            d = dictionaries.get(name) if dictionaries else None
            cols[name] = column_from_python(data[name], ty, d)
        return ColumnBatch.from_columns(cols)

    def take(self, idx: np.ndarray) -> "ColumnBatch":
        return ColumnBatch({k: c.take(idx) for k, c in self.columns.items()}, len(idx))

    def column_names(self) -> list[str]:
        return list(self.columns.keys())

    def to_pydict(self) -> dict[str, list]:
        return {k: c.to_python() for k, c in self.columns.items()}

    def to_rows(self) -> list[tuple]:
        cols = [c.to_python() for c in self.columns.values()]
        return list(zip(*cols)) if cols else []


class DeltaBatch:
    """One write-optimized columnar ingest batch parked in front of the
    base arrays (the delta half of the delta + base ≙ heap + vacuum
    split, SURVEY §7 hard part #3). Rows own GLOBAL positions assigned
    at append time — ``start`` .. ``start + nrows`` — so MVCC stamping
    and WAL framing address a delta row exactly as if it already lived
    in the base arrays; ``absorb`` (compaction) is position-preserving
    by construction."""

    __slots__ = ("start", "nrows", "cols", "validity", "xmin", "xmax",
                 "row_id")

    def __init__(self, start, nrows, cols, validity, xmin, xmax, row_id):
        self.start = start
        self.nrows = nrows
        self.cols = cols            # name -> np.ndarray (typed)
        self.validity = validity    # name -> bool array | None
        self.xmin = xmin
        self.xmax = xmax
        self.row_id = row_id

    def contains(self, s: int, e: int) -> bool:
        return s >= self.start and e <= self.start + self.nrows


class ScanView:
    """One coherent READ-ONLY capture of a store: base-array references
    plus the pending delta segments, taken in one moment under the
    store lock and assembled lazily, LOCK-FREE, per plane — the
    scannable delta plane (a scan ≙ a heap scan over unvacuumed pages;
    the fold is compaction's job alone, never a reader's).

    Why lock-free assembly is sound: the fold writes delta contents
    INTO the base arrays only at positions >= the captured
    ``base_rows`` (positions are global and the fold is position-
    preserving), growth and vacuum REPLACE arrays rather than mutating
    captured ones, and MVCC stamps are idempotent absolute writes a
    concurrent reader may see either side of — exactly the torn-stamp
    tolerance the folding read path already had. So a view reads
    ``base[:base_rows]`` + its captured DeltaBatch segments and never
    needs the lock again."""

    __slots__ = (
        "schema", "nrows", "base_rows", "version", "structure_version",
        "mvcc_seq", "mvcc_log", "deltas", "_bcols", "_bvalidity",
        "_bxmin", "_bxmax", "_brow_id",
    )

    def __init__(self, store: "ShardStore", nrows: int):
        # caller holds store._delta_mu
        self.schema = dict(store.schema)
        self.nrows = nrows
        self.base_rows = min(store._base_rows, nrows)
        self.version = store.version
        self.structure_version = store.structure_version
        self.mvcc_seq = store.mvcc_seq
        self.mvcc_log = tuple(store._mvcc_log)
        self.deltas = list(store._deltas)
        self._bcols = dict(store._base_cols)
        self._bvalidity = dict(store._base_validity)
        self._bxmin = store._base_xmin
        self._bxmax = store._base_xmax
        self._brow_id = store._base_row_id

    # -- assembly ---------------------------------------------------------
    def delta_rows(self, s: int = 0, e: int | None = None) -> int:
        """Rows of [s, e) served from pending deltas (0 = base-only)."""
        e = self.nrows if e is None else min(e, self.nrows)
        return max(0, e - max(s, self.base_rows))

    def _plane(self, base, seg, s, e, pad=None, fill=0):
        """Assemble plane rows [s, e): a zero-copy base VIEW when the
        range is base-resident and unpadded, else one allocation filled
        from base + overlapping delta segments. ``pad`` sizes the
        output (scan batches assemble straight into their padded
        width — never pay a second copy on top of the assembly)."""
        n = e - s
        if e <= self.base_rows and pad is None:
            return base[s:e]
        out_n = n if pad is None else pad
        out = np.full(out_n, fill, dtype=base.dtype)
        b = min(self.base_rows, e)
        if s < b:
            out[: b - s] = base[s:b]
        if e > self.base_rows:
            for d in self.deltas:
                ds = d.start
                lo = max(ds, s)
                hi = min(ds + d.nrows, e)
                if lo < hi:
                    out[lo - s : hi - s] = seg(d)[lo - ds : hi - ds]
        return out

    def col(self, name: str, s: int = 0, e: int | None = None,
            pad=None, fill=0):
        e = self.nrows if e is None else e
        return self._plane(
            self._bcols[name], lambda d: d.cols[name], s, e, pad, fill
        )

    def validity(self, name: str, s: int = 0, e: int | None = None,
                 pad=None):
        """Assembled validity for [s, e), or None when every covered
        row is valid-by-construction (no mask anywhere in range).
        Padded lanes are False (dead), data lanes default True."""
        e = self.nrows if e is None else e
        vm = self._bvalidity.get(name)
        if not self.has_validity(name):
            return None
        n = e - s
        out_n = n if pad is None else pad
        out = np.zeros(out_n, dtype=np.bool_)
        out[:n] = True
        b = min(self.base_rows, e)
        if vm is not None and s < b:
            out[: b - s] = vm[s:b]
        if e > self.base_rows:
            for d in self.deltas:
                ds = d.start
                lo = max(ds, s)
                hi = min(ds + d.nrows, e)
                if lo < hi:
                    dv = d.validity.get(name)
                    if dv is not None:
                        out[lo - s : hi - s] = dv[lo - ds : hi - ds]
        return out

    def has_validity(self, name: str) -> bool:
        return self._bvalidity.get(name) is not None or any(
            d.validity.get(name) is not None for d in self.deltas
        )

    def col_at(self, name: str, idx: np.ndarray) -> np.ndarray:
        """Column values at global positions — a positional gather that
        touches ONLY the requested rows (never materializes the whole
        column), base rows from the base view, delta rows from their
        batches."""
        return self._plane_at(
            self._bcols[name], lambda d: d.cols[name], idx
        )

    def validity_at(self, name: str, idx: np.ndarray):
        """Validity at global positions, or None when no mask exists
        anywhere (all-valid)."""
        if not self.has_validity(name):
            return None
        idx = np.asarray(idx, dtype=np.int64)
        out = np.ones(len(idx), dtype=np.bool_)
        vm = self._bvalidity.get(name)
        bm = idx < self.base_rows
        if vm is not None and bm.any():
            out[bm] = vm[idx[bm]]
        rest = ~bm
        if rest.any():
            for d in self.deltas:
                sel = rest & (idx >= d.start) & (idx < d.start + d.nrows)
                if sel.any():
                    dv = d.validity.get(name)
                    if dv is not None:
                        out[sel] = dv[idx[sel] - d.start]
                    rest &= ~sel
        return out

    def xmin(self, s: int = 0, e: int | None = None, pad=None):
        e = self.nrows if e is None else e
        return self._plane(
            self._bxmin, lambda d: d.xmin, s, e, pad, np.int64(INF_TS)
        )

    def xmax(self, s: int = 0, e: int | None = None, pad=None):
        e = self.nrows if e is None else e
        return self._plane(self._bxmax, lambda d: d.xmax, s, e, pad, 0)

    def xmin_at(self, idx: np.ndarray) -> np.ndarray:
        return self._plane_at(self._bxmin, lambda d: d.xmin, idx)

    def xmax_at(self, idx: np.ndarray) -> np.ndarray:
        return self._plane_at(self._bxmax, lambda d: d.xmax, idx)

    def row_id_at(self, idx: np.ndarray) -> np.ndarray:
        return self._plane_at(self._brow_id, lambda d: d.row_id, idx)

    def _plane_at(self, base, seg, idx: np.ndarray) -> np.ndarray:
        """Positional gather over an MVCC plane — O(rows taken), like
        ``col_at`` (the zone-pruned scan's visibility read)."""
        idx = np.asarray(idx, dtype=np.int64)
        out = np.empty(len(idx), dtype=base.dtype)
        bm = idx < self.base_rows
        if bm.any():
            out[bm] = base[idx[bm]]
        rest = ~bm
        if rest.any():
            for d in self.deltas:
                sel = rest & (idx >= d.start) & (idx < d.start + d.nrows)
                if sel.any():
                    out[sel] = seg(d)[idx[sel] - d.start]
                    rest &= ~sel
        return out

    def row_id(self, s: int = 0, e: int | None = None):
        e = self.nrows if e is None else e
        return self._plane(self._brow_id, lambda d: d.row_id, s, e)


class ShardStore:
    """Mutable storage for one shard of one table on one datanode.

    Append-only columns + MVCC timestamp columns, with amortized growth.
    A monotonically increasing ``version`` invalidates device-side caches
    (the buffer-manager analog: instead of evicting 8KB pages we re-upload
    whole columns when the shard mutates).

    Write-optimized ingest (the INSERT→COPY plane): ``append_delta``
    parks a batch as an immutable :class:`DeltaBatch` instead of copying
    it into the base arrays — O(1) per batch, no capacity-doubling
    copies, no base-array churn during a burst. Readers see ONE store
    through :meth:`scan_view`, which assembles base + pending delta
    segments WITHOUT folding (the scannable delta plane: a delta batch
    ≙ unvacuumed heap pages a seq scan simply reads); the hot ingest
    loop (append → commit-stamp → WAL frame encode) runs entirely
    delta-side via ``stamp_xmin``'s in-delta fast path and
    ``slice_insert_arrays``, and UPDATE/DELETE stamps address delta
    rows in place by their global positions. Folding is compaction's
    job alone (storage/compaction.py background naptime job, vacuum,
    MAX_DELTAS write-side backpressure) — a background amortizer, never
    a synchronous read-side tax. The legacy fold-on-read base-array
    accessors (``_cols``/``xmin_ts``/… properties) remain for WRITERS
    and recovery, which need the real base arrays.

    Concurrency: read statements overlap table-granular writers (the
    engine's RWStatementLock). READS NEVER FOLD: every scan path goes
    through :meth:`scan_view`, which captures one coherent snapshot
    under ``_delta_mu`` (microseconds — reference capture only) and
    assembles base + delta segments lock-free afterwards, so a
    read-after-write scan costs the same one copy the padded batch
    build always paid, never a store mutation. The folding property
    accessors below remain for WRITERS and legacy direct readers
    (persist recovery writes through them); ``_delta_mu`` — reentrant,
    so the property accessors compose with the mutators — brackets the
    fold, the delta append, the in-delta stamp, vacuum, and schema
    changes, while arrays handed out stay valid across a concurrent
    fold/vacuum because those replace or extend arrays, never mutate
    absorbed positions.
    """

    # a burst longer than this folds at append time: bounds the linear
    # delta scans (stamp fast path, slice lookup) and the fold's own
    # concat width
    MAX_DELTAS = 512

    def __init__(self, schema: dict[str, t.SqlType], dictionaries: dict[str, Dictionary]):
        self.schema = dict(schema)
        self.dictionaries = dictionaries
        self._base_cols: dict[str, np.ndarray] = {
            name: np.empty(0, ty.np_dtype) for name, ty in schema.items()
        }
        self._base_validity: dict[str, np.ndarray | None] = {
            name: None for name in schema
        }
        self._base_xmin = np.empty(0, np.int64)
        self._base_xmax = np.empty(0, np.int64)
        # Stable per-row identity, monotonic per store: the WAL refers to
        # rows by id (not position) so redo stays correct across aborted
        # inserts, interleaved commits, and vacuum compaction — the ctid
        # vs. logical-identity distinction of the reference's heap.
        self._base_row_id = np.empty(0, np.int64)
        self.next_row_id = 0
        # TOTAL rows (base + pending deltas); _base_rows counts only
        # what the base arrays hold
        self.nrows = 0
        self._base_rows = 0
        self._deltas: list[DeltaBatch] = []
        import threading as _threading

        self._delta_mu = _threading.RLock()
        self.deltas_absorbed = 0  # lifetime folds (pg_stat_wal evidence)
        # scannable-delta-plane evidence (pg_stat_fused): scans that
        # served pending delta rows WITHOUT forcing a fold, and how
        # many delta-resident rows they served
        self.fold_reads_avoided = 0
        self.delta_rows_read = 0
        self._capacity = 0
        self.version = 0
        # Incremental device-cache support (executor/fused.DeviceCache):
        # appends only ever extend the column prefix, and MVCC stamps are
        # logged below, so the cache can delta-upload instead of
        # re-uploading whole columns. ``structure_version`` bumps on
        # anything that rewrites existing row positions (vacuum, schema
        # change) and forces a full reload.
        self.structure_version = 0
        self.mvcc_seq = 0
        self._mvcc_log: list[tuple] = []  # (seq, kind, a, b, ts)
        # zone maps (BRIN analog, src/backend/access/brin): per-column
        # block min/max built on demand, version-keyed
        self._zone_cache: dict = {}
        # Prepared-but-undecided 2PC transactions hold (start, end) row
        # ranges / index arrays into this store for later stamping. Vacuum
        # compaction would invalidate them, so such transactions pin the
        # store (the moral equivalent of the reference's shard barrier,
        # src/backend/pgxc/shard/shardbarrier.c).
        self._pins = 0

    # -- delta <-> base publication --------------------------------------
    # WRITER-side accessors: the property getters fold pending deltas
    # first because they hand out the real base arrays for in-place
    # mutation (recovery rebuild, base-tail appends). READ paths must
    # use scan_view()/peek_* instead — reads never fold. The fold is
    # position-preserving: delta rows were assigned their global
    # positions at append time.
    @property
    def _cols(self) -> dict:
        with self._delta_mu:
            if self._deltas:
                self._absorb_locked()
            return self._base_cols

    @_cols.setter
    def _cols(self, value) -> None:
        with self._delta_mu:
            self._base_cols = value

    @property
    def _validity(self) -> dict:
        with self._delta_mu:
            if self._deltas:
                self._absorb_locked()
            return self._base_validity

    @_validity.setter
    def _validity(self, value) -> None:
        with self._delta_mu:
            self._base_validity = value

    @property
    def xmin_ts(self) -> np.ndarray:
        with self._delta_mu:
            if self._deltas:
                self._absorb_locked()
            return self._base_xmin

    @xmin_ts.setter
    def xmin_ts(self, value) -> None:
        with self._delta_mu:
            self._base_xmin = value

    @property
    def xmax_ts(self) -> np.ndarray:
        with self._delta_mu:
            if self._deltas:
                self._absorb_locked()
            return self._base_xmax

    @xmax_ts.setter
    def xmax_ts(self, value) -> None:
        with self._delta_mu:
            self._base_xmax = value

    @property
    def row_id(self) -> np.ndarray:
        with self._delta_mu:
            if self._deltas:
                self._absorb_locked()
            return self._base_row_id

    @row_id.setter
    def row_id(self, value) -> None:
        with self._delta_mu:
            self._base_row_id = value

    @property
    def pending_delta_rows(self) -> int:
        with self._delta_mu:
            return self.nrows - self._base_rows

    # -- non-folding reads (the scannable delta plane) -------------------
    def scan_view(
        self, nrows: int | None = None, fold: bool = False,
    ) -> ScanView:
        """One coherent :class:`ScanView` of this store — THE read
        entry for every scan/materialization path. Never mutates the
        store. ``fold=True`` restores the legacy fold-on-read capture
        (``enable_delta_scan = off`` — the HTAP bench baseline and an
        escape hatch, reproducing the pre-delta-scan read path on the
        same binary). Fold-avoided evidence is recorded by the READERS
        via :meth:`note_delta_read` with the rows they actually served
        — a capture alone proves nothing about what was scanned."""
        with self._delta_mu:
            if fold and self._deltas:
                self._absorb_locked()
            n = self.nrows if nrows is None else nrows
            v = ScanView(self, n)
            served = v.delta_rows()
        if served:
            # failpoint: the delta-scan assembly boundary; an error is a
            # reader dying mid-assembly (the store untouched, its
            # deltas intact, nothing half folded)
            FAULT("storage/delta_scan", rows=served)
        return v

    def note_delta_read(self, rows: int) -> None:
        """Record that a scan served ``rows`` delta-resident rows
        without forcing a fold (pg_stat_fused evidence). Called by the
        read paths with the rows THEY actually covered — a parallel
        block worker counts only its block, a zone-pruned scan only
        its row subset, a device refresh only its tail — so the
        published counters never overstate delta-plane reads."""
        if rows:
            with self._delta_mu:
                self.fold_reads_avoided += 1
                self.delta_rows_read += int(rows)

    def peek_xmax(self, nrows: int | None = None) -> np.ndarray:
        """xmax plane [0, nrows) WITHOUT folding (read-only)."""
        return self.scan_view(nrows).xmax()

    def peek_xmax_at(self, idx) -> np.ndarray:
        """xmax values at global positions WITHOUT folding — the
        write-conflict / abort-path probe (positions may live in base
        or in pending deltas)."""
        return self.scan_view().xmax_at(idx)

    def peek_row_id_at(self, idx) -> np.ndarray:
        """Stable row ids at global positions WITHOUT folding — the
        WAL delete-frame encoder's read (a DELETE targeting
        delta-resident rows must not fold the store at commit)."""
        return self.scan_view().row_id_at(idx)

    def memory_stats(self) -> tuple[int, int, int]:
        """(column_bytes, validity_bytes, mvcc_bytes) over base arrays
        + pending deltas, WITHOUT folding (pg_shard_memory)."""
        with self._delta_mu:
            col_b = sum(a.nbytes for a in self._base_cols.values())
            vm_b = sum(
                v.nbytes for v in self._base_validity.values()
                if v is not None
            )
            mvcc_b = (
                self._base_xmin.nbytes + self._base_xmax.nbytes
                + self._base_row_id.nbytes
            )
            for d in self._deltas:
                col_b += sum(a.nbytes for a in d.cols.values())
                vm_b += sum(
                    v.nbytes for v in d.validity.values()
                    if v is not None
                )
                mvcc_b += (
                    d.xmin.nbytes + d.xmax.nbytes + d.row_id.nbytes
                )
            return col_b, vm_b, mvcc_b

    # -- delta-aware plane writes (caller holds ``_delta_mu``) -----------
    def _plane_write_range(self, plane: str, s: int, e: int, val) -> None:
        """Caller holds ``_delta_mu``. Absolute-write ``val`` into
        [s, e) of an MVCC plane without folding: base portion in
        place, delta portions into their batches (positions are global
        on both sides of the split)."""
        base = self._base_xmin if plane == "xmin" else self._base_xmax
        b = min(self._base_rows, e)
        if s < b:
            base[s:b] = val
        if e > self._base_rows:
            for d in self._deltas:
                lo = max(d.start, s)
                hi = min(d.start + d.nrows, e)
                if lo < hi:
                    arr = d.xmin if plane == "xmin" else d.xmax
                    arr[lo - d.start : hi - d.start] = val

    def _plane_write_at(self, plane: str, idx: np.ndarray, val) -> None:
        """Caller holds ``_delta_mu``. Absolute-write ``val`` at global
        positions without folding — UPDATE/DELETE target stamps
        address delta rows in place."""
        idx = np.asarray(idx, dtype=np.int64)
        base = self._base_xmin if plane == "xmin" else self._base_xmax
        bm = idx < self._base_rows
        if bm.any():
            base[idx[bm]] = val
        rest = ~bm
        if rest.any():
            for d in self._deltas:
                sel = rest & (idx >= d.start) & (idx < d.start + d.nrows)
                if sel.any():
                    arr = d.xmin if plane == "xmin" else d.xmax
                    arr[idx[sel] - d.start] = val
                    rest &= ~sel

    def _absorb_locked(self) -> None:
        """Caller holds ``_delta_mu``. Fold every pending delta batch
        into the base arrays IN PLACE after one amortized capacity-
        doubling grow — a read-after-write pattern folding one small
        delta per statement must cost O(rows appended), never a full-
        base copy per statement (the quadratic trap the old exact-size
        concatenate had). Positions and row ids are preserved, so
        device caches, txn ins_ranges, and zone maps stay valid;
        ``structure_version`` does NOT bump."""
        deltas = self._deltas
        if not deltas:
            return
        total = self.nrows
        self._ensure_capacity(total - self._base_rows)
        for name in self.schema:
            arr = self._base_cols[name]
            vm = self._base_validity[name]
            if vm is None and any(
                d.validity.get(name) is not None for d in deltas
            ):
                vm = np.ones(len(arr), np.bool_)
                self._base_validity[name] = vm
            for d in deltas:
                end = d.start + d.nrows
                arr[d.start:end] = d.cols[name]
                if vm is not None:
                    dv = d.validity.get(name)
                    vm[d.start:end] = True if dv is None else dv
        for d in deltas:
            end = d.start + d.nrows
            self._base_xmin[d.start:end] = d.xmin
            self._base_xmax[d.start:end] = d.xmax
            self._base_row_id[d.start:end] = d.row_id
        self._base_rows = total
        self.deltas_absorbed += len(deltas)
        self._deltas = []

    def compact(self) -> int:
        """Fold pending deltas into the base table (the compaction job's
        per-store verb). Returns delta batches folded."""
        with self._delta_mu:
            n = len(self._deltas)
            if n:
                self._absorb_locked()
            return n

    # -- growth ---------------------------------------------------------
    def _ensure_capacity(self, extra: int) -> None:
        """Caller holds ``_delta_mu``. ``extra`` rows beyond
        ``_base_rows`` (callers either absorbed pending deltas first,
        or ARE the absorb sizing for the pending delta rows)."""
        need = self._base_rows + extra
        if need <= self._capacity:
            return
        new_cap = max(need, max(64, self._capacity * 2))
        nb = self._base_rows
        for name, arr in self._base_cols.items():
            grown = np.zeros(new_cap, dtype=arr.dtype)
            grown[:nb] = arr[:nb]
            self._base_cols[name] = grown
            vm = self._base_validity[name]
            if vm is not None:
                gvm = np.ones(new_cap, dtype=np.bool_)
                gvm[:nb] = vm[:nb]
                self._base_validity[name] = gvm
        for attr in ("_base_xmin", "_base_xmax", "_base_row_id"):
            arr = getattr(self, attr)
            grown = np.zeros(new_cap, dtype=np.int64)
            grown[:nb] = arr[:nb]
            setattr(self, attr, grown)
        self._capacity = new_cap

    # -- writes ---------------------------------------------------------
    def append_batch(self, batch: ColumnBatch, xmin_ts: int) -> tuple[int, int]:
        """Append rows with the given xmin timestamp (PENDING_TS for 2PC
        prepare). Returns the (start, end) row range for later stamping."""
        n = batch.nrows
        with self._delta_mu:
            if self._deltas:
                self._absorb_locked()
            self._ensure_capacity(n)
            start = self._base_rows
            for name in self.schema:
                col = batch.columns[name]
                self._base_cols[name][start : start + n] = col.data
                if col.validity is not None:
                    if self._base_validity[name] is None:
                        vm = np.ones(self._capacity, dtype=np.bool_)
                        self._base_validity[name] = vm
                    self._base_validity[name][start : start + n] = col.validity
                elif self._base_validity[name] is not None:
                    self._base_validity[name][start : start + n] = True
            self._base_xmin[start : start + n] = xmin_ts
            self._base_xmax[start : start + n] = INF_TS
            self._base_row_id[start : start + n] = np.arange(
                self.next_row_id, self.next_row_id + n, dtype=np.int64
            )
            self.next_row_id += n
            self._base_rows += n
            self.nrows += n
            self.version += 1
            return start, start + n

    def append_delta(
        self, batch: ColumnBatch, xmin_ts: int,
        row_id_start: int | None = None,
    ) -> tuple[int, int]:
        """Park a batch as a write-optimized delta: O(1), no base-array
        copy. Same contract as ``append_batch`` — global (start, end)
        positions for later stamping — but the rows fold into the base
        arrays lazily (first base read) or via compaction.
        ``row_id_start`` pins replayed row ids (WAL redo / DN direct
        apply); fresh inserts draw from ``next_row_id``."""
        n = batch.nrows
        with self._delta_mu:
            if n == 0:
                return self.nrows, self.nrows
            cols: dict[str, np.ndarray] = {}
            validity: dict[str, np.ndarray | None] = {}
            for name, ty in self.schema.items():
                col = batch.columns[name]
                data = col.data
                if data.dtype != ty.np_dtype:
                    data = data.astype(ty.np_dtype)
                cols[name] = data
                validity[name] = col.validity
            if len(self._deltas) >= self.MAX_DELTAS:
                self._absorb_locked()
            start = self.nrows
            rid0 = (
                self.next_row_id if row_id_start is None else row_id_start
            )
            self._deltas.append(DeltaBatch(
                start, n, cols, validity,
                np.full(n, xmin_ts, np.int64),
                np.full(n, INF_TS, np.int64),
                np.arange(rid0, rid0 + n, dtype=np.int64),
            ))
            self.next_row_id = max(self.next_row_id, rid0 + n)
            self.nrows += n
            self.version += 1
            return start, start + n

    def slice_insert_arrays(self, s: int, e: int):
        """(cols, validity, row_id_start) for insert range [s, e) —
        THE WAL-frame encoder's read path. Served straight from a
        pending delta when the range lies inside one (the common case:
        a commit frames exactly the ranges it appended), so framing an
        ingest burst never forces the fold; falls back to the base
        arrays (absorbing only if the range straddles)."""
        with self._delta_mu:
            d = self._delta_range(s, e)
            if d is not None:
                o = s - d.start
                k = e - s
                cols = {
                    name: d.cols[name][o : o + k] for name in self.schema
                }
                validity = {}
                for name in self.schema:
                    dv = d.validity.get(name)
                    validity[name] = None if dv is None else dv[o : o + k]
                rid0 = int(d.row_id[o]) if k else 0
                return cols, validity, rid0
            if e > self._base_rows and self._deltas:
                self._absorb_locked()
            cols = {
                name: self._base_cols[name][s:e] for name in self.schema
            }
            validity = {}
            for name in self.schema:
                vm = self._base_validity[name]
                validity[name] = None if vm is None else vm[s:e]
            rid0 = int(self._base_row_id[s]) if e > s else 0
            return cols, validity, rid0

    _MVCC_LOG_CAP = 64

    def _log_mvcc(self, kind: str, a, b, ts) -> None:
        """Caller holds ``_delta_mu``."""
        self.mvcc_seq += 1
        self._mvcc_log.append((self.mvcc_seq, kind, a, b, ts))
        if len(self._mvcc_log) > self._MVCC_LOG_CAP:
            del self._mvcc_log[0]

    def _delta_range(self, start: int, end: int):
        """Caller holds ``_delta_mu``. The pending delta fully
        containing [start, end), or None — the commit path's stamp
        addresses exactly the range it appended, so an ingest burst
        stamps delta-side without forcing the fold. Scanned from the
        END: commits address the ranges they just appended, so the
        match is almost always the last few batches — front-first made
        every commit O(pending deltas) during a long burst."""
        for d in reversed(self._deltas):
            if d.contains(start, end):
                return d
            if d.start + d.nrows <= start:
                # deltas are position-ordered: everything earlier ends
                # below this range, no containment possible
                return None
        return None

    def stamp_xmin(self, start: int, end: int, commit_ts: int) -> None:
        with self._delta_mu:
            # in-delta fast path: a fold must see either the stamped
            # delta or hand us the split write — never copy the delta
            # out from under a landing stamp (hence one lock for both)
            d = self._delta_range(start, end)
            if d is not None:
                d.xmin[start - d.start : end - d.start] = commit_ts
            else:
                self._plane_write_range("xmin", start, end, commit_ts)
            self.version += 1
            self._log_mvcc("xmin", start, end, commit_ts)

    def truncate_range(self, start: int, end: int) -> None:
        """Abort path for a prepared insert: mark the range dead forever."""
        with self._delta_mu:
            self._plane_write_range("xmin", start, end, INF_TS)
            # dead: xmax <= every snapshot
            self._plane_write_range("xmax", start, end, 0)
            self.version += 1
            self._log_mvcc("xmin", start, end, INF_TS)
            self._log_mvcc("xmax_range", start, end, 0)

    def stamp_xmax(self, idx: np.ndarray, commit_ts: int) -> None:
        with self._delta_mu:
            # deletes address arbitrary positions — base rows in place,
            # delta rows inside their batches (no fold: UPDATE/DELETE
            # targeting fresh rows keeps them delta-resident)
            self._plane_write_at("xmax", idx, commit_ts)
            self.version += 1
            self._log_mvcc(
                "xmax", np.array(idx, dtype=np.int64), None, commit_ts
            )

    def unstamp_xmax(self, idx: np.ndarray) -> None:
        with self._delta_mu:
            self._plane_write_at("xmax", idx, INF_TS)
            self.version += 1
            self._log_mvcc(
                "xmax", np.array(idx, dtype=np.int64), None, INF_TS
            )

    # -- schema evolution (ALTER TABLE, tablecmds.c) ---------------------
    def add_column(self, name: str, ty: t.SqlType) -> None:
        """Append a column; existing rows read NULL (PG's fast default-
        less ADD COLUMN: no rewrite, just metadata + NULL fill)."""
        with self._delta_mu:
            if self._deltas:
                self._absorb_locked()  # deltas carry the pre-ALTER schema
            self.schema[name] = ty
            self._base_cols[name] = np.zeros(
                self._capacity, dtype=ty.np_dtype
            )
            self._base_validity[name] = np.zeros(
                self._capacity, dtype=np.bool_
            )
            self.version += 1
            self.structure_version += 1

    def drop_column(self, name: str) -> None:
        with self._delta_mu:
            if self._deltas:
                self._absorb_locked()
            self.schema.pop(name, None)
            self._base_cols.pop(name, None)
            self._base_validity.pop(name, None)
            self.version += 1
            self.structure_version += 1

    ZONE_BLOCK = 4096

    def zone_map(self, name: str):
        """(mins, maxs) per ZONE_BLOCK rows of an integer-typed column —
        the BRIN-style min/max summary consulted for block pruning.
        Computed over ALL physical rows (dead included): conservative, a
        pruned block provably contains no matching value. Returns None
        for non-integer columns or empty stores."""
        with self._delta_mu:
            ty = self.schema.get(name)
            if ty is None or self.nrows == 0 or not np.issubdtype(
                np.dtype(ty.np_dtype), np.integer
            ):
                return None
            # keyed on DATA shape only (appends + structural rewrites):
            # MVCC stamps bump ``version`` without touching column
            # values, and a delete-heavy workload must not rebuild maps
            # per query
            key = (name, self.structure_version, self.nrows)
            zm = self._zone_cache.get(key)
            if zm is not None:
                return zm
            n = self.nrows
            b = self.ZONE_BLOCK
            nblocks = -(-n // b)
            padded = nblocks * b
            # assembled WITHOUT folding: zone maps over base + pending
            # delta rows — block pruning works mid-burst too
            data = self.scan_view(n).col(name, 0, n)
            if padded != n:
                # pad with the last value: never widens any block's range
                data = np.concatenate(
                    [data, np.full(padded - n, data[-1])]
                )
            blocks = data.reshape(nblocks, b)
            zm = (blocks.min(axis=1), blocks.max(axis=1))
            # evict this column's stale generations only
            self._zone_cache = {
                k: v for k, v in self._zone_cache.items() if k[0] != name
            }
            self._zone_cache[key] = zm
            return zm

    # -- reads ----------------------------------------------------------
    # Read accessors capture one coherent ScanView (reference capture
    # under the store lock — the fold NEVER runs inside a read) and
    # assemble base + pending delta segments lock-free: scans run on
    # the snapshot they captured, and a concurrent vacuum/fold replaces
    # or extends arrays rather than mutating absorbed positions, so
    # captured views stay valid (the columnar answer to MVCC
    # readers-never-block, tqual.c).
    def column_array(self, name: str, nrows=None) -> np.ndarray:
        return self.scan_view(nrows).col(name)

    def column(self, name: str) -> Column:
        v = self.scan_view()
        return Column(
            v.schema[name],
            v.col(name),
            v.validity(name),
            self.dictionaries.get(name),
        )

    def snapshot_arrays(self) -> dict[str, np.ndarray]:
        """All columns + MVCC columns as contiguous arrays (for device upload)."""
        v = self.scan_view()
        out = {name: v.col(name) for name in v.schema}
        out["__xmin_ts"] = v.xmin()
        out["__xmax_ts"] = v.xmax()
        return out

    def to_batch(self) -> ColumnBatch:
        # capture-once: the ScanView is one moment (schema included),
        # so column lengths and batch.nrows agree (ADVICE r4) even
        # under concurrent appends — and materializing never folds
        v = self.scan_view()
        n = v.nrows
        cols = {}
        for name in v.schema:
            cols[name] = Column(
                v.schema[name],
                v.col(name),
                v.validity(name),
                self.dictionaries.get(name),
            )
        return ColumnBatch(cols, n)

    def take_batch(self, idx) -> ColumnBatch:
        """``to_batch().take(idx)`` without materializing whole
        columns: a positional gather over base + delta segments — THE
        old-row-image read for UPDATE/DELETE RETURNING and matview
        decode, O(rows taken) even while a burst is delta-resident."""
        v = self.scan_view()
        idx = np.asarray(idx, dtype=np.int64)
        cols = {
            name: Column(
                v.schema[name],
                v.col_at(name, idx),
                v.validity_at(name, idx),
                self.dictionaries.get(name),
            )
            for name in v.schema
        }
        return ColumnBatch(cols, len(idx))

    # -- pinning --------------------------------------------------------
    def pin(self) -> None:
        with self._delta_mu:
            self._pins += 1

    def unpin(self) -> None:
        with self._delta_mu:
            assert self._pins > 0
            self._pins -= 1

    # -- vacuum ---------------------------------------------------------
    def live_index(self, snapshot_ts: int) -> np.ndarray:
        """Positions of rows visible at ``snapshot_ts`` (the MVCC
        visibility predicate xmin <= snap < xmax) — the ONE helper for
        host-side direct store reads (system views, matview state).
        Non-folding: delta-resident rows answer from their batches."""
        v = self.scan_view()
        return np.nonzero(
            (v.xmin() <= snapshot_ts) & (snapshot_ts < v.xmax())
        )[0]

    def vacuum(self, oldest_ts: int) -> int:
        """Reclaim rows deleted before every live snapshot (shard_vacuum.c
        equivalent, src/backend/pgxc/shard/shard_vacuum.c). Returns rows
        removed. No-op while any prepared transaction pins the store: row
        positions are stable identifiers for pending stamp/abort calls."""
        with self._delta_mu:
            if self._pins > 0:
                return 0
            if self._deltas:
                self._absorb_locked()  # compaction rides the vacuum verb
            n = self.nrows
            dead = self._base_xmax[:n] <= oldest_ts
            ndead = int(dead.sum())
            if ndead == 0:
                return 0
            keep = ~dead
            for name in self.schema:
                self._base_cols[name] = (
                    self._base_cols[name][:n][keep].copy()
                )
                vm = self._base_validity[name]
                if vm is not None:
                    self._base_validity[name] = vm[:n][keep].copy()
            self._base_xmin = self._base_xmin[:n][keep].copy()
            self._base_xmax = self._base_xmax[:n][keep].copy()
            self._base_row_id = self._base_row_id[:n][keep].copy()
            self.nrows = n - ndead
            self._base_rows = self.nrows
            self._capacity = self.nrows
            self.version += 1
            self.structure_version += 1  # row positions rewritten
            return ndead


def zone_usable_bounds(bounds: dict, meta, scan) -> dict:
    """Filter predicate bounds down to zone-indexed, non-text columns —
    the ONE eligibility rule shared by the host scan pruner
    (executor/local.py) and the fused device window
    (executor/fused.py)."""
    return {
        c: b for c, b in bounds.items()
        if c in meta.zone_cols
        and not scan.schema[scan.columns.index(c)].type.is_text
    }


def zone_candidate_blocks(store, usable: dict):
    """Boolean candidate mask over a store's zone blocks for per-column
    [lo, hi] bounds: False = PROVEN to contain no matching row. The ONE
    definition of the min/max intersection both pruning paths use."""
    b = store.ZONE_BLOCK
    nblocks = -(-store.nrows // b) if store.nrows else 0
    sel = np.ones(nblocks, dtype=bool)
    for col, (lo, hi) in usable.items():
        zm = store.zone_map(col)
        if zm is None:
            continue
        mins, maxs = zm
        if lo is not None:
            sel &= maxs >= lo
        if hi is not None:
            sel &= mins <= hi
    return sel

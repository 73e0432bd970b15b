"""Fused single-fragment executor on one GPU (subset of the reference's
opentenbase_tpu/executor/fused.py).

All shards of a table live stacked on the device as [S, Rmax] planes per
column (a TEXT column as its int32 dictionary codes) plus the xmin/xmax
commit-timestamp planes; the shard axis is the leading tensor
dimension, where the reference spread it over a device mesh. A fragment
of the shape scan -> filter/project chain -> partial aggregate,
gathered to the coordinator, runs as one launch of the scan-aggregate
kernel (ops/scan_agg.py) where the kernel's certifier takes it, and
otherwise through the fragment program: eager torch over the shard
planes flattened to one row axis (the reference's one-device form of its
XLA-fused program) — the live mask, the filter/project chain over
(data, valid) pairs, the visible rows compacted, then a scalar reduce,
hash-addressed grouping at 64 and then 1024 slots, or sort-based
grouping, the reference's ladder. Any other plan goes to ``dag_output``,
the fused DAG (executor/fused_dag.py), which runs joins under an
aggregate over the same cached planes.

Ported: ``DeviceCache`` for any table (all shards, or one replica of a
replicated table; compact [S, 1] MVCC planes when every shard is
uniform, expanded on the device at the first per-row write), with the
reference's incremental refresh (delta-tail uploads, the coalesced MVCC
replay, both as in-place writes), device-resident external tables
(``register_external``), the host column stats the certifier reads, the
fragment matcher, ``fragment_output`` (the kernel, then the program) and
``dag_output``, with the reference's zone windows (a program whose
predicate bounds a CREATE INDEX column reads only each shard's window of
candidate zone-map blocks) and its chunked scan (a scan whose resident
footprint passes ``SCAN_HBM_BUDGET`` streams shard-row windows through
the program, one resident at a time, ``get_window``). Where the reference's
program declines (min/max over TEXT, the sort mode past its capacity),
the port raises ``FusedUnsupported`` and the session's host executor
answers, as the reference's does.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.executor.dist import concat_batches
from opentenbase_tpu_torch.executor.local import (
    _predicate_bounds,
    to_host_arrays,
)
from opentenbase_tpu_torch.fault import FAULT
from opentenbase_tpu_torch.ops import agg as agg_ops
from opentenbase_tpu_torch.ops import scan_agg as sa
from opentenbase_tpu_torch.ops.expr import ExprCompiler, resolve_param
from opentenbase_tpu_torch.ops.filter import (
    bucket_size,
    compact_indices,
    gather_cols,
)
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan import texpr as E
from opentenbase_tpu_torch.plan.distribute import Fragment
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import (
    ColumnBatch,
    zone_candidate_blocks,
    zone_usable_bounds,
)

# slots of the fragment program's largest hash rung (the reference's
# DEFAULT_GROUP_CAP); the first rung takes min(64, this)
DEFAULT_GROUP_CAP = 1024

# Resident ceiling for one table's scan columns: past it the scan
# streams fixed-width shard windows instead of caching the whole table
# (``_fragment_chunked``).
DEFAULT_SCAN_HBM_BUDGET = 8_000_000_000
SCAN_HBM_BUDGET = int(os.environ.get("OTB_SCAN_HBM_BUDGET",
                                     DEFAULT_SCAN_HBM_BUDGET))


class FusedUnsupported(NotPorted):
    """The fused executors decline this fragment where the reference's
    decline too (the reference's ``FusedUnsupported``): the session then
    hands the plan to the host executor (executor/dist.py)."""


# ---------------------------------------------------------------------------
# Device table cache: stacked shards on the device
# ---------------------------------------------------------------------------


@dataclass
class DeviceTable:
    """All shards of one table stacked: column name -> [S, Rmax] tensor,
    plus validity and MVCC planes, on ``device``."""

    columns: dict[str, torch.Tensor]
    validity: dict[str, Optional[torch.Tensor]]
    xmin: torch.Tensor  # [S, Rmax], or [S, 1] when every shard is uniform
    xmax: torch.Tensor
    nrows: np.ndarray  # [S] row count per shard (host)
    nrows_dev: torch.Tensor  # the same, int64 on the device
    rmax: int
    versions: tuple[int, ...]
    # host-side |max| per column over real rows (None where not integer):
    # feeds the certifier (ops/scan_agg.certify_*)
    col_maxabs: dict[str, Optional[float]]
    # host-side [min, max] per integer column: sizes the group-key domain
    col_range: dict[str, Optional[tuple[int, int]]]
    # registered on the device (``register_external``): no host rows
    # back it, so no column can upload later
    external: bool = False
    # per-shard sync record for the incremental refresh: {nrows,
    # structure, mvcc_seq} of the store state the planes hold
    sync: Optional[list] = None


class DeviceCache:
    """Uploads and refreshes stacked shard columns, keyed by store
    versions; columns upload lazily on first use.

    Incremental, as the reference's: an append uploads only the new row
    tail of each resident column (served straight from the store's
    pending delta batches, never folding them), and MVCC stamps replay
    from the store's stamp log as one de-duplicated scatter per plane,
    sized by the rows touched. Both are in-place writes into the
    resident planes. A full upload happens only where row positions
    were rewritten (VACUUM, a schema change: ``structure_version``),
    the padded row capacity is outgrown, or a column's first NULL needs
    a validity plane. ``stats`` counts each kind of refresh and the
    bytes sent to the device."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._tables: dict = {}
        self._mu = threading.RLock()
        self.stats = {
            "hits": 0,
            "full_uploads": 0,
            "column_uploads": 0,
            "delta_uploads": 0,
            "delta_rows": 0,
            "mvcc_replays": 0,
            # refreshes whose tail was served from pending delta batches,
            # and the delta-resident rows those tails carried
            "delta_tail_uploads": 0,
            "delta_tail_rows": 0,
            # every byte this cache sent host -> device
            "h2d_bytes": 0,
            # the full uploads forced by a shard outgrowing ``rmax``
            # (counted in ``full_uploads`` too)
            "rmax_rebuilds": 0,
            # the chunked scan: shard-row windows uploaded
            # (``get_window``), scans streamed and the windows they ran
            "window_uploads": 0,
            "chunked_scans": 0,
            "scan_chunks": 0,
        }
        # enable_delta_scan = off: fold the stores' pending deltas
        # before a refresh, and replay a stamp log of more than 8
        # entries as a whole-plane upload (the pre-delta-plane path)
        self.legacy_fold = False

    def _views(self, stores) -> list:
        """One coherent ``scan_view`` a store; under ``legacy_fold``
        (``enable_delta_scan`` off) each store's pending deltas fold
        first, the fold-on-read path bench.py's HTAP leg baselines
        against."""
        if self.legacy_fold:
            for s in stores:
                if s.pending_delta_rows:
                    s.compact()
        return [s.scan_view() for s in stores]

    def drop_table(self, name: str) -> None:
        """Free every resident plane of ``name`` (whole tables and
        windows): a dropped table's planes must never answer for a table
        created again under its name."""
        with self._mu:
            for k in [k for k in self._tables if k[0] == name]:
                del self._tables[k]

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        self.stats["h2d_bytes"] += arr.nbytes
        return torch.from_numpy(arr).to(self.device)

    def _write(self, buf: torch.Tensor, i: int, start: int,
               arr: np.ndarray) -> None:
        """``buf[i, start:start + len(arr)] = arr`` in place."""
        if len(arr):
            self.stats["h2d_bytes"] += arr.nbytes
            buf[i, start:start + len(arr)].copy_(
                torch.from_numpy(np.ascontiguousarray(arr)))

    def get(
        self, name: str, meta, node_stores: dict[int, dict], nodes,
        columns=None,
    ) -> DeviceTable:
        """The stacked planes of ``name`` over the stores of ``nodes``
        (every shard, or one replica of a replicated table), with at
        least ``columns`` resident."""
        nodes = tuple(nodes)
        want = tuple(columns) if columns is not None else tuple(meta.schema)
        stores = [node_stores[n][name] for n in nodes]
        versions = tuple(s.version for s in stores)
        with self._mu:
            return self._get_locked(name, meta, stores, nodes, want, versions)

    def _get_locked(
        self, name, meta, stores, nodes, want, versions
    ) -> DeviceTable:
        cached = self._tables.get((name, nodes))
        if cached is not None and cached.versions == versions:
            self.stats["hits"] += 1
            if cached.external:
                missing = [c for c in want if c not in cached.columns]
                if missing:
                    raise KeyError(f"external table {name!r} holds no "
                                   f"column {missing[0]!r}")
                return cached
            self._ensure_columns(cached, stores, meta, want)
            return cached
        if cached is not None and not cached.external:
            updated = self._try_delta(cached, stores, meta, versions)
            if updated is not None:
                self._ensure_columns(updated, stores, meta, want)
                return updated
        self._tables.pop((name, nodes), None)  # free the stale planes
        self.stats["full_uploads"] += 1
        S = len(stores)
        # one coherent capture per store: nrows, the planes, mvcc_seq and
        # structure are read at one moment, so every plane slices the
        # same prefix and the sync record claims no stamp it did not read
        views = self._views(stores)
        for s, v in zip(stores, views):
            s.note_delta_read(v.delta_rows())
        totals = [v.nrows for v in views]
        xmins = [v.xmin() for v in views]
        xmaxs = [v.xmax() for v in views]
        rmax = bucket_size(max(max(totals, default=0), 1))
        # COMPACT visibility: after a bulk load every row of a shard
        # carries the same (xmin, xmax), so the two planes upload as
        # [S, 1] per-shard constants instead of 16 bytes a row. Any
        # non-uniform shard takes the full planes.
        uniform = True
        for xm, xx, nr in zip(xmins, xmaxs, totals):
            if nr == 0:
                continue
            if xm[0] != xm[-1] or xx[0] != xx[-1] or not (
                np.all(xm == xm[0]) and np.all(xx == xx[0])
            ):
                uniform = False
                break
        nrows = np.asarray(totals, dtype=np.int64).reshape(S)
        if uniform:
            xmin = np.full((S, 1), 2**62, dtype=np.int64)
            xmax = np.zeros((S, 1), dtype=np.int64)
            for i in range(S):
                if totals[i]:
                    xmin[i, 0] = xmins[i][0]
                    xmax[i, 0] = xmaxs[i][0]
        else:
            xmin = np.full((S, rmax), 2**62, dtype=np.int64)
            xmax = np.zeros((S, rmax), dtype=np.int64)
            for i in range(S):
                nr = totals[i]
                xmin[i, :nr] = xmins[i]
                xmax[i, :nr] = xmaxs[i]
        dt = DeviceTable(
            {}, {}, self._put(xmin), self._put(xmax), nrows,
            self._put(nrows.copy()), rmax, versions, {}, {},
            sync=[{"nrows": v.nrows, "structure": v.structure_version,
                   "mvcc_seq": v.mvcc_seq} for v in views],
        )
        self._ensure_columns(dt, stores, meta, want, totals, views)
        self._tables[(name, nodes)] = dt
        return dt

    def _try_delta(
        self, dt: DeviceTable, stores, meta, versions
    ) -> Optional[DeviceTable]:
        """Refresh ``dt`` in place: upload each shard's appended tail of
        every resident column (absent columns upload later, lazily,
        with current data) and replay the MVCC stamps since the sync
        point. Returns None where only a full rebuild is sound: row
        positions rewritten, the tail past ``rmax``, rows gone, or a
        first NULL in a column without a validity plane."""
        present = list(dt.columns)
        if not set(present) <= set(meta.schema):
            return None
        # one coherent capture per store: a concurrent append could
        # otherwise cross rmax between the checks and the tail write,
        # and a stamp landing between the plane read and the sync
        # record would count as synced without reaching the device
        views = self._views(stores)
        for v, sy in zip(views, dt.sync):
            if v.structure_version != sy["structure"]:
                return None
            if v.nrows > dt.rmax:
                self.stats["rmax_rebuilds"] += 1
                return None
            if v.nrows < sy["nrows"]:
                return None
            for c in present:
                if v.has_validity(c) and dt.validity[c] is None:
                    return None  # the first NULL needs a validity plane
        if dt.xmin.shape[1] == 1:
            # compact planes take no per-row writes: expand them on the
            # device (no host transfer) before tails and stamps land
            S = dt.xmin.shape[0]
            dt.xmin = dt.xmin.expand(S, dt.rmax).contiguous()
            dt.xmax = dt.xmax.expand(S, dt.rmax).contiguous()
        if any(v.nrows > sy["nrows"] for v, sy in zip(views, dt.sync)):
            # failpoint: the tail-upload boundary. An injected error
            # leaves ``dt`` as it was but for the plane expansion, so
            # the next statement repeats the same refresh
            FAULT("fused/delta_tail_upload")
        delta_rows = tail_delta_rows = replays = 0
        for i, (v, sy) in enumerate(zip(views, dt.sync)):
            old_n, new_n = sy["nrows"], v.nrows
            if new_n > old_n:
                delta_rows += new_n - old_n
                served = v.delta_rows(old_n, new_n)
                tail_delta_rows += served
                stores[i].note_delta_read(served)
                for c in present:
                    tail = v.col(c, old_n, new_n)
                    self._write(dt.columns[c], i, old_n, tail)
                    if dt.validity[c] is not None:
                        vm = v.validity(c, old_n, new_n)
                        self._write(dt.validity[c], i, old_n,
                                    np.ones(new_n - old_n, dtype=np.bool_)
                                    if vm is None else vm)
                    if tail.size and np.issubdtype(tail.dtype, np.integer):
                        # the certifier's bounds and the group-key
                        # domain must cover the new rows
                        lo, hi = int(tail.min()), int(tail.max())
                        rng = dt.col_range.get(c)
                        dt.col_range[c] = ((lo, hi) if rng is None else
                                           (min(rng[0], lo), max(rng[1], hi)))
                        dt.col_maxabs[c] = max(dt.col_maxabs[c] or 0.0,
                                               float(max(abs(lo), abs(hi))))
                self._write(dt.xmin, i, old_n, v.xmin(old_n, new_n))
                self._write(dt.xmax, i, old_n, v.xmax(old_n, new_n))
                dt.nrows[i] = new_n
            # bounded by this capture: stamps after it replay next time
            if v.mvcc_seq != sy["mvcc_seq"]:
                replays += self._replay_mvcc(dt, i, v, sy, old_n)
            dt.sync[i] = {"nrows": new_n, "structure": v.structure_version,
                          "mvcc_seq": v.mvcc_seq}
        dt.nrows_dev.copy_(torch.from_numpy(dt.nrows))
        dt.versions = versions
        self.stats["delta_uploads"] += 1
        self.stats["delta_rows"] += delta_rows
        if tail_delta_rows:
            self.stats["delta_tail_uploads"] += 1
            self.stats["delta_tail_rows"] += tail_delta_rows
        self.stats["mvcc_replays"] += replays
        return dt

    def _replay_mvcc(self, dt, i, view, sy, old_n) -> int:
        """Bring shard ``i``'s MVCC planes up to ``view.mvcc_seq``;
        returns the plane writes made. Rows at or past ``old_n`` came
        with the fresh tail, stamps and all, so only the synced prefix
        takes writes: the stamp log's entries since the sync point,
        coalesced into ONE last-write-wins scatter per plane (the cost
        follows the rows touched, not the plane). Where the log was
        trimmed past the sync point (``_MVCC_LOG_CAP``), or the touched
        rows rival the prefix, the prefix is rewritten in one copy."""
        seq = view.mvcc_seq
        pending = [e for e in view.mvcc_log if sy["mvcc_seq"] < e[0] <= seq]
        trimmed = len(pending) != seq - sy["mvcc_seq"]
        if self.legacy_fold:
            return self._replay_mvcc_legacy(dt, i, view, pending, trimmed)
        synced = old_n
        spans = 0
        for _seq, kind, a, b, _ts in pending:
            if kind == "xmax":
                spans += int((np.asarray(a) < synced).sum())
            else:
                spans += max(0, min(b, synced) - a)
        if not trimmed and spans == 0:
            return 0
        if trimmed or spans >= max(synced, 1):
            if synced:
                self._write(dt.xmin, i, 0, view.xmin(0, synced))
                self._write(dt.xmax, i, 0, view.xmax(0, synced))
            return 1
        planes = {"xmin": ([], []), "xmax": ([], [])}
        for _seq, kind, a, b, ts in pending:
            if kind == "xmax":
                pos = np.asarray(a, dtype=np.int64)
                pos = pos[pos < synced]
            else:
                pos = np.arange(a, max(a, min(b, synced)), dtype=np.int64)
            if len(pos):
                plane = planes["xmin" if kind == "xmin" else "xmax"]
                plane[0].append(pos)
                plane[1].append(np.full(len(pos), ts, dtype=np.int64))
        n = 0
        for plane, (poss, valss) in planes.items():
            if not poss:
                continue
            pos = np.concatenate(poss)
            vals = np.concatenate(valss)
            # last write wins: a scatter's order over duplicate indices
            # is undefined on the card, the log's order is the law
            uniq, last = np.unique(pos[::-1], return_index=True)
            vals = vals[::-1][last]
            self.stats["h2d_bytes"] += uniq.nbytes + vals.nbytes
            buf = dt.xmin if plane == "xmin" else dt.xmax
            buf[i].index_put_(
                (torch.from_numpy(uniq).to(self.device),),
                torch.from_numpy(vals).to(self.device))
            n += 1
        return n

    def _replay_mvcc_legacy(self, dt, i, view, pending, trimmed) -> int:
        """The reference's pre-delta-plane replay, kept for the
        ``enable_delta_scan = off`` baseline: past 8 entries (or a
        trimmed log) both planes upload whole; otherwise each entry is
        its own write."""
        n = view.nrows
        if trimmed or len(pending) > 8:
            self._write(dt.xmin, i, 0, view.xmin(0, n))
            self._write(dt.xmax, i, 0, view.xmax(0, n))
            return 1
        for _seq, kind, a, b, ts in pending:
            buf = dt.xmin if kind == "xmin" else dt.xmax
            if kind == "xmax":
                pos = np.asarray(a, dtype=np.int64)
                if len(pos):
                    buf[i].index_fill_(
                        0, torch.from_numpy(pos).to(self.device), int(ts))
            else:
                buf[i, a:b] = int(ts)
        return len(pending)

    def get_window(
        self, name: str, meta, node_stores: dict[int, dict], nodes,
        columns, start: int, length: int,
    ) -> DeviceTable:
        """A DeviceTable over the row window [start, start + length) of
        every shard: the streaming unit of a scan past the budget. Only
        the latest window of a table stays resident (a scan visits its
        windows in order, and keeping more would defeat the chunking):
        every other residency of the table, whole or windowed, is
        evicted first. The planes are per row and exact: ``rmax`` is the
        bucketed window width, ``nrows`` each shard's rows in it."""
        nodes = tuple(nodes)
        want = tuple(sorted(columns))
        stores = [node_stores[n][name] for n in nodes]
        if not all(hasattr(s, "scan_view") for s in stores):
            # an external table: its rows live on the device only
            raise KeyError(f"external table {name!r} has no host rows to "
                           "stream in windows")
        versions = tuple(s.version for s in stores)
        wkey = (name, nodes, "win", start, length, want)
        with self._mu:
            return self._get_window_locked(wkey, name, meta, stores, nodes,
                                           want, versions, start, length)

    def _get_window_locked(self, wkey, name, meta, stores, nodes, want,
                           versions, start, length) -> DeviceTable:
        cached = self._tables.get(wkey)
        if cached is not None and cached.versions == versions:
            self.stats["hits"] += 1
            return cached
        for k in [k for k in self._tables
                  if k[0] == name and k[1] == nodes and k != wkey]:
            del self._tables[k]
        self.stats["window_uploads"] += 1
        S = len(stores)
        W = bucket_size(max(length, 1))
        xmin = np.full((S, W), 2**62, dtype=np.int64)
        xmax = np.zeros((S, W), dtype=np.int64)
        nrows = np.zeros(S, dtype=np.int64)
        # one coherent capture per store: every plane and column slices
        # the same prefix, and the sync record claims no stamp it did
        # not read
        views = self._views(stores)
        for i, v in enumerate(views):
            n = max(min(v.nrows - start, length), 0)
            if n:
                xmin[i, :n] = v.xmin(start, start + n)
                xmax[i, :n] = v.xmax(start, start + n)
                stores[i].note_delta_read(v.delta_rows(start, start + n))
            nrows[i] = n
        cols: dict = {}
        valids: dict = {}
        for cname in want:
            stack = np.zeros((S, W), dtype=meta.schema[cname].np_dtype)
            vstack = None
            for i, v in enumerate(views):
                n = int(nrows[i])
                if not n:
                    continue
                stack[i, :n] = v.col(cname, start, start + n)
                vm = v.validity(cname, start, start + n)
                if vm is not None:
                    if vstack is None:
                        vstack = np.ones((S, W), dtype=np.bool_)
                    vstack[i, :n] = vm
            cols[cname] = self._put(stack)
            valids[cname] = None if vstack is None else self._put(vstack)
        dt = DeviceTable(
            cols, valids, self._put(xmin), self._put(xmax), nrows,
            self._put(nrows.copy()), W, versions, {}, {},
            sync=[{"nrows": v.nrows, "structure": v.structure_version,
                   "mvcc_seq": v.mvcc_seq} for v in views],
        )
        self._tables[wkey] = dt
        return dt

    def register_external(
        self, name: str, meta, nodes, columns: dict, nrows, versions=None,
    ) -> DeviceTable:
        """Register a table whose columns already lie on the device and
        never lived in host stores (benchmark data generated on the
        card). ``columns``: {name: [S, rmax] tensor} covering every
        column a query will read (nothing can upload later); ``rmax`` is
        any row count, not bucket-padded; ``nrows`` the live rows of
        each shard. Visibility is compact all-visible [S, 1] planes. The
        column stats are taken over live rows only, in one transfer.
        Pair it with stub stores exposing ``.nrows`` and ``.version`` so
        the planner's estimates and the version checks keep working."""
        nodes = tuple(nodes)
        first = next(iter(columns.values()))
        S, rmax = first.shape
        dev = self.device
        nr = np.zeros(S, dtype=np.int64)
        nr[: len(nrows)] = nrows
        nr_dev = torch.from_numpy(nr.copy()).to(dev)
        live = torch.arange(rmax, device=dev)[None, :] < nr_dev[:, None]
        cols = {c: a.to(dev) for c, a in columns.items()}
        ints = [c for c, a in cols.items()
                if not a.dtype.is_floating_point and a.dtype != torch.bool]
        stats = []
        for c in ints:
            a = cols[c]
            info = torch.iinfo(a.dtype)
            # padding past nrows holds anything: it must not widen the
            # range the certifier and the narrow operands read
            stats.append(torch.where(live, a, info.max).amin().to(
                torch.int64).reshape(1))
            stats.append(torch.where(live, a, info.min).amax().to(
                torch.int64).reshape(1))
        host = to_host_arrays([torch.cat(stats)])[0] if stats else []
        col_range: dict = {c: None for c in cols}
        col_maxabs: dict = {c: None for c in cols}
        for i, c in enumerate(ints):
            lo, hi = int(host[2 * i]), int(host[2 * i + 1])
            col_range[c] = (lo, hi)
            col_maxabs[c] = float(max(abs(lo), abs(hi)))
        if versions is None:
            versions = (1,) * len(nodes)
        dt = DeviceTable(
            cols, {c: None for c in cols},
            torch.zeros((S, 1), dtype=torch.int64, device=dev),
            torch.full((S, 1), 2**62, dtype=torch.int64, device=dev),
            nr, nr_dev, rmax, tuple(versions), col_maxabs, col_range,
            external=True,
        )
        with self._mu:
            self._tables[(name, nodes)] = dt
        return dt

    def _ensure_columns(
        self, dt: DeviceTable, stores, meta, want, totals=None, views=None,
    ) -> None:
        """Upload any of ``want`` not yet resident. Row bounds come from
        ``totals`` (the caller's capture) or dt.nrows — never a fresh
        nrows read, which could run past the resident MVCC planes."""
        if all(cname in dt.columns for cname in want):
            return
        S = len(stores)
        if views is None:
            views = [s.scan_view() for s in stores]
        bounds = [
            min(
                totals[i] if totals is not None else int(dt.nrows[i]),
                dt.rmax,
                views[i].nrows,
            )
            for i in range(S)
        ]
        for cname in want:
            if cname in dt.columns:
                continue
            ty = meta.schema[cname]
            stack = np.zeros((S, dt.rmax), dtype=ty.np_dtype)
            vstack = None
            reals = []
            for i, v in enumerate(views):
                n0 = bounds[i]
                real = v.col(cname, 0, n0)
                reals.append(real)
                stack[i, :n0] = real
                vm = v.validity(cname, 0, n0)
                if vm is not None:
                    if vstack is None:
                        vstack = np.ones((S, dt.rmax), dtype=np.bool_)
                    vstack[i, :n0] = vm
            if np.issubdtype(stack.dtype, np.integer):
                # stats over REAL rows only: the zero padding would
                # inflate the range and disqualify small-domain keys
                lo = hi = ma = None
                for real in reals:
                    if real.size == 0:
                        continue
                    rlo, rhi = int(real.min()), int(real.max())
                    lo = rlo if lo is None else min(lo, rlo)
                    hi = rhi if hi is None else max(hi, rhi)
                    ma = max(ma or 0.0, float(max(abs(rlo), abs(rhi))))
                dt.col_maxabs[cname] = ma if ma is not None else 0.0
                dt.col_range[cname] = None if lo is None else (lo, hi)
            else:
                dt.col_maxabs[cname] = None
                dt.col_range[cname] = None
            dt.columns[cname] = self._put(stack)
            dt.validity[cname] = None if vstack is None else self._put(vstack)
            self.stats["column_uploads"] += 1


# ---------------------------------------------------------------------------
# Fragment pattern matching
# ---------------------------------------------------------------------------


@dataclass
class _FusablePartial:
    scan: L.Scan
    steps: list  # Filter/Project chain bottom-up (excluding scan/agg)
    agg: L.Aggregate


def _match_partial_fragment(root: L.LogicalPlan) -> Optional[_FusablePartial]:
    if not isinstance(root, L.Aggregate):
        return None
    if any(a.distinct for a in root.aggs):
        return None
    steps = []
    node = root.child
    while isinstance(node, (L.Filter, L.Project)):
        steps.append(node)
        node = node.child
    if not isinstance(node, L.Scan):
        return None
    return _FusablePartial(node, list(reversed(steps)), root)


# ---------------------------------------------------------------------------
# Fused executor
# ---------------------------------------------------------------------------


class FusedExecutor:
    """Runs partial-aggregate fragments through the scan-aggregate kernel
    or the fragment program, and join plans through the fused DAG, on
    ``device``. ``last_route`` names what answered the last fragment
    ("scan_agg", "program" or "dag"), and ``last_rung`` the program's
    rung: ("scalar", None), ("hash", slots) or ("sort", capacity)."""

    def __init__(self, catalog, node_stores, device: torch.device):
        self.catalog = catalog
        self.node_stores = node_stores
        self.device = torch.device(device)
        self.cache = DeviceCache(self.device)
        self._programs: dict = {}
        self._dag = None
        self.last_route: Optional[str] = None
        self.last_rung: Optional[tuple] = None
        # zone-map pruning of the fragment program: blocks left out of
        # the scanned window, and blocks considered, over every query
        self.zone_stats = {"pruned_blocks": 0, "total_blocks": 0}
        # the session's settings, set before each run: the DAG's join
        # formulation, its radix tables' device budget (0: the env knob
        # or the default) and K2's switch (False: no radix join)
        self.join_mode = "auto"
        self.device_memory_limit = 0
        self.enable_pallas_join = None
        # the last fused statement's compile / device / host_merge ms,
        # and their sums over every fused statement (pg_stat_fused)
        self.last_phases: dict = {}
        self.phase_totals: dict = {}

    def forget_table(self, name: str) -> None:
        """Drop ``name``'s device planes and every program and DAG retry
        state keyed by store versions (a table created again under the
        name starts its versions over)."""
        self.cache.drop_table(name)
        self._programs.clear()
        self._dag = None

    def dag_output(self, dplan, snapshot_ts) -> tuple[int, ColumnBatch]:
        """Run a whole plan — joins under an aggregate — through the
        fused DAG (executor/fused_dag.py): (final fragment index,
        gathered batch). Raises NotPorted outside its subset."""
        from opentenbase_tpu_torch.executor.fused_dag import DagRunner

        if self._dag is None:
            self._dag = DagRunner(self)
        out = self._dag.run(dplan, snapshot_ts)
        self.last_route, self.last_rung = "dag", None
        return out

    def fragment_output(
        self, frag: Fragment, snapshot_ts: Optional[int],
        use_pallas: bool = True,
    ) -> Optional[ColumnBatch]:
        """The fragment's gathered output batch (what the motion would
        deliver to the coordinator), or None when the fragment is not a
        scan -> filter/project -> partial aggregate over every shard of
        its table: the caller then hands the plan to ``dag_output``, as
        the reference does. The kernel answers where its certifier takes
        the fragment (and ``use_pallas``, the ``enable_pallas_scan``
        setting, leaves it on), the fragment program otherwise."""
        if frag.motion != "gather":
            return None
        m = _match_partial_fragment(frag.root)
        if m is None:
            return None
        meta = self.catalog.get(m.scan.table)
        if tuple(meta.node_indices) != tuple(frag.nodes):
            return None
        for n in frag.nodes:
            if m.scan.table not in self.node_stores.get(n, {}):
                return None
        # a scan past the budget streams shard-row windows through the
        # fragment program, before and instead of the kernel's route
        if self._resident_bytes(meta, m.scan.columns) > SCAN_HBM_BUDGET:
            return self._fragment_chunked(m, meta, snapshot_ts)
        dtab = self.cache.get(
            m.scan.table, meta, self.node_stores, frag.nodes,
            columns=m.scan.columns,
        )
        out = self._scan_agg(m, dtab, snapshot_ts) if use_pallas else None
        if out is not None:
            self.last_route, self.last_rung = "scan_agg", None
            return out
        # zone-map pruning: the program reads only each shard's window
        # of candidate blocks
        return self._run_program(m, dtab, snapshot_ts,
                                 self._zone_window(m, meta, dtab))

    def _fragment_chunked(self, m, meta, snapshot_ts) -> ColumnBatch:
        """Stream a scan past the budget: fixed-width shard-row windows
        upload one at a time (``DeviceCache.get_window``) and each runs
        the fragment program; the windows' partial rows concatenate, and
        the coordinator's merge combines them as any partials. The
        kernel and zone windows are skipped here, as in the reference:
        the upload dominates. The width is the budget's rows a shard,
        bucketed and halved where the bucket overshoots it."""
        _bytes, row_bytes, S, mx = self._scan_footprint(meta, m.scan.columns)
        budget_rows = max(SCAN_HBM_BUDGET // max(S * row_bytes, 1), 4096)
        W = bucket_size(budget_rows)
        if W > budget_rows:
            W //= 2
        nodes = tuple(meta.node_indices)
        parts: list = []
        start = 0
        while start < mx:
            # no reference to a window outlives its run: the cache evicts
            # it as the next uploads, so one window is resident at a time
            parts.append(self._run_program(m, self.cache.get_window(
                meta.name, meta, self.node_stores, nodes, m.scan.columns,
                start, W), snapshot_ts))
            start += W
        self.cache.stats["chunked_scans"] += 1
        self.cache.stats["scan_chunks"] += len(parts)
        if not parts:  # no rows at all: one empty window answers
            return self._run_program(m, self.cache.get_window(
                meta.name, meta, self.node_stores, nodes, m.scan.columns,
                0, 1), snapshot_ts)
        return concat_batches(parts)

    def _zone_window(self, m, meta, dtab) -> Optional[tuple]:
        """(starts [S] int64, W): per shard, a window of W rows covering
        every zone-map block the scan's predicate may match, W bucketed
        and below ``rmax``; None where pruning saves nothing. The answer
        never depends on the window: its rows still pass the predicate,
        and the rows outside it are proven not to by the blocks' min and
        max. ``zone_stats`` counts the blocks considered and pruned."""
        if not meta.zone_cols:
            return None
        if not m.steps or not isinstance(m.steps[0], L.Filter):
            return None
        bounds = _predicate_bounds(m.steps[0].predicate, m.scan)
        usable = zone_usable_bounds(bounds, meta, m.scan)
        if not usable:
            return None
        starts: list[int] = []
        lens: list[int] = []
        total = pruned = 0
        for node in meta.node_indices:
            store = self.node_stores.get(node, {}).get(m.scan.table)
            if store is None:
                return None
            B = store.ZONE_BLOCK
            nb = -(-store.nrows // B) if store.nrows else 0
            idx = np.nonzero(zone_candidate_blocks(store, usable))[0]
            total += nb
            if len(idx) == 0:
                starts.append(0)
                lens.append(0)
                pruned += nb
            else:
                lo_b, hi_b = int(idx[0]), int(idx[-1]) + 1
                starts.append(lo_b * B)
                lens.append(min(hi_b * B, store.nrows) - lo_b * B)
                pruned += nb - (hi_b - lo_b)
        W = bucket_size(max(max(lens, default=1), 1))
        if W >= dtab.rmax:
            return None  # as wide as the scan: nothing saved
        self.zone_stats["total_blocks"] += total
        self.zone_stats["pruned_blocks"] += pruned
        arr = np.zeros(len(dtab.nrows), dtype=np.int64)
        # clamped so each window stays inside its shard's planes: it only
        # widens leftward, and the extra rows fail the predicate
        arr[: len(starts)] = np.minimum(np.asarray(starts, dtype=np.int64),
                                        max(dtab.rmax - W, 0))
        return arr, W

    def _scan_footprint(self, meta, columns) -> tuple[int, int, int, int]:
        """(resident bytes, row bytes, S, largest shard's rows) of
        caching ``columns`` of a table (with 16 bytes a row of MVCC
        timestamps) at the padded width: the model the chunk trigger
        reads. A table already resident with every wanted column (a
        ``register_external`` table: exact row capacity, compact MVCC
        planes) reports its actual bytes, which the padded estimate
        would overstate."""
        row_bytes = 16 + sum(
            np.dtype(meta.schema[c].np_dtype).itemsize + 1 for c in columns
        )
        mx = 0
        for n in meta.node_indices:
            s = self.node_stores.get(n, {}).get(meta.name)
            if s is not None:
                mx = max(mx, s.nrows)
        S = len(meta.node_indices)
        dt = self.cache._tables.get((meta.name, tuple(meta.node_indices)))
        if dt is not None and all(c in dt.columns for c in columns):
            actual = sum(
                _nbytes(dt.columns[c]) + _nbytes(dt.validity.get(c))
                for c in columns
            ) + _nbytes(dt.xmin) + _nbytes(dt.xmax)
            return actual, row_bytes, S, mx
        return S * bucket_size(max(mx, 1)) * row_bytes, row_bytes, S, mx

    def _resident_bytes(self, meta, columns) -> int:
        return self._scan_footprint(meta, columns)[0]

    # -- the fragment program (the reference's XLA-fused program) ----------
    def _run_program(self, m, dtab, snapshot_ts, zone=None) -> ColumnBatch:
        """The reference's ``_run_xla_fragment``: the fragment's visible
        rows, then its grouping ladder — hash at min(64, cap) slots, hash
        at ``cap``, then sort-based grouping — where a rung whose slots
        collide hands over to the next. The rows are computed once: only
        the slots and the reduction depend on the rung. ``zone``: (starts,
        W) from ``_zone_window``, each shard read over [start, start + W)
        only."""
        rows, specs, param_specs = self._compile(m)
        # compiled on every call, so this query's literals (and the codes
        # of its TEXT constants, which move as dictionaries grow) are the
        # ones bound: eager torch has no compile cost for a cache to save,
        # the reference's jit does
        params = tuple(
            resolve_param(s, self.device, self.catalog.dictionary)
            for s in param_specs
        )
        snap = snapshot_ts if snapshot_ts is not None else 2**61
        keys, vals, k = rows(dtab, m.scan.columns, snap, params, zone)
        if not keys:
            outs = agg_ops.scalar_reduce(
                vals, torch.ones(k, dtype=torch.bool, device=self.device),
                specs)
            batch, _ = self._collect(
                m, [], [(d.reshape(1), v.reshape(1)) for d, v in outs],
                torch.ones(1, dtype=torch.bool, device=self.device), None)
            self.last_route, self.last_rung = "program", ("scalar", None)
            return batch
        for cap in (min(64, DEFAULT_GROUP_CAP), DEFAULT_GROUP_CAP):
            slot, _ngroups, collision = agg_ops.hash_slots(keys, None, cap)
            out_keys, out_vals, gvalid = agg_ops.group_reduce(
                keys, vals, None, slot, cap, specs)
            batch, collided = self._collect(m, out_keys, out_vals, gvalid,
                                            collision)
            if not collided:
                self.last_route, self.last_rung = "program", ("hash", cap)
                return batch
        cap = DEFAULT_GROUP_CAP
        perm, seg, ngroups = agg_ops.group_ids(keys, None)
        out_keys, out_vals, gvalid = agg_ops.group_reduce(
            keys, vals, perm, seg, cap, specs)
        batch, ngroups = self._collect(m, out_keys, out_vals, gvalid,
                                       ngroups)
        if ngroups >= cap:
            raise FusedUnsupported(
                f"group capacity overflow in the sort mode ({cap} groups)")
        self.last_route, self.last_rung = "program", ("sort", cap)
        return batch

    def _compile(self, m: _FusablePartial):
        """(rows, specs, param specs) for the fragment (the part of the
        reference's ``_compile`` before its grouping): ``rows(dtab,
        scan_columns, snap, params)`` returns the group keys and the
        aggregates' arguments as (data, valid) pairs over the visible
        rows, compacted, and their number."""
        comp = ExprCompiler(self.device)
        step_fns = []
        cur_schema = m.scan.schema
        for step in m.steps:
            dids = [c.dict_id for c in cur_schema]
            if isinstance(step, L.Filter):
                step_fns.append(("filter", comp.compile(step.predicate,
                                                        dids)))
            else:
                want = [c.dict_id for c in step.schema]
                step_fns.append(("project", [
                    comp.compile(e, dids,
                                 (w or None) if e.type.is_text else None)
                    for e, w in zip(step.exprs, want)
                ]))
            cur_schema = step.schema
        dids = [c.dict_id for c in cur_schema]
        gfns = [comp.compile(g, dids) for g in m.agg.group_exprs]
        specs: list = []
        afns: list = []
        for a in m.agg.aggs:
            if a.func == "count" and a.arg is None:
                specs.append("count_star")
                afns.append(None)
                continue
            if a.func not in ("sum", "count", "min", "max"):
                raise FusedUnsupported(f"aggregate {a.func} in the "
                                       "fragment program")
            if a.func in ("min", "max") and a.arg.type.is_text:
                # codes follow insertion order, not collation: the
                # host executor ranks them
                raise FusedUnsupported(f"{a.func} over TEXT on the device")
            specs.append(a.func)
            afns.append(comp.compile(a.arg, dids))
        dev = self.device
        # the columns the aggregate reads: only these are compacted
        used = {
            x.index
            for e in (*m.agg.group_exprs,
                      *(a.arg for a in m.agg.aggs if a.arg is not None))
            for x in E.walk(e) if isinstance(x, E.Col)
        }

        def rows(dtab, scan_columns, snap, params, zone=None):
            S, rmax = len(dtab.nrows), dtab.rmax
            xmin, xmax, nrows = dtab.xmin, dtab.xmax, dtab.nrows_dev
            cuts = None
            if zone is not None:
                # each shard's window [start, start + W): one copy of the
                # window's rows, nothing else of the planes is read
                starts, rmax = zone
                cuts = [slice(int(st), int(st) + rmax) for st in starts]
                nrows = torch.clamp(
                    nrows - torch.from_numpy(starts).to(dev), 0, rmax)

            def plane(a):
                if cuts is None:
                    return a.reshape(S * rmax)
                return torch.cat([a[i, c] for i, c in enumerate(cuts)])

            if cuts is not None and xmin.shape[1] != 1:
                xmin = plane(xmin).reshape(S, rmax)
                xmax = plane(xmax).reshape(S, rmax)
            n = S * rmax
            live = (
                (torch.arange(rmax, device=dev)[None, :] < nrows[:, None])
                & (xmin <= snap) & (snap < xmax)
            ).reshape(n)
            env = []
            for c in scan_columns:
                v = dtab.validity[c]
                env.append((plane(dtab.columns[c]),
                            None if v is None else plane(v)))
            mask = live
            for kind, fn in step_fns:
                if kind == "filter":
                    d, v = fn(env, params)
                    keep = d if v is None else (d & v)
                    mask = mask & keep.expand(n)
                else:
                    env = [_bcast(f(env, params), n) for f in fn]
            # the aggregate reads only the visible rows, compacted: no
            # invisible row reaches a scatter (they would all contend
            # for the overflow slot)
            idx, _ = compact_indices(mask)
            env = [gather_cols([c], idx)[0] if i in used else None
                   for i, c in enumerate(env)]
            k = idx.shape[0]
            keys = [_bcast(fn(env, params), k) for fn in gfns]
            vals = [None if fn is None else _bcast(fn(env, params), k)
                    for fn in afns]
            return keys, vals, k

        return rows, tuple(specs), tuple(comp.params)

    def _collect(self, m, out_keys, out_vals, gvalid, flag):
        """(the program's groups as partial rows, ``flag`` on the host):
        the reference's ``_collect``. ``flag`` is the hash rung's
        collision bit or the sort rung's group count, fetched with the
        rows in one transfer."""
        pairs = list(out_keys) + list(out_vals)
        host = to_host_arrays([flag, gvalid]
                        + [x for pair in pairs for x in pair])
        fl = None if flag is None else host[0].item()
        keep = np.nonzero(host[1].reshape(-1))[0]
        cols: dict[str, Column] = {}
        for i, oc in enumerate(m.agg.schema):
            d, v = host[2 + 2 * i], host[3 + 2 * i]
            dd = d.reshape(-1)[keep].astype(oc.type.np_dtype)
            vv = None if v is None else v.reshape(-1)[keep]
            dic = self.catalog.dictionary(oc.dict_id) if oc.dict_id else None
            cols[oc.name] = Column(oc.type, dd, vv, dic)
        return ColumnBatch(cols, len(keep)), fl

    # -- scan-aggregate kernel path (ops/scan_agg.py) ----------------------
    def _scan_agg(
        self, m: _FusablePartial, dtab: DeviceTable, snapshot_ts
    ) -> Optional[ColumnBatch]:
        """Route a filter+SUM/COUNT fragment — ungrouped, or grouped by
        small-domain keys (TPC-H Q1's shape) — through the kernel, or
        return None where it does not apply: a NULL-able scan column, or
        a fragment outside the reference certifier's subset, re-run
        against the current column stats on every call (data growth can
        push values past its bounds)."""
        if any(dtab.validity[c] is not None for c in m.scan.columns):
            return None
        col_bounds = [dtab.col_maxabs.get(c) for c in m.scan.columns]
        col_ranges = [dtab.col_range.get(c) for c in m.scan.columns]
        try:
            preds, agg_args, group_plan, sig = self._scan_agg_plan(
                m, col_bounds, col_ranges
            )
            key = ("scan_agg", m.agg.key(), sig)
            compiled = self._programs.get(key)
            if compiled is None:
                compiled = self._compile_spec(preds, agg_args,
                                              group_plan) + (
                    tuple(m.scan.columns),
                )
                self._programs[key] = compiled
        except sa.PallasUnsupported:
            return None  # outside the certified subset: the program runs
        spec, specs, _scan_cols = compiled
        decoders, n_groups = (
            (group_plan[1], group_plan[2]) if group_plan else (None, 1)
        )
        snap = snapshot_ts if snapshot_ts is not None else 2**61
        cols = [dtab.columns[m.scan.columns[i]] for i in spec.cols]
        sums, counts = sa.scan_agg(
            cols, dtab.xmin, dtab.xmax, dtab.nrows_dev, snap, spec,
            max_nrows=int(dtab.nrows.max(initial=0)),
        )
        sums, counts = to_host_arrays([sums, counts])
        S = len(dtab.nrows)
        if decoders is None:
            return self._scalar_batch(m, sums[:, 0], counts[:, 0], specs, S)
        return self._grouped_batch(
            m, sums, counts, specs, decoders, S, n_groups
        )

    def _scalar_batch(self, m, sums, counts, specs, S) -> ColumnBatch:
        # per-shard partial rows (the coordinator's merge aggs combine them)
        cols_out: dict[str, Column] = {}
        e = 0
        for oc, spec in zip(m.agg.schema, specs):
            if spec in ("count_star", "count"):
                d = counts.astype(np.int64)
                v = np.ones(S, dtype=bool)
            else:  # sum
                d = sums[:, e].astype(oc.type.np_dtype)
                v = counts > 0
                e += 1
            cols_out[oc.name] = Column(oc.type, d, v, None)
        return ColumnBatch(cols_out, S)

    def _grouped_batch(
        self, m, sums, counts, specs, decoders, S, n_groups
    ) -> ColumnBatch:
        """[S, G] grouped partials -> (shard, group) partial rows with
        count > 0, keys decoded from the dense joint index."""
        keep = counts > 0  # [S, G]
        sidx, gidx = np.nonzero(keep)
        nkeys = len(m.agg.group_exprs)
        cols_out: dict[str, Column] = {}
        for i, oc in enumerate(m.agg.schema[:nkeys]):
            _ci, lo, domain, stride = decoders[i]
            vals = (lo + (gidx // stride) % domain).astype(oc.type.np_dtype)
            dic = self.catalog.dictionary(oc.dict_id) if oc.dict_id else None
            cols_out[oc.name] = Column(oc.type, vals, None, dic)
        e = 0
        for oc, spec in zip(m.agg.schema[nkeys:], specs):
            if spec in ("count_star", "count"):
                d = counts[sidx, gidx].astype(np.int64)
            else:  # sum
                d = sums[sidx, gidx, e].astype(oc.type.np_dtype)
                e += 1
            cols_out[oc.name] = Column(oc.type, d, None, None)
        return ColumnBatch(cols_out, len(sidx))

    def _scan_agg_plan(self, m: _FusablePartial, col_bounds, col_ranges):
        """Inline the Filter/Project chain to scan-schema expressions and
        certify them against current column bounds (the reference's
        _pallas_plan). Returns (preds, agg_args, group_plan, sig) where
        sig captures every certification decision and group_plan is None
        (ungrouped) or (key_expr, decoders, n_groups). Raises
        PallasUnsupported outside the certified subset."""
        project_chain: list = []
        preds: list = []
        for step in m.steps:
            if isinstance(step, L.Filter):
                preds.append(
                    sa.inline_projects(step.predicate, project_chain)
                )
            else:
                project_chain.append(tuple(
                    sa.inline_projects(e, project_chain)
                    for e in step.exprs
                ))
        for p in preds:
            if not sa.certify_predicate(p, col_bounds):
                raise sa.PallasUnsupported("predicate")
        group_plan = None
        sig_parts: list = []
        if m.agg.group_exprs:
            key_exprs = [
                sa.inline_projects(g, project_chain)
                for g in m.agg.group_exprs
            ]
            key_expr, decoders, n_groups = sa.plan_group_keys(
                key_exprs, col_ranges
            )
            group_plan = (key_expr, decoders, n_groups)
            sig_parts.append(("groups", tuple(decoders)))
        agg_args: list = []
        for a in m.agg.aggs:
            if a.func == "count":
                if a.arg is not None:
                    # count(expr) == count(*) only when expr can never be
                    # NULL: columns have no validity masks here (gated by
                    # the caller) AND the expression stays in the bounded
                    # arithmetic subset
                    arg = sa.inline_projects(a.arg, project_chain)
                    if sa.bound(arg, col_bounds) is None:
                        raise sa.PallasUnsupported("nullable count arg")
                agg_args.append(None)
                sig_parts.append("count")
                continue
            if a.func != "sum":
                raise sa.PallasUnsupported(a.func)
            arg = sa.inline_projects(a.arg, project_chain)
            dec = sa.decompose_value(arg, col_bounds)
            if dec is None:
                raise sa.PallasUnsupported("value bound")
            agg_args.append(arg)
            sig_parts.append(f"sum{len(dec)}")
        return preds, agg_args, group_plan, tuple(sig_parts)

    def _compile_spec(self, preds, agg_args, group_plan):
        """(ScanAggSpec, per-agg output kinds) for a certified plan."""
        specs = ["count_star" if a is None else "sum" for a in agg_args]
        values = [a for a in agg_args if a is not None]
        key_expr, n_groups = None, 1
        if group_plan is not None:
            key_expr, _decoders, n_groups = group_plan
        return sa.compile_spec(preds, key_expr, values, n_groups), specs


def _bcast(kv, n: int):
    """A (data, valid) pair at ``n`` rows: a 0-d constant broadcasts."""
    d, v = kv
    if d.dim() == 0:
        d = d.expand(n)
    if v is not None and v.dim() == 0:
        v = v.expand(n)
    return (d, v)


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()

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

Ported: the full upload of ``DeviceCache`` for any table (all shards, or
one replica of a replicated table; compact [S, 1] MVCC planes when every
shard is uniform), device-resident external tables
(``register_external``), the host column stats the certifier reads, the
fragment matcher, ``fragment_output`` (the kernel, then the program) and
``dag_output``. Not ported: delta-tail uploads, MVCC replay, zone
windows and chunked scans: a scan whose resident footprint passes
``SCAN_HBM_BUDGET``, which the reference streams in windows, raises
NotPorted. Where the reference's program declines and its host executor
answers (min/max over TEXT, the sort mode past its capacity), the port
raises NotPorted.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opentenbase_tpu_torch.errors import NotPorted
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
from opentenbase_tpu_torch.storage.table import ColumnBatch

# slots of the fragment program's largest hash rung (the reference's
# DEFAULT_GROUP_CAP); the first rung takes min(64, this)
DEFAULT_GROUP_CAP = 1024

# Resident ceiling for one table's scan columns: past it the reference
# streams fixed-width shard windows instead of caching the whole table
# (its chunked scan, not ported: the port raises NotPorted there).
SCAN_HBM_BUDGET = int(os.environ.get("OTB_SCAN_HBM_BUDGET", 8_000_000_000))


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


class DeviceCache:
    """Uploads stacked shard columns, keyed by store versions. Any
    version change rebuilds the table (full upload only); columns upload
    lazily on first use."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._tables: dict = {}
        self._mu = threading.RLock()

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

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
            if cached.external:
                missing = [c for c in want if c not in cached.columns]
                if missing:
                    raise KeyError(f"external table {name!r} holds no "
                                   f"column {missing[0]!r}")
                return cached
            self._ensure_columns(cached, stores, meta, want)
            return cached
        self._tables.pop((name, nodes), None)  # free the stale planes
        S = len(stores)
        # one coherent capture per store: nrows and the planes are read
        # at one moment, so every plane slices the same prefix
        views = [s.scan_view() for s in stores]
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
        )
        self._ensure_columns(dt, stores, meta, want, totals, views)
        self._tables[(name, nodes)] = dt
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
        host = _to_host([torch.cat(stats)])[0] if stats else []
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
        self, frag: Fragment, snapshot_ts: Optional[int]
    ) -> Optional[ColumnBatch]:
        """The fragment's gathered output batch (what the motion would
        deliver to the coordinator), or None when the fragment is not a
        scan -> filter/project -> partial aggregate over every shard of
        its table: the caller then hands the plan to ``dag_output``, as
        the reference does. The kernel answers where its certifier takes
        the fragment, the fragment program otherwise."""
        if frag.motion != "gather":
            return None
        m = _match_partial_fragment(frag.root)
        if m is None:
            return None
        meta = self.catalog.get(m.scan.table)
        if tuple(meta.node_indices) != tuple(frag.nodes):
            return None
        if self._resident_bytes(meta, m.scan.columns) > SCAN_HBM_BUDGET:
            raise NotPorted(
                "chunked scan (the scan's resident footprint passes "
                "OTB_SCAN_HBM_BUDGET: the reference streams shard windows)")
        dtab = self.cache.get(
            m.scan.table, meta, self.node_stores, frag.nodes,
            columns=m.scan.columns,
        )
        out = self._scan_agg(m, dtab, snapshot_ts)
        if out is not None:
            self.last_route, self.last_rung = "scan_agg", None
            return out
        return self._run_program(m, dtab, snapshot_ts)

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
    def _run_program(self, m, dtab, snapshot_ts) -> ColumnBatch:
        """The reference's ``_run_xla_fragment``: the fragment's visible
        rows, then its grouping ladder — hash at min(64, cap) slots, hash
        at ``cap``, then sort-based grouping — where a rung whose slots
        collide hands over to the next. The rows are computed once: only
        the slots and the reduction depend on the rung."""
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
        keys, vals, k = rows(dtab, m.scan.columns, snap, params)
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
            raise NotPorted(
                f"group capacity overflow in the sort mode ({cap} groups; "
                "the reference answers on its host executor)")
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
                raise NotPorted(f"aggregate {a.func} in the fragment "
                                "program")
            if a.func in ("min", "max") and a.arg.type.is_text:
                # codes follow insertion order, not collation: the
                # reference's host executor ranks them
                raise NotPorted(f"{a.func} over TEXT on the device (the "
                                "reference answers it on its host "
                                "executor)")
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

        def rows(dtab, scan_columns, snap, params):
            S, rmax = len(dtab.nrows), dtab.rmax
            n = S * rmax
            live = (
                (torch.arange(rmax, device=dev)[None, :]
                 < dtab.nrows_dev[:, None])
                & (dtab.xmin <= snap) & (snap < dtab.xmax)
            ).reshape(n)
            env = []
            for c in scan_columns:
                v = dtab.validity[c]
                env.append((dtab.columns[c].reshape(n),
                            None if v is None else v.reshape(n)))
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
            idx = compact_indices(mask)
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
        host = _to_host([flag, gvalid]
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
        sums, counts = _to_host([sums, counts])
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


def _to_host(tensors: list) -> list:
    """numpy arrays of ``tensors`` (None stays None) from one
    device-to-host transfer: their bytes ride one buffer, so the host
    waits for the device once. The widest elements go first, so each
    array is an aligned view into the buffer (no copy on the host)."""
    flat = [None if t is None else t.reshape(-1).contiguous()
            for t in tensors]
    order = sorted((i for i, f in enumerate(flat) if f is not None),
                   key=lambda i: -flat[i].element_size())
    if not order:
        return flat
    buf = torch.cat([flat[i].view(torch.uint8) for i in order]).cpu().numpy()
    out, off = list(flat), 0
    for i in order:
        t = tensors[i]
        nb = flat[i].numel() * flat[i].element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[i] = buf[off:off + nb].view(dtype).reshape(t.shape)
        off += nb
    return out

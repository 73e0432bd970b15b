"""Fused single-fragment executor on one GPU (subset of the reference's
opentenbase_tpu/executor/fused.py).

All shards of a table live stacked on the device as [S, Rmax] planes per
column plus the xmin/xmax commit-timestamp planes; the shard axis is the
leading tensor dimension, where the reference spread it over a device
mesh. An eligible fragment (scan -> filter/project chain -> partial
aggregate, gathered to the coordinator) runs as one launch of the
scan-aggregate kernel (ops/scan_agg.py) and yields the per-shard partial
rows the coordinator merges. Any other plan goes to ``dag_output``, the
fused DAG (executor/fused_dag.py), which runs joins under a scalar
aggregate over the same cached planes.

Ported: the full upload of ``DeviceCache`` for any table (all shards, or
one replica of a replicated table; compact [S, 1] MVCC planes when every
shard is uniform), the host column stats the certifier reads, the
fragment matcher, the kernel route of ``fragment_output`` and
``dag_output``. Not ported: delta-tail uploads, MVCC replay, zone
windows, chunked scans and the XLA-fused program — a fragment of the
kernel's shape that the kernel does not take raises NotPorted.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.ops import scan_agg as sa
from opentenbase_tpu_torch.ops.filter import bucket_size
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan.distribute import Fragment
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import ColumnBatch


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
    """Runs eligible partial-aggregate fragments through the scan-aggregate
    kernel, and join plans through the fused DAG, on ``device``."""

    def __init__(self, catalog, node_stores, device: torch.device):
        self.catalog = catalog
        self.node_stores = node_stores
        self.device = torch.device(device)
        self.cache = DeviceCache(self.device)
        self._programs: dict = {}
        self._dag = None

    def dag_output(self, dplan, snapshot_ts) -> tuple[int, ColumnBatch]:
        """Run a whole plan — joins under a scalar aggregate — through the
        fused DAG (executor/fused_dag.py): (final fragment index,
        gathered batch). Raises NotPorted outside its subset."""
        from opentenbase_tpu_torch.executor.fused_dag import DagRunner

        if self._dag is None:
            self._dag = DagRunner(self)
        return self._dag.run(dplan, snapshot_ts)

    def fragment_output(
        self, frag: Fragment, snapshot_ts: Optional[int],
    ) -> Optional[ColumnBatch]:
        """The fragment's gathered output batch (what the motion would
        deliver to the coordinator), or None when the fragment is not a
        scan -> filter/project -> partial aggregate over every shard of
        its table: the caller then hands the plan to ``dag_output``, as
        the reference does. Raises NotPorted for a fragment of that shape
        the kernel does not take (the reference runs it through its
        XLA-fused program, which is not ported)."""
        if frag.motion != "gather":
            return None
        m = _match_partial_fragment(frag.root)
        if m is None:
            return None
        meta = self.catalog.get(m.scan.table)
        if tuple(meta.node_indices) != tuple(frag.nodes):
            return None
        for c in m.scan.schema:
            if c.type.id == t.TypeId.TEXT:
                raise NotPorted(f"text scan column {c.name!r}")
        dtab = self.cache.get(
            m.scan.table, meta, self.node_stores, frag.nodes,
            columns=m.scan.columns,
        )
        for c in m.scan.columns:
            if dtab.validity[c] is not None:
                raise NotPorted(f"NULL-able scan column {c!r}")
        return self._scan_agg(m, dtab, snapshot_ts)

    # -- scan-aggregate kernel path (ops/scan_agg.py) ----------------------
    def _scan_agg(
        self, m: _FusablePartial, dtab: DeviceTable, snapshot_ts
    ) -> ColumnBatch:
        """Route a filter+SUM/COUNT fragment — ungrouped, or grouped by
        small-domain keys (TPC-H Q1's shape) — through the kernel.
        Eligibility is the reference certifier's, re-run against the
        current column stats on every call (data growth can push values
        past its bounds)."""
        col_bounds = [dtab.col_maxabs.get(c) for c in m.scan.columns]
        col_ranges = [dtab.col_range.get(c) for c in m.scan.columns]
        try:
            preds, agg_args, group_plan, sig = self._scan_agg_plan(
                m, col_bounds, col_ranges
            )
            key = ("scan_agg", m.agg.key(), sig)
            compiled = self._programs.get(key)
            if compiled is None:
                compiled = self._compile(preds, agg_args, group_plan) + (
                    tuple(m.scan.columns),
                )
                self._programs[key] = compiled
        except sa.PallasUnsupported as e:
            raise NotPorted(
                f"aggregate outside the kernel's certified subset ({e}); "
                "the reference runs it through its XLA-fused program"
            ) from None
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
        sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
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

    def _compile(self, preds, agg_args, group_plan):
        """(ScanAggSpec, per-agg output kinds) for a certified plan."""
        specs = ["count_star" if a is None else "sum" for a in agg_args]
        values = [a for a in agg_args if a is not None]
        key_expr, n_groups = None, 1
        if group_plan is not None:
            key_expr, _decoders, n_groups = group_plan
        return sa.compile_spec(preds, key_expr, values, n_groups), specs

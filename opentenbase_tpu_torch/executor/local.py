"""Per-datanode plan evaluation, the host executor (the reference's
opentenbase_tpu/executor/local.py).

A LocalExecutor evaluates a logical plan bottom-up over whole padded
columns on ``device``: every intermediate is a ``DevBatch`` of (data,
valid) tensor pairs padded to a power-of-two bucket, with a live mask in
place of per-row qual checks. It runs one fragment against one
datanode's shard stores (``DistExecutor``, executor/dist.py), and the
coordinator's plan over the gathered fragment outputs (``remote_inputs``),
the fused route's merge among them (on the CPU for a few partial rows,
as the reference runs its merge on the host's devices, and on the
cluster's device for many: ``engine.merge_device``). With no ``device``
it runs on the first CUDA device, and without CUDA it raises.

Scans read one coherent ``scan_view`` of a store: the snapshot's
``xmin <= snap < xmax`` test, the pending delta rows, and the running
transaction's own writes laid over it (insert ranges made live, deleted
positions made dead, positional over the same view). Expressions bind
through the port's ``ExprCompiler`` on the executor's device, so the
device and the coordinator share one set of semantics (FLOAT8 computed
in float32, division by zero NULL). TEXT values stay dictionary codes:
grouping and equality work on codes, ORDER BY, min and max on each
code's rank in the sorted dictionary, and a join or a UNION over two
dictionaries translates one side's codes into the other's.

Joins: inner, left, right (a flipped left), full, semi and anti, through
the radix table for a single integer-family key and otherwise the joint
encode + sort-merge (ops/join.py); ``last_join_mode`` names which
answered. Window functions run on the device too (the reference runs
them on the host in numpy): stable sort passes, scans and prefix
differences, min and max through order-independent reductions.

Every ``int(...)`` of a device value is a round trip: the operators
read one count each where they size an output, and ``to_host`` brings a
batch back in one transfer.

Within-fragment parallel workers (``run_fragment_parallel``, a datanode
process's ``parallel`` > 1): a partial aggregate over a filter/project
chain to one base scan is split over K host threads, each a
LocalExecutor whose scan reads and uploads one contiguous row block
(``scan_block``), and the block partials are merged by a second
aggregate on the same device. The threads share the device's default
stream, so no tensor crosses streams (the caching allocator needs no
``record_stream``); the GIL covers the Python between their kernels.

The write path's row location lives here too (``predicate_rows``, the
reference's ``LocalExecutor.predicate_rows``): simple predicates in
numpy over a store's base rows and delta tail, the rest through the
ExprCompiler on the cluster's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.catalog import Catalog
from opentenbase_tpu_torch.device import resolve_device
from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.ops import LITERAL_DICT
from opentenbase_tpu_torch.ops import agg as agg_ops
from opentenbase_tpu_torch.ops import join as join_ops
from opentenbase_tpu_torch.ops import sort as sort_ops
from opentenbase_tpu_torch.ops.expr import (
    DictTranslateParam,
    ExprCompiler,
    resolve_param,
    torch_dtype,
)
from opentenbase_tpu_torch.ops.filter import (
    bucket_size,
    compact_indices,
    gather_cols,
)
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan import texpr as E
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import (
    ColumnBatch,
    zone_candidate_blocks,
    zone_usable_bounds,
)
from opentenbase_tpu_torch.utils.hashing import _GOLDEN, _M32, hash32_torch


@dataclass
class DevBatch:
    """Columns as (data, valid_or_None) tensor pairs of ``n`` padded
    rows, and the live rows (``mask``; None: all ``n`` live)."""

    schema: tuple[L.OutCol, ...]
    cols: list
    mask: Optional[torch.Tensor]
    n: int


class ExecError(RuntimeError):
    pass


class LocalExecutor:
    """Evaluates a logical plan against one datanode's shard of every
    table (``stores``: table -> ShardStore) and the motioned inputs
    (``remote_inputs``: fragment index -> ColumnBatch), on ``device``."""

    def __init__(
        self,
        catalog: Catalog,
        remote_inputs: Optional[dict] = None,
        *,
        stores: Optional[dict] = None,
        snapshot_ts: Optional[int] = None,
        subquery_values: Optional[list] = None,
        own_writes: Optional[dict] = None,
        device=None,
        instrument: bool = False,
        fold_on_read: bool = False,
        cancel_check=None,
    ):
        self.catalog = catalog
        self.stores = stores or {}
        self.snapshot_ts = snapshot_ts
        self.remote_inputs = remote_inputs or {}
        self._subquery_values = subquery_values
        # table -> (insert ranges, deleted positions): the transaction's
        # own uncommitted writes, laid over the snapshot
        self.own_writes = own_writes or {}
        self.device = resolve_device(device)
        # which formulation answered the last join ("radix" or "merge"),
        # and every join's, in evaluation order, a merge with the reason
        # the radix route declined it ("merge(passes=2)", ...)
        self.last_join_mode: Optional[str] = None
        self.join_modes: list[str] = []
        # bytes this executor moved to the device (scans, motioned inputs)
        self.h2d_bytes = 0
        # zone-map pruning over this executor's scans
        self.zone_total_blocks = 0
        self.zone_pruned_blocks = 0
        # (dictionary id, its size) -> collation ranks and their inverse
        self._ranks: dict = {}
        # per-operator instrumentation (EXPLAIN ANALYZE): pre-order
        # records {depth, op, detail, ms, rows, batch_rows}; None = off
        self.op_records: Optional[list[dict]] = [] if instrument else None
        self._op_depth = 0
        # enable_delta_scan = off: scans fold the pending deltas first
        self._fold_on_read = fold_on_read
        # the delta-resident rows the last scan served
        self.last_scan_delta_rows = 0
        # a within-fragment parallel worker's base scan: this contiguous
        # row block only (execParallel.c's parallel seq scan chunking;
        # ``run_fragment_parallel`` merges the blocks' partials)
        self.scan_block: Optional[tuple[int, int]] = None
        # polled before every operator: raises when the coordinator
        # abandoned the fragment (dn/server.py ``cancel_fragment``)
        self._cancel_check = cancel_check

    # -- expression binding ---------------------------------------------
    def _bind(self, exprs, schema, want_dids=None):
        """Compile ``exprs`` over ``schema`` with one shared param list:
        (functions, params bound on the executor's device)."""
        comp = ExprCompiler(self.device)
        dids = [c.dict_id for c in schema]
        fns = []
        for i, e in enumerate(exprs):
            want = None
            if want_dids is not None and e.type.is_text:
                want = want_dids[i] or LITERAL_DICT
            fns.append(comp.compile(e, dids, want))
        params = tuple(
            resolve_param(s, self.device, self.catalog.dictionary,
                          self._subquery_values)
            for s in comp.params
        )
        return fns, params

    # -- statement entry -------------------------------------------------
    def execute(self, splan: L.StatementPlan) -> ColumnBatch:
        """A whole statement plan: its subplans (InitPlans) first, in
        registration order, each one's scalar visible to the later ones
        and to the root."""
        self._subquery_values = []
        for sp in splan.subplans:
            b = self.run_plan(sp)
            if b.nrows > 1:
                raise ExecError("more than one row returned by a subquery "
                                "used as an expression")
            col0 = next(iter(b.columns.values()), None)
            ty = sp.schema[0].type
            if b.nrows == 0 or col0 is None or not col0.valid_mask[0]:
                self._subquery_values.append((None, ty))
            else:
                self._subquery_values.append((col0.data[0], ty))
        return self.run_plan(splan.root)

    def run_plan(self, root: L.LogicalPlan) -> ColumnBatch:
        """Evaluate one plan tree (no subplan handling) to a host batch."""
        return self.to_host(self.eval(root))

    def run_plan_partitioned(self, root: L.LogicalPlan, positions,
                             ndest: int):
        """Evaluate ``root`` for a redistribute motion: (the host batch
        with its rows grouped by destination slot, each slot's rows in
        their order, and the slot counts), or None where a key is a
        float (the caller partitions on the host). The slot is the
        placement hash of ``hash_batch_columns`` (executor/dist.py)
        modulo ``ndest``, computed on the device, so the rows come back
        in one transfer and split on the host without a copy."""
        if any(root.schema[p].type.id in (t.TypeId.FLOAT4, t.TypeId.FLOAT8)
               for p in positions):
            return None
        b = self.eval(root)
        cols = [_bcast_pair(c, b.n) for c in b.cols]
        if b.mask is not None:
            idx, _ = compact_indices(b.mask)
            cols = gather_cols(cols, idx)
        slot = self._placement_hash(cols, b.schema, positions) % ndest
        order = torch.sort(slot, stable=True).indices
        cols = gather_cols(cols, order)
        counts = torch.bincount(slot, minlength=ndest)
        host = to_host_arrays([counts] + [x for pair in cols for x in pair])
        return (self._host_batch(b.schema, host[1:],
                                 cols[0][0].shape[0] if cols else 0),
                host[0].tolist())

    def _placement_hash(self, cols, schema, positions) -> torch.Tensor:
        """``hash_batch_columns`` on the device, bit for bit: each key's
        murmur mix (a TEXT code through its dictionary's string hashes),
        0 for a NULL, combined as ``combine_hashes`` does, in int64 lanes
        holding uint32 values."""
        acc = None
        for p in positions:
            d, v = cols[p]
            oc = schema[p]
            if oc.type.is_text:
                dic = (self.catalog.dictionary(oc.dict_id) if oc.dict_id
                       else self.catalog.literals)
                if len(dic):
                    harr = self._upload(dic.hash_array().astype(np.int64))
                    d = harr[d.long().clamp(0, len(dic) - 1)]
                else:
                    d = torch.zeros_like(d, dtype=torch.int64)
            h = hash32_torch(d)
            if v is not None:
                h = torch.where(v, h, 0)
            acc = h if acc is None else acc ^ (
                (h + _GOLDEN + ((acc << 6) & _M32) + (acc >> 2)) & _M32)
        return acc

    # -- host materialization --------------------------------------------
    def to_host(self, b: DevBatch) -> ColumnBatch:
        """The live rows as a host batch: compacted on the device, then
        every column in one transfer."""
        cols = [(_bcast(d, b.n), None if v is None else _bcast(v, b.n))
                for d, v in b.cols]
        if b.mask is not None:
            idx, _ = compact_indices(b.mask)
            cols = gather_cols(cols, idx)
            n = idx.shape[0]
        else:
            n = b.n
        return self._host_batch(
            b.schema, to_host_arrays([x for pair in cols for x in pair]), n)

    def _host_batch(self, schema, flat: list, n: int) -> ColumnBatch:
        """A ColumnBatch of host (data, valid) arrays, interleaved in
        ``flat``, each column typed and given its dictionary."""
        out: dict[str, Column] = {}
        used: dict[str, int] = {}
        for i, oc in enumerate(schema):
            d, v = flat[2 * i], flat[2 * i + 1]
            name = oc.name
            if name in out:
                used[name] = used.get(name, 0) + 1
                name = f"{name}_{used[oc.name]}"
            ty = oc.type
            if oc.dict_id:
                dic = self.catalog.dictionary(oc.dict_id)
            else:  # computed TEXT codes index the literal pool
                dic = self.catalog.literals if ty.is_text else None
            out[name] = Column(ty, d.astype(ty.np_dtype), v, dic)
        return ColumnBatch(out, n)

    def _upload(self, parts, padded: Optional[int] = None,
                fill=0) -> torch.Tensor:
        """An array on the executor's device: ``parts`` (a numpy array, or
        a list of them) one after another, padded with ``fill`` to
        ``padded`` rows where given (the padding is written on the
        device, never copied from the host)."""
        if isinstance(parts, np.ndarray):
            parts = [parts]
        n = sum(len(p) for p in parts)
        self.h2d_bytes += sum(p.nbytes for p in parts)
        if len(parts) == 1 and (padded is None or padded == n):
            return _tensor(parts[0]).to(self.device)
        out = torch.empty(n if padded is None else padded,
                          dtype=torch.from_numpy(parts[0][:0].copy()).dtype,
                          device=self.device)
        off = 0
        for p in parts:
            out[off:off + len(p)].copy_(_tensor(p))
            off += len(p)
        out[off:] = fill
        return out

    # -- plan dispatch ----------------------------------------------------
    def eval(self, plan: L.LogicalPlan) -> DevBatch:
        if self._cancel_check is not None:
            # an abandoned fragment stops at the next operator boundary
            self._cancel_check()
        m = getattr(self, f"_eval_{type(plan).__name__.lower()}", None)
        if m is None:
            raise NotPorted(f"host operator {type(plan).__name__}")
        recs = self.op_records
        if recs is None:
            return m(plan)
        # instrumented (EXPLAIN ANALYZE): records in pre-order, so the
        # list reads as the plan tree; times include the children
        # (instrument.c's actual-total), and rows cost a device count
        rec = {"depth": self._op_depth, "op": type(plan).__name__,
               "detail": _op_detail(plan)}
        recs.append(rec)
        self._op_depth += 1
        t0 = time.perf_counter()
        try:
            out = m(plan)
        finally:
            self._op_depth -= 1
        rec["ms"] = (time.perf_counter() - t0) * 1000.0
        rec["rows"] = (int(out.n) if out.mask is None
                       else int(_bcast(out.mask, out.n).sum()))
        rec["batch_rows"] = int(out.n)
        if rec["op"] == "Join" and self.last_join_mode:
            rec["detail"] = (f"{rec['detail'] or ''} "
                             f"({self.last_join_mode})").strip()
        elif rec["op"] == "Scan" and self.last_scan_delta_rows:
            rec["detail"] = (f"{rec['detail'] or ''} (delta-resident: "
                             f"{self.last_scan_delta_rows} rows)").strip()
        return out

    def _eval_remotesource(self, plan) -> DevBatch:
        batch = self.remote_inputs.get(plan.fragment)
        if batch is None:
            raise ExecError(f"no input for fragment {plan.fragment}")
        return self._batch_to_dev(batch, plan.schema)

    def _batch_to_dev(self, batch: ColumnBatch, schema) -> DevBatch:
        nrows = batch.nrows
        padded = bucket_size(max(nrows, 1))
        cols = []
        for col in batch.columns.values():
            d = self._upload([np.asarray(col.data)], padded)
            v = None if col.validity is None else self._upload(
                [np.asarray(col.validity)], padded, False)
            cols.append((d, v))
        return DevBatch(tuple(schema), cols, self._live(nrows, padded),
                        padded)

    def _live(self, nrows: int, padded: int) -> torch.Tensor:
        return torch.arange(padded, device=self.device) < nrows

    # -- leaves -----------------------------------------------------------
    def _eval_scan(self, plan: L.Scan, row_idx=None) -> DevBatch:
        """``row_idx``: an optional physical row subset (zone-map
        pruning); callers passing it have ruled out own-write overlays,
        whose positions cover the full store."""
        store = self._foreign_store(plan.table)
        if store is None:
            store = self.stores.get(plan.table)
        if store is None:
            raise ExecError(f"no shard for table {plan.table} on this node")
        # one coherent capture: every column and both MVCC planes read
        # the same fully written prefix, base rows and delta tail alike
        view = store.scan_view(fold=self._fold_on_read)
        n0 = view.nrows
        # a block worker reads (and uploads) its rows [s0, e0) only
        s0, e0 = 0, n0
        blk = self.scan_block
        if blk is not None:
            assert row_idx is None and not self.own_writes
            s0 = max(0, blk[0])
            e0 = max(min(blk[1], n0), s0)
        nrows = (e0 - s0) if row_idx is None else len(row_idx)
        padded = bucket_size(max(nrows, 1))
        # the base rows read the store's own arrays (no copy on the
        # host), the delta tail its assembled rows; both upload into the
        # padded device column
        b0 = min(view.base_rows, n0)
        segs = [(max(s, s0), min(e, e0)) for s, e in ((0, b0), (b0, n0))]
        segs = [(s, e) for s, e in segs if e > s] or [(s0, s0)]
        cols = []
        for name in plan.columns:
            if row_idx is None:
                d = self._upload([view.col(name, s, e) for s, e in segs],
                                 padded)
                v = view.validity(name, s0, e0)
            else:
                d = self._upload([view.col_at(name, row_idx)], padded)
                v = view.validity_at(name, row_idx)
            cols.append((d, None if v is None
                         else self._upload([v], padded, False)))
        live = np.zeros(padded, dtype=np.bool_)
        live[:nrows] = True
        if self.snapshot_ts is not None:
            snap = np.int64(self.snapshot_ts)
            if row_idx is None:
                for s, e in segs:
                    live[s - s0:e - s0] &= ((view.xmin(s, e) <= snap)
                                            & (snap < view.xmax(s, e)))
            else:
                live[:nrows] &= ((view.xmin_at(row_idx) <= snap)
                                 & (snap < view.xmax_at(row_idx)))
        self.last_scan_delta_rows = (
            view.delta_rows(s0, e0) if row_idx is None
            else int((np.asarray(row_idx) >= view.base_rows).sum()))
        store.note_delta_read(self.last_scan_delta_rows)
        own = self.own_writes.get(plan.table)
        if own is not None:
            assert row_idx is None, "own writes are positional"
            ins_ranges, del_idx = own
            for s, e in ins_ranges:
                live[s:min(e, nrows)] = True
            if len(del_idx):
                live[np.asarray(del_idx)] = False
        return DevBatch(plan.schema, cols, self._upload(live), padded)

    def _foreign_store(self, table: str):
        """A foreign table's rows, read from its source at scan time
        (fdw.py); None for any other table."""
        meta = self.catalog.get(table) if self.catalog.has(table) else None
        if getattr(meta, "foreign", None) is None:
            return None
        from opentenbase_tpu_torch.fdw import foreign_store

        return foreign_store(meta)

    def _eval_valuesscan(self, plan: L.ValuesScan) -> DevBatch:
        nrows = len(plan.rows)
        padded = bucket_size(max(nrows, 1))
        cols = []
        for ci, oc in enumerate(plan.schema):
            data = np.zeros(padded, dtype=oc.type.np_dtype)
            valid = np.zeros(padded, dtype=np.bool_)
            for ri, row in enumerate(plan.rows):
                e = row[ci]
                if isinstance(e, E.Const) and e.value is None:
                    continue
                if isinstance(e, E.Const) and not oc.type.is_text:
                    data[ri] = e.value
                    valid[ri] = True
                    continue
                # anything else (TEXT, a subquery's value, a closed
                # expression) through the compiler over a no-column row,
                # TEXT straight into the target dictionary
                want = [oc.dict_id] if oc.type.is_text else None
                fns, params = self._bind([e], (), want_dids=want)
                dv, vv = fns[0]([], params)
                if vv is not None and not bool(vv.reshape(-1)[0]):
                    continue
                data[ri] = dv.reshape(-1)[0].item()
                valid[ri] = True
            all_valid = nrows > 0 and bool(valid[:nrows].all())
            cols.append((self._upload(data),
                         None if all_valid else self._upload(valid)))
        return DevBatch(plan.schema, cols, self._live(nrows, padded),
                        padded)

    # -- filter / project --------------------------------------------------
    def _eval_filter(self, plan: L.Filter) -> DevBatch:
        child = None
        if isinstance(plan.child, L.Scan):
            child = self._eval_scan_pruned(plan.child, plan.predicate)
        if child is None:
            child = self.eval(plan.child)
        fns, params = self._bind([plan.predicate], plan.child.schema)
        d, v = fns[0](child.cols, params)
        keep = _bcast(d if v is None else (d & v), child.n)
        mask = keep if child.mask is None else (child.mask & keep)
        return DevBatch(plan.schema, child.cols, mask, child.n)

    def _eval_scan_pruned(self, plan: L.Scan, pred) -> Optional[DevBatch]:
        """Scan only the zone-map blocks whose [min, max] meets the
        predicate's bounds; None where pruning does not apply (no
        indexed column bound, nothing pruned, own writes pending)."""
        store = self.stores.get(plan.table)
        if store is None or store.nrows == 0:
            return None
        if self.scan_block is not None:
            return None  # block workers scan plain contiguous ranges
        if plan.table in self.own_writes:
            return None  # insert ranges and deletes are positional
        if not self.catalog.has(plan.table):
            return None
        meta = self.catalog.get(plan.table)
        if not meta.zone_cols:
            return None
        usable = zone_usable_bounds(_predicate_bounds(pred, plan), meta,
                                    plan)
        if not usable:
            return None
        b = store.ZONE_BLOCK
        nblocks = -(-store.nrows // b)
        sel = zone_candidate_blocks(store, usable)
        self.zone_total_blocks += nblocks
        nsel = int(sel.sum())
        if nsel == nblocks:
            return None  # nothing pruned: the plain scan is simpler
        self.zone_pruned_blocks += nblocks - nsel
        starts = np.nonzero(sel)[0] * b
        idx = np.concatenate([
            np.arange(s, min(s + b, store.nrows)) for s in starts
        ]) if nsel else np.empty(0, dtype=np.int64)
        return self._eval_scan(plan, row_idx=idx)

    def _eval_project(self, plan: L.Project) -> DevBatch:
        child = self.eval(plan.child)
        fns, params = self._bind(plan.exprs, plan.child.schema,
                                 want_dids=[c.dict_id for c in plan.schema])
        cols = [_bcast_pair(fn(child.cols, params), child.n) for fn in fns]
        return DevBatch(plan.schema, cols, child.mask, child.n)

    def _all_live(self, b: DevBatch) -> torch.Tensor:
        if b.mask is not None:
            return b.mask
        return torch.ones(b.n, dtype=torch.bool, device=self.device)

    # -- aggregate ---------------------------------------------------------
    def _eval_aggregate(self, plan: L.Aggregate) -> DevBatch:
        child = self.eval(plan.child)
        gfns, gparams = self._bind(plan.group_exprs, plan.child.schema)
        keys = [_bcast_pair(fn(child.cols, gparams), child.n) for fn in gfns]
        specs, vals = self._agg_inputs(plan.aggs, child)
        if any(a.distinct for a in plan.aggs):
            return self._eval_distinct_agg(plan, child, keys, specs, vals)
        if not plan.group_exprs:
            outs = agg_ops.scalar_reduce(vals, self._all_live(child),
                                         tuple(specs))
            cols = self._finalize_aggs(plan.aggs, outs)
            return DevBatch(plan.schema, _as_rows(cols), None, 1)
        perm, seg, ngroups = agg_ops.group_ids(keys, child.mask)
        cap = bucket_size(max(int(ngroups), 1))
        out_keys, out_vals, gvalid = agg_ops.group_reduce(
            keys, vals, perm, seg, cap, tuple(specs))
        cols = list(out_keys) + self._finalize_aggs(plan.aggs, out_vals)
        return DevBatch(plan.schema, cols, gvalid, cap)

    def _agg_inputs(self, aggs, child: DevBatch):
        """Aggregate calls as reduction specs and their argument columns.
        ``avg(x)`` becomes a sum and a count, merged by
        ``_finalize_aggs``; min and max over TEXT reduce each code's
        collation rank, mapped back to a code afterwards."""
        specs: list[str] = []
        vals: list = []
        self._agg_rank_inv: list = []  # per spec: rank -> code, or None
        fns, params = self._bind([a.arg for a in aggs if a.arg is not None],
                                 child.schema)
        fns = iter(fns)
        for a in aggs:
            if a.func == "count" and a.arg is None:
                specs.append("count_star")
                vals.append(None)
                self._agg_rank_inv.append(None)
                continue
            d, v = _bcast_pair(next(fns)(child.cols, params), child.n)
            if a.func == "avg":
                specs += ["sum", "count"]
                vals += [(d, v), (d, v)]
                self._agg_rank_inv += [None, None]
            elif a.func in ("sum", "count", "min", "max"):
                inv = None
                if a.func in ("min", "max") and a.arg.type.is_text:
                    did = _texpr_did(a.arg, child.schema) or LITERAL_DICT
                    ranks, inv = self._dict_ranks(did, with_order=True)
                    d = ranks[d.long().clamp(0, ranks.shape[0] - 1)]
                specs.append(a.func)
                vals.append((d, v))
                self._agg_rank_inv.append(inv)
            else:
                raise ExecError(f"aggregate {a.func} not supported")
        return specs, vals

    def _finalize_aggs(self, aggs, outs):
        """One column per aggregate call from the reductions' outputs
        (``avg`` = sum / count)."""
        cols = []
        i = 0
        inv = self._agg_rank_inv
        for a in aggs:
            if a.func == "avg":
                (s_d, s_v), (c_d, _c) = outs[i], outs[i + 1]
                i += 2
                if not s_d.dtype.is_floating_point:
                    s_d = s_d.to(torch.float64)  # jnp divides ints in f64
                if a.arg.type.id == t.TypeId.DECIMAL:
                    s_d = s_d / a.arg.type.decimal_factor
                cols.append((s_d / torch.clamp(c_d, min=1), s_v))
                continue
            d, v = outs[i]
            if inv[i] is not None:
                d = inv[i][d.long().clamp(0, inv[i].shape[0] - 1)]
            i += 1
            if a.func == "sum" and a.type.id == t.TypeId.INT8:
                d = d.to(torch.int64)
            cols.append((d, v))
        return cols

    def _eval_distinct_agg(self, plan, child, keys, specs, vals):
        """DISTINCT aggregates by two-level grouping: deduplicate (group
        keys, argument), then aggregate the deduplicated rows. One
        DISTINCT argument per query, and plain aggregates only over the
        same argument."""
        dargs = {a.arg.key() for a in plan.aggs if a.distinct}
        if len(dargs) > 1:
            raise ExecError("multiple DISTINCT aggregate arguments")
        plain = [a for a in plan.aggs if not a.distinct and a.func != "count"]
        if plain and {a.arg.key() for a in plain if a.arg} - dargs:
            raise ExecError("mix of DISTINCT and non-DISTINCT aggregates")
        arg_val = next(vv for vv in vals if vv is not None)
        lvl1 = keys + [arg_val]
        perm, seg, ngroups = agg_ops.group_ids(lvl1, child.mask)
        cap1 = bucket_size(max(int(ngroups), 1))
        out_keys, out_vals, gvalid = agg_ops.group_reduce(
            lvl1, [arg_val], perm, seg, cap1, ("any",))
        ded_keys, ded_arg = out_keys[:-1], out_vals[0]
        specs2, vals2 = [], []
        for a in plan.aggs:
            if a.func == "count" and a.arg is None:
                specs2.append("count_star")
                vals2.append(None)
            else:
                specs2.append(a.func if a.func != "avg" else "sum")
                vals2.append(ded_arg)
                if a.func == "avg":
                    specs2.append("count")
                    vals2.append(ded_arg)
        if not plan.group_exprs:
            outs = agg_ops.scalar_reduce(vals2, gvalid, tuple(specs2))
            cols = self._finalize_aggs(plan.aggs, outs)
            return DevBatch(plan.schema, _as_rows(cols), None, 1)
        perm2, seg2, ng2 = agg_ops.group_ids(ded_keys, gvalid)
        cap2 = bucket_size(max(int(ng2), 1))
        out_keys2, out_vals2, gvalid2 = agg_ops.group_reduce(
            ded_keys, vals2, perm2, seg2, cap2, tuple(specs2))
        cols = list(out_keys2) + self._finalize_aggs(plan.aggs, out_vals2)
        return DevBatch(plan.schema, cols, gvalid2, cap2)

    # -- distinct ----------------------------------------------------------
    def _eval_distinct(self, plan: L.Distinct) -> DevBatch:
        child = self.eval(plan.child)
        keys = [_bcast_pair(c, child.n) for c in child.cols]
        perm, seg, ngroups = agg_ops.group_ids(keys, child.mask)
        cap = bucket_size(max(int(ngroups), 1))
        out_keys, _, gvalid = agg_ops.group_reduce(keys, [], perm, seg, cap,
                                                   ())
        return DevBatch(plan.schema, list(out_keys), gvalid, cap)

    # -- sort / limit ------------------------------------------------------
    def _sort_key_arrays(self, plan_keys, schema, cols, n):
        fns, params = self._bind([k.expr for k in plan_keys], schema)
        keys = []
        for k, fn in zip(plan_keys, fns):
            d, v = _bcast_pair(fn(cols, params), n)
            if k.expr.type.is_text:
                did = _texpr_did(k.expr, schema)
                if did is None:
                    raise ExecError("ORDER BY on TEXT without dictionary")
                ranks = self._dict_ranks(did)
                d = ranks[d.long().clamp(0, ranks.shape[0] - 1)]
            keys.append((d, v, k.descending, k.nulls_first))
        return keys

    def _dict_ranks(self, dict_id: str, with_order: bool = False):
        """code -> collation rank over dictionary ``dict_id`` (padded to a
        power of two) on the device; ``with_order`` also returns the
        inverse, rank -> code, from the same sort."""
        dic = self.catalog.dictionary(dict_id)
        key = (dict_id, len(dic))
        if key not in self._ranks:  # one sort of the values a query
            ranks, inv = dict_ranks_host(dic)
            self._ranks[key] = (self._upload(ranks), self._upload(inv))
        ranks, inv = self._ranks[key]
        return (ranks, inv) if with_order else ranks

    def _eval_sort(self, plan: L.Sort) -> DevBatch:
        child = self.eval(plan.child)
        keys = self._sort_key_arrays(plan.keys, plan.child.schema,
                                     child.cols, child.n)
        perm = sort_ops.order_indices(keys, child.mask)
        cols = gather_cols([_bcast_pair(c, child.n) for c in child.cols],
                           perm)
        mask = None if child.mask is None else child.mask[perm]
        return DevBatch(plan.schema, cols, mask, child.n)

    def _eval_limit(self, plan: L.Limit) -> DevBatch:
        child = self.eval(plan.child)
        mask = self._all_live(child)
        # int64 running rank: an int32 sum wraps past 2^31 live rows
        rank = torch.cumsum(mask, 0, dtype=torch.int64)
        keep = mask & (rank > plan.offset)
        if plan.limit is not None:
            keep = keep & (rank <= plan.offset + plan.limit)
        return DevBatch(plan.schema, child.cols, keep, child.n)

    # -- window functions ---------------------------------------------------
    def _eval_window(self, plan: L.Window) -> DevBatch:
        """nodeWindowAgg over the live rows, one appended column a spec,
        each result written back in the batch's row order."""
        child = self.eval(plan.child)
        n = child.n
        cols = [_bcast_pair(c, n) for c in child.cols]
        live = (torch.arange(n, device=self.device) if child.mask is None
                else compact_indices(child.mask)[0])
        out_cols = list(cols)
        for spec in plan.specs:
            out_cols.append(window_one(self, spec, cols, live, n,
                                       plan.child.schema))
        return DevBatch(plan.schema, out_cols, child.mask, n)

    # -- join --------------------------------------------------------------
    def _eval_join(self, plan: L.Join) -> DevBatch:
        left = self.eval(plan.left)
        right = self.eval(plan.right)
        if plan.join_type == "right":
            # planned as a left join with the sides flipped
            return self._join_impl(plan, right, left, "left", flipped=True)
        return self._join_impl(plan, left, right, plan.join_type,
                               flipped=False)

    def _join_impl(self, plan, probe, build, jt, flipped):
        lk = plan.right_keys if flipped else plan.left_keys
        rk = plan.left_keys if flipped else plan.right_keys
        pschema = plan.right.schema if flipped else plan.left.schema
        bschema = plan.left.schema if flipped else plan.right.schema
        pf, pp = self._bind(lk, pschema)
        bf, bp = self._bind(rk, bschema)
        probe_keys = [_bcast_pair(fn(probe.cols, pp), probe.n) for fn in pf]
        build_keys = [_bcast_pair(fn(build.cols, bp), build.n) for fn in bf]
        # TEXT keys: codes compare only within one dictionary, so the
        # probe side's codes translate into the build side's (minting
        # values it lacks)
        for i, (lk_e, rk_e) in enumerate(zip(lk, rk)):
            if not lk_e.type.is_text:
                continue
            pdid = _texpr_did(lk_e, pschema) or LITERAL_DICT
            bdid = _texpr_did(rk_e, bschema) or LITERAL_DICT
            if pdid != bdid:
                d, v = probe_keys[i]
                probe_keys[i] = (self._translate_codes(d, pdid, bdid), v)
        probe_keys, build_keys = _align_key_dtypes(probe_keys, build_keys)

        # a single integer-family key probes the radix table; FULL joins
        # also need the reverse counts, so they keep the encoded ids
        build_ids = probe_ids = None
        radix = ("full join" if jt == "full" else self._radix_counts(
            probe_keys, build_keys, probe, build))
        if not isinstance(radix, str):
            build_order, lo, counts, total = radix
            self.last_join_mode = "radix"
            self.join_modes.append("radix")
        else:
            build_ids, probe_ids = join_ops.encode_keys(
                build_keys, probe_keys, build.mask, probe.mask)
            build_order, lo, counts, total = join_ops.match_counts(
                build_ids, probe_ids)
            self.last_join_mode = "merge"
            self.join_modes.append(f"merge({radix})")

        if jt in ("semi", "anti"):
            has = counts > 0
            keep = has if jt == "semi" else ~has
            if probe.mask is not None:
                keep = keep & probe.mask
            return DevBatch(plan.schema, probe.cols, keep, probe.n)

        outer = jt in ("left", "full")
        if outer:
            # every probe lane without a match emits one null-extended
            # row (the invisible ones are masked after the gather)
            total = total + torch.sum(counts == 0, dtype=torch.int64)
        out_size = bucket_size(max(int(total), 1))
        probe_idx, build_idx, matched, valid = join_ops.emit_pairs(
            build_order, lo, counts, out_size, outer)
        probe_idx, build_idx = probe_idx.long(), build_idx.long()
        if probe.mask is not None:
            valid = valid & probe.mask[probe_idx]
        pcols = gather_cols([_bcast_pair(c, probe.n) for c in probe.cols],
                            probe_idx)
        bcols = []
        for d, v in (_bcast_pair(c, build.n) for c in build.cols):
            bcols.append((d[build_idx],
                          matched if v is None else v[build_idx] & matched))
        cols = bcols + pcols if flipped else pcols + bcols
        out = DevBatch(plan.schema, cols, valid, out_size)

        if plan.residual is not None:
            fns, params = self._bind([plan.residual], plan.schema)
            d, v = fns[0](out.cols, params)
            keep = _bcast(d if v is None else (d & v), out_size)
            if outer:
                keep = keep | ~matched  # the residual filters matches only
            out = DevBatch(plan.schema, out.cols, out.mask & keep, out.n)

        if jt == "full":
            out = self._full_tail(plan, out, probe, build, probe_ids,
                                  build_ids, flipped)
        return out

    def _full_tail(self, plan, out, probe, build, probe_ids, build_ids,
                   flipped) -> DevBatch:
        """FULL join's second half: the build rows nothing matched,
        appended with a null-extended probe side (nodeHashjoin.c's fill
        pass over the unmatched inner tuples)."""
        _bo, _lo, counts_b, _t = join_ops.match_counts(probe_ids, build_ids)
        un_b = counts_b == 0
        if build.mask is not None:
            un_b = un_b & build.mask
        dev = self.device
        seg_p = [(torch.zeros(build.n, dtype=d.dtype, device=dev),
                  torch.zeros(build.n, dtype=torch.bool, device=dev))
                 for d, _v in probe.cols]
        seg_b = [(_bcast(d, build.n), None if v is None else _bcast(v, build.n))
                 for d, v in build.cols]
        seg_cols = seg_b + seg_p if flipped else seg_p + seg_b
        new_n = bucket_size(out.n + build.n)

        def cat(a, b, fill=0):
            return _pad_dev(torch.cat([a, b]), new_n, fill)

        def ones(n):
            return torch.ones(n, dtype=torch.bool, device=dev)

        cols = []
        for (da, va), (db, vb) in zip(out.cols, seg_cols):
            d2 = cat(*_promote_pair(da, db))
            if va is None and vb is None:
                v2 = None
            else:
                v2 = cat(ones(out.n) if va is None else va,
                         ones(build.n) if vb is None else vb, False)
            cols.append((d2, v2))
        m2 = cat(ones(out.n) if out.mask is None else out.mask, un_b, False)
        return DevBatch(plan.schema, cols, m2, new_n)

    def _radix_counts(self, probe_keys, build_keys, probe, build):
        """``match_counts``'s tuple (build_order, lo, counts, total)
        through the bucket-padded radix table, or, where the shape stays
        on the encode + sort path, the reason: several keys or a float
        key need the joint encoding; a plan of more than one pass over
        the budget; a table whose bucket overflowed (a skewed hash)
        retries once at 4x the bucket, then falls back rather than probe
        a table that dropped rows."""
        from opentenbase_tpu_torch.plan import batchplan

        if join_ops.JOIN_MODE() == "sortmerge":
            return "OTB_JOIN_MODE"
        if len(build_keys) != 1:
            return f"keys={len(build_keys)}"
        (bd, bv), (pd, pv) = build_keys[0], probe_keys[0]
        if bd.dtype.is_floating_point or pd.dtype.is_floating_point:
            return "float key"
        rplan = batchplan.plan_radix_join(
            build.n, probe.n,
            batchplan.resolve_budget(0, "OTB_RADIX_HBM_BUDGET",
                                     batchplan.DEFAULT_EXCHANGE_BUDGET))
        if rplan is None:
            return "no plan"
        if rplan.passes != 1:
            return f"passes={rplan.passes}"

        def real(mask, v, n):
            if mask is None and v is None:
                return torch.ones(n, dtype=torch.bool, device=self.device)
            if mask is None:
                return v
            return mask if v is None else (mask & v)

        breal = real(build.mask, bv, build.n)
        preal = real(probe.mask, pv, probe.n)
        bucket = rplan.bucket
        for _ in range(2):
            bo, lo, cnt, tot, ovf = join_ops.radix_match_counts(
                bd, breal, pd, preal, rplan.partitions, bucket)
            if not bool(ovf):
                return bo, lo, cnt, tot
            bucket *= 4
        return "overflow"

    # -- union -------------------------------------------------------------
    def _translate_codes(self, d, src_did: str, dst_did: str):
        """TEXT codes of one dictionary as the same strings' codes in
        another, on the device."""
        tbl = resolve_param(DictTranslateParam(src_did, dst_did),
                            self.device, self.catalog.dictionary)
        return tbl[d.long().clamp(0, tbl.shape[0] - 1)]

    def _eval_union(self, plan: L.Union) -> DevBatch:
        parts = [self.eval(c) for c in plan.inputs]
        padded = bucket_size(max(sum(p.n for p in parts), 1))
        cols = []
        for ci, oc in enumerate(plan.schema):
            any_valid = any(p.cols[ci][1] is not None for p in parts)
            out_did = (oc.dict_id or LITERAL_DICT) if oc.type.is_text \
                else None
            datas, valids = [], []
            for inp, p in zip(plan.inputs, parts):
                d, v = _bcast_pair(p.cols[ci], p.n)
                if out_did is not None:
                    src = inp.schema[ci].dict_id or LITERAL_DICT
                    if src != out_did:
                        # the branches' codes index different
                        # dictionaries: align them before they mix
                        d = self._translate_codes(d, src, out_did)
                datas.append(d)
                if any_valid:
                    valids.append(torch.ones(p.n, dtype=torch.bool,
                                             device=self.device)
                                  if v is None else v)
            dt = datas[0].dtype
            for d in datas[1:]:
                dt = torch.promote_types(dt, d.dtype)
            d = _pad_dev(torch.cat([x.to(dt) for x in datas]), padded)
            v = _pad_dev(torch.cat(valids), padded, False) if any_valid \
                else None
            cols.append((d, v))
        mask = _pad_dev(torch.cat([self._all_live(p) for p in parts]),
                        padded, False)
        return DevBatch(plan.schema, cols, mask, padded)


# -- window functions: torch over the live rows, on the executor's device ----


def _window_key(ex, col: int, schema, cols, rows):
    """(comparable values, isnull) of key column ``col`` at ``rows``; a
    TEXT key compares by its code's collation rank."""
    d, v = cols[col]
    vals = d[rows]
    isnull = (torch.zeros(rows.shape[0], dtype=torch.bool,
                          device=rows.device)
              if v is None else ~v[rows])
    oc = schema[col]
    if oc.type.is_text and oc.dict_id is not None:
        ranks = ex._dict_ranks(oc.dict_id)
        vals = ranks[vals.long().clamp(0, ranks.shape[0] - 1)]
    elif vals.dtype == torch.bool:
        vals = vals.to(torch.int32)
    elif vals.dtype.is_floating_point:
        # one pattern for every NaN and 0.0 for -0.0: the device sort
        # orders bit patterns, numpy's compares values
        vals = torch.where(torch.isnan(vals), float("nan"), vals + 0.0)
    return vals, isnull


def _sort_pass(perm, key):
    return perm[torch.sort(key[perm], stable=True).indices]


def window_one(ex, spec: L.WinSpec, cols, live, n, schema):
    """One window column over the live rows ``live`` (int64 positions)
    of an ``n``-row batch (the reference's ``_window_one``): (data,
    valid) tensors of ``n`` rows. The live rows sort stably by
    (partition keys, order keys), each key's NULL flag above its value
    (NULLS LAST ascending, FIRST descending), as numpy's lexsort orders
    them in the reference; every reduction over a partition is a prefix
    difference, a scan or an order-independent scatter (min, max), so
    the result does not depend on the device's scatter order."""
    dev = live.device
    m = live.shape[0]
    odt = torch_dtype(spec.out.type)
    out = torch.zeros(n, dtype=odt, device=dev)
    outv = torch.zeros(n, dtype=torch.bool, device=dev)
    if m == 0:
        return out, outv
    perm = torch.arange(m, device=dev)
    keys = [(c, False, True) for c in spec.partition] + [
        (c, desc, False) for c, desc in spec.order]
    for col, desc, is_part in reversed(keys):
        k, isnull = _window_key(ex, col, schema, cols, live)
        if desc:
            k = -(k.to(torch.float64) if k.dtype.is_floating_point
                  else k.to(torch.int64))
        perm = _sort_pass(perm, k)
        flag = isnull if (is_part or not desc) else ~isnull
        perm = _sort_pass(perm, flag.to(torch.uint8))
    srows = live[perm]
    idx = torch.arange(m, device=dev)

    def boundary(cols_idx, base):
        nb = base.clone()
        nb[0] = True
        for c in cols_idx:
            k, isnull = _window_key(ex, c, schema, cols, srows)
            nb[1:] |= (k[1:] != k[:-1]) & ~(isnull[1:] & isnull[:-1])
            nb[1:] |= isnull[1:] != isnull[:-1]
        return nb

    newpart = boundary(spec.partition,
                       torch.zeros(m, dtype=torch.bool, device=dev))
    part_id = torch.cumsum(newpart, 0) - 1
    part_start = _cummax(torch.where(newpart, idx, 0))
    pos = idx - part_start  # 0-based position in the partition
    # peer groups: same partition and same ORDER BY values
    newpeer = (boundary([c for c, _d in spec.order], newpart)
               if spec.order else newpart.clone())
    kind = spec.kind
    ones = torch.ones(m, dtype=torch.bool, device=dev)
    if kind == "row_number":
        vals, valid = pos + 1, ones
    elif kind == "rank":
        vals, valid = pos[_cummax(torch.where(newpeer, idx, -1))] + 1, ones
    elif kind == "dense_rank":
        cums = torch.cumsum(newpeer, 0)
        vals = cums - _cummax(torch.where(newpart, cums - 1, 0))
        valid = ones
    elif kind in ("lag", "lead"):
        off = spec.offset if kind == "lag" else -spec.offset
        src = idx - off
        src_clip = src.clamp(0, m - 1)
        same = (src >= 0) & (src < m) & (part_id[src_clip] == part_id)
        ad, av = cols[spec.arg]
        vals = torch.where(same, ad[srows][src_clip],
                           torch.zeros((), dtype=ad.dtype, device=dev))
        valid = same if av is None else same & av[srows][src_clip]
    else:  # count / sum / avg / min / max
        postmap = None
        scale = 1
        if spec.arg is not None:
            ad, av = cols[spec.arg]
            a = ad[srows]
            avm = ones if av is None else av[srows]
            aty = schema[spec.arg]
            if aty.type.is_text and aty.dict_id is not None:
                # min/max over TEXT: compare ranks, map the winner back
                ranks, inv = ex._dict_ranks(aty.dict_id, with_order=True)
                a = ranks[a.long().clamp(0, ranks.shape[0] - 1)]

                def postmap(r, inv=inv):
                    return inv[r.long().clamp(0, inv.shape[0] - 1)]
            if aty.type.id == t.TypeId.DECIMAL:
                scale = aty.type.decimal_factor
        else:
            a, avm = torch.ones(m, dtype=torch.int64, device=dev), ones
        af = a.to(torch.float64)
        if spec.frame is not None:
            vals, valid = _window_agg_framed(kind, af, avm, newpart,
                                             part_id, spec.frame)
        else:
            vals, valid = _window_agg(kind, af, avm, newpart, newpeer,
                                      part_id, bool(spec.order))
        if kind == "avg" and scale != 1:
            vals = vals / scale  # an average of scaled decimals, unscaled
        if postmap is not None:
            vals = postmap(vals)
    out[srows] = vals.to(odt)  # srows are distinct: one write a row
    outv[srows] = valid
    return out, outv


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _seg_bounds(newpart, part_id):
    """Each sorted row's partition [start, end] (inclusive)."""
    m = newpart.shape[0]
    starts = torch.nonzero(newpart, as_tuple=True)[0]
    ends = torch.cat([starts[1:], starts.new_tensor([m])]) - 1
    return starts[part_id], ends[part_id]


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive-then-inclusive prefix sums: p[i] = sum(x[:i])."""
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def _window_agg_framed(kind, af, avm, newpart, part_id, frame):
    """ROWS-frame aggregation: per row the window [i + start, i + end]
    clamped to its partition. Sums and counts are prefix differences;
    min and max answer range queries from a sparse table."""
    m = af.shape[0]
    s_off, e_off = frame
    idx = torch.arange(m, device=af.device)
    ps, pe = _seg_bounds(newpart, part_id)
    lo = ps if s_off is None else torch.maximum(idx + s_off, ps)
    hi = pe if e_off is None else torch.minimum(idx + e_off, pe)
    nonempty = lo <= hi
    lo, hi = lo.clamp(0, m - 1), hi.clamp(0, m - 1)
    ccnt = _prefix(avm.to(torch.int64))
    cnt = torch.where(nonempty, ccnt[hi + 1] - ccnt[lo], 0)
    if kind == "count":
        return cnt, torch.ones(m, dtype=torch.bool, device=af.device)
    if kind in ("sum", "avg"):
        cs = _prefix(torch.where(avm, af, 0.0))
        s = torch.where(nonempty, cs[hi + 1] - cs[lo], 0.0)
        if kind == "sum":
            return s, cnt > 0
        return s / cnt.clamp(min=1), cnt > 0
    big = float("inf") if kind == "min" else float("-inf")
    red = torch.minimum if kind == "min" else torch.maximum
    tables = [torch.where(avm, af, big)]
    span = 1
    while span * 2 <= m:
        prev = tables[-1]
        nxt = prev.clone()
        nxt[: m - span] = red(prev[: m - span], prev[span:])
        tables.append(nxt)
        span *= 2
    length = (hi - lo + 1).clamp(min=1)
    k = torch.floor(torch.log2(length.to(torch.float64))).long()
    k = k.clamp(0, len(tables) - 1)
    stacked = torch.stack(tables)
    right = (hi - (1 << k) + 1).clamp(min=0)
    vals = red(stacked[k, lo], stacked[k, right])
    valid = nonempty & (cnt > 0)
    return torch.where(valid, vals, 0.0), valid


def _window_agg(kind, af, avm, newpart, newpeer, part_id, running: bool):
    m = af.shape[0]
    dev = af.device
    idx = torch.arange(m, device=dev)
    contrib = torch.where(avm, af, 0.0)
    cnt_contrib = avm.to(torch.int64)
    ones = torch.ones(m, dtype=torch.bool, device=dev)
    big = float("inf") if kind == "min" else float("-inf")
    if not running:
        # the whole partition's value, broadcast to every member
        ps, pe = _seg_bounds(newpart, part_id)
        cs, cc = _prefix(contrib), _prefix(cnt_contrib)
        sums, cnts = cs[pe + 1] - cs[ps], cc[pe + 1] - cc[ps]
        if kind == "count":
            return cnts, ones
        if kind == "sum":
            return sums, cnts > 0
        if kind == "avg":
            return sums / cnts.clamp(min=1), cnts > 0
        nparts = int(part_id[-1]) + 1
        red = torch.full((nparts,), big, dtype=torch.float64, device=dev)
        red.scatter_reduce_(0, part_id, torch.where(avm, af, big),
                            "amin" if kind == "min" else "amax")
        return red[part_id], cnts > 0
    # running (peers share the value): the prefix sum less the one
    # before the partition head (the head's index is carried, never its
    # value, so negative partial sums stay exact)
    csum = torch.cumsum(contrib, 0)
    ccnt = torch.cumsum(cnt_contrib, 0)
    head = _cummax(torch.where(newpart, idx, 0))
    run_sum = csum - (csum[head] - contrib[head])
    run_cnt = ccnt - (ccnt[head] - cnt_contrib[head])
    run_val = None
    if kind in ("min", "max"):
        run_val = _segmented_running(af, avm, part_id, kind)
    # peers share the frame end: each peer group's last row answers
    grp = torch.cumsum(newpeer, 0) - 1
    last = torch.zeros(int(grp[-1]) + 1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, grp, idx, "amax")
    take = last[grp]
    if kind == "count":
        return run_cnt[take], ones
    if kind == "sum":
        return run_sum[take], run_cnt[take] > 0
    if kind == "avg":
        return (run_sum[take] / run_cnt[take].clamp(min=1),
                run_cnt[take] > 0)
    return run_val[take], run_cnt[take] > 0


def _segmented_running(af, avm, part_id, kind):
    """The running min or max inside each partition (rows sorted by
    partition): a cummax over (partition, value rank), where a NULL
    carries rank 0, so a partition never reads an earlier one's
    values. Rows before the partition's first value get +-inf, as the
    reference's accumulate over its +-inf fill gives them."""
    m = af.shape[0]
    dev = af.device
    key = af if kind == "max" else -af
    order = torch.sort(torch.where(avm, key, float("-inf")),
                       stable=True).indices
    rank = torch.empty(m, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(1, m + 1, device=dev)
    rank = torch.where(avm, rank, 0)
    best = _cummax(part_id * (m + 1) + rank)
    r = best - part_id * (m + 1)
    got = r > 0
    vals = af[order[(r - 1).clamp(min=0)]]
    big = float("inf") if kind == "min" else float("-inf")
    return torch.where(got, vals, big)


# -- helpers ------------------------------------------------------------------


def dict_ranks_host(dictionary):
    """(code -> collation rank, rank -> code) over a dictionary's values,
    each padded to a power of two (int32 numpy arrays)."""
    vals = dictionary.values
    order = np.argsort(np.asarray(vals, dtype=object)).astype(np.int32)
    padded = bucket_size(max(len(vals), 1))
    ranks = np.zeros(padded, dtype=np.int32)
    ranks[order] = np.arange(len(vals), dtype=np.int32)
    inv = np.zeros(padded, dtype=np.int32)
    inv[: len(order)] = order
    return ranks, inv


def to_host_arrays(tensors: list) -> list:
    """numpy arrays of ``tensors`` (None stays None) from one
    device-to-host transfer: their bytes ride one buffer, so the host
    waits for the device once. The widest elements go first, so each
    array is an aligned view into the buffer (no copy on the host)."""
    flat = [None if x is None else x.reshape(-1).contiguous()
            for x in tensors]
    order = sorted((i for i, f in enumerate(flat) if f is not None),
                   key=lambda i: -flat[i].element_size())
    if not order:
        return flat
    buf = torch.cat([flat[i].view(torch.uint8) for i in order]).cpu().numpy()
    out, off = list(flat), 0
    for i in order:
        x = tensors[i]
        nb = flat[i].numel() * flat[i].element_size()
        dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
        out[i] = buf[off:off + nb].view(dtype).reshape(x.shape)
        off += nb
    return out


def _op_detail(plan) -> Optional[str]:
    """An operator's note in the EXPLAIN ANALYZE tree: its table, its
    input fragment, or its join type."""
    table = getattr(plan, "table", None)
    if isinstance(table, str):
        return table
    frag = getattr(plan, "fragment", None)
    if frag is not None and type(plan).__name__ == "RemoteSource":
        return f"fragment {frag}"
    jt = getattr(plan, "join_type", None)
    return None if jt is None else str(jt)


def _bcast(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.expand(n) if x.dim() == 0 else x


def _bcast_pair(kv, n: int):
    """A (data, valid) pair at ``n`` rows: a 0-d constant broadcasts."""
    d, v = kv
    return (_bcast(d, n), None if v is None else _bcast(v, n))


def _promote_pair(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _align_key_dtypes(probe_keys, build_keys):
    """Paired join keys at a common dtype, so the joint encoding compares
    equal values equal (an int4 key against an int8 one)."""
    pk, bk = [], []
    for (pd, pv), (bd, bv) in zip(probe_keys, build_keys):
        if pd.dtype != bd.dtype:
            pd, bd = _promote_pair(pd, bd)
        pk.append((pd, pv))
        bk.append((bd, bv))
    return pk, bk


def _as_rows(cols):
    """0-d scalar aggregate outputs as 1-row columns."""
    return [(d.reshape(1), None if v is None else v.reshape(1))
            for d, v in cols]


def _pad_dev(arr: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    cur = arr.shape[0]
    if cur == n:
        return arr
    pad = torch.full((n - cur,), fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


def _predicate_bounds(pred, scan: L.Scan) -> dict:
    """Per-column [lo, hi] bounds (either side None: unbounded) that a
    predicate's top-level conjuncts imply, in the columns' physical units
    (scaled decimals, epoch days: the analyzer lowers literals so). Only
    bare column-vs-constant comparisons and IN lists count; anything else
    is ignored (a copy of the reference's ``_predicate_bounds``)."""
    out: dict = {}

    def narrow(ci: int, lo, hi):
        name = scan.columns[ci]
        cur = out.get(name, (None, None))
        nlo = cur[0] if lo is None else (
            lo if cur[0] is None else max(cur[0], lo))
        nhi = cur[1] if hi is None else (
            hi if cur[1] is None else min(cur[1], hi))
        out[name] = (nlo, nhi)

    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
    for c in E.conjuncts(pred):
        if isinstance(c, E.BinE) and c.op in ("=", "<", "<=", ">", ">="):
            op, col, k = c.op, c.left, c.right
            if isinstance(col, E.Const) and isinstance(k, E.Col):
                col, k = k, col
                op = flip.get(op, op)
            if not (isinstance(col, E.Col) and isinstance(k, E.Const)):
                continue
            if k.value is None or isinstance(k.value, (str, bytes)):
                continue
            try:
                v = int(k.value)
            except (TypeError, ValueError):
                continue
            lo, hi = {"=": (v, v), "<": (None, v - 1), "<=": (None, v),
                      ">": (v + 1, None), ">=": (v, None)}[op]
            narrow(col.index, lo, hi)
        elif isinstance(c, E.InListE) and not c.negated:
            if not isinstance(c.operand, E.Col):
                continue
            vals = []
            for item in c.items:
                if (not isinstance(item, E.Const) or item.value is None
                        or isinstance(item.value, (str, bytes))):
                    vals = []
                    break
                try:
                    vals.append(int(item.value))
                except (TypeError, ValueError):
                    vals = []
                    break
            if vals:
                narrow(c.operand.index, min(vals), max(vals))
    return out


# -- within-fragment parallelism (execParallel.c, nodeGather.c) -------------

# how the block partials of each aggregate merge; avg and DISTINCT decline
_BLOCK_MERGE_FUNC = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def _parallel_min_rows() -> int:
    """``OTB_DN_PARALLEL_MIN_ROWS`` (default 100 000), read per call so a
    datanode process and the tests can lower it through the
    environment."""
    import os

    return int(os.environ.get("OTB_DN_PARALLEL_MIN_ROWS", 100_000))


def _parallel_shape(plan):
    """(aggregate, scan) when the fragment is a mergeable partial
    aggregate over a Filter/Project chain to one base scan, else None."""
    if not isinstance(plan, L.Aggregate):
        return None
    for a in plan.aggs:
        if a.distinct or a.func not in _BLOCK_MERGE_FUNC:
            return None
    node = plan.child
    while isinstance(node, (L.Filter, L.Project)):
        node = node.child
    if not isinstance(node, L.Scan):
        return None
    return plan, node


def run_fragment_parallel(catalog, stores, snapshot_ts, plan, remote_inputs,
                          subquery_values, nworkers: int, device=None,
                          fold_on_read: bool = False, cancel_check=None):
    """``plan`` split over at most ``nworkers`` row-block threads and the
    blocks' partials merged, or None where the shape or the size does
    not qualify (the caller runs the serial path): fewer rows than
    ``_parallel_min_rows()``, or a predicate the zone maps could prune
    (the serial path's block skipping beats scanning every block).
    ``cancel_check`` rides into every block worker, so an abandoned
    fragment stops at its next operator boundary as the serial path
    does."""
    import threading

    from opentenbase_tpu_torch.plan.distribute import RemoteSource

    shape = _parallel_shape(plan)
    if shape is None or nworkers <= 1:
        return None
    agg, scan = shape
    store = stores.get(scan.table)
    min_rows = _parallel_min_rows()
    if store is None or store.nrows < min_rows:
        return None
    node = agg.child
    pred = None
    while isinstance(node, (L.Filter, L.Project)):
        if isinstance(node, L.Filter) and isinstance(node.child, L.Scan):
            pred = node.predicate
        node = node.child
    if pred is not None and catalog.has(scan.table):
        meta = catalog.get(scan.table)
        if meta.zone_cols and zone_usable_bounds(
                _predicate_bounds(pred, scan), meta, scan):
            return None
    n0 = store.nrows  # one capture: the blocks cover a consistent prefix
    k = min(nworkers, max(n0 // max(min_rows // 2, 1), 1))
    if k <= 1:
        return None
    bounds = [(n0 * i // k, n0 * (i + 1) // k) for i in range(k)]
    parts: list = [None] * k
    errors: list = []

    def worker(i):
        try:
            ex = LocalExecutor(catalog, remote_inputs, stores=stores,
                               snapshot_ts=snapshot_ts,
                               subquery_values=subquery_values,
                               device=device, fold_on_read=fold_on_read,
                               cancel_check=cancel_check)
            ex.scan_block = bounds[i]
            parts[i] = ex.run_plan(plan)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"dn-block-{i}") for i in range(k)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    from opentenbase_tpu_torch.executor.dist import concat_batches

    ngroups = len(agg.group_exprs)
    merge_groups = tuple(E.Col(i, agg.schema[i].type)
                         for i in range(ngroups))
    merge_aggs = tuple(
        E.AggCall(_BLOCK_MERGE_FUNC[a.func],
                  E.Col(ngroups + i, agg.schema[ngroups + i].type), False,
                  agg.schema[ngroups + i].type)
        for i, a in enumerate(agg.aggs))
    src = RemoteSource(fragment=-1, schema=tuple(agg.schema))
    merge_plan = L.Aggregate(src, merge_groups, merge_aggs, tuple(agg.schema))
    ex = LocalExecutor(catalog, {-1: concat_batches(parts)},
                       subquery_values=subquery_values, device=device)
    return ex.run_plan(merge_plan)


# -- DML row location (the reference's LocalExecutor.predicate_rows) --------


def predicate_rows(catalog, store, table: str, predicate, snapshot_ts,
                   own_writes=None, device="cpu",
                   subquery_values=None, fold: bool = False) -> np.ndarray:
    """Positions in ``store`` (one node's shard of ``table``) of the rows
    matching ``predicate`` under ``snapshot_ts``, with the transaction's
    own writes (``own_writes``: (insert ranges, deleted positions))
    overriding visibility: UPDATE/DELETE target selection.

    Simple predicates over non-text, non-decimal columns evaluate in
    numpy (``_np_pred_eval``), segment by segment over the store's base
    rows and its delta tail, so DML on fresh rows never folds the store.
    Anything else (TEXT, IN lists, CASE, decimals, / and %) runs through
    the port's ExprCompiler over the columns it reads, on ``device``:
    that path alone defines the semantics. ``subquery_values``: the
    statement's scalar subqueries' values, (value, type) each.
    ``fold``: fold the pending deltas first (``enable_delta_scan``
    off)."""
    view = store.scan_view(fold=fold)
    store.note_delta_read(view.delta_rows())  # a whole-table read
    n0 = view.nrows
    cols = list(catalog.get(table).schema)
    pred = None
    if predicate is None:
        pred = np.ones(n0, dtype=np.bool_)
    else:
        b = min(view.base_rows, n0)
        pred = np.empty(n0, dtype=np.bool_)
        for s0, e0 in ((0, b), (b, n0)):
            if s0 >= e0:
                continue
            res = _np_pred_eval(predicate, view, cols, s0, e0)
            if res is None:
                pred = _device_pred(catalog, view, table, predicate,
                                    n0, device, subquery_values)
                break
            d, v = res
            keep = d if v is None else (d & v)
            pred[s0:e0] = np.broadcast_to(keep, (e0 - s0,))
    vis = np.ones(n0, dtype=np.bool_)
    if snapshot_ts is not None:
        snap = np.int64(snapshot_ts)
        vis = (view.xmin(0, n0) <= snap) & (snap < view.xmax(0, n0))
    if own_writes is not None:
        ins_ranges, del_idx = own_writes
        for s, e in ins_ranges:  # own inserts: visible, predicate holds
            vis[s:min(e, n0)] = True
        if len(del_idx):
            vis[np.asarray(del_idx)] = False
    return np.nonzero(pred & vis)[0]


def _device_pred(catalog, view, table, predicate, n0, device,
                 subquery_values=None) -> np.ndarray:
    """The predicate's verdict over rows [0, n0) of ``view`` through the
    ExprCompiler on ``device``: only the columns it reads upload."""
    meta = catalog.get(table)
    names = list(meta.schema)
    dids = [f"{table}.{c}" if meta.schema[c].is_text else None
            for c in names]
    used = {x.index for x in E.walk(predicate) if isinstance(x, E.Col)}
    env = [None] * len(names)
    for i in used:
        vm = view.validity(names[i], 0, n0)
        env[i] = (_tensor(view.col(names[i], 0, n0)).to(device),
                  None if vm is None else _tensor(vm).to(device))
    comp = ExprCompiler(device)
    fn = comp.compile(predicate, dids)
    params = tuple(resolve_param(s, device, catalog.dictionary,
                                 subquery_values)
                   for s in comp.params)
    d, v = fn(env, params)
    keep = d if v is None else (d & v)
    return keep.expand(n0).cpu().numpy().astype(np.bool_, copy=False)


_NP_CMP = {
    "=": np.equal, "<>": np.not_equal, "<": np.less,
    "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
}


def _np_and_valid(lv, rv):
    if lv is None:
        return rv
    if rv is None:
        return lv
    return lv & rv


def _np_pred_eval(e, view, cols, s, n):
    """(data, validity) for a SIMPLE predicate over rows [s, n) of a
    store's ScanView in numpy, or None when the expression needs the
    compiled path (see ``np_expr_eval``)."""
    def getcol(idx):
        if idx >= len(cols):
            return None
        name = cols[idx]
        if name not in view.schema:
            return None
        return (view.col(name, s, n), view.validity(name, s, n))

    return np_expr_eval(e, getcol)


def np_expr_eval(e, getcol):
    """(data, validity) for a SIMPLE expression evaluated in numpy, or
    None when it needs the compiled path. ``getcol(index)`` resolves a
    column reference to (data, validity) host arrays (or None).
    Supported: Col/Const of non-text non-decimal types, comparisons,
    and/or (three-valued, as the ExprCompiler's), + - *, unary - and
    not. Shared by DML row location and UPDATE's SET evaluation."""
    if isinstance(e, E.Col):
        if e.type.is_text or e.type.id == t.TypeId.DECIMAL:
            return None
        return getcol(e.index)
    if isinstance(e, E.Const):
        if e.type.is_text or e.type.id == t.TypeId.DECIMAL:
            return None
        if e.value is None:
            return (
                np.zeros((), dtype=e.type.np_dtype),
                np.zeros((), dtype=np.bool_),
            )
        try:
            return (np.asarray(e.value, dtype=e.type.np_dtype), None)
        except (TypeError, ValueError, OverflowError):
            return None
    if isinstance(e, E.UnaryE):
        r = np_expr_eval(e.operand, getcol)
        if r is None:
            return None
        d, v = r
        if e.op == "-":
            return (-d, v)
        if e.op == "not":
            return (~d, v)
        return None
    if isinstance(e, E.BinE):
        if e.left.type.is_text or e.right.type.is_text:
            return None
        if t.TypeId.DECIMAL in (e.type.id, e.left.type.id, e.right.type.id):
            return None
        lr = np_expr_eval(e.left, getcol)
        rr = np_expr_eval(e.right, getcol)
        if lr is None or rr is None:
            return None
        ld, lv = lr
        rd, rv = rr
        if e.op == "and":
            if lv is None and rv is None:
                return (ld & rd, None)
            lF = ~ld if lv is None else (lv & ~ld)
            rF = ~rd if rv is None else (rv & ~rd)
            valid = _np_and_valid(lv, rv)
            defl = lF | rF
            valid = defl if valid is None else (valid | defl)
            return (np.where(defl, False, ld & rd), valid)
        if e.op == "or":
            if lv is None and rv is None:
                return (ld | rd, None)
            lT = ld if lv is None else (lv & ld)
            rT = rd if rv is None else (rv & rd)
            valid = _np_and_valid(lv, rv)
            deft = lT | rT
            valid = deft if valid is None else (valid | deft)
            return (np.where(deft, True, ld | rd), valid)
        if e.op in _NP_CMP:
            return (_NP_CMP[e.op](ld, rd), _np_and_valid(lv, rv))
        if e.op == "+":
            return (ld + rd, _np_and_valid(lv, rv))
        if e.op == "-":
            return (ld - rd, _np_and_valid(lv, rv))
        if e.op == "*":
            return (ld * rd, _np_and_valid(lv, rv))
        return None  # / and % have division-by-zero semantics
    return None


def _tensor(a) -> torch.Tensor:
    """A CPU tensor over a numpy array (copied only where numpy's layout
    or write flag forbids sharing it)."""
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a)
    return torch.from_numpy(a)


def _texpr_did(e: E.TExpr, schema):
    """The dictionary a TEXT expression's codes index: its column's, or
    the literal pool for computed TEXT."""
    if isinstance(e, E.Col):
        return schema[e.index].dict_id
    if isinstance(e, E.CastE):
        return _texpr_did(e.operand, schema)
    return LITERAL_DICT if e.type.is_text else None

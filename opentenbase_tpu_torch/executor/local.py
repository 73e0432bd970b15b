"""Coordinator finish on the host (subset of the reference's
opentenbase_tpu/executor/local.py).

After the fused fragment ran on the device, the coordinator merges the
gathered per-shard partial rows: ``RemoteSource -> Aggregate (merge) ->
Project -> Sort -> Limit``, with Filter for HAVING. The inputs are a few
rows per shard (or per group), so the operators run in numpy on the
host; every expression beyond a column reference (``avg``'s sum / count,
HAVING predicates, computed sort keys) is compiled by the port's
``ExprCompiler`` and run over CPU tensors, as the reference runs its own
compiler on jnp, so the device and the coordinator share one set of
semantics (FLOAT8 computed in float32, division by zero NULL).

TEXT values stay dictionary codes: they group on codes, and ORDER BY,
min and max work on each code's rank in the sorted dictionary (codes
follow insertion order, not collation). Float group keys group by the
reference's ``float_key_parts`` (every NaN one group, -0.0 with 0.0);
ORDER BY puts NaN last in both directions, as the reference's stable
argsort passes do. Operators outside this subset raise NotPorted.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.catalog import Catalog
from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.ops import LITERAL_DICT
from opentenbase_tpu_torch.ops.expr import ExprCompiler, resolve_param
from opentenbase_tpu_torch.ops.filter import bucket_size
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan import texpr as E
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import ColumnBatch


@dataclass
class HostBatch:
    """Columns as (data, valid_or_None) numpy pairs of ``n`` rows."""

    schema: tuple[L.OutCol, ...]
    cols: list
    n: int


class ExecError(RuntimeError):
    pass


class LocalExecutor:
    """Evaluates the coordinator's plan over the gathered fragment
    outputs (``remote_inputs``: fragment index -> ColumnBatch)."""

    def __init__(
        self, catalog: Catalog, remote_inputs: dict[int, ColumnBatch]
    ):
        self.catalog = catalog
        self.remote_inputs = remote_inputs

    def run_plan(self, root: L.LogicalPlan) -> ColumnBatch:
        """Evaluate one plan tree to a host batch."""
        return self.to_host(self.eval(root))

    def _dict_ranks(self, dict_id, with_order: bool = False):
        """code -> collation rank over dictionary ``dict_id`` (padded to a
        power of two); ``with_order`` also returns the inverse, rank ->
        code, from the same sort."""
        if not dict_id:
            raise ExecError("TEXT without a dictionary")
        vals = self.catalog.dictionary(dict_id).values
        order = np.argsort(np.asarray(vals, dtype=object)).astype(np.int32)
        padded = bucket_size(max(len(vals), 1))
        ranks = np.zeros(padded, dtype=np.int32)
        ranks[order] = np.arange(len(vals), dtype=np.int32)
        if not with_order:
            return ranks
        inv = np.zeros(padded, dtype=np.int32)
        inv[: len(order)] = order
        return ranks, inv

    def to_host(self, b: HostBatch) -> ColumnBatch:
        cols: dict[str, Column] = {}
        used: dict[str, int] = {}
        for oc, (data, valid) in zip(b.schema, b.cols):
            name = oc.name
            if name in cols:
                used[name] = used.get(name, 0) + 1
                name = f"{name}_{used[oc.name]}"
            ty = oc.type
            if oc.dict_id:
                dic = self.catalog.dictionary(oc.dict_id)
            else:  # computed TEXT codes index the literal pool
                dic = self.catalog.literals if ty.is_text else None
            cols[name] = Column(ty, np.asarray(data).astype(ty.np_dtype),
                                valid, dic)
        return ColumnBatch(cols, b.n)

    def eval(self, plan: L.LogicalPlan) -> HostBatch:
        m = getattr(self, f"_eval_{type(plan).__name__.lower()}", None)
        if m is None:
            raise NotPorted(
                f"coordinator operator {type(plan).__name__}"
            )
        return m(plan)

    def _eval_remotesource(self, plan) -> HostBatch:
        batch = self.remote_inputs.get(plan.fragment)
        if batch is None:
            raise ExecError(f"no input for fragment {plan.fragment}")
        cols = [
            (np.asarray(c.data), None if c.validity is None
             else np.asarray(c.validity))
            for c in batch.columns.values()
        ]
        return HostBatch(tuple(plan.schema), cols, batch.nrows)

    # -- expressions: the port's compiler over CPU tensors ------------------
    def _bind(self, exprs, schema, want_dids=None):
        """Compile ``exprs`` over ``schema`` with one shared param list
        (the reference's ``_bind``): (functions, bound params)."""
        comp = ExprCompiler("cpu")
        dids = [c.dict_id for c in schema]
        fns = []
        for i, e in enumerate(exprs):
            want = None
            if want_dids is not None and e.type.is_text:
                want = want_dids[i] or LITERAL_DICT
            fns.append(comp.compile(e, dids, want))
        params = tuple(resolve_param(s, "cpu", self.catalog.dictionary)
                       for s in comp.params)
        return fns, params

    def _eval_exprs(self, exprs, child: HostBatch, want_dids=None) -> list:
        """Each expression over ``child``'s rows as a numpy (data, valid)
        pair. A plain column reference passes through; anything else
        runs through ``_bind``."""
        out: list = [None] * len(exprs)
        todo = []
        for i, e in enumerate(exprs):
            want = None
            if want_dids is not None and e.type.is_text:
                want = want_dids[i] or LITERAL_DICT
            if isinstance(e, E.Col) and (
                want is None
                or (child.schema[e.index].dict_id or LITERAL_DICT) == want
            ):
                out[i] = child.cols[e.index]
            else:
                todo.append(i)
        if not todo:
            return out
        fns, params = self._bind(
            [exprs[i] for i in todo], child.schema,
            None if want_dids is None else [want_dids[i] for i in todo])
        env = [(_tensor(d), None if v is None else _tensor(v))
               for d, v in child.cols]
        n = child.n
        for i, fn in zip(todo, fns):
            d, v = fn(env, params)
            out[i] = (d.expand(n).contiguous().numpy(),
                      None if v is None else v.expand(n).contiguous().numpy())
        return out

    def _eval_project(self, plan: L.Project) -> HostBatch:
        child = self.eval(plan.child)
        cols = self._eval_exprs(plan.exprs, child,
                                [oc.dict_id for oc in plan.schema])
        return HostBatch(plan.schema, cols, child.n)

    def _eval_filter(self, plan: L.Filter) -> HostBatch:
        child = self.eval(plan.child)
        ((d, v),) = self._eval_exprs([plan.predicate], child)
        keep = np.broadcast_to(d if v is None else (d & v), (child.n,))
        idx = np.nonzero(keep)[0]
        cols = [(d[idx], None if v is None else v[idx])
                for d, v in child.cols]
        return HostBatch(plan.schema, cols, len(idx))

    # -- aggregate: the merge of per-shard partials --------------------------
    def _eval_aggregate(self, plan: L.Aggregate) -> HostBatch:
        child = self.eval(plan.child)
        for a in plan.aggs:
            if a.distinct or a.func not in ("sum", "count", "min", "max"):
                raise NotPorted(f"coordinator aggregate {a.func}")
            if (
                a.func == "sum" and a.arg is not None
                and a.arg.type.id == t.TypeId.DECIMAL
                and a.type.scale != a.arg.type.scale
            ):
                raise NotPorted("sum with a decimal rescale")
        keys = self._eval_exprs(plan.group_exprs, child)
        if keys:
            gid, first = _group_ids(keys, child.n)
            ng = len(first)
        else:
            gid = np.zeros(child.n, dtype=np.int64)
            first = np.zeros(1, dtype=np.int64)
            ng = 1
        cols = [
            (d[first], None if v is None else v[first]) for d, v in keys
        ]
        args = self._eval_exprs(
            [a.arg for a in plan.aggs if a.arg is not None], child)
        for a in plan.aggs:
            arg = None if a.arg is None else args.pop(0)
            cols.append(self._reduce(a, arg, child, gid, ng))
        return HostBatch(plan.schema, cols, ng)

    def _reduce(self, a: E.AggCall, arg, child: HostBatch, gid, ng):
        """One merge aggregate per group (the reference's group_reduce
        and ``_finalize_aggs``): integer sums exact in int64, float sums
        in the values' own float type. An ``avg`` reaches the merge as
        a partial sum and count, finished by the Project above it."""
        if a.arg is None:  # count(*)
            return (np.bincount(gid, minlength=ng).astype(np.int64), None)
        d, v = arg
        d = np.asarray(d)
        valid = np.ones(child.n, dtype=bool) if v is None else v
        cnt = np.bincount(gid[valid], minlength=ng).astype(np.int64)
        if a.func == "count":
            return (cnt, None)
        if a.func in ("min", "max"):
            inv = None
            if a.arg.type.is_text:
                # reduce in rank space, then map the winner back to its code
                ranks, inv = self._dict_ranks(
                    _texpr_did(a.arg, child.schema), with_order=True)
                d = ranks[np.clip(d, 0, len(ranks) - 1)]
            if d.dtype.kind == "f":
                init = np.inf if a.func == "min" else -np.inf
            elif d.dtype.kind == "b":
                d, init = d.astype(np.int8), (2 if a.func == "min" else -1)
            else:
                info = np.iinfo(d.dtype)
                init = info.max if a.func == "min" else info.min
            out = np.full(ng, init, dtype=d.dtype)
            op = np.minimum if a.func == "min" else np.maximum
            op.at(out, gid[valid], d[valid])
            if inv is not None:
                out = inv[np.clip(out, 0, len(inv) - 1)]
            return (out.astype(a.type.np_dtype), cnt > 0)
        # integers (scaled decimals included) exact in int64, floats in
        # their own type (NaN propagates)
        s = np.zeros(ng, dtype=d.dtype if d.dtype.kind == "f" else np.int64)
        np.add.at(s, gid[valid], d[valid].astype(s.dtype))
        return (s.astype(a.type.np_dtype), cnt > 0)  # SQL: sum of none is NULL

    # -- sort / limit ---------------------------------------------------------
    def _eval_sort(self, plan: L.Sort) -> HostBatch:
        """Stable passes from the least significant key to the most (the
        reference's ``ops/sort.order_indices``): each key sorts its
        values (negated for DESC, so NaN stays last either way), then a
        stable pass on its NULL flag puts the NULLs first or last."""
        child = self.eval(plan.child)
        keys = self._eval_exprs([k.expr for k in plan.keys], child)
        perm = np.arange(child.n)
        for k, (d, v) in zip(reversed(plan.keys), reversed(keys)):
            d = np.asarray(d)
            if k.expr.type.is_text:
                ranks = self._dict_ranks(_texpr_did(k.expr, child.schema))
                d = ranks[np.clip(d, 0, len(ranks) - 1)]
            elif d.dtype == np.bool_:
                d = d.astype(np.int32)
            x = d[perm]
            perm = perm[np.argsort(-x if k.descending else x, kind="stable")]
            if v is not None:
                nulls_first = (k.nulls_first if k.nulls_first is not None
                               else k.descending)
                null = ~np.asarray(v)[perm]
                perm = perm[np.argsort(null != nulls_first, kind="stable")]
        cols = [
            (d[perm], None if v is None else v[perm]) for d, v in child.cols
        ]
        return HostBatch(plan.schema, cols, child.n)

    def _eval_limit(self, plan: L.Limit) -> HostBatch:
        child = self.eval(plan.child)
        lo = min(plan.offset, child.n)
        hi = child.n if plan.limit is None else min(lo + plan.limit, child.n)
        cols = [
            (d[lo:hi], None if v is None else v[lo:hi]) for d, v in child.cols
        ]
        return HostBatch(plan.schema, cols, hi - lo)


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


def _float_key_parts(d: np.ndarray) -> list:
    """numpy twin of ``ops/agg.float_key_parts``: int32 views under which
    equal floats compare equal, -0.0 folded into 0.0 and every NaN one
    pattern; float64 as its hi and lo float32 parts."""
    with np.errstate(all="ignore"):
        d = np.where(d == 0, np.zeros((), d.dtype), d)
        d = np.where(np.isnan(d), np.full((), np.nan, d.dtype), d)
        if d.dtype == np.float64:
            hi = d.astype(np.float32)
            lo = (d - hi.astype(np.float64)).astype(np.float32)
            lo = np.where(np.isfinite(d), lo, np.float32(0))
            return [hi.view(np.int32), lo.view(np.int32)]
        return [d.astype(np.float32).view(np.int32)]


def _group_ids(keys, n: int):
    """Dense group id per row and each group's first row, groups in the
    reference's order: ascending key parts (a float key by its
    ``float_key_parts``), NULL keys after the non-NULL ones."""
    parts = []
    for d, v in keys:
        d = np.asarray(d)
        for p in _float_key_parts(d) if d.dtype.kind == "f" else [d]:
            parts.append((p, v))
    lex = []
    for d, v in reversed(parts):
        valid = np.ones(n, dtype=bool) if v is None else v
        lex.append(np.where(valid, d, 0))
        lex.append(~valid)
    order = np.lexsort(lex) if n else np.zeros(0, dtype=np.int64)
    same = np.ones(len(order), dtype=bool)  # row equals its predecessor
    same[:1] = False
    for d, v in parts:
        valid = np.ones(n, dtype=bool) if v is None else v
        dv, vv = np.where(valid, d, 0)[order], valid[order]
        same[1:] &= (dv[1:] == dv[:-1]) & (vv[1:] == vv[:-1])
    starts = ~same
    gid_sorted = np.cumsum(starts) - 1
    gid = np.empty(n, dtype=np.int64)
    gid[order] = gid_sorted
    return gid, order[starts]

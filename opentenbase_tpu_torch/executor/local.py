"""Coordinator finish on the host (subset of the reference's
opentenbase_tpu/executor/local.py).

After the fused fragment ran on the device, the coordinator merges the
gathered per-shard partial rows: ``RemoteSource -> Aggregate (merge) ->
Project -> Sort -> Limit``. The inputs are a few rows per shard (or per
group), so this runs in numpy on the host. TEXT values stay dictionary
codes: they group on codes, and ORDER BY, min and max work on each
code's rank in the sorted dictionary (codes follow insertion order, not
collation). Operators and expressions outside this subset raise
NotPorted.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.catalog import Catalog
from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.ops import LITERAL_DICT
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
            dic = self.catalog.dictionary(oc.dict_id) if oc.dict_id else None
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

    @staticmethod
    def _col(e: E.TExpr, child: HostBatch):
        if not isinstance(e, E.Col):
            raise NotPorted(
                f"coordinator expression {type(e).__name__} (only column "
                "references are ported)"
            )
        return child.cols[e.index]

    def _eval_project(self, plan: L.Project) -> HostBatch:
        child = self.eval(plan.child)
        cols = []
        for e, oc in zip(plan.exprs, plan.schema):
            d, v = self._col(e, child)
            src = child.schema[e.index].dict_id or LITERAL_DICT
            if e.type.is_text and oc.dict_id and src != oc.dict_id:
                # the output names another dictionary (min/max of a
                # column types as computed text, in the literal pool):
                # carry each code over by its string
                table = self._translate(src, oc.dict_id)
                d = table[np.clip(d, 0, len(table) - 1)]
            cols.append((d, v))
        return HostBatch(plan.schema, cols, child.n)

    def _translate(self, src: str, dst: str) -> np.ndarray:
        """code in dictionary ``src`` -> code of the same string in
        ``dst`` (minted there where missing)."""
        vals = list(self.catalog.dictionary(src).values)
        table = np.zeros(max(len(vals), 1), dtype=np.int32)
        if vals:
            table[: len(vals)] = self.catalog.dictionary(dst).encode(vals)
        return table

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
        keys = [self._col(g, child) for g in plan.group_exprs]
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
        for a in plan.aggs:
            cols.append(self._reduce(a, child, gid, ng))
        return HostBatch(plan.schema, cols, ng)

    def _reduce(self, a: E.AggCall, child: HostBatch, gid, ng):
        if a.arg is None:  # count(*)
            return (np.bincount(gid, minlength=ng).astype(np.int64), None)
        d, v = self._col(a.arg, child)
        valid = np.ones(child.n, dtype=bool) if v is None else v
        cnt = np.bincount(gid[valid], minlength=ng).astype(np.int64)
        if a.func == "count":
            return (cnt, None)
        if a.func in ("min", "max"):
            d = np.asarray(d)
            inv = None
            if a.arg.type.is_text:
                # reduce in rank space, then map the winner back to its code
                ranks, inv = self._dict_ranks(
                    child.schema[a.arg.index].dict_id, with_order=True)
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
        # exact integer sums (scaled decimals and ints are int64 here)
        s = np.zeros(ng, dtype=np.int64)
        np.add.at(s, gid[valid], d[valid].astype(np.int64))
        return (s.astype(a.type.np_dtype), cnt > 0)  # SQL: sum of none is NULL

    # -- sort / limit ---------------------------------------------------------
    def _eval_sort(self, plan: L.Sort) -> HostBatch:
        child = self.eval(plan.child)
        lex = []
        # np.lexsort sorts by the LAST key first: feed keys in reverse,
        # each as (value rank, null rank) with the null rank primary
        for k in reversed(plan.keys):
            d, v = self._col(k.expr, child)
            valid = np.ones(child.n, dtype=bool) if v is None else v
            nulls_first = (
                k.nulls_first if k.nulls_first is not None else k.descending
            )
            if k.expr.type.is_text:
                ranks = self._dict_ranks(child.schema[k.expr.index].dict_id)
                d = ranks[np.clip(d, 0, len(ranks) - 1)]
            rank = np.unique(d, return_inverse=True)[1].reshape(-1)
            lex.append(-rank if k.descending else rank)
            lex.append(valid if nulls_first else ~valid)
        perm = (
            np.lexsort(lex) if lex else np.arange(child.n)
        )
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


def _group_ids(keys, n: int):
    """Dense group id per row (groups in ascending key order, NULL keys
    grouped together after the non-NULL ones) and each group's first
    row."""
    lex = []
    for d, v in reversed(keys):
        valid = np.ones(n, dtype=bool) if v is None else v
        lex.append(np.where(valid, d, 0))
        lex.append(~valid)
    order = np.lexsort(lex) if n else np.zeros(0, dtype=np.int64)
    same = np.ones(len(order), dtype=bool)  # row equals its predecessor
    same[:1] = False
    for d, v in keys:
        valid = np.ones(n, dtype=bool) if v is None else v
        dv, vv = np.where(valid, d, 0)[order], valid[order]
        same[1:] &= (dv[1:] == dv[:-1]) & (vv[1:] == vv[:-1])
    starts = ~same
    gid_sorted = np.cumsum(starts) - 1
    gid = np.empty(n, dtype=np.int64)
    gid[order] = gid_sorted
    return gid, order[starts]

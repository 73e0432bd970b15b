"""Fused DAG executor on one GPU: join plans under a scalar aggregate
(subset of the reference's opentenbase_tpu/executor/fused_dag.py).

The reference compiles every fragment of a distributed plan into a
``shard_map`` program over its device mesh and wires redistribute
motions through ``all_to_all`` exchanges. Here every shard of every table
lives on the one card, so the mesh has one device (the reference's
D == 1 form): each motion is an identity, the producer fragments inline
into the final one (``_inline_sources``), and the whole plan runs as one
program over the flattened [S * Rmax] shard planes.

An inner equi-join takes one of three formulations, each failure class
degrading one step at run time through a per-join flag:

- fold: a small build side whose visible keys form a gap-free unique
  range is a perfect-hash table; each probe row gathers its match by key
  arithmetic (``_lookup_dense``). Flag: the keys are not dense.
- radix: a build side small against the probe goes into a bucket-padded
  radix hash table (ops/join.build_radix_table), probed by the
  hand-written kernel (ops/radix_probe.py). Flag: duplicate build keys
  or a bucket overflow.
- sort-merge: the build side sorts once and every probe row searches it
  (``_lookup``). Flag: duplicate build keys — the runner flips the build
  side, and a second flag means duplicates on both sides.

Ported: the scalar-aggregate final mode with its flag-retry loop, inner
joins, and the join-mode notes (``last_join_modes``). Grouped, top-k,
row-returning, gsort, gagg, gseg and windowed modes, semi/anti joins and
the multi-device exchanges raise NotPorted.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.ops import join as join_ops
from opentenbase_tpu_torch.ops import radix_probe as rp
from opentenbase_tpu_torch.ops.agg import scalar_reduce
from opentenbase_tpu_torch.ops.expr import ExprCompiler, resolve_param
from opentenbase_tpu_torch.ops.filter import mask_count
from opentenbase_tpu_torch.plan import batchplan
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan import texpr as E
from opentenbase_tpu_torch.plan.distribute import RemoteSource
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import ColumnBatch

# Dimension fold: an inner join whose build side is this small (and at
# most half the probe) is first tried as a dense direct-index lookup.
DIMFOLD_MAX_BUILD = 33_554_432

_JOINABLE_KEY_TYPES = (
    t.TypeId.INT4, t.TypeId.INT8, t.TypeId.BOOL,
    t.TypeId.DECIMAL, t.TypeId.DATE, t.TypeId.TIMESTAMP,
)

_PROGRAM_CACHE_MAX = 64


class DagUnsupported(NotPorted):
    """Plan shape outside the fused DAG subset. The reference answers
    such plans on its host executor; the port has none, so this is a
    NotPorted."""


# ---------------------------------------------------------------------------
# Compile-time plan walking. ``_Builder.build`` turns a plan tree into a
# closure ``fn(blocks, params, snap) -> (env, mask, n, flags)``: ``env``
# the (data, valid) columns of the node's schema over ``n`` rows, ``mask``
# the rows alive there, ``flags`` one 0-d bool per inner join below.
# ``blocks`` are the per-leaf tensor tuples in ``_walk_leaves`` order.
# ---------------------------------------------------------------------------


def _scan_nodes(meta) -> tuple:
    """Stores a scan reads: every shard of a distributed table, exactly
    ONE replica of a replicated one (reading all would duplicate rows)."""
    if meta.dist.is_replicated:
        return tuple(meta.node_indices[:1])
    return tuple(meta.node_indices)


def _walk_leaves(node: L.LogicalPlan):
    """Canonical DFS leaf order — the ONE definition both the closure
    builder and the per-run array collection follow."""
    if isinstance(node, (L.Filter, L.Project, L.Aggregate)):
        yield from _walk_leaves(node.child)
    elif isinstance(node, L.Join):
        yield from _walk_leaves(node.left)
        yield from _walk_leaves(node.right)
    elif isinstance(node, (L.Scan, RemoteSource)):
        yield node
    else:
        raise DagUnsupported(type(node).__name__)


def _leaf_arrays(fx, node):
    """Device tensors for one scan leaf, fetched fresh every run so a
    cached program sees current data: (columns, non-None validities,
    xmin, xmax, nrows)."""
    if not isinstance(node, L.Scan):
        raise DagUnsupported("remote source order")
    meta = fx.catalog.get(node.table)
    nodes = _scan_nodes(meta)
    for n in nodes:
        if node.table not in fx.node_stores.get(n, {}):
            raise DagUnsupported("missing store")
    dtab = fx.cache.get(
        node.table, meta, fx.node_stores, nodes, columns=node.columns
    )
    valids = tuple(dtab.validity[c] for c in node.columns)
    return (
        tuple(dtab.columns[c] for c in node.columns),
        tuple(v for v in valids if v is not None),
        dtab.xmin, dtab.xmax, dtab.nrows_dev,
    )


def _collect_arrays(fx, root) -> list:
    return [_leaf_arrays(fx, n) for n in _walk_leaves(root)]


def _inline_sources(node, producers: dict):
    """Substitute each RemoteSource with its producer fragment's root
    (recursively: producers may consume earlier fragments). Valid because
    every motion is an identity on one device."""
    if isinstance(node, RemoteSource):
        return _inline_sources(producers[node.fragment], producers)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, (L.LogicalPlan, RemoteSource)):
                nv = _inline_sources(v, producers)
                if nv is not v:
                    changes[f.name] = nv
            elif isinstance(v, tuple) and v and all(
                isinstance(x, L.LogicalPlan) for x in v
            ):
                nv = tuple(_inline_sources(x, producers) for x in v)
                if any(a is not b for a, b in zip(nv, v)):
                    changes[f.name] = nv
        if changes:
            return dataclasses.replace(node, **changes)
    return node


def _expr_cols(e, out=None):
    """All child-column positions an expression references."""
    if out is None:
        out = set()
    if isinstance(e, E.Col):
        out.add(e.index)
    for c in e.children():
        _expr_cols(c, out)
    return out


def _chain_leaf(node, folded_ids: dict):
    """Peel a build subtree down to the ONE leaf whose rows it preserves:
    Filters keep rows; an inner join that folded (``folded_ids``: id ->
    build_right, post-order known) keeps its probe side's rows. Returns
    (leaf, leaf_positions): the positions of ``node.schema`` backed
    directly by leaf columns (a fold key must be leaf-backed, since
    folded-in columns hold garbage on unmatched rows). None when the
    chain breaks."""
    offset = 0
    width = len(node.schema)
    while True:
        if isinstance(node, L.Filter):
            node = node.child
            continue
        if isinstance(node, L.Join) and node.join_type == "inner":
            if id(node) not in folded_ids:
                return None
            nl = len(node.left.schema)
            if folded_ids[id(node)]:  # built right: the left side stays
                node = node.left
                width = nl
            else:
                node = node.right
                offset += nl
                width = len(node.schema)
            continue
        if isinstance(node, L.Scan):
            return node, range(offset, offset + width)
        return None


def _fold_gate(runner, node: L.Join, ji: int, build_right: bool,
               fold_off, folded_ids: dict) -> bool:
    """THE dimension-fold gate. Static checks only; density and
    uniqueness are verified at run time by the fold flag. Requires a
    build subtree that preserves ONE leaf's rows, with the join key
    backed by that leaf, and a build side small in absolute terms AND
    against the probe."""
    if ji in fold_off:
        return False
    bnode = node.right if build_right else node.left
    pnode = node.left if build_right else node.right
    chain = _chain_leaf(bnode, folded_ids)
    if chain is None:
        return False
    bkey = (node.right_keys if build_right else node.left_keys)[0]
    if not _expr_cols(bkey) <= set(chain[1]):
        return False
    best = runner._est_rows(bnode)
    pest = runner._est_rows(pnode)
    return 0 < best <= DIMFOLD_MAX_BUILD and best * 2 <= pest


def _radix_gate(runner, node: L.Join, ji: int, build_right: bool,
                radix_off) -> bool:
    """THE radix-hash-join gate: the radix table engages where the fold
    can't (keys unique but not a gap-free range) for a build side
    estimated at most half the probe. Inner joins only."""
    if ji in radix_off:
        return False
    bnode = node.right if build_right else node.left
    pnode = node.left if build_right else node.right
    best = runner._est_rows(bnode)
    pest = runner._est_rows(pnode)
    return 0 < best and best * 2 <= pest


def _lookup_radix(pk, pmask, bk, bmask, budget, fallback):
    """Equi-join over the bucket-padded radix hash table: one small
    build-side sort and one bucket walk per probe row (the kernel). The
    batch planner sizes partitions and bucket against ``budget``; a
    build side whose table would not fit splits into passes (the probe
    stays resident, one transient table per pass), and when even the
    most passes cannot fit, ``fallback`` (the sort-merge lookup)
    answers.

    Returns (matched, bidx, flag) like ``_lookup``; the flag is raised by
    duplicate build keys (inside a bucket, or a probe key matching in
    two passes) or by a bucket overflow."""
    pd, pv = pk
    bd, bv = bk
    nb = bd.shape[0]
    npr = pd.shape[0]
    dev = pd.device
    if nb == 0:  # no build rows can ever match
        return (
            torch.zeros(npr, dtype=torch.bool, device=dev),
            torch.zeros(npr, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev),
        )
    plan = batchplan.plan_radix_join(nb, npr, budget)
    if plan is None:
        return fallback(pk, pmask, bk, bmask, check_dup=True)
    breal = bmask if bv is None else (bmask & bv)
    preal = pmask if pv is None else (pmask & pv)
    if pd.dtype not in (torch.int32, torch.int64):
        pd = pd.to(torch.int64)  # the partition hashes the int64 value
    P, B = plan.partitions, plan.bucket
    matched = torch.zeros(npr, dtype=torch.bool, device=dev)
    bidx = torch.zeros(npr, dtype=torch.int32, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    chunk = -(-nb // plan.passes)
    for p in range(plan.passes):
        s = p * chunk
        e = min(s + chunk, nb)
        if s >= e:
            break
        tkeys, tvalid, tbidx, dup, ovf = join_ops.build_radix_table(
            bd[s:e], breal[s:e], P, B
        )
        m, bi = rp.radix_probe(tkeys, tvalid, tbidx, pd, preal, P, B)
        # a probe key matching in two passes = build dup across chunks
        flag = flag | dup | ovf | torch.any(m & matched)
        bidx = torch.where(m & ~matched, bi + s, bidx)
        matched = matched | m
    return matched, bidx, flag


def _lookup_dense(pk, pmask, bk, bvis, bfull):
    """Equi-join for a small dense-keyed build side: sort the build rows
    by key, then verify the VISIBLE keys form a gap-free unique range
    [base, base + cnt) (sorted position i holds key base + i). When they
    do, the sorted rows are a perfect-hash table: slot = key - base.

    The density domain is ``bvis`` (storage visibility only); query
    predicates arrive as ``bfull`` and act as slot validity, so a
    filtered dimension keeps its dense range. Duplicates and gaps both
    break the position identity, so the single ``notdense`` flag
    subsumes the dup check. Returns (matched, bidx int32, notdense)."""
    pd, pv = pk
    bd, bv = bk
    nb = bd.shape[0]
    npr = pd.shape[0]
    dev = pd.device
    if nb == 0:
        return (
            torch.zeros(npr, dtype=torch.bool, device=dev),
            torch.zeros(npr, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev),
        )
    breal = bvis if bv is None else (bvis & bv)
    preal = pmask if pv is None else (pmask & pv)
    bkey = torch.where(
        breal, bd.to(torch.int64), torch.full_like(bd, 2**62,
                                                    dtype=torch.int64)
    )
    sk, sidx = torch.sort(bkey)
    cnt = mask_count(breal)
    iota = torch.arange(nb, dtype=torch.int64, device=dev)
    base = sk[0]
    dense = torch.all((iota >= cnt) | (sk == base + iota))
    slot = pd.to(torch.int64) - base
    inr = (slot >= 0) & (slot < cnt)
    bidx = sidx[slot.clamp(0, nb - 1)].to(torch.int32)
    matched = inr & preal & bfull[bidx]
    return matched, bidx, ~dense


def _lookup(pk, pmask, bk, bmask, check_dup: bool):
    """Sorted-lookup equi-join (the sort-merge formulation on a card with
    per-thread gathers): the build side sorts once with its real rows
    first within equal keys, and every probe row binary-searches it, so
    the left bound lands on a real row whenever one exists. ``dup`` is
    exact: adjacent equal keys where both rows are real. Returns
    (matched [np] bool, bidx [np] int32, dup 0-d bool)."""
    pd, pv = pk
    bd, bv = bk
    nb = bd.shape[0]
    breal = bmask if bv is None else (bmask & bv)
    bkey = bd.to(torch.int64)
    order = torch.argsort((~breal).to(torch.int8), stable=True)
    order = order[torch.argsort(bkey[order], stable=True)]
    bs = bkey[order]
    sreal = breal[order]
    if check_dup and nb > 1:
        dup = torch.any((bs[1:] == bs[:-1]) & sreal[1:] & sreal[:-1])
    else:
        dup = torch.zeros((), dtype=torch.bool, device=bd.device)
    pkey = pd.to(torch.int64)
    posc = torch.searchsorted(bs, pkey, side="left").clamp(0, nb - 1)
    matched = (bs[posc] == pkey) & sreal[posc] & pmask
    if pv is not None:
        matched = matched & pv
    return matched, order[posc].to(torch.int32), dup


def _bcast(kv, n):
    d, v = kv
    if d.dim() == 0:
        d = d.expand(n)
    if v is not None and v.dim() == 0:
        v = v.expand(n)
    return (d, v)


def _gather(env, bidx):
    return [
        (d.index_select(0, bidx),
         None if v is None else v.index_select(0, bidx))
        for d, v in env
    ]


class _Builder:
    def __init__(self, fx, comp: ExprCompiler, orientation: tuple, root,
                 runner, offs=(frozenset(), frozenset())):
        self.fx = fx
        self.comp = comp
        self.orientation = orientation
        self.leaf_index = {
            id(n): i for i, n in enumerate(_walk_leaves(root))
        }
        self.njoin = 0  # inner joins seen (orientation index)
        self.runner = runner
        # joins whose fold or radix table already failed at run time
        self.fold_off, self.radix_off = offs
        self.folded: set = set()
        self.folded_ids: dict = {}  # id(join) -> build_right, folded
        self.radixed: set = set()  # joins THIS compile radix-hashed
        self.modes: set = set()  # 'fold' / 'radix' / 'merge' compiled
        # the port has no device_memory_limit setting: env > default
        self.radix_budget = batchplan.resolve_budget(
            0, "OTB_RADIX_HBM_BUDGET", batchplan.DEFAULT_EXCHANGE_BUDGET
        )

    def jinfo(self) -> tuple:
        """(folded, radixed) join-index sets for THIS compile: whether a
        raised flag means fold-disable, radix-disable, or flip."""
        return (frozenset(self.folded), frozenset(self.radixed))

    def _leaf_scan(self, node: L.Scan) -> Callable:
        meta = self.fx.catalog.get(node.table)
        dtab = self.fx.cache.get(
            node.table, meta, self.fx.node_stores, _scan_nodes(meta),
            columns=node.columns,
        )
        has_valid = tuple(
            dtab.validity[c] is not None for c in node.columns
        )
        idx = self.leaf_index[id(node)]
        rmax = dtab.rmax

        def run(blocks, params, snap):
            # visibility planes are [k, Rmax] or compact [k, 1]: the 2-D
            # compares broadcast either form
            cols, valids, xmin, xmax, nrows = blocks[idx]
            k = xmin.shape[0]
            n = k * rmax
            rows = torch.arange(rmax, device=nrows.device)
            live = (
                (rows[None, :] < nrows[:, None])
                & (xmin <= snap) & (snap < xmax)
            ).reshape(n)
            env = []
            vi = 0
            for ci in range(len(cols)):
                d = cols[ci].reshape(n)
                if has_valid[ci]:
                    env.append((d, valids[vi].reshape(n)))
                    vi += 1
                else:
                    env.append((d, None))
            return env, live, n, []

        return run

    def build(self, node: L.LogicalPlan) -> Callable:
        if isinstance(node, L.Filter):
            child = self.build(node.child)
            pred = self.comp.compile(node.predicate)

            def run(blocks, params, snap):
                env, mask, n, flags = child(blocks, params, snap)
                d, v = pred(env, params)
                keep = d if v is None else (d & v)
                return env, mask & keep, n, flags

            return run

        if isinstance(node, L.Project):
            child = self.build(node.child)
            fns = [self.comp.compile(ex) for ex in node.exprs]

            def run(blocks, params, snap):
                env, mask, n, flags = child(blocks, params, snap)
                out = [_bcast(fn(env, params), n) for fn in fns]
                return out, mask, n, flags

            return run

        if isinstance(node, L.Scan):
            return self._leaf_scan(node)

        if isinstance(node, L.Join):
            return self._build_join(node)

        raise DagUnsupported(type(node).__name__)

    def _build_join(self, node: L.Join) -> Callable:
        if node.join_type != "inner":
            raise DagUnsupported(f"{node.join_type} join")
        if len(node.left_keys) != 1 or len(node.right_keys) != 1:
            raise DagUnsupported("multi-key join")
        for k in (node.left_keys[0], node.right_keys[0]):
            if k.type.id not in _JOINABLE_KEY_TYPES:
                raise DagUnsupported(f"join key type {k.type.id}")
        left = self.build(node.left)
        right = self.build(node.right)
        lkfn = self.comp.compile(node.left_keys[0])
        rkfn = self.comp.compile(node.right_keys[0])
        resfn = (
            None if node.residual is None
            else self.comp.compile(node.residual)
        )
        ji = self.njoin
        self.njoin += 1
        build_right = (
            self.orientation[ji] if ji < len(self.orientation) else "R"
        ) == "R"
        # mode selection: fold (perfect hash over a dense key range) >
        # radix hash table > sort-merge; each failure class degrades one
        # step at run time through the join's flag
        fold = _fold_gate(
            self.runner, node, ji, build_right, self.fold_off,
            folded_ids=self.folded_ids,
        )
        use_radix = False
        bstrip_fn = None
        if fold:
            self.folded.add(ji)
            self.folded_ids[id(node)] = build_right
            # the chain leaf supplies the density domain (visibility
            # only); the full build closure's mask becomes slot validity
            bnode = node.right if build_right else node.left
            leaf, _lp = _chain_leaf(bnode, self.folded_ids)
            bstrip_fn = self.build(leaf)
        else:
            use_radix = _radix_gate(
                self.runner, node, ji, build_right, self.radix_off
            )
            if use_radix:
                self.radixed.add(ji)
        self.modes.add("fold" if fold else ("radix" if use_radix else
                                            "merge"))
        radix_budget = self.radix_budget

        def run(blocks, params, snap):
            lenv, lmask, ln, lflags = left(blocks, params, snap)
            renv, rmask, rn, rflags = right(blocks, params, snap)
            flags = lflags + rflags
            lk = _bcast(lkfn(lenv, params), ln)
            rk = _bcast(rkfn(renv, params), rn)
            if build_right:
                pk, pmask, penv, pn = lk, lmask, lenv, ln
                bk, bmask, benv = rk, rmask, renv
            else:
                pk, pmask, penv, pn = rk, rmask, renv, rn
                bk, bmask, benv = lk, lmask, lenv
            if fold:
                _benv, bvis, _bn, _bf = bstrip_fn(blocks, params, snap)
                matched, bidx, flag = _lookup_dense(
                    pk, pmask, bk, bvis, bmask
                )
            elif use_radix:
                matched, bidx, flag = _lookup_radix(
                    pk, pmask, bk, bmask, radix_budget, _lookup
                )
            else:
                matched, bidx, flag = _lookup(
                    pk, pmask, bk, bmask, check_dup=True
                )
            gathered = _gather(benv, bidx)
            env = (
                list(penv) + gathered if build_right
                else gathered + list(penv)
            )
            mask = pmask & matched
            if resfn is not None:
                d, v = resfn(env, params)
                mask = mask & (d if v is None else (d & v))
            return env, mask, pn, flags + [flag]

        return run


def _agg_specs(comp, agg):
    """(specs, compiled args) for an Aggregate's functions."""
    specs: list[str] = []
    afns: list = []
    for a in agg.aggs:
        if a.func == "count" and a.arg is None:
            specs.append("count_star")
            afns.append(None)
        else:
            if a.func in ("min", "max") and a.arg.type.is_text:
                raise DagUnsupported(f"{a.func}() over TEXT")
            specs.append(a.func)
            afns.append(comp.compile(a.arg))
    return specs, afns


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


class DagRunner:
    """Compiles and runs an eligible DistributedPlan on the FusedExecutor's
    device. One instance per FusedExecutor."""

    def __init__(self, fx):
        self.fx = fx
        self._programs: dict = {}
        self._orientations: dict = {}  # skey -> tuple of 'R'/'L'
        self._fold_off: dict = {}  # skey -> {join idx}: dense fold failed
        # skey -> {join idx}: radix table failed at run time (bucket
        # overflow or duplicate build keys): sort-merge answers instead
        self._radix_off: dict = {}
        self.last_mode = None  # final-fragment mode of the last run
        self.last_folded = frozenset()  # joins dense-folded in last run
        # join formulations the last run compiled ('fold'/'radix'/'merge')
        self.last_join_modes: tuple = ()
        self._mode_notes: set = set()

    def run(self, dplan, snapshot_ts) -> tuple[int, ColumnBatch]:
        """Execute the whole fragment DAG on the device: (final fragment
        index, gathered batch). Raises NotPorted outside the subset."""
        self._mode_notes = set()
        frags = dplan.fragments
        if not frags:
            raise DagUnsupported("no fragments")
        final = frags[-1]
        if final.motion != "gather":
            raise DagUnsupported("final motion")
        # Sort/Limit/Distinct inside the final fragment are pushdowns the
        # coordinator re-applies above the gather
        final_root = final.root
        while isinstance(final_root, (L.Sort, L.Limit, L.Distinct)):
            final_root = final_root.child
        for f in frags[:-1]:
            if f.motion == "broadcast":
                continue
            if f.motion != "redistribute" or not f.hash_positions:
                raise DagUnsupported(f.motion)
        snap = snapshot_ts if snapshot_ts is not None else 2**61
        versions = self._data_versions(frags)
        if len(frags) > 1:
            # one device: every exchange is an identity, so the producer
            # fragments inline and the DAG runs as ONE program
            final_root = _inline_sources(
                final_root, {f.index: f.root for f in frags[:-1]}
            )
        batch = self._run_final(final_root, snap, versions)
        self.last_join_modes = tuple(sorted(self._mode_notes))
        return final.index, batch

    def _data_versions(self, frags) -> tuple:
        """(table, node, version) for every scanned store."""
        out = []
        for f in frags:
            root = f.root
            while isinstance(
                root, (L.Sort, L.Limit, L.Distinct, L.Aggregate)
            ):
                root = root.child
            for leaf in _walk_leaves(root):
                if isinstance(leaf, L.Scan):
                    meta = self.fx.catalog.get(leaf.table)
                    for n in _scan_nodes(meta):
                        store = self.fx.node_stores.get(n, {}).get(
                            leaf.table
                        )
                        if store is None:
                            raise DagUnsupported("missing store")
                        out.append((leaf.table, n, store.version))
        return tuple(out)

    def _est_rows(self, node) -> int:
        """Rough output-width estimate for orientation seeding and the
        mode gates: the largest leaf's live row count under ``node`` (an
        inlined tree: every leaf is a scan)."""
        if isinstance(node, L.Scan):
            meta = self.fx.catalog.get(node.table)
            return sum(
                st.nrows
                for n in _scan_nodes(meta)
                if (st := self.fx.node_stores.get(n, {}).get(node.table))
                is not None
            )
        kids = node.children() if isinstance(node, L.LogicalPlan) else ()
        return max((self._est_rows(c) for c in kids), default=0)

    def _orientation_for(self, skey, root):
        njoins = _count_inner_joins(root)
        o = self._orientations.get(skey, ())
        if len(o) == njoins:
            return o
        # seed build sides from estimated leaf widths: the smaller input
        # is the likelier unique side, and a wrong guess costs one flip
        seeded: list = []

        def walk(n):
            if isinstance(n, L.Join):
                walk(n.left)
                walk(n.right)
                if n.join_type == "inner":
                    le, re = self._est_rows(n.left), self._est_rows(n.right)
                    seeded.append("L" if le <= re else "R")
            elif isinstance(n, (L.Filter, L.Project, L.Aggregate)):
                walk(n.child)

        walk(root)
        return tuple(seeded) if len(seeded) == njoins else ("R",) * njoins

    def _flip(self, orientation, flip_idx):
        if orientation[flip_idx] == "L":
            raise DagUnsupported("duplicate join keys on both sides")
        return tuple(
            "L" if i == flip_idx else o for i, o in enumerate(orientation)
        )

    def _offs(self, skey) -> tuple:
        """(fold_off, radix_off) frozenset pair for ``skey``: threaded
        through every compile and every cache key (a disabled formulation
        must not reuse its old program)."""
        return (
            frozenset(self._fold_off.get(skey, ())),
            frozenset(self._radix_off.get(skey, ())),
        )

    def _on_flag(self, skey, orientation, flip, jinfo):
        """Join ``flip`` raised its data flag. Folded: the build keys are
        not a dense unique range — disable the fold for that join. Radix:
        bucket overflow or duplicate build keys — disable the radix table
        (sort-merge re-derives the exact dup verdict). Sort-merge:
        duplicate build keys — flip the build side (raises when both
        sides were tried)."""
        folded, radixed = jinfo
        for flag_set, off in ((folded, self._fold_off),
                              (radixed, self._radix_off)):
            if flip in flag_set:
                off.setdefault(skey, set()).add(flip)
                while len(off) > 512:
                    off.pop(next(iter(off)))
                return orientation
        return self._flip(orientation, flip)

    def _run_final(self, final_root, snap, versions) -> ColumnBatch:
        root = final_root
        if not isinstance(root, L.Aggregate):
            raise NotPorted("fused DAG rows mode (the final fragment "
                            "ships rows, not partial aggregates)")
        if any(a.distinct for a in root.aggs):
            raise DagUnsupported("distinct agg")
        for a in root.aggs:
            if a.func not in ("sum", "count", "min", "max"):
                raise DagUnsupported(a.func)
        if root.group_exprs:
            raise NotPorted("fused DAG grouped modes (grouped, gsort, "
                            "gagg, gseg, wgagg)")
        agg, root = root, root.child
        # the executed tree (inlined) keys the programs and the retry
        # state; the key holds literal values, as the reference's does
        # for every plan with a join
        skey = final_root.key()
        orientation = self._orientation_for(skey, root)
        arrays = _collect_arrays(self.fx, root)
        sig = _shapes_sig(arrays)
        while True:
            fo = self._offs(skey)
            # versions: the mode gates read row counts at compile time
            fkey = ("final", skey, orientation, sig, fo, versions)
            entry = self._programs.get(fkey)
            if entry is None:
                entry = self._compile_final(agg, root, orientation, fo)
                self._programs[fkey] = entry
                while len(self._programs) > _PROGRAM_CACHE_MAX:
                    self._programs.pop(next(iter(self._programs)))
            prog, comp, mode, jinfo, modes = entry
            self._mode_notes |= modes
            params = tuple(
                resolve_param(s, self.fx.device) for s in comp.params
            )
            out_vals, flags = prog(arrays, params, snap)
            self.last_mode = mode
            self.last_folded = jinfo[0]
            flip = _first_true(flags)
            if flip is not None:
                orientation = self._on_flag(skey, orientation, flip, jinfo)
                continue
            self._orientations[skey] = orientation
            return self._collect_scalar(agg, out_vals)

    def _compile_final(self, agg, root, orientation, fo):
        comp = ExprCompiler(self.fx.device)
        b = _Builder(self.fx, comp, orientation, root, runner=self, offs=fo)
        ev = b.build(root)
        specs, afns = _agg_specs(comp, agg)

        def program(arrays, params, snap):
            env, mask, n, flags = ev(arrays, params, snap)
            vals = [
                None if fn is None else _bcast(fn(env, params), n)
                for fn in afns
            ]
            return scalar_reduce(vals, mask, tuple(specs)), flags

        return program, comp, "scalar", b.jinfo(), frozenset(b.modes)

    def _collect_scalar(self, agg, out_vals) -> ColumnBatch:
        cols: dict[str, Column] = {}
        for oc, (d, v) in zip(agg.schema, out_vals):
            dd = d.reshape(1).cpu().numpy()
            vv = v.reshape(1).cpu().numpy()
            if dd.dtype != oc.type.np_dtype:
                dd = dd.astype(oc.type.np_dtype)
            cols[oc.name] = Column(oc.type, dd, vv, None)
        return ColumnBatch(cols, 1)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _shapes_sig(arrays) -> tuple:
    def leaves(x):
        if isinstance(x, torch.Tensor):
            yield x
        else:
            for y in x:
                yield from leaves(y)

    return tuple(
        tuple((tuple(a.shape), str(a.dtype)) for a in leaves(blk))
        for blk in arrays
    )


def _count_inner_joins(plan) -> int:
    n = 0
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, L.Join):
            if node.join_type == "inner":
                n += 1
            stack.extend([node.left, node.right])
        elif isinstance(node, (L.Filter, L.Project, L.Aggregate)):
            stack.append(node.child)
    return n


def _first_true(flags) -> Optional[int]:
    """Index of the first raised flag (one device copy for all)."""
    if not flags:
        return None
    raised = torch.stack([f.reshape(()) for f in flags]).cpu().tolist()
    for i, f in enumerate(raised):
        if f:
            return i
    return None

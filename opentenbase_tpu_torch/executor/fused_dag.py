"""Fused DAG executor on one GPU: join plans under a scalar or grouped
aggregate, ranked on the device under ORDER BY ... LIMIT (subset of the
reference's opentenbase_tpu/executor/fused_dag.py).

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

The grouped mode compacts the rows that pass, sorts them by their group
keys, packed into one int64 key while the keys' combined range fits (a
run-time flag retries with one sort per key part), and reduces each
group into a group capacity that starts optimistic and regrows once
when a run finds more groups; the capacity that fit is remembered per
plan, data version and literal values. TEXT keys group on their
dictionary codes and decode on the host.

A coordinator plan ``Limit(Sort(...))`` over integer-family sort keys
with k = limit + offset <= 1024 ranks on the device and ships k groups
(``_detect_topk``; one device, so every group is whole). The mode, per
orientation: gagg (one sort of the packed group key, aggregates by prefix
differences and segmented scans, ranking at run ends) where the top join
folds or there is none; gsort (one co-sort of build and probe keys,
ranking at the build rows) for grouping by the unique build key of the
top join; otherwise the grouped mode ranks its groups (grouped_topk).
Each ranked run returns an ``ok`` flag, and its failures climb a ladder
remembered per plan: the i32 program retries wide, gagg's cumsum run
base retries with segmented add scans, and a ranking key whose range
passes 2^62 ships every group unranked. Ties at the k-th row go to the
lowest position, as in the reference.

A gagg whose sort operands would pass the window budget
(``OTB_DAG_WINDOW_BUDGET``) runs windowed (wgagg): the dominant scan leaf
streams in shard-row windows through the same tree, each window leaves
its compact per-group partials on the device, and one merge program
regroups, ranks and ships the k rows. A big build side of the top join
is hoisted: evaluated and key-sorted once, then read presorted by every
window.

Ported: the scalar, grouped, gagg, wgagg (with the hoist), gsort and
grouped_topk final modes with their retry loops, inner joins, and the
join-mode notes (``last_join_modes``). Where the reference would
segment-reduce over the build rows (gseg) or ship rows (rows,
rows_topk), and for semi/anti joins and the multi-device exchanges, the
port raises NotPorted.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.executor.fused import _to_host
from opentenbase_tpu_torch.ops import join as join_ops
from opentenbase_tpu_torch.ops import radix_probe as rp
from opentenbase_tpu_torch.ops import agg as agg_ops
from opentenbase_tpu_torch.ops.expr import ExprCompiler, resolve_param_host
from opentenbase_tpu_torch.ops.filter import bucket_size, mask_count
from opentenbase_tpu_torch.plan import batchplan
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan import texpr as E
from opentenbase_tpu_torch.plan.distribute import RemoteSource
from opentenbase_tpu_torch.storage.column import Column
from opentenbase_tpu_torch.storage.table import ColumnBatch

# Dimension fold: an inner join whose build side is this small (and at
# most half the probe) is first tried as a dense direct-index lookup.
DIMFOLD_MAX_BUILD = int(os.environ.get("OTB_DIMFOLD_MAX", 33_554_432))

_JOINABLE_KEY_TYPES = (
    t.TypeId.INT4, t.TypeId.INT8, t.TypeId.BOOL,
    t.TypeId.DECIMAL, t.TypeId.DATE, t.TypeId.TIMESTAMP,
)

_PROGRAM_CACHE_MAX = 64

# First group capacity of a grouped run; a run that finds more groups
# reruns once at the bucketed count, and the count that fit is kept.
OPTIMISTIC_GROUP_CAP = 1 << 16

# A wgagg window's first capacity for its compact partials: a quarter of
# its rows, at least this many; a window with more groups doubles it.
WGAGG_MIN_CAP = 4096

# The sentinels of wgagg's raw int64 sort keys: NULL keys sort just below
# dead rows, and every live key must stay strictly inside (-DEADS, NULLS).
_NULLS = 2**62 - 1
_DEADS = 2**62


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


def _leaf_arrays(fx, node, sources: dict):
    """Device tensors for one leaf, fetched fresh every run so a cached
    program sees current data. A scan: (columns, non-None validities,
    xmin, xmax, nrows). A device-resident source (the hoisted build
    side): (columns [1, cap], validities or None, live counts [1])."""
    if isinstance(node, RemoteSource):
        src = sources.get(node.fragment)
        if src is None:
            raise DagUnsupported("remote source order")
        return (src["cols"], src["valids"], src["counts"])
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


def _collect_arrays(fx, root, sources=None) -> list:
    return [_leaf_arrays(fx, n, sources or {}) for n in _walk_leaves(root)]


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


def _pack_group_keys(keys, mask):
    """Pack integer group keys into ONE int64 sort key from their
    run-time ranges: packed = sum((k_i - min_i) * stride_i), NULLs in a
    bucket past each key's range. Returns (packed, ok): ``ok`` is False
    when the combined range reaches 2^62 (guarded in float64, since the
    int64 range itself can wrap), and the caller then retries with one
    sort per key part."""
    dev = mask.device
    stride = torch.ones((), dtype=torch.int64, device=dev)
    prod = torch.ones((), dtype=torch.float64, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    packed = torch.zeros(mask.shape[0], dtype=torch.int64, device=dev)
    big = 2**62
    for d, v in keys:
        live = mask if v is None else (mask & v)
        d64 = d.to(torch.int64)
        mn = _reduce_or(torch.where(live, d64, big), torch.amin, big)
        mx = _reduce_or(torch.where(live, d64, -big), torch.amax, -big)
        mn = torch.minimum(mn, mx)  # no live rows: a range of 1
        rngf = (mx.to(torch.float64) - mn.to(torch.float64)) + 1.0
        ok = ok & (rngf < 2.0**62)
        rng = torch.clamp(mx - mn + 1, min=1)
        if v is None:
            x, r, rf = d64 - mn, rng, rngf
        else:
            x = torch.where(v, d64 - mn, rng)  # the NULL bucket
            r, rf = rng + 1, rngf + 1.0
        packed = packed + x * stride  # dead rows may wrap: masked anyway
        stride = stride * r
        prod = prod * torch.clamp(rf, min=1.0)
    return packed, ok & (prod < 2.0**62)


def _reduce_or(x, fn, empty):
    """``fn(x)``, or ``empty`` for a tensor with no rows (torch's amin
    and amax refuse an empty input)."""
    if x.numel():
        return fn(x)
    return torch.full((), empty, dtype=x.dtype, device=x.device)


def _group_visible(keys, vals, mask, gcap: int, specs: tuple,
                   use_packed: bool):
    """The grouped aggregate of the rows ``mask`` marks: (out_keys,
    out_vals, group_valid, ngroups, pack_ok or None).

    The visible rows are compacted first (one ``nonzero``, which waits
    for the device), so the sort and the segment reductions cost what
    the rows that pass cost, not the whole flattened plane; invisible
    rows never reach the overflow bin. Groups, their order, ``ngroups``
    and every reduction equal the reference's sort of the whole plane
    with the invisible rows last. With ``use_packed`` the keys pack into
    one int64 and one stable sort groups them; ``pack_ok`` False means
    the packed range overflowed and the result is void."""
    rows = torch.nonzero(mask).reshape(-1)

    def take(pair):
        d, v = pair
        return (d[rows], None if v is None else v[rows])

    keys = [take(k) for k in keys]
    vals = [None if v is None else take(v) for v in vals]
    pack_ok = None
    if use_packed:
        every = torch.ones(rows.shape[0], dtype=torch.bool,
                           device=mask.device)
        packed, pack_ok = _pack_group_keys(keys, every)
        perm, seg, ngroups = agg_ops.group_ids([(packed, None)], None)
    else:
        perm, seg, ngroups = agg_ops.group_ids(keys, None)
    out_keys, out_vals, gvalid = agg_ops.group_reduce(
        keys, vals, perm, seg, gcap, specs)
    return out_keys, out_vals, gvalid, ngroups, pack_ok


def _detect_topk(dplan, final):
    """The reference's top-k pushdown test: the coordinator plan is
    ``Limit(Sort(Project*...(Aggregate?)(RemoteSource(final))))`` with
    bare-column sort keys and k = limit + offset <= 1024. Returns (k,
    ((position, descending, nulls_first), ...), merged) with positions
    into the final fragment's output schema, or None. The port runs no
    top-k mode: its caller raises NotPorted where the reference would
    rank on the device."""
    node = dplan.root
    if not isinstance(node, L.Limit) or node.limit is None:
        return None
    k = node.limit + (node.offset or 0)
    if k <= 0 or k > 1024:
        return None
    node = node.child
    if not isinstance(node, L.Sort) or not node.keys:
        return None
    positions, descs, nfs = [], [], []
    for sk in node.keys:
        if not isinstance(sk.expr, E.Col):
            return None
        positions.append(sk.expr.index)
        descs.append(sk.descending)
        nfs.append(sk.nulls_first)
    node = node.child
    merged = False
    while True:
        if isinstance(node, L.Project):
            newpos = []
            for p in positions:
                ex = node.exprs[p]
                if not isinstance(ex, E.Col):
                    return None
                newpos.append(ex.index)
            positions = newpos
            node = node.child
        elif isinstance(node, L.Aggregate):
            if merged:
                return None
            merged = True
            nk = len(node.group_exprs)
            newpos = []
            for p in positions:
                if p < nk:
                    ex = node.group_exprs[p]
                    if not isinstance(ex, E.Col):
                        return None
                    newpos.append(ex.index)
                else:
                    a = node.aggs[p - nk]
                    if a.arg is None or not isinstance(a.arg, E.Col):
                        return None
                    if a.distinct:
                        return None
                    newpos.append(a.arg.index)
            positions = newpos
            node = node.child
        elif isinstance(node, RemoteSource):
            if node.fragment != final.index:
                return None
            break
        else:
            return None
    return k, tuple(zip(positions, descs, nfs)), merged


# ORDER BY columns the device can rank: integer-family values packed into
# one int64 ranking key (TEXT ranks by collation, not code)
_PACKABLE_SORT_TYPES = _JOINABLE_KEY_TYPES


def _join_side(root, orientation):
    """(top join, build_right) for the outermost join under ``root``
    (Filters stripped; the top join is the last in post-order), or
    None."""
    node = root
    while isinstance(node, L.Filter):
        node = node.child
    if not isinstance(node, L.Join):
        return None
    ji = _count_inner_joins(root) - 1
    return node, (orientation[ji] if ji < len(orientation) else "R") == "R"


def _detect_build_group(agg, root, orientation):
    """Group-by over the unique build side of the top join: every GROUP
    BY expression is a bare column of the build side (or the probe join
    key, equal to the build key on every matched row) and one of them IS
    the join key, so groups are 1:1 with real build rows. Returns
    build_cols, the build-side column backing each group expr, or
    None."""
    top = _join_side(root, orientation)
    if top is None:
        return None
    node, build_right = top
    if node.join_type != "inner":
        return None
    if len(node.left_keys) != 1 or len(node.right_keys) != 1:
        return None
    nl = len(node.left.schema)
    lk, rk = node.left_keys[0], node.right_keys[0]
    if build_right:
        bkey, pkey = rk, lk
        build_lo, build_hi = nl, nl + len(node.right.schema)
        poff = 0
    else:
        bkey, pkey = lk, rk
        build_lo, build_hi = 0, nl
        poff = nl
    if not isinstance(bkey, E.Col):
        return None
    pkey_pos = (poff + pkey.index) if isinstance(pkey, E.Col) else None
    build_cols = []
    has_key = False
    for g in agg.group_exprs:
        if not isinstance(g, E.Col):
            return None
        p = g.index
        if build_lo <= p < build_hi:
            bc = p - build_lo
        elif pkey_pos is not None and p == pkey_pos:
            bc = bkey.index
        else:
            return None
        if bc == bkey.index:
            has_key = True
        build_cols.append(bc)
    if not has_key:
        return None
    return tuple(build_cols)


def _detect_gsort(agg, root, orientation):
    """Eligibility for the co-sort join + group formulation: the
    group-by-unique-build shape with the aggregate directly on the join
    and every aggregate argument over probe columns only (sum/count by
    cumsum differences, min/max by one reverse segmented scan). A join
    residual rides along. Returns a spec dict or None."""
    build_cols = _detect_build_group(agg, root, orientation)
    if build_cols is None or not isinstance(root, L.Join):
        return None
    _join, build_right = _join_side(root, orientation)
    nl = len(root.left.schema)
    plo, phi = (0, nl) if build_right else (nl, nl + len(root.right.schema))
    for a in agg.aggs:
        if a.func == "count" and a.arg is None:
            continue
        if a.func not in ("sum", "count", "min", "max"):
            return None
        if a.func in ("min", "max") and a.arg.type.is_text:
            return None  # code order is not collation order
        if any(not (plo <= c < phi) for c in _expr_cols(a.arg)):
            return None
    bkey = (root.right_keys if build_right else root.left_keys)[0]
    return {
        "join": root,
        "build_right": build_right,
        "build_cols": build_cols,
        "bkey_col": bkey.index,
        "residual": root.residual,
    }


def _detect_gagg(agg):
    """Eligibility for the sort-based grouped aggregate + top-k with no
    build-side requirement (the ClickBench shape): integer-family or
    TEXT-code group keys, and no min/max over TEXT."""
    if not agg.group_exprs:
        return None
    for a in agg.aggs:
        if a.func in ("min", "max") and (
            a.arg is not None and a.arg.type.is_text
        ):
            return None
        if a.func not in ("count", "sum", "min", "max"):
            return None
    for g in agg.group_exprs:
        if not (g.type.id in _JOINABLE_KEY_TYPES or g.type.is_text):
            return None
    return True


def _fd_map(root, orientation):
    """Functional dependencies between output columns, in root.schema
    positions: {determined: determining}. Every verified-unique inner
    join makes its build-side columns functions of the probe key (a run
    that returns with no flag raised proved its keys unique), so grouped
    aggregation may pack a determinant subset of the GROUP BY keys."""
    counter = [0]

    # mirrors _Builder.build: both children of every join, this join's
    # index post-order
    def walk(node):
        if isinstance(node, (L.Scan, RemoteSource)):
            return {}
        if isinstance(node, L.Filter):
            return walk(node.child)
        if isinstance(node, L.Project):
            cfd = walk(node.child)
            pos_of = {}
            for o, ex in enumerate(node.exprs):
                if isinstance(ex, E.Col) and ex.index not in pos_of:
                    pos_of[ex.index] = o
            out = {}
            for o, ex in enumerate(node.exprs):
                if not isinstance(ex, E.Col):
                    continue
                q = cfd.get(ex.index)
                if q is not None and q in pos_of and pos_of[q] != o:
                    out[o] = pos_of[q]
            return out
        if isinstance(node, L.Join):
            if node.join_type in ("semi", "anti"):
                lfd = walk(node.left)
                walk(node.right)  # index alignment only
                return lfd
            lfd = walk(node.left)
            rfd = walk(node.right)
            nl = len(node.left.schema)
            out = dict(lfd)
            out.update({k + nl: v + nl for k, v in rfd.items()})
            if node.join_type != "inner":
                return out
            ji = counter[0]
            counter[0] += 1
            build_right = (
                orientation[ji] if ji < len(orientation) else "R"
            ) == "R"
            if len(node.left_keys) != 1:
                return out
            pkey = node.left_keys[0] if build_right else node.right_keys[0]
            if not isinstance(pkey, E.Col):
                return out
            pkpos = pkey.index + (0 if build_right else nl)
            lo, hi = (
                (nl, nl + len(node.right.schema)) if build_right else (0, nl)
            )
            for p in range(lo, hi):
                if p != pkpos:
                    out[p] = pkpos
            return out
        return {}

    return walk(root)


def _fd_reduce(root, orientation, agg):
    """(kept, dropped) group-expr indices after removing the keys
    functionally determined (transitively) by another present key."""
    fd = _fd_map(root, orientation)
    nkeys = len(agg.group_exprs)
    colpos = {
        i: g.index
        for i, g in enumerate(agg.group_exprs)
        if isinstance(g, E.Col)
    }
    present = {p: i for i, p in colpos.items()}
    drop: set = set()
    changed = True
    while changed:
        changed = False
        for i, p in colpos.items():
            if i in drop:
                continue
            q = fd.get(p)
            seen = set()
            while q is not None and q not in present and q not in seen:
                seen.add(q)
                q = fd.get(q)
            if (
                q is not None and q in present
                and present[q] != i and present[q] not in drop
            ):
                drop.add(i)
                changed = True
    return [i for i in range(nkeys) if i not in drop], sorted(drop)


def _top_join(root):
    """The outermost join under ``root``, peeling Filters AND Projects,
    or None."""
    node = root
    while isinstance(node, (L.Filter, L.Project)):
        node = node.child
    return node if isinstance(node, L.Join) else None


def _runs(start):
    """(run id, first row, last row) of every position, for the runs
    that begin where ``start`` is set (``start[0]`` is). The run heads
    come from one ``nonzero`` (a host sync): torch's cummax and cummin,
    the reference's carries, scan a 1-D tensor as one row on the card."""
    n = start.shape[0]
    heads = torch.nonzero(start).reshape(-1)
    tails = torch.cat([heads[1:], heads.new_full((1,), n)]) - 1
    rid = torch.cumsum(start, 0) - 1
    return rid, heads[rid], tails[rid]


def _seg_scan(x, runs, op: str):
    """The reference's segmented scan, in the forms its callers read,
    over ``runs`` (``_runs``). 'add' and 'first' (the run's first value)
    give the forward prefix at every position, as the reference's scan
    does. 'min' and 'max' give each run's full reduction at every
    position: the reference's forward prefix at run ends and its reverse
    suffix at run starts, the only positions the grouped top-k programs
    read."""
    rid, head, _tail = runs
    if op == "first":
        return x[head]
    if op == "add":
        cs = torch.cumsum(x, 0, dtype=x.dtype)
        return cs - (cs - x)[head]
    if op in ("min", "max"):
        out = x.clone()
        out.scatter_reduce_(0, rid, x, "amin" if op == "min" else "amax",
                            include_self=False)
        return out[rid]
    raise ValueError(f"segmented scan {op!r}")


def _rank_encode(d64, v, desc, nf, live, bound=2**62):
    """Monotone slot encoding of ONE ORDER BY column over run-time
    min/max ranges: (x, r, rf, okbit) with x the ascending slot in [0,
    r), r its int64 range, rf the float64 range for overflow products,
    okbit False when the value spread itself reaches ``bound``. NULLs
    land at PG's default end (DESC first, ASC last) unless ``nf`` says
    otherwise. Dead rows get bounded garbage; callers mask them."""
    big = 2**62
    nulls_first = desc if nf is None else nf
    lv = live if v is None else (live & v)
    mn = _reduce_or(torch.where(lv, d64, big), torch.amin, big)
    mx = _reduce_or(torch.where(lv, d64, -big), torch.amax, -big)
    mn = torch.minimum(mn, mx)  # no live rows: a range of 1
    rngf = (mx.to(torch.float64) - mn.to(torch.float64)) + 1.0
    okbit = rngf < float(bound)
    rng = torch.clamp(mx - mn + 1, min=1)
    base = (mx - d64) if desc else (d64 - mn)
    base = torch.minimum(torch.clamp(base, min=0), rng - 1)
    if v is None:
        return base, rng, rngf, okbit
    if nulls_first:
        x = torch.where(v, base + 1, 0)
    else:
        x = torch.where(v, base, rng)
    return x, rng + 1, rngf + 1.0, okbit


def _pack_sort_cols(cols, sspecs, live):
    """Pack ORDER BY columns into ONE ascending int64 ranking key from
    their run-time ranges, the first key most significant. Returns
    (packed, ok): ``ok`` is False when the product of the ranges reaches
    2^62, and the caller then ships unranked rows."""
    dev = live.device
    stride = torch.ones((), dtype=torch.int64, device=dev)
    prod = torch.ones((), dtype=torch.float64, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    packed = torch.zeros(live.shape[0], dtype=torch.int64, device=dev)
    for (d, v), (_pos, desc, nf) in reversed(list(zip(cols, sspecs))):
        x, r, rf, okbit = _rank_encode(d.to(torch.int64), v, desc, nf, live)
        ok = ok & okbit
        packed = packed + x * stride
        stride = stride * r
        prod = prod * torch.clamp(rf, min=1.0)
    return packed, ok & (prod < 2.0**62)


def _topk_idx(packed, live, k: int):
    """Indices and validity of the k smallest packed keys among live
    rows, in (key, index) order: ties go to the LOWEST index, as the
    reference's chunked arg-min picks the first chunk and then the first
    lane. (idx int64 [k], valid bool [k]); ``valid`` is False past the
    live rows, whose indices are then any rows (callers mask them).

    Exact without a full sort: the k-th smallest key is the threshold,
    every key below it is taken, and the lowest-index keys equal to it
    fill the rest; the taken rows land in index order through a prefix
    count, then one stable sort of k keys orders them."""
    big = 2**62
    key = torch.where(live, packed, big)
    n = key.shape[0]
    dev = key.device
    kk = min(k, n)
    if kk == 0:
        return (torch.zeros(k, dtype=torch.int64, device=dev),
                torch.zeros(k, dtype=torch.bool, device=dev))
    thr = torch.topk(key, kk, largest=False, sorted=True).values[kk - 1]
    below = key < thr
    eq = key == thr
    need = kk - torch.sum(below, dtype=torch.int64)
    taken = below | (eq & (torch.cumsum(eq, 0) <= need))
    slot = torch.where(taken, torch.cumsum(taken, 0) - 1, kk)
    buf = torch.zeros(kk + 1, dtype=torch.int64, device=dev)
    # one writer per slot below kk; the spare slot kk takes the rest
    buf.scatter_(0, slot, torch.arange(n, device=dev))
    idx = buf[:kk]
    idx = idx[torch.argsort(key[idx], stable=True)]
    valid = key[idx] < big
    if kk < k:  # fewer rows than k: pad with invalid lanes
        idx = torch.cat([idx, torch.full((k - kk,), n - 1,
                                         dtype=torch.int64, device=dev)])
        valid = torch.cat([valid, torch.zeros(k - kk, dtype=torch.bool,
                                              device=dev)])
    return idx, valid


def _dids(schema) -> list:
    return [c.dict_id for c in schema]


def _chain_leaf(node, folded_ids=None, est=None):
    """Peel a build subtree down to the ONE leaf whose rows it preserves:
    Filters keep rows; an inner join that folds keeps its probe side's
    rows. Returns (leaf, leaf_positions): the positions of
    ``node.schema`` backed directly by leaf columns (a fold key must be
    leaf-backed, since folded-in columns hold garbage on unmatched
    rows). None when the chain breaks.

    ``folded_ids`` (id -> build_right): the joins the builder folded,
    known post-order. ``est``: the row estimate the runner's mode choice
    uses before any builder exists — it assumes a small-side join folds,
    which risks only a slower mode, never a wrong answer."""
    offset = 0
    width = len(node.schema)
    while True:
        if isinstance(node, L.Filter):
            node = node.child
            continue
        if isinstance(node, L.Join) and node.join_type == "inner":
            nl = len(node.left.schema)
            if folded_ids is not None:
                if id(node) not in folded_ids:
                    return None
                build_right = folded_ids[id(node)]
            elif est is not None:
                le, re = est(node.left), est(node.right)
                build_right = le > re
                bn_est = min(le, re)
                if not (0 < bn_est <= DIMFOLD_MAX_BUILD
                        and bn_est * 2 <= max(le, re)):
                    return None
            else:
                return None
            if build_right:  # built right: the left side stays
                node = node.left
                width = nl
            else:
                node = node.right
                offset += nl
                width = len(node.schema)
            continue
        if isinstance(node, (L.Scan, RemoteSource)):
            return node, range(offset, offset + width)
        return None


def _fold_gate(runner, node: L.Join, ji: int, build_right: bool,
               fold_off, folded_ids=None) -> bool:
    """THE dimension-fold gate, shared by the builder (``folded_ids``
    given) and the runner's mode choice (row estimates). Static checks
    only; density and uniqueness are verified at run time by the fold
    flag. Requires a build subtree that preserves ONE leaf's rows, with
    the join key backed by that leaf, and a build side small in absolute
    terms AND against the probe."""
    if ji in fold_off:
        return False
    bnode = node.right if build_right else node.left
    pnode = node.left if build_right else node.right
    chain = _chain_leaf(
        bnode, folded_ids,
        est=runner._est_rows if folded_ids is None else None,
    )
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


def _lookup_dense(pk, pmask, bk, bvis, bfull, presorted=False):
    """Equi-join for a small dense-keyed build side: sort the build rows
    by key, then verify the VISIBLE keys form a gap-free unique range
    [base, base + cnt) (sorted position i holds key base + i). When they
    do, the sorted rows are a perfect-hash table: slot = key - base.
    ``presorted``: a fold-prep program already key-sorted the rows; the
    position check still verifies it (a row out of place or dead breaks
    sk[i] == base + i).

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
    bkey = torch.where(breal, bd.to(torch.int64), 2**62)
    if presorted:  # position i is row i
        sk, sidx = bkey, None
    else:
        sk, sidx = torch.sort(bkey)
    cnt = mask_count(breal)
    iota = torch.arange(nb, dtype=torch.int64, device=dev)
    base = sk[0]
    dense = torch.all((iota >= cnt) | (sk == base + iota))
    slot = pd.to(torch.int64) - base
    inr = (slot >= 0) & (slot < cnt)
    slot = slot.clamp(0, nb - 1)
    bidx = (slot if sidx is None else sidx[slot]).to(torch.int32)
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
                 runner, offs=(frozenset(), frozenset()), window=None,
                 sources=None):
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
        # (leaf id, W): that scan leaf reads only the shard rows
        # [wstart, wstart + W) a run, wstart appended to its block tuple
        self.window = window
        # device-resident sources by fragment (the hoisted build side)
        self.sources = sources or {}

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
        win = (self.window[1] if self.window is not None
               and self.window[0] == id(node) else None)

        def run(blocks, params, snap):
            # visibility planes are [k, Rmax] or compact [k, 1]: the 2-D
            # compares broadcast either form
            if win is None:
                cols, valids, xmin, xmax, nrows = blocks[idx]
                rows = torch.arange(rmax, device=nrows.device)
            else:
                # the window's views: wstart + W never passes rmax (the
                # width divides it)
                cols, valids, xmin, xmax, nrows, wstart = blocks[idx]
                cut = slice(wstart, wstart + win)
                cols = [c[:, cut] for c in cols]
                valids = [v[:, cut] for v in valids]
                if xmin.shape[1] != 1:
                    xmin, xmax = xmin[:, cut], xmax[:, cut]
                rows = wstart + torch.arange(win, device=nrows.device)
            k = xmin.shape[0]
            n = k * rows.shape[0]
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

    def _leaf_source(self, node: RemoteSource) -> Callable:
        """A device-resident source: [1, cap] columns whose first
        ``counts`` rows are live."""
        if node.fragment not in self.sources:
            raise DagUnsupported("remote source order")
        idx = self.leaf_index[id(node)]

        def run(blocks, params, snap):
            cols, valids, counts = blocks[idx]
            dsrc, cap = cols[0].shape
            n = dsrc * cap
            live = (torch.arange(cap, device=counts.device)[None, :]
                    < counts[:, None]).reshape(n)
            env = [(d.reshape(n), None if v is None else v.reshape(n))
                   for d, v in zip(cols, valids)]
            return env, live, n, []

        return run

    def build(self, node: L.LogicalPlan) -> Callable:
        if isinstance(node, L.Filter):
            child = self.build(node.child)
            pred = self.comp.compile(node.predicate, _dids(node.child.schema))

            def run(blocks, params, snap):
                env, mask, n, flags = child(blocks, params, snap)
                d, v = pred(env, params)
                keep = d if v is None else (d & v)
                return env, mask & keep, n, flags

            return run

        if isinstance(node, L.Project):
            child = self.build(node.child)
            dids = _dids(node.child.schema)
            fns = [
                self.comp.compile(
                    ex, dids,
                    (oc.dict_id or None) if ex.type.is_text else None,
                )
                for ex, oc in zip(node.exprs, node.schema)
            ]

            def run(blocks, params, snap):
                env, mask, n, flags = child(blocks, params, snap)
                out = [_bcast(fn(env, params), n) for fn in fns]
                return out, mask, n, flags

            return run

        if isinstance(node, L.Scan):
            return self._leaf_scan(node)

        if isinstance(node, RemoteSource):
            return self._leaf_source(node)

        if isinstance(node, L.Join):
            return self._build_join(node)

        raise DagUnsupported(type(node).__name__)

    def _build_join(self, node: L.Join) -> Callable:
        if node.join_type in ("semi", "anti"):
            raise NotPorted(f"fused DAG {node.join_type} join")
        if node.join_type != "inner":
            raise DagUnsupported(f"{node.join_type} join")
        if len(node.left_keys) != 1 or len(node.right_keys) != 1:
            raise DagUnsupported("multi-key join")
        for k in (node.left_keys[0], node.right_keys[0]):
            if k.type.id not in _JOINABLE_KEY_TYPES:
                raise DagUnsupported(f"join key type {k.type.id}")
        left = self.build(node.left)
        right = self.build(node.right)
        lkfn = self.comp.compile(node.left_keys[0], _dids(node.left.schema))
        rkfn = self.comp.compile(node.right_keys[0],
                                 _dids(node.right.schema))
        resfn = (
            None if node.residual is None
            else self.comp.compile(node.residual, _dids(node.schema))
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
        presorted = False
        if fold:
            self.folded.add(ji)
            self.folded_ids[id(node)] = build_right
            # the chain leaf supplies the density domain (visibility
            # only); the full build closure's mask becomes slot validity
            bnode = node.right if build_right else node.left
            leaf, _lp = _chain_leaf(bnode, self.folded_ids)
            bstrip_fn = self.build(leaf)
            presorted = isinstance(leaf, RemoteSource) and bool(
                self.sources.get(leaf.fragment, {}).get("presorted"))
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
                    pk, pmask, bk, bvis, bmask, presorted
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


def _agg_specs(comp, agg, dids):
    """(specs, compiled args) for an Aggregate's functions."""
    specs: list[str] = []
    afns: list = []
    for a in agg.aggs:
        if a.func == "count" and a.arg is None:
            specs.append("count_star")
            afns.append(None)
        else:
            if a.func in ("min", "max") and a.arg.type.is_text:
                # code order is not collation order: the reference's
                # host executor answers these
                raise DagUnsupported(f"{a.func}() over TEXT")
            specs.append(a.func)
            afns.append(comp.compile(a.arg, dids))
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
        # skey -> False once the packed group key overflowed: per-part
        # sorting from then on
        self._packing: dict = {}
        self._caps: dict = {}  # gcapkey -> group capacity that fit
        # the top-k retry ladder, each entry remembered so a repeat
        # starts where the last run ended: skey -> True once the i32
        # operands of gagg/gsort overflowed (wide from then on); skey ->
        # True once negative sums broke gagg's cumsum run base (segmented
        # add scans); (skey, top-k spec, data versions) -> True once the
        # ranking key's range overflowed (ship every group, unranked)
        self._narrow_off: dict = {}
        self._robust_on: dict = {}
        self._topk_off: dict = {}
        self.last_mode = None  # final-fragment mode of the last run
        self.last_folded = frozenset()  # joins dense-folded in last run
        # join formulations the last run compiled ('fold'/'radix'/'merge')
        self.last_join_modes: tuple = ()
        self._mode_notes: set = set()
        # the last wgagg run: (windows, window width, final capacity),
        # whether its build side was hoisted, and the reruns each kind of
        # flag caused ('flag': a join's, 'cap': a window's capacity,
        # 'robust': the cumsum run base's)
        self.last_windows: Optional[tuple] = None
        self.last_hoisted = False
        self.last_retries: dict = {}
        # sources that stand for a subtree (the hoisted build side):
        # fragment -> the subtree, for row estimates
        self._producers: dict = {}

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
        probe_root = final_root
        if isinstance(probe_root, L.Project):
            probe_root = probe_root.child
        if len(frags) == 1 and not (
            isinstance(probe_root, L.Aggregate)
            or _contains_join(final_root)
        ):
            # a bare scan chain: the reference's host executor answers it
            raise DagUnsupported("trivial scan")
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
        batch = self._run_final(final_root, snap, versions,
                                _detect_topk(dplan, final))
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
        if isinstance(node, RemoteSource):
            pr = self._producers.get(node.fragment)
            return self._est_rows(pr) if pr is not None else 0
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

    def _remember(self, store: dict, key, value=True) -> None:
        """Record one retry outcome or group capacity in a bounded dict:
        keys of superseded plans and data versions would otherwise
        accumulate."""
        store[key] = value
        while len(store) > 512:
            store.pop(next(iter(store)))

    def _top_join_foldable(self, root, orientation, skey) -> bool:
        """``_fold_gate`` applied to the TOP join before any builder
        exists: where it holds, gagg over the folded tree is chosen over
        the gsort co-sort."""
        join = _top_join(root)
        if join is None or join.join_type != "inner":
            return False
        ji = _count_inner_joins(root) - 1
        build_right = (
            orientation[ji] if ji < len(orientation) else "R"
        ) == "R"
        return _fold_gate(self, join, ji, build_right,
                          self._fold_off.get(skey, ()))

    def _wgagg_leaf(self, root, agg):
        """(leaf, width, rmax) when the gagg program's sort operands
        would pass the window budget, so the dominant scan leaf streams
        in shard-row windows (wgagg); None when it all fits. ``rmax`` is
        the cache's actual capacity (an external table's is exact, not
        bucket-padded), and the width halves it evenly."""
        budget = batchplan.resolve_budget(
            0, "OTB_DAG_WINDOW_BUDGET", batchplan.DEFAULT_WINDOW_BUDGET)
        leaves = [lf for lf in _walk_leaves(root) if isinstance(lf, L.Scan)]
        if not leaves:
            return None
        big = max(leaves, key=self._est_rows)
        rows = self._est_rows(big)
        # sort operands per probe row: key + per-aggregate value and
        # validity + carried keys + row id, tripled for the sorted copies
        # and the prefix scans
        per_row = 8 + len(agg.aggs) * 9 + 8 + 4
        if rows * per_row * 3 <= budget:
            return None
        meta = self.fx.catalog.get(big.table)
        nodes = _scan_nodes(meta)
        dtab = self.fx.cache.get(big.table, meta, self.fx.node_stores,
                                 nodes, columns=big.columns)
        width = batchplan.probe_window_width(
            dtab.rmax, per_row * 3, len(nodes), budget)
        if width >= dtab.rmax:
            return None
        return big, width, dtab.rmax

    def _topk_spec(self, tk, agg, root, out_proj, skey, versions):
        """The reference's packable-key test for a detected top-k: every
        ORDER BY column of the shipped schema must be integer-family (not
        TEXT), and a coordinator that re-aggregates needs partial
        aggregates to rank. Positions move through an absorbed
        projection into the aggregate's schema. (Whether every group is
        whole on one device matters only on a mesh of several; here it
        always is.) None where ranking is off, or remembered off after
        the ranking key's range overflowed on these data versions."""
        if tk is None:
            return None
        schema = (out_proj[1] if out_proj is not None
                  else (agg.schema if agg is not None else root.schema))
        kk, sspecs, merged = tk
        if any(schema[p].type.id not in _PACKABLE_SORT_TYPES
               or schema[p].type.is_text for p, _d, _nf in sspecs):
            return None
        if merged and agg is None:
            return None  # the coordinator's re-aggregation needs partials
        if out_proj is not None:
            perm = out_proj[0]
            tk = (kk, tuple((perm[p], d, nf) for p, d, nf in sspecs), merged)
        if self._topk_off.get((skey, tk, versions)):
            return None
        return tk

    def _run_final(self, final_root, snap, versions, tk) -> ColumnBatch:
        root = final_root
        # a plan whose grouping subsumes the shard key ships a
        # bare-column projection over the (complete) aggregate and skips
        # the coordinator merge: absorb it, re-apply it at collect time
        out_proj = None
        if (
            isinstance(root, L.Project)
            and isinstance(root.child, L.Aggregate)
            and root.child.group_exprs
            and all(isinstance(e, E.Col) for e in root.exprs)
            and len({c.name for c in root.schema}) == len(root.schema)
        ):
            out_proj = (tuple(e.index for e in root.exprs), root.schema)
            root = root.child
        agg = None
        if isinstance(root, L.Aggregate):
            if any(a.distinct for a in root.aggs):
                raise DagUnsupported("distinct agg")
            for a in root.aggs:
                if a.func not in ("sum", "count", "min", "max"):
                    raise DagUnsupported(a.func)
            agg, root = root, root.child
        # the executed tree (inlined) keys the programs and the retry
        # state; the key holds literal values, as the reference's does
        # for every plan with a join
        skey = final_root.key()
        tk = self._topk_spec(tk, agg, root, out_proj, skey, versions)
        if agg is None:
            if tk is not None:
                raise NotPorted("fused DAG rows_topk mode (ORDER BY ... "
                                "LIMIT over join rows, ranked on the device)")
            raise NotPorted("fused DAG rows mode (the final fragment "
                            "ships rows, not partial aggregates)")
        orientation = self._orientation_for(skey, root)
        arrays = _collect_arrays(self.fx, root)
        sig = _shapes_sig(arrays)
        n_dup = _count_inner_joins(root)
        grouped = bool(agg.group_exprs)
        # the packed single-sort key until its range overflows; the
        # outcome is remembered, so a repeat never reruns a doomed pack
        packing = self._packing.get(skey, True)
        gcap = OPTIMISTIC_GROUP_CAP
        gcapkey = None
        while True:
            # mode choice per orientation (one device, so groups are
            # complete): gagg over a folded top join > gsort (co-sort
            # with the unique build side) > gagg > gseg > the grouped
            # mode, ranked (grouped_topk) while a top-k applies
            gs = ga = None
            if tk is not None:
                ga_ok = _detect_gagg(agg)
                if ga_ok and self._top_join_foldable(root, orientation,
                                                     skey):
                    ga = ga_ok
                else:
                    gs = _detect_gsort(agg, root, orientation)
                    if gs is None:
                        ga = ga_ok
            if ga is not None:
                # bigger than the window budget: the dominant scan leaf
                # streams through the same program in windows
                wplan = self._wgagg_leaf(root, agg)
                if wplan is not None:
                    return self._run_wgagg(wplan, agg, root, tk, skey,
                                           orientation, sig, versions,
                                           snap, out_proj)
            bg = None
            if tk is not None and gs is None and ga is None:
                bg = _detect_build_group(agg, root, orientation)
            if bg is not None:
                raise NotPorted(
                    "fused DAG gseg mode (grouped by the unique build key "
                    "of the top join, ranked on the device)")
            narrow = (gs is not None or ga is not None) and not \
                self._narrow_off.get(skey)
            robust = bool(self._robust_on.get(skey))
            fo = self._offs(skey)
            # versions: the mode gates read row counts at compile time
            fkey = ("final", skey, orientation, sig, fo, versions,
                    gcap if grouped else None, packing, tk,
                    gs is not None, ga is not None, narrow, robust)
            prog, comp, mode, jinfo, modes = self._cached(
                fkey, lambda: self._compile_final(
                    agg, root, orientation, fo, gcap, packing, tk, gs,
                    ga is not None, narrow, robust))
            self._mode_notes |= modes
            host_params, params = self._bind(comp)
            if grouped and gcapkey is None:
                # the capacity that fit is data-dependent: keyed by data
                # versions and the literal values
                gcapkey = ("gcap", skey, orientation, sig, versions,
                           _params_sig(host_params))
                known = self._caps.get(gcapkey)
                if known is not None and known != gcap:
                    gcap = known
                    continue  # compile or look up at that capacity
            outs, flags = prog(arrays, params, snap)
            self.last_mode = mode
            self.last_folded = jinfo[0]
            flip = _first_true(flags)
            if flip is not None:
                if flip >= n_dup:
                    # the packed key's range overflowed int64: retry with
                    # one sort per key part (the answer never depended
                    # on the packing)
                    packing = False
                    self._remember(self._packing, skey, False)
                    continue
                orientation = self._on_flag(skey, orientation, flip, jinfo)
                gcapkey = None  # keyed per orientation
                continue
            if mode != "grouped" and mode != "scalar" and not bool(outs[-1]):
                # the ladder: i32 operands overflowed -> the wide program;
                # negative sums broke gagg's run base -> segmented add
                # scans; the ranking key's range overflowed -> ship every
                # group unranked (correct, a bigger transfer)
                if mode != "grouped_topk" and narrow:
                    self._remember(self._narrow_off, skey)
                elif mode == "gagg" and not robust:
                    self._remember(self._robust_on, skey)
                else:
                    self._remember(self._topk_off, (skey, tk, versions))
                    tk = None
                continue
            self._orientations[skey] = orientation
            if mode in ("gagg", "gsort"):
                out_keys, out_vals, sel, _ok = outs
                return self._apply_proj(
                    self._collect_grouped(agg, out_keys, out_vals, sel)[0],
                    out_proj)
            if not grouped:
                return self._collect_scalar(agg, outs)
            out_keys, out_vals, gvalid, ngroups = outs[:4]
            actual = int(ngroups)
            if actual >= gcap:
                gcap = bucket_size(actual + 1)
                continue
            self._remember(self._caps, gcapkey, gcap)
            return self._apply_proj(
                self._collect_grouped(agg, out_keys, out_vals, gvalid)[0],
                out_proj,
            )

    def _bind(self, comp) -> tuple:
        """(host values, device tensors) of a compiler's literal params,
        resolved for this run (TEXT constants' codes move as dictionaries
        grow)."""
        host = [resolve_param_host(s, self.fx.catalog.dictionary)
                for s in comp.params]
        return host, tuple(torch.from_numpy(p).to(self.fx.device)
                           for p in host)

    def _cached(self, key, compile_fn):
        """The program cache: ``compile_fn()`` on a miss, the oldest
        entry evicted past the cache's size."""
        entry = self._programs.get(key)
        if entry is None:
            entry = compile_fn()
            self._programs[key] = entry
            while len(self._programs) > _PROGRAM_CACHE_MAX:
                self._programs.pop(next(iter(self._programs)))
        return entry

    # -- wgagg: the windowed gagg, with its hoisted build side -------------
    PREP_FRAG = -7  # the hoisted build side's source
    HOIST_MIN_ROWS = 4_000_000  # smaller build sides re-sort per window

    def _run_wgagg(self, wplan, agg, root, tk, skey, orientation, sig,
                   versions, snap, out_proj) -> ColumnBatch:
        """Windowed gagg: the dominant scan leaf streams in shard-row
        windows through the same folded, filtered tree; each window
        leaves its compact per-group partials on the device, and one
        merge program regroups them, ranks, and ships the LIMIT rows in
        one transfer. Build sides stay resident (a big one is hoisted:
        evaluated and key-sorted once, ``_maybe_hoist``), so the
        reference's multi-batch hash join becomes: the same program over
        a sliding window, one sort of the partials at the end.

        Every rerun runs every window: a join flag raised in any window
        (orientation or fold off), a window whose groups pass the
        capacity (doubled, up to the width), a cumsum run base broken by
        negative sums (robust mode, then the ranking is given up)."""
        leaf, width, rmax = wplan
        nwin = rmax // width
        cap = max(width // 4, WGAGG_MIN_CAP)
        wcapkey = ("wcap", skey, orientation, sig, versions)
        cap = self._caps.get(wcapkey, cap)
        retries = {"flag": 0, "cap": 0, "robust": 0}
        h = h_key = None
        while True:
            fo = self._offs(skey)
            robust = bool(self._robust_on.get(skey))
            root_c, src_c, ori_c, fo_c, gmap = root, {}, orientation, fo, None
            if h_key != (orientation, fo):
                # the prep survives capacity and robust reruns; a new
                # orientation or fold-off set invalidates it
                h, orientation = self._maybe_hoist(
                    root, orientation, skey, snap, leaf, sig, versions)
                h_key = (orientation, fo)
            if h == "retry":  # a join of the prep raised its flag
                retries["flag"] += 1
                h_key = None
                continue
            if h is not None:
                root_c, src_c, gmap = h
                nj2 = _count_inner_joins(root_c)
                # the prepped source always sits on the right
                ori_c = tuple(
                    orientation[gmap(i)] if gmap(i) < len(orientation)
                    else "R" for i in range(nj2 - 1)) + ("R",)
                fo_c = tuple(frozenset(i for i in range(nj2)
                                       if gmap(i) in s) for s in fo)
            ckey = ("wgagg", skey, orientation, sig, fo, cap, width, robust,
                    h is not None, versions)
            wprog, mprog, comp, jinfo, modes = self._cached(
                ckey, lambda: self._compile_wgagg(
                    agg, root_c, src_c, tk, ori_c, fo_c, leaf, width, cap,
                    robust))
            self._mode_notes |= modes
            _host, params = self._bind(comp)
            arrays = _collect_arrays(self.fx, root_c, src_c)
            lidx = self.leaf_index_of(root_c, leaf)
            wouts = []
            for w in range(nwin):
                arr_w = list(arrays)
                arr_w[lidx] = tuple(arrays[lidx]) + (w * width,)
                # device tensors only: nothing comes back until the merge
                wouts.append(wprog(arr_w, params, snap))
            out_keys, out_vals, sel, novf, ok, flags = mprog(wouts)
            del wouts
            batch, (novf, ok, *flags) = self._collect_grouped(
                agg, out_keys, out_vals, sel, [novf, ok, *flags])
            gjinfo = (jinfo if gmap is None else
                      tuple(frozenset(gmap(x) for x in s) for s in jinfo))
            self.last_mode = "wgagg"
            self.last_folded = gjinfo[0]
            self.last_hoisted = h is not None
            self.last_windows = (nwin, width, cap)
            self.last_retries = retries
            flip = next((i for i, f in enumerate(flags) if f), None)
            if flip is not None:
                retries["flag"] += 1
                orientation = self._on_flag(
                    skey, orientation, flip if gmap is None else gmap(flip),
                    gjinfo)
                continue
            if novf:
                retries["cap"] += 1
                cap *= 2  # a window held more groups than the capacity
                if cap > width:
                    raise DagUnsupported("wgagg partials exceed window")
                self._remember(self._caps, wcapkey, cap)
                continue
            if not ok:
                if not robust:
                    retries["robust"] += 1
                    self._remember(self._robust_on, skey)
                    continue
                self._remember(self._topk_off, (skey, tk, versions))
                raise DagUnsupported("wgagg ranking overflow")
            self._orientations[skey] = orientation
            return self._apply_proj(batch, out_proj)

    def leaf_index_of(self, root, leaf) -> int:
        for i, lf in enumerate(_walk_leaves(root)):
            if lf is leaf:
                return i
        raise DagUnsupported("window leaf not found")

    def _maybe_hoist(self, root, orientation, skey, snap, wleaf, sig,
                     versions):
        """Where the top join's build side holds no windowed leaf and is
        big, evaluate and key-sort it once in a prep program, and rewrite
        the tree so every window reads it as a presorted device-resident
        source behind a ``__match_ok`` filter (otherwise each window would
        re-sort the whole build side; the multi-batch hash join keeps its
        table across batches for the same reason). Returns (hoisted,
        orientation): hoisted is (root2, sources, ori_map), or "retry"
        after a prep join raised its flag (with the orientation that
        flag leaves), or None; ``ori_map`` turns the rewritten tree's
        join indices into the original's."""
        top = _top_join(root)
        if top is None or top.join_type != "inner":
            return None, orientation
        gji = _count_inner_joins(root) - 1
        build_right = (
            orientation[gji] if gji < len(orientation) else "R") == "R"
        if build_right:
            bnode, pnode = top.right, top.left
        else:
            if top.residual is not None:
                return None, orientation  # its positions would need remapping
            bnode, pnode = top.left, top.right
        if any(lf is wleaf for lf in _walk_leaves(bnode)):
            return None, orientation  # the windowed leaf is on the build side
        if not any(lf is wleaf for lf in _walk_leaves(pnode)):
            return None, orientation
        if self._est_rows(bnode) < self.HOIST_MIN_ROWS:
            # a small build side re-sorts cheaply in every window
            return None, orientation
        if not self._top_join_foldable(root, orientation, skey):
            return None, orientation
        p = _count_inner_joins(pnode)
        b = _count_inner_joins(bnode)
        # post-order numbering: the first-built child's joins come first,
        # so the build side's joins are [p, p + b) when it is the right
        # child and [0, b) when it is the left
        boff = p if build_right else 0
        poff = 0 if build_right else b
        ori_local = tuple(orientation[boff:boff + b])
        fo_local = tuple(
            frozenset(x - boff for x in s if boff <= x < boff + b)
            for s in self._offs(skey))
        bkey = (top.right_keys if build_right else top.left_keys)[0]
        prog, comp, jinfo_local, modes = self._cached(
            ("prep", skey, orientation, fo_local, sig, versions),
            lambda: self._compile_fold_prep(bnode, ori_local, fo_local,
                                            bkey))
        self._mode_notes |= modes
        _host, params = self._bind(comp)
        cols, valids, counts, flags = prog(_collect_arrays(self.fx, bnode),
                                           params, snap)
        flip = _first_true(flags)  # tiny; the build rows stay put
        if flip is not None:
            return "retry", self._on_flag(
                skey, orientation, flip + boff,
                tuple(frozenset(x + boff for x in s) for s in jinfo_local))
        schema2 = tuple(bnode.schema) + (L.OutCol("__match_ok", t.BOOL),)
        rs = RemoteSource(fragment=self.PREP_FRAG, schema=schema2)
        filt = L.Filter(
            child=rs,
            predicate=E.Col(len(bnode.schema), t.BOOL, "__match_ok"),
            schema=schema2,
        )
        if build_right:
            repl = dataclasses.replace(top, right=filt)
        else:
            # swap the sides so the prepped source (with its trailing
            # __match_ok) sits on the right, where the extra column
            # shifts no position, and restore the column order above
            nr0 = len(top.right.schema)
            swapped = dataclasses.replace(
                top, left=top.right, right=filt,
                left_keys=top.right_keys, right_keys=top.left_keys,
                schema=tuple(top.right.schema) + schema2,
            )
            repl = L.Project(
                child=swapped,
                exprs=tuple(E.Col(nr0 + i, c.type, c.name)
                            for i, c in enumerate(top.left.schema))
                + tuple(E.Col(i, c.type, c.name)
                        for i, c in enumerate(top.right.schema)),
                schema=top.schema,
            )
        sources = {self.PREP_FRAG: {"cols": cols, "valids": valids,
                                    "counts": counts, "presorted": True}}
        self._producers = {self.PREP_FRAG: bnode}

        def ori_map(local_idx: int) -> int:
            # the rewritten tree's probe joins are [0, p); its top join
            # (local p) is the original's p + b
            return poff + local_idx if local_idx < p else p + b

        return (_replace_node(root, top, repl), sources, ori_map), orientation

    def _compile_fold_prep(self, bnode, ori_local, fo_local, bkey):
        """(program, compiler, jinfo, join modes) of ONE evaluation and
        key sort of a build subtree: its rows sorted by the join key over
        the density domain (the chain leaf's visibility), every schema
        column and its validity riding along, and the build's full mask
        appended as the ``__match_ok`` column. The output is [1, rows]
        columns with their live count, the layout ``_leaf_source`` reads.
        One sort of the key gives the permutation every column gathers
        by (the reference's multi-operand sort)."""
        comp = ExprCompiler(self.fx.device)
        b = _Builder(self.fx, comp, ori_local, bnode, runner=self,
                     offs=fo_local)
        ev = b.build(bnode)
        chain = _chain_leaf(bnode, folded_ids=b.folded_ids)
        if chain is None:
            # a nested build join was disabled at run time: the spine no
            # longer folds
            raise DagUnsupported("prep build side is not a fold chain")
        bstrip = b.build(chain[0])
        bkfn = comp.compile(bkey, _dids(bnode.schema))

        def program(arrays, params, snap):
            env, mask, n, flags = ev(arrays, params, snap)
            _e, vis, _n, _f = bstrip(arrays, params, snap)
            kd, kv = _bcast(bkfn(env, params), n)
            kreal = vis if kv is None else (vis & kv)
            _sk, perm = torch.sort(
                torch.where(kreal, kd.to(torch.int64), _DEADS))
            cols, valids = [], []
            for d, v in env:
                d, v = _bcast((d, v), n)
                cols.append(d[perm].reshape(1, n))
                valids.append(None if v is None else v[perm].reshape(1, n))
            cols.append(mask[perm].reshape(1, n))  # __match_ok
            valids.append(None)
            return cols, valids, mask_count(kreal).reshape(1), flags

        return program, comp, b.jinfo(), frozenset(b.modes)

    def _compile_wgagg(self, agg, root, sources, topk, orientation, fo,
                       leaf, width, cap, robust):
        """(window program, merge program, compiler, jinfo, join modes).
        After FD reduction exactly ONE bare integer group key must remain:
        its raw int64 value is the sort key of both programs, so the
        windows' sorts compare without a global range pass (live keys
        stay strictly inside the NULL and dead-row sentinels, or ``ok``
        clears).

        The window program sorts its rows by key (dead rows last, NULL
        keys just before them), reduces each run — sums and counts by
        prefix differences, min/max by segmented scans — carries the
        FD-dropped keys, and keeps the run ends, at most ``cap`` of them
        (``novf`` flags more). The merge concatenates every window's
        partials, sorts them by key, re-sums sums and counts, takes the
        min of mins and the max of maxes, ranks by the top-k spec and
        keeps k rows."""
        comp = ExprCompiler(self.fx.device)
        b = _Builder(self.fx, comp, orientation, root, runner=self, offs=fo,
                     window=(id(leaf), width), sources=sources)
        ev = b.build(root)
        dids = _dids(root.schema)
        gfns = [comp.compile(g, dids) for g in agg.group_exprs]
        specs, afns = _agg_specs(comp, agg, dids)
        k, sspecs, _merged = topk
        nkeys = len(agg.group_exprs)
        kept, dropped = _fd_reduce(root, orientation, agg)
        if len(kept) != 1 or not isinstance(agg.group_exprs[kept[0]],
                                             E.Col):
            raise DagUnsupported("wgagg needs one bare group key")
        kidx = kept[0]
        if agg.group_exprs[kidx].type.is_text:
            raise DagUnsupported("wgagg text group key")

        def ident(spec, dtype):
            """The min/max identity: dead and NULL values never win."""
            if dtype.is_floating_point:
                return float("inf") if spec == "min" else float("-inf")
            return 2**62 if spec == "min" else -(2**62)

        def window_program(arrays, params, snap):
            env, mask, n, flags = ev(arrays, params, snap)
            kd, kv = _bcast(gfns[kidx](env, params), n)
            k64 = kd.to(torch.int64)
            live_k = mask if kv is None else (mask & kv)
            ok = torch.all(~live_k | ((k64 < _NULLS) & (k64 > -_DEADS)))
            if kv is not None:
                k64 = torch.where(kv, k64, _NULLS)
            salk, perm = torch.sort(torch.where(mask, k64, _DEADS))
            runs, live_end = _key_runs(salk)
            out = [salk]
            for spec, fn in zip(specs, afns):
                if fn is None:  # count(*)
                    c = _run_total((salk < _DEADS).to(torch.int64), runs)
                    out += [c, c > 0]
                    continue
                d, v = _bcast(fn(env, params), n)
                d = _widen(d)
                vv = mask if v is None else (mask & v)
                vv = vv[perm]
                vcnt = _run_total(vv.to(torch.int64), runs)
                if spec == "count":
                    out += [vcnt, live_end]
                    continue
                vvalid = vcnt > 0
                if spec in ("min", "max"):
                    sval = torch.where(vv, d[perm], ident(spec, d.dtype))
                    out += [_seg_scan(sval, runs, spec), vvalid]
                    continue
                sv, okbit = _run_sums(torch.where(vv, d[perm], 0), runs,
                                      robust)
                ok = ok & okbit
                out += [sv, vvalid]
            for p in dropped:
                d, v = _bcast(gfns[p](env, params), n)
                out += [torch.where(mask, d.to(torch.int64), 0)[perm],
                        None if v is None else (mask & v)[perm]]
            # the run ends, in key order: at most cap of them ship
            ends = torch.nonzero(live_end).reshape(-1)
            novf = torch.tensor(ends.shape[0] > cap, device=mask.device)
            ends = ends[:cap]
            return ([None if x is None else x[ends] for x in out],
                    novf, ok, flags)

        def merge_program(wouts):
            ncols = len(wouts[0][0])
            cols = [None if wouts[0][0][i] is None
                    else torch.cat([w[0][i] for w in wouts])
                    for i in range(ncols)]
            novf = torch.stack([w[1] for w in wouts]).any()
            ok = torch.stack([w[2] for w in wouts]).all()
            flags = [torch.stack([w[3][f].reshape(()) for w in wouts]).any()
                     for f in range(len(wouts[0][3]))]
            if cols[0].shape[0] == 0:  # no live row: one dead row
                cols = [None if c is None else c.new_zeros(1) for c in cols]
                cols[0] = cols[0] + _DEADS
            salk, perm = torch.sort(cols[0])
            sops = [None if c is None else c[perm] for c in cols]
            runs, live_end = _key_runs(salk)
            vals = []  # per aggregate: (value, valid) at the run ends
            for ai, spec in enumerate(specs):
                sval, svld = sops[1 + 2 * ai], sops[2 + 2 * ai]
                vvalid = _run_total(svld.to(torch.int64), runs) > 0
                if spec in ("min", "max"):
                    sv = torch.where(svld, sval, ident(spec, sval.dtype))
                    vals.append((_seg_scan(sv, runs, spec), vvalid))
                    continue
                sv, okbit = _run_sums(torch.where(svld, sval, 0), runs,
                                      robust)
                ok = ok & okbit
                vals.append((sv, vvalid))
            coff = 1 + 2 * len(specs)

            def key_col(p):
                if p == kidx:
                    return salk, salk != _NULLS
                di = coff + 2 * dropped.index(p)
                return sops[di], sops[di + 1]

            packed, okr = _pack_sort_cols(
                [vals[p - nkeys] if p >= nkeys else key_col(p)
                 for p, _d, _nf in sspecs], sspecs, live_end)
            idx, sel = _topk_idx(packed, live_end, k)
            ok = ok & okr
            out_keys = [_take(key_col(i), idx) for i in range(nkeys)]
            out_vals = [_take(pair, idx) for pair in vals]
            return out_keys, out_vals, sel, novf, ok, flags

        return (window_program, merge_program, comp, b.jinfo(),
                frozenset(b.modes))

    def _compile_final(self, agg, root, orientation, fo, gcap, packing,
                       tk=None, gs=None, ga=False, narrow=False,
                       robust=False):
        """(program, compiler, mode, jinfo, join modes) of one mode:
        gsort (``gs``), gagg (``ga``), or the scalar / grouped reduce,
        grouped_topk where ``tk`` ranks its groups."""
        comp = ExprCompiler(self.fx.device)
        b = _Builder(self.fx, comp, orientation, root, runner=self, offs=fo)
        if gs is not None:
            program = self._compile_gsort(b, comp, agg, gs, tk, narrow)
            return program, comp, "gsort", b.jinfo(), frozenset(b.modes)
        ev = b.build(root)
        if ga:
            program = self._compile_gagg(ev, comp, agg, root, orientation,
                                         tk, narrow, robust)
            return program, comp, "gagg", b.jinfo(), frozenset(b.modes)
        dids = _dids(root.schema)
        gfns = [comp.compile(g, dids) for g in agg.group_exprs]
        specs, afns = _agg_specs(comp, agg, dids)
        specs = tuple(specs)
        grouped = bool(agg.group_exprs)
        nkeys = len(agg.group_exprs)
        # the packed single sort takes integer-family and TEXT (code)
        # keys; a run-time range flag retries with per-part sorting
        use_packed = packing and all(
            g.type.id in _JOINABLE_KEY_TYPES or g.type.is_text
            for g in agg.group_exprs
        )

        def program(arrays, params, snap):
            env, mask, n, flags = ev(arrays, params, snap)
            vals = [
                None if fn is None else _bcast(fn(env, params), n)
                for fn in afns
            ]
            if not grouped:
                return agg_ops.scalar_reduce(vals, mask, specs), flags
            keys = [_bcast(fn(env, params), n) for fn in gfns]
            out_keys, out_vals, gvalid, ngroups, pack_ok = _group_visible(
                keys, vals, mask, gcap, specs, use_packed)
            if pack_ok is not None:
                flags = flags + [~pack_ok]
            if tk is None:
                return (out_keys, out_vals, gvalid, ngroups), flags
            # grouped_topk: rank the groups, keep k
            kk, sspecs, _m = tk
            sortcols = [out_keys[p] if p < nkeys else out_vals[p - nkeys]
                        for p, _d, _nf in sspecs]
            packed, ok = _pack_sort_cols(sortcols, sspecs, gvalid)
            idx, sel = _topk_idx(packed, gvalid, kk)
            out_keys = [_take(pair, idx) for pair in out_keys]
            out_vals = [_take(pair, idx) for pair in out_vals]
            return (out_keys, out_vals, sel, ngroups, ok), flags

        if not grouped:
            mode = "scalar"
        else:
            mode = "grouped_topk" if tk is not None else "grouped"
        return program, comp, mode, b.jinfo(), frozenset(b.modes)

    def _compile_gagg(self, ev, comp, agg, root, orientation, topk,
                      narrow: bool, robust: bool):
        """Grouped aggregation + top-k as ONE sort and prefix scans, no
        join required. Rows sort by the run-time packed group key;
        groups are runs; sums and counts are prefix differences against
        the prefix at the run's head, min/max a segmented scan each;
        ranking happens at run ENDS, where every aggregate is final, and
        only k rows leave the device.

        Group keys functionally determined by another grouped key
        (through verified-unique joins, ``_fd_reduce``) stay out of the
        packed key and are read back per output row through the row id
        (the sort permutation); the kept keys decode straight out of the
        sorted packed key, since the monotone packing inverts. ``narrow``
        sorts an i32 key and carries i32 values while the run-time
        ranges fit; ``robust`` sums by segmented add scans, for negative
        values or a wrapping global prefix. Either overflow, and an
        overflow of the ranking key, clears the returned ``ok``."""
        dids = _dids(root.schema)
        gfns = [comp.compile(g, dids) for g in agg.group_exprs]
        specs, afns = _agg_specs(comp, agg, dids)
        k, sspecs, _merged = topk
        nkeys = len(agg.group_exprs)
        kept, dropped = _fd_reduce(root, orientation, agg)
        drop = set(dropped)
        # ORDER BY group keys that were FD-dropped ride the sort as
        # carried operands (their values are not in the packed key)
        carried = sorted({p for p, _d, _nf in sspecs
                          if p < nkeys and p in drop})
        big = 2**62

        def program(arrays, params, snap):
            env, mask, n, flags = ev(arrays, params, snap)
            dev = mask.device
            keys = [_bcast(fn(env, params), n) for fn in gfns]
            ok = torch.ones((), dtype=torch.bool, device=dev)
            # pack the kept keys, remembering (mn, stride, r, rng) per key
            # so values decode back out of the sorted key
            stride0 = torch.ones((), dtype=torch.int64, device=dev)
            prod0 = torch.ones((), dtype=torch.float64, device=dev)
            packed = torch.zeros(n, dtype=torch.int64, device=dev)
            decode_info = {}
            for i in kept:
                d, v = keys[i]
                live = mask if v is None else (mask & v)
                d64 = d.to(torch.int64)
                mn = _reduce_or(torch.where(live, d64, big), torch.amin, big)
                mx = _reduce_or(torch.where(live, d64, -big), torch.amax,
                                -big)
                mn = torch.minimum(mn, mx)
                rngf = (mx.to(torch.float64) - mn.to(torch.float64)) + 1.0
                ok = ok & (rngf < 2.0**62)
                rng = torch.clamp(mx - mn + 1, min=1)
                if v is None:
                    x, r, rf = d64 - mn, rng, rngf
                else:
                    x = torch.where(v, d64 - mn, rng)
                    r, rf = rng + 1, rngf + 1.0
                decode_info[i] = (mn, stride0, r, rng)
                packed = packed + x * stride0
                stride0 = stride0 * r
                prod0 = prod0 * torch.clamp(rf, min=1.0)
            ok = ok & (prod0 < 2.0**62)
            if narrow:
                ok = ok & (prod0 < float(_I32_SENT))
                ksent = _I32_SENT
                skeyop = torch.where(mask, packed, _I32_SENT).to(torch.int32)
            else:
                ksent = big
                skeyop = torch.where(mask, packed, big)

            def narrow_val(dv):
                nonlocal ok
                if narrow and dv.dtype == torch.int64:
                    ok = ok & _fits_i32(dv)
                    return dv.to(torch.int32)
                return dv

            operands = []  # value operands, permuted with the sort key
            val_pos: list = []
            for spec, fn in zip(specs, afns):
                if fn is None:
                    val_pos.append(None)
                    continue
                d, v = _bcast(fn(env, params), n)
                d = _widen(d)
                vv = mask if v is None else (mask & v)
                if spec in ("min", "max"):
                    # identity padding so dead and NULL rows never win;
                    # inside the narrow bound, so it trips no flag
                    if d.dtype.is_floating_point:
                        ident = float("inf") if spec == "min" else \
                            float("-inf")
                    else:
                        mag = (_I32_SENT - 1) if narrow else big
                        ident = mag if spec == "min" else -mag
                    dv = narrow_val(torch.where(vv, d, ident))
                else:
                    dv = narrow_val(torch.where(vv, d, 0))
                operands.append(dv)
                vi = None
                if v is not None or spec in ("min", "max"):
                    operands.append(vv.to(torch.int8))
                    vi = len(operands) - 1
                val_pos.append((len(operands) - (2 if vi is not None
                                                 else 1), vi))
            carried_pos = {}
            for p in carried:
                d, v = keys[p]
                operands.append(narrow_val(
                    torch.where(mask, d.to(torch.int64), 0)))
                ci, vi = len(operands) - 1, None
                if v is not None:
                    operands.append((mask & v).to(torch.int8))
                    vi = len(operands) - 1
                carried_pos[p] = (ci, vi)
            salk, perm = torch.sort(skeyop, stable=False)
            sops = [op[perm] for op in operands]
            runs, live_end = _key_runs(salk, ksent)
            run_cnt = []

            def get_run_cnt():
                if not run_cnt:
                    run_cnt.append(_run_total(
                        (salk < ksent).to(torch.int64), runs))
                return run_cnt[0]

            out_vals_pos = []
            for spec, vp in zip(specs, val_pos):
                if spec == "count_star":
                    c = get_run_cnt()
                    out_vals_pos.append((c, c > 0))
                    continue
                oi, vi = vp
                sval = sops[oi]
                if vi is not None:
                    vcnt = _run_total(sops[vi].to(torch.int64), runs)
                    vvalid = vcnt > 0
                else:
                    vvalid = live_end
                if spec == "count":
                    c = vcnt if vi is not None else get_run_cnt()
                    out_vals_pos.append((c, live_end))
                    continue
                if spec in ("min", "max"):
                    out_vals_pos.append(
                        (_widen(_seg_scan(sval, runs, spec)), vvalid))
                    continue
                sv, okbit = _run_sums(_widen(sval), runs, robust)
                ok = ok & okbit
                out_vals_pos.append((sv, vvalid))

            def decode_key(i, src):
                """(value, valid or None) of kept key i from packed keys
                ``src`` (inverts the monotone packing)."""
                mn, strd, r, rng = decode_info[i]
                x = torch.remainder(
                    torch.div(src.to(torch.int64), strd,
                              rounding_mode="floor"), r)
                d = x + mn
                if keys[i][1] is None:
                    return d, None
                return torch.where(x == rng, 0, d), x != rng

            stride = torch.ones((), dtype=torch.int64, device=dev)
            prod = torch.ones((), dtype=torch.float64, device=dev)
            packed_rank = torch.zeros(n, dtype=torch.int64, device=dev)
            for p, desc, nf in reversed(sspecs):
                if p >= nkeys:
                    d64, v = out_vals_pos[p - nkeys]
                    d64 = d64.to(torch.int64)
                elif p in drop:
                    ci, vi = carried_pos[p]
                    d64 = sops[ci].to(torch.int64)
                    v = None if vi is None else sops[vi] > 0
                else:
                    d64, v = decode_key(p, salk)
                x, r, rf, okbit = _rank_encode(d64, v, desc, nf, live_end)
                packed_rank = packed_rank + x * stride
                stride = stride * r
                prod = prod * torch.clamp(rf, min=1.0)
                ok = ok & okbit
            ok = ok & (prod < 2.0**62)

            idx, sel = _topk_idx(packed_rank, live_end, k)
            row_k = perm[idx] if drop else None
            salk_k = salk[idx]
            out_keys = []
            for i, (d, v) in enumerate(keys):
                if i in drop:
                    dk = d[row_k]
                    vk = sel if v is None else v[row_k]
                else:
                    dk, vk = decode_key(i, salk_k)
                    dk = dk.to(d.dtype)
                    if vk is None:
                        vk = sel
                out_keys.append((dk, vk))
            out_vals = [_take(pair, idx) for pair in out_vals_pos]
            return (out_keys, out_vals, sel, ok), flags

        return program

    def _compile_gsort(self, b, comp, agg, gs, topk, narrow: bool):
        """Co-sort join + grouped aggregation + top-k in ONE program,
        when grouping by the unique build key of the top join: the
        concatenated [build keys, probe keys] sort by (key, is_probe),
        so each run starts at its build row, and every per-group
        quantity falls out of prefix scans — run sums by cumsum
        differences, the run-end prefix read back at the build position,
        min/max by one segmented scan. A join residual rides the sort:
        build-side inputs forward-fill from each run's build row and
        failing probe rows leave every reduction. Ranking happens at the
        build positions, where build-side ORDER BY columns are local;
        only k rows leave the device. ``narrow`` sorts i32 keys and carries i32
        values while the run-time ranges fit."""
        join = gs["join"]
        build_right = gs["build_right"]
        build_cols = gs["build_cols"]
        bkey_col = gs["bkey_col"]
        residual = gs["residual"]
        left_fn = b.build(join.left)
        right_fn = b.build(join.right)
        lkfn = comp.compile(join.left_keys[0], _dids(join.left.schema))
        rkfn = comp.compile(join.right_keys[0], _dids(join.right.schema))
        jdids = _dids(join.schema)
        resfn = (comp.compile(residual, jdids)
                 if residual is not None else None)
        res_cols = sorted(_expr_cols(residual)) if residual is not None \
            else []
        specs, afns = _agg_specs(comp, agg, jdids)
        k, sspecs, _merged = topk
        nkeys = len(agg.group_exprs)
        nl = len(join.left.schema)
        nr = len(join.right.schema)
        # build-side ORDER BY columns: their slots are encoded on the
        # build side before the sort and carried as one payload
        bslot_cols = sorted({
            build_cols[p] for p, _d, _nf in sspecs
            if p < nkeys and build_cols[p] != bkey_col
        })
        big = 2**62

        def program(arrays, params, snap):
            lenv, lmask, ln, lflags = left_fn(arrays, params, snap)
            renv, rmask, rn, rflags = right_fn(arrays, params, snap)
            flags = lflags + rflags
            lk = _bcast(lkfn(lenv, params), ln)
            rk = _bcast(rkfn(renv, params), rn)
            if build_right:
                bk, benv, bmask, bn = rk, renv, rmask, rn
                pk, penv, pmask, pn = lk, lenv, lmask, ln
                poff, boff = 0, nl
            else:
                bk, benv, bmask, bn = lk, lenv, lmask, ln
                pk, penv, pmask, pn = rk, renv, rmask, rn
                poff, boff = nl, 0
            dev = bmask.device
            bkd, bkv = bk
            pkd, pkv = pk
            breal = bmask if bkv is None else (bmask & bkv)
            preal = pmask if pkv is None else (pmask & pkv)
            bk64, pk64 = bkd.to(torch.int64), pkd.to(torch.int64)
            # ONE sort key: key * 2 + is_probe, so build rows lead their
            # runs; dead rows ride in the sentinel run at the end
            allk = torch.cat([torch.where(breal, bk64 * 2, big),
                              torch.where(preal, pk64 * 2 + 1, big)])
            kmax = torch.maximum(
                _reduce_or(torch.where(breal, bk64, 0), torch.amax, 0),
                _reduce_or(torch.where(preal, pk64, 0), torch.amax, 0))
            kmin = torch.minimum(
                _reduce_or(torch.where(breal, bk64, 0), torch.amin, 0),
                _reduce_or(torch.where(preal, pk64, 0), torch.amin, 0))
            ok = (kmax < 2**61) & (kmin > -(2**61))
            if narrow:
                ok = ok & (kmax < 2**29) & (kmin > -(2**29))
                allk = torch.where(allk >= big, _I32_SENT, allk).to(
                    torch.int32)
            # probe-side aggregate inputs (build positions ride as zeros)
            zero = (torch.zeros((), dtype=torch.int32, device=dev), None)
            env_full = [zero] * (nl + nr)
            for i, c in enumerate(penv):
                env_full[poff + i] = c
            operands = []  # permuted with the sort key
            val_pos: list = []  # per agg: (operand idx, valid idx or None)
            sents: list = []  # per agg: the min/max identity or None
            for spec, fn in zip(specs, afns):
                if fn is None:
                    val_pos.append(None)
                    sents.append(None)
                    continue
                d, v = _bcast(fn(env_full, params), pn)
                d = _widen(d)
                vv = preal if v is None else (preal & v)
                dv = torch.where(vv, d, 0)
                if narrow and dv.dtype == torch.int64:
                    ok = ok & _fits_i32(dv)
                    dv = dv.to(torch.int32)
                if spec in ("min", "max"):
                    # dead and NULL rows and the build positions carry
                    # the identity, so the reverse segmented scan reduces
                    # over live probe rows only
                    if dv.dtype.is_floating_point:
                        sent = float("inf") if spec == "min" else \
                            float("-inf")
                    elif dv.dtype == torch.int32:
                        sent = _I32_SENT if spec == "min" else -(2**31)
                    else:
                        sent = big if spec == "min" else -big
                    dv = torch.where(vv, dv, sent)
                    bfill = torch.full((bn,), sent, dtype=dv.dtype,
                                       device=dev)
                    sents.append(sent)
                else:
                    bfill = torch.zeros(bn, dtype=dv.dtype, device=dev)
                    sents.append(None)
                operands.append(torch.cat([bfill, dv]))
                vi = None
                if v is not None:
                    operands.append(torch.cat([
                        torch.zeros(bn, dtype=torch.int8, device=dev),
                        vv.to(torch.int8)]))
                    vi = len(operands) - 1
                val_pos.append((len(operands) - (2 if vi is not None
                                                 else 1), vi))
            # residual inputs ride the sort: probe-side columns are local
            # at probe positions; build-side columns sit at each run's
            # leading build row and forward-fill after the sort
            res_pos: dict = {}  # col -> (op idx, valid idx, is_build)
            pspan = range(poff, poff + len(penv))
            for c in res_cols:
                is_bld = c not in pspan
                d, v = benv[c - boff] if is_bld else penv[c - poff]
                m = bn if is_bld else pn
                d = d.expand(m) if d.dim() == 0 else d
                zd = torch.zeros(pn if is_bld else bn, dtype=d.dtype,
                                 device=dev)
                operands.append(torch.cat([d, zd] if is_bld else [zd, d]))
                oi, vi = len(operands) - 1, None
                if v is not None:
                    v8 = (v.expand(m) if v.dim() == 0 else v).to(torch.int8)
                    z8 = torch.zeros(pn if is_bld else bn, dtype=torch.int8,
                                     device=dev)
                    operands.append(torch.cat([v8, z8] if is_bld
                                              else [z8, v8]))
                    vi = len(operands) - 1
                res_pos[c] = (oi, vi, is_bld)
            # build ORDER BY slots: direction and NULLs encoded on the
            # build side (ranges over real build rows, a superset of the
            # matched groups, still order-preserving), packed with the
            # build row index into ONE int64 payload
            slot_rng: dict = {}
            slot_stride: dict = {}
            sb_acc = torch.zeros(bn, dtype=torch.int64, device=dev)
            sb_stride = torch.ones((), dtype=torch.int64, device=dev)
            sb_prod = torch.ones((), dtype=torch.float64, device=dev)
            for bc in bslot_cols:
                _p, desc, nf = next(
                    s for s in sspecs
                    if s[0] < nkeys and build_cols[s[0]] == bc)
                d, v = _bcast(benv[bc], bn)
                slot, r, rf, okbit = _rank_encode(
                    d.to(torch.int64), v, desc, nf, breal, bound=2**61)
                ok = ok & okbit
                slot_rng[bc] = r
                slot_stride[bc] = sb_stride
                sb_acc = sb_acc + slot * sb_stride
                sb_stride = sb_stride * r
                sb_prod = sb_prod * torch.clamp(rf, min=1.0)
            ok = ok & (sb_prod * float(max(bn, 1)) < 2.0**62)
            operands.append(torch.cat([
                sb_acc * bn + torch.arange(bn, device=dev),
                torch.zeros(pn, dtype=torch.int64, device=dev)]))
            sb_i = len(operands) - 1

            salk, perm = torch.sort(allk, stable=False)
            sops = [op[perm] for op in operands]
            ksent = _I32_SENT if narrow else big
            skey = salk >> 1  # the run key (an arithmetic shift)
            M = bn + pn
            boundary = torch.ones(M, dtype=torch.bool, device=dev)
            boundary[1:] = skey[1:] != skey[:-1]
            odd = (salk & 1) == 1
            real = salk < ksent
            isb = ~odd & real
            isp = odd & real
            # duplicate real build keys: adjacent build rows in one run
            # (build rows sort first), the same verdict as _lookup's
            flags = flags + [torch.any(isb[1:] & isb[:-1] & ~boundary[1:])]
            end = torch.ones(M, dtype=torch.bool, device=dev)
            end[:-1] = boundary[1:]
            runs = _runs(boundary)
            resid_ok = None
            if resfn is not None:
                env_res = [zero] * (nl + nr)
                for c, (oi, vi, is_bld) in res_pos.items():
                    rd = sops[oi]
                    rv = None if vi is None else sops[vi]
                    if is_bld:
                        rd = _seg_scan(rd, runs, "first")
                        if rv is not None:
                            rv = _seg_scan(rv, runs, "first")
                    env_res[c] = (rd, None if rv is None else rv > 0)
                okd, okv = _bcast(resfn(env_res, params), M)
                resid_ok = okd if okv is None else (okd & okv)
            isp_ok = isp if resid_ok is None else (isp & resid_ok)

            def run_total(cs):
                # the value at a BUILD position (its run's first row,
                # contributing nothing) is the run-end prefix less its
                # own prefix (the reference carries the run-end prefix
                # back by a reverse cummin, the same where cs is
                # monotone). Probe rows of build-less runs never surface:
                # their run has no build position.
                return cs[runs[2]] - cs

            run_cnt = []

            def get_run_cnt():
                if not run_cnt:
                    run_cnt.append(run_total(torch.cumsum(
                        isp_ok.to(torch.int64), 0)))
                return run_cnt[0]

            # group existence: without a residual every build row that
            # is not its run's end has a probe row; with one, a group
            # lives iff a probe row PASSED
            has_probe = ~end if resid_ok is None else (get_run_cnt() > 0)
            out_vals_pos = []
            for spec, vp, sent in zip(specs, val_pos, sents):
                if spec == "count_star":
                    out_vals_pos.append((get_run_cnt(), has_probe))
                    continue
                oi, vi = vp
                sval = sops[oi]
                if resid_ok is not None:
                    # failing probe rows leave every reduction
                    sval = torch.where(isp & ~resid_ok,
                                       0 if sent is None else sent, sval)
                if vi is not None:
                    vlive = isp_ok & (sops[vi] > 0)
                    vcnt = run_total(torch.cumsum(vlive.to(torch.int64), 0))
                    vvalid = vcnt > 0
                else:
                    vcnt = None
                    vvalid = has_probe
                if spec == "count":
                    c = vcnt if vcnt is not None else get_run_cnt()
                    out_vals_pos.append((c, has_probe))
                    continue
                if spec in ("min", "max"):
                    # the full-run reduction lands at the run START: the
                    # build row, where every per-group output lives
                    out_vals_pos.append((_seg_scan(sval, runs, spec),
                                         vvalid))
                    continue
                # sum: the reverse-cummin carry needs a monotone prefix;
                # a negative value or a wrapping prefix clears ok
                ok = ok & ~(_reduce_or(sval, torch.amin, 0) < 0)
                if sval.dtype.is_floating_point:
                    cs = torch.cumsum(sval, 0)
                else:
                    cs = torch.cumsum(sval, 0, dtype=torch.int64)
                    ok = ok & (cs[-1] < big) & (cs[-1] >= 0)
                out_vals_pos.append((run_total(cs), vvalid))

            live = isb & has_probe
            ssb = sops[sb_i]
            nbd = max(bn, 1)
            sslots = torch.div(ssb, nbd, rounding_mode="floor")
            # rank at the build positions: build ORDER BY slots are
            # local, run-level values were just computed
            stride = torch.ones((), dtype=torch.int64, device=dev)
            prod = torch.ones((), dtype=torch.float64, device=dev)
            packed = torch.zeros(M, dtype=torch.int64, device=dev)
            for p, desc, nf in reversed(sspecs):
                if p < nkeys and build_cols[p] == bkey_col:
                    d64, v = skey.to(torch.int64), None
                elif p < nkeys:
                    bc = build_cols[p]
                    sl = torch.remainder(
                        torch.div(sslots, slot_stride[bc],
                                  rounding_mode="floor"), slot_rng[bc])
                    packed = packed + sl * stride
                    stride = stride * slot_rng[bc]
                    prod = prod * torch.clamp(
                        slot_rng[bc].to(torch.float64), min=1.0)
                    continue
                else:
                    d64, v = out_vals_pos[p - nkeys]
                    d64 = d64.to(torch.int64)
                x, r, rf, okbit = _rank_encode(d64, v, desc, nf, live)
                packed = packed + x * stride
                stride = stride * r
                prod = prod * torch.clamp(rf, min=1.0)
                ok = ok & okbit
            ok = ok & (prod < 2.0**62)

            idx, sel = _topk_idx(packed, live, k)
            brow_k = torch.remainder(ssb[idx], nbd)
            out_keys = []
            for gi in range(nkeys):
                bc = build_cols[gi]
                if bc == bkey_col:
                    out_keys.append((skey[idx], sel))
                else:
                    d, v = _bcast(benv[bc], bn)
                    out_keys.append((d[brow_k],
                                     sel if v is None else v[brow_k]))
            out_vals = [_take(pair, idx) for pair in out_vals_pos]
            return (out_keys, out_vals, sel, ok), flags

        return program

    def _apply_proj(self, batch, out_proj) -> ColumnBatch:
        """Re-apply an absorbed bare-column projection: reorder and
        rename the aggregate-schema batch to the fragment's schema."""
        if out_proj is None:
            return batch
        perm, schema = out_proj
        src = list(batch.columns.values())
        cols = {oc.name: src[perm[i]] for i, oc in enumerate(schema)}
        return ColumnBatch(cols, batch.nrows)

    def _dic(self, oc):
        return self.fx.catalog.dictionary(oc.dict_id) if oc.dict_id else None

    def _collect_grouped(self, agg, out_keys, out_vals, gvalid,
                         extra=()) -> tuple:
        """(the existing groups' rows on the host, ``extra``'s values):
        the rows compacted on the device, then one device-to-host
        transfer for them and the ``extra`` tensors (flags) together.
        TEXT keys keep their codes and decode through their
        dictionary."""
        keep = torch.nonzero(gvalid.reshape(-1)).reshape(-1)
        pairs = list(out_keys) + list(out_vals)
        host = _to_host([*extra] + [None if x is None else x.reshape(-1)[keep]
                                    for p in pairs for x in p])
        base = len(extra)
        cols: dict[str, Column] = {}
        for i, oc in enumerate(agg.schema):
            dd, vv = host[base + 2 * i], host[base + 2 * i + 1]
            if dd.dtype != oc.type.np_dtype:
                dd = dd.astype(oc.type.np_dtype)
            cols[oc.name] = Column(oc.type, dd, vv, self._dic(oc))
        return ColumnBatch(cols, int(keep.shape[0])), host[:base]

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


# the dead-row sentinel of an i32 ("narrow") sort key, and the bound
# narrowed values must stay strictly inside
_I32_SENT = 2**31 - 1


def _fits_i32(x) -> torch.Tensor:
    """0-d: every value of int64 ``x`` lies strictly inside +-(2^31 - 1)
    (two-sided, not abs(): abs of INT64_MIN wraps negative)."""
    return ((_reduce_or(x, torch.amax, 0) < _I32_SENT)
            & (_reduce_or(x, torch.amin, 0) > -_I32_SENT))


def _widen(d):
    """Integer (and bool) values as int64, floats as float64."""
    return d.to(torch.float64 if d.dtype.is_floating_point else torch.int64)


def _key_runs(salk, dead=_DEADS):
    """(``_runs`` of the sorted keys, live run ends): a run is one key,
    and its end is live unless the key is the dead-row sentinel
    ``dead``."""
    n = salk.shape[0]
    boundary = torch.ones(n, dtype=torch.bool, device=salk.device)
    boundary[1:] = salk[1:] != salk[:-1]
    end = torch.ones(n, dtype=torch.bool, device=salk.device)
    end[:-1] = boundary[1:]
    return _runs(boundary), end & (salk < dead)


def _run_total(x, runs, cs=None):
    """Each run's running sum of ``x`` at every position (its total at
    the run's end): the prefix ``cs`` less the prefix just before the
    run's head (the reference carries that base by a cummax, the same
    where the prefix is monotone)."""
    if cs is None:
        cs = torch.cumsum(x, 0)
    return cs - (cs - x)[runs[1]]


def _run_sums(x, runs, robust: bool):
    """(each run's running sum of ``x``, ok): by segmented add scans
    when ``robust``, else by the global prefix, which needs non-negative
    values and a last prefix below 2^62 (``ok`` False otherwise, as in
    the reference, whose cummax run base breaks there)."""
    if robust:
        return _seg_scan(x, runs, "add"), torch.ones(
            (), dtype=torch.bool, device=x.device)
    ok = ~(_reduce_or(x, torch.amin, 0) < 0)
    cs = torch.cumsum(x, 0)
    if not cs.dtype.is_floating_point:
        ok = ok & (cs[-1] < _DEADS) & (cs[-1] >= 0)
    return _run_total(x, runs, cs), ok


def _replace_node(root, old, new):
    """``root`` rebuilt with the subtree ``old`` (by identity) replaced
    by ``new``."""
    if root is old:
        return new
    if dataclasses.is_dataclass(root) and not isinstance(root, type):
        changes = {}
        for f in dataclasses.fields(root):
            v = getattr(root, f.name)
            if isinstance(v, L.LogicalPlan):
                nv = _replace_node(v, old, new)
                if nv is not v:
                    changes[f.name] = nv
        if changes:
            return dataclasses.replace(root, **changes)
    return root


def _take(pair, idx):
    d, v = pair
    return d[idx], (None if v is None else v[idx])


def _shapes_sig(arrays) -> tuple:
    def leaves(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif x is not None:
            for y in x:
                yield from leaves(y)

    return tuple(
        tuple((tuple(a.shape), str(a.dtype)) for a in leaves(blk))
        for blk in arrays
    )


def _contains_join(plan) -> bool:
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, L.Join):
            return True
        if isinstance(node, (L.Filter, L.Project, L.Aggregate)):
            stack.append(node.child)
    return False


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


def _params_sig(host_params) -> tuple:
    """Hashable digest of the resolved literal params: a remembered
    group capacity must not alias across literal values."""
    return tuple((a.shape, str(a.dtype), hash(a.tobytes()))
                 for a in host_params)


def _first_true(flags) -> Optional[int]:
    """Index of the first raised flag (one device copy for all)."""
    if not flags:
        return None
    raised = torch.stack([f.reshape(()) for f in flags]).cpu().tolist()
    for i, f in enumerate(raised):
        if f:
            return i
    return None

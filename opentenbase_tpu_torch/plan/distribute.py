"""Distributed planner: logical plan -> fragment DAG with motions.

The reference annotates every optimizer path with a ``Distribution``
(src/include/nodes/relation.h:36-44), inserts redistribution paths
(redistribute_path, src/backend/optimizer/util/pathnode.c:1469) and cuts
the final plan into RemoteSubplan fragments shipped to datanodes
(make_remotesubplan, src/backend/optimizer/plan/createplan.c:6458), with a
fast-path that ships whole single-node queries as one unit (pgxc_FQS_planner,
src/backend/pgxc/plan/planner.c:273).

This module is the TPU-native equivalent. A ``Fragment`` is the unit one
set of datanodes executes (compiled per-node by executor/local.py, or as
one shard_map program on the device mesh by the fused path); a ``Motion``
edge between fragments is realized as a collective (gather / all-to-all
redistribute / broadcast) instead of the reference's squeue+DataPump socket
fabric (src/backend/pgxc/squeue/squeue.c).

Placement algebra (Dist):
- replicated(nodes): every node holds all rows (LOCATOR_TYPE_REPLICATED)
- sharded(nodes, strategy, key_positions): rows split; key_positions are
  the output columns that determine placement (empty = placement exists
  but is not derivable from output, e.g. roundrobin or post-projection)
- single(node): all rows on one executor; node -1 = the coordinator

Two-phase aggregation follows the reference's agg split
(createplan.c:1852): partial per shard -> motion -> merge, with avg
decomposed into sum+count and re-divided in a finalize projection.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.catalog import Catalog
from opentenbase_tpu_torch.catalog.distribution import DistStrategy
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan import texpr as E

COORDINATOR = -1  # pseudo node index for the coordinator executor


# ---------------------------------------------------------------------------
# Distribution property
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Dist:
    kind: str  # 'replicated' | 'sharded' | 'single'
    nodes: tuple[int, ...]
    strategy: Optional[DistStrategy] = None  # sharded only
    key_positions: tuple[int, ...] = ()  # sharded only; () = underivable

    @staticmethod
    def single(node: int) -> "Dist":
        return Dist("single", (node,))

    @staticmethod
    def replicated(nodes) -> "Dist":
        return Dist("replicated", tuple(nodes))

    @staticmethod
    def sharded(nodes, strategy=None, key_positions=()) -> "Dist":
        return Dist("sharded", tuple(nodes), strategy, tuple(key_positions))

    @property
    def is_single(self) -> bool:
        return self.kind == "single"


# ---------------------------------------------------------------------------
# Fragment DAG
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RemoteSource(L.LogicalPlan):
    """Leaf operator reading the motioned output of another fragment —
    what the DN-side RemoteSubplan reads from squeue/conns in the
    reference (ExecRemoteSubplan consumer half, execRemote.c:10883)."""

    fragment: int
    schema: tuple[L.OutCol, ...]

    def key(self) -> str:
        return f"remotesrc({self.fragment})"


def eq_consts(scan, pred) -> dict:
    """Column-name → constant for every `col = const` conjunct over a
    scan. THE one equality-pinning walk — node pruning and the shard
    barrier's membership proof must extract identically."""
    consts: dict = {}
    for c in E.conjuncts(pred):
        if (
            isinstance(c, E.BinE)
            and c.op == "="
            and isinstance(c.left, E.Col)
            and isinstance(c.right, E.Const)
            and c.right.value is not None
        ):
            consts[scan.columns[c.left.index]] = c.right.value
    return consts


@dataclass
class Fragment:
    """One plan fragment + the motion delivering its output upward."""

    index: int
    root: L.LogicalPlan
    nodes: tuple[int, ...]
    motion: str  # 'gather' | 'redistribute' | 'broadcast'
    # for 'redistribute': output columns to hash on and the consumer nodes
    hash_positions: tuple[int, ...] = ()
    dest_nodes: tuple[int, ...] = ()
    # sorted-gather: merge on these sort keys at the consumer (the
    # merge-sorted ResponseCombiner, execRemote.h:150)
    merge_keys: tuple[L.SortKey, ...] = ()


@dataclass
class DistributedPlan:
    fragments: list[Fragment] = field(default_factory=list)
    root: Optional[L.LogicalPlan] = None  # runs on the coordinator
    # scalar subquery plans (InitPlans), each itself distributed
    subplans: list["DistributedPlan"] = field(default_factory=list)

    def explain(self) -> str:
        lines = []
        for f in self.fragments:
            dest = (
                f"->{f.motion}"
                + (f"({','.join(map(str, f.hash_positions))})" if f.hash_positions else "")
            )
            lines.append(f"Fragment {f.index} on nodes {list(f.nodes)} {dest}:")
            lines.append(L.explain_tree(f.root, 1))
        lines.append("Coordinator:")
        lines.append(L.explain_tree(self.root, 1))
        return "\n".join(lines)


class DistributeError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Distributor
# ---------------------------------------------------------------------------

_MERGE_FUNC = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


class Distributor:
    """Assigns placement bottom-up, cutting fragments at motion points."""

    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self.fragments: list[Fragment] = []

    # -- fragment cutting ------------------------------------------------
    def _cut(
        self,
        plan: L.LogicalPlan,
        nodes: tuple[int, ...],
        motion: str,
        hash_positions: tuple[int, ...] = (),
        dest_nodes: tuple[int, ...] = (),
        merge_keys: tuple[L.SortKey, ...] = (),
    ) -> RemoteSource:
        idx = len(self.fragments)
        self.fragments.append(
            Fragment(idx, plan, nodes, motion, hash_positions, dest_nodes, merge_keys)
        )
        return RemoteSource(idx, plan.schema)

    def _to_single(self, plan: L.LogicalPlan, dist: Dist) -> L.LogicalPlan:
        """Deliver ``plan`` to the coordinator executor."""
        if dist.is_single and dist.nodes[0] == COORDINATOR:
            return plan
        if dist.kind == "replicated":
            # read from one preferred node only
            return self._cut(plan, (dist.nodes[0],), "gather")
        return self._cut(plan, dist.nodes, "gather")

    # -- entry -----------------------------------------------------------
    def distribute(self, splan: L.StatementPlan) -> DistributedPlan:
        subdps = []
        for sp in splan.subplans:
            sub = Distributor(self.catalog)
            root, dist = sub._walk(sp)
            subdps.append(
                DistributedPlan(sub.fragments, sub._to_single(root, dist))
            )
        root, dist = self._walk(splan.root)
        out = DistributedPlan(self.fragments, self._to_single(root, dist))
        out.subplans = subdps
        return out

    # -- recursion --------------------------------------------------------
    def _walk(self, plan: L.LogicalPlan) -> tuple[L.LogicalPlan, Dist]:
        m = getattr(self, f"_d_{type(plan).__name__.lower()}", None)
        if m is None:
            raise DistributeError(f"no distribution rule for {type(plan).__name__}")
        return m(plan)

    def _d_scan(self, plan: L.Scan):
        meta = self.catalog.get(plan.table)
        nodes = tuple(meta.node_indices)
        if meta.dist.is_replicated:
            return plan, Dist.replicated(nodes)
        if meta.dist.strategy in (
            DistStrategy.HASH,
            DistStrategy.MODULO,
            DistStrategy.SHARD,
            DistStrategy.RANGE,
        ):
            positions = []
            for k in meta.dist.key_columns:
                if k in plan.columns:
                    positions.append(plan.columns.index(k))
                else:
                    positions = []
                    break
            return plan, Dist.sharded(nodes, meta.dist.strategy, tuple(positions))
        return plan, Dist.sharded(nodes)  # roundrobin

    def _d_valuesscan(self, plan: L.ValuesScan):
        return plan, Dist.single(COORDINATOR)

    def _d_filter(self, plan: L.Filter):
        child, dist = self._walk(plan.child)
        # node pruning: dist-key equality conjuncts restrict the node set
        # (GetRelationNodesByQuals, src/backend/pgxc/locator/locator.c:2511)
        if (
            isinstance(child, L.Scan)
            and dist.kind == "sharded"
            and dist.key_positions
        ):
            pruned = self._prune_nodes(child, plan.predicate, dist)
            if pruned is not None:
                dist = Dist.sharded(pruned, dist.strategy, dist.key_positions)
        return L.Filter(child, plan.predicate, plan.schema), dist

    def _prune_nodes(self, scan: L.Scan, pred: E.TExpr, dist: Dist):
        meta = self.catalog.get(scan.table)
        consts = eq_consts(scan, pred)
        if not all(k in consts for k in meta.dist.key_columns):
            return None
        values = {k: consts[k] for k in meta.dist.key_columns}
        try:
            nodes = meta.locator.prune_by_key_equal(values)
        except Exception:
            return None
        if nodes is None:
            return None
        return tuple(nodes)

    def _d_project(self, plan: L.Project):
        child, dist = self._walk(plan.child)
        new_dist = dist
        if dist.kind == "sharded" and dist.key_positions:
            # track pass-through of the distribution key columns
            remap: dict[int, int] = {}
            for out_i, ex in enumerate(plan.exprs):
                if isinstance(ex, E.Col) and ex.index not in remap:
                    remap[ex.index] = out_i
            if all(p in remap for p in dist.key_positions):
                new_dist = Dist.sharded(
                    dist.nodes,
                    dist.strategy,
                    tuple(remap[p] for p in dist.key_positions),
                )
            else:
                new_dist = Dist.sharded(dist.nodes, dist.strategy, ())
        return L.Project(child, plan.exprs, plan.schema), new_dist

    # -- aggregation -------------------------------------------------------
    def _d_aggregate(self, plan: L.Aggregate):
        child, dist = self._walk(plan.child)
        local = L.Aggregate(child, plan.group_exprs, plan.aggs, plan.schema)
        if dist.is_single or dist.kind == "replicated":
            return local, (dist if dist.is_single else Dist.single(dist.nodes[0]))

        # group keys covering the distribution key => groups never span
        # nodes: aggregate entirely locally, stay sharded
        if plan.group_exprs and dist.key_positions:
            covered = set()
            for gi, g in enumerate(plan.group_exprs):
                if isinstance(g, E.Col):
                    covered.add(g.index)
            if set(dist.key_positions) <= covered:
                pos_map = {}
                for gi, g in enumerate(plan.group_exprs):
                    if isinstance(g, E.Col) and g.index not in pos_map:
                        pos_map[g.index] = gi
                return local, Dist.sharded(
                    dist.nodes,
                    dist.strategy,
                    tuple(pos_map[p] for p in dist.key_positions),
                )

        if any(a.distinct for a in plan.aggs):
            # DISTINCT aggs cannot be 2-phased: gather rows, aggregate once
            src = self._cut(child, dist.nodes, "gather")
            return (
                L.Aggregate(src, plan.group_exprs, plan.aggs, plan.schema),
                Dist.single(COORDINATOR),
            )

        return self._two_phase_agg(plan, child, dist)

    def _two_phase_agg(self, plan: L.Aggregate, child, dist):
        """Partial per shard -> gather -> merge (+ finalize projection)."""
        ngroups = len(plan.group_exprs)
        partial_aggs: list[E.AggCall] = []
        # original agg index -> list of partial output offsets
        slots: list[list[int]] = []
        # per-partial dict id: min/max outputs stay codes in the
        # ARGUMENT's dictionary (plan.schema carries it since the
        # analyzer stamps agg output dict ids) — dropping it made the
        # merge translate text codes into the wrong dictionary
        pdicts: list = []
        for j, a in enumerate(plan.aggs):
            if a.func == "avg":
                at = a.arg.type
                sum_t = at if at.id == t.TypeId.DECIMAL else t.FLOAT8
                partial_aggs.append(E.AggCall("sum", a.arg, False, sum_t))
                partial_aggs.append(E.AggCall("count", a.arg, False, t.INT8))
                pdicts.extend([None, None])
                slots.append([len(partial_aggs) - 2, len(partial_aggs) - 1])
            elif a.func == "count":
                partial_aggs.append(a)
                pdicts.append(None)
                slots.append([len(partial_aggs) - 1])
            else:
                partial_aggs.append(a)
                pdicts.append(
                    plan.schema[ngroups + j].dict_id
                    if a.func in ("min", "max") else None
                )
                slots.append([len(partial_aggs) - 1])

        partial_schema = tuple(
            [
                L.OutCol(f"__g{i}", g.type, plan.schema[i].dict_id)
                for i, g in enumerate(plan.group_exprs)
            ]
            + [
                L.OutCol(f"__p{i}", a.type, pdicts[i])
                for i, a in enumerate(partial_aggs)
            ]
        )
        partial = L.Aggregate(
            child, plan.group_exprs, tuple(partial_aggs), partial_schema
        )

        src = self._cut(partial, dist.nodes, "gather")

        # merge aggregation over partials
        merge_groups = tuple(
            E.Col(i, g.type) for i, g in enumerate(plan.group_exprs)
        )
        merge_aggs: list[E.AggCall] = []
        for i, a in enumerate(partial_aggs):
            func = _MERGE_FUNC["count" if a.func == "count" else a.func]
            col = E.Col(ngroups + i, a.type)
            out_t = t.INT8 if a.func == "count" else a.type
            merge_aggs.append(E.AggCall(func, col, False, out_t))
        merge_schema = tuple(
            list(partial_schema[:ngroups])
            + [
                L.OutCol(f"__m{i}", a.type, pdicts[i])
                for i, a in enumerate(merge_aggs)
            ]
        )
        merged = L.Aggregate(src, merge_groups, tuple(merge_aggs), merge_schema)

        # finalize: map back to the original output (avg = sum/count)
        final_exprs: list[E.TExpr] = [
            E.Col(i, g.type) for i, g in enumerate(plan.group_exprs)
        ]
        for a, slot in zip(plan.aggs, slots):
            if a.func == "avg":
                s = E.Col(ngroups + slot[0], merge_aggs[slot[0]].type)
                c = E.Col(ngroups + slot[1], t.INT8)
                # CastE DECIMAL->FLOAT8 already divides by the scale factor
                num = E.CastE(s, t.FLOAT8)
                final_exprs.append(
                    E.BinE("/", num, E.CastE(c, t.FLOAT8), t.FLOAT8)
                )
            else:
                mi = slot[0]
                col = E.Col(ngroups + mi, merge_aggs[mi].type)
                final_exprs.append(
                    E.CastE(col, a.type) if col.type != a.type else col
                )
        final = L.Project(merged, tuple(final_exprs), plan.schema)
        return final, Dist.single(COORDINATOR)

    def _d_distinct(self, plan: L.Distinct):
        child, dist = self._walk(plan.child)
        if dist.is_single or dist.kind == "replicated":
            node = dist.nodes[0] if not dist.is_single else dist.nodes[0]
            return L.Distinct(child, plan.schema), (
                dist if dist.is_single else Dist.single(node)
            )
        # partial dedup per node, gather, final dedup
        partial = L.Distinct(child, plan.schema)
        src = self._cut(partial, dist.nodes, "gather")
        return L.Distinct(src, plan.schema), Dist.single(COORDINATOR)

    # -- joins -------------------------------------------------------------
    def _d_join(self, plan: L.Join):
        left, ldist = self._walk(plan.left)
        right, rdist = self._walk(plan.right)
        jt = plan.join_type

        def rebuild(lc, rc):
            return L.Join(
                lc, rc, jt, plan.left_keys, plan.right_keys, plan.residual, plan.schema
            )

        # both single on the coordinator
        if ldist.is_single and rdist.is_single:
            lc = self._to_single(left, ldist)
            rc = self._to_single(right, rdist)
            return rebuild(lc, rc), Dist.single(COORDINATOR)

        # both replicated: every node holds both inputs entirely — run on
        # exactly one (preferred-node read, locator.c REPLICATED select)
        if ldist.kind == "replicated" and rdist.kind == "replicated":
            common = [n for n in ldist.nodes if n in rdist.nodes]
            if common:
                return rebuild(left, right), Dist.single(common[0])

        out_key_positions = self._join_out_keys(plan, ldist, jt)

        # replicated inner side: join runs where the outer side lives
        # (not FULL: each node would emit the replica's unmatched rows
        # once per left shard)
        if (
            rdist.kind == "replicated" and ldist.kind == "sharded"
            and jt != "full"
        ):
            if set(ldist.nodes) <= set(rdist.nodes):
                return rebuild(left, right), Dist.sharded(
                    ldist.nodes, ldist.strategy, out_key_positions
                )
        if (
            ldist.kind == "replicated"
            and rdist.kind == "sharded"
            and jt == "inner"
        ):
            if set(rdist.nodes) <= set(ldist.nodes):
                nleft = len(plan.left.schema)
                rpos = tuple(
                    nleft + p for p in rdist.key_positions
                ) if rdist.key_positions else ()
                return rebuild(left, right), Dist.sharded(
                    rdist.nodes, rdist.strategy, rpos
                )

        # colocated shard-to-shard join
        if self._colocated(plan, ldist, rdist):
            return rebuild(left, right), Dist.sharded(
                ldist.nodes, ldist.strategy, out_key_positions
            )

        # cost-based motion choice (redistribute_path vs broadcast,
        # pathnode.c:1469): when one side is estimated much smaller,
        # broadcast it to the other side's nodes and keep the big side
        # in place instead of reshuffling both.
        if plan.left_keys and ldist.kind == "sharded" and (
            rdist.kind in ("sharded", "single")
        ):
            from opentenbase_tpu_torch.plan import costs

            lest = costs.estimate_rows(plan.left, self.catalog)
            rest = costs.estimate_rows(plan.right, self.catalog)
            if (
                jt in ("inner", "left", "semi", "anti")
                and rest * 8 < lest and rest <= 100_000
            ):
                # small right side -> every left node. Only join types
                # that preserve the LEFT side: a right/full join would
                # emit each unmatched broadcast row once per left shard
                rsrc = self._motion_broadcast(right, rdist, ldist.nodes)
                return rebuild(left, rsrc), Dist.sharded(
                    ldist.nodes, ldist.strategy, out_key_positions
                )
            if (
                jt == "inner"
                and rdist.kind == "sharded"
                and lest * 8 < rest
                and lest <= 100_000
            ):
                # small left side -> every right node (inner only: a
                # broadcast probe side would duplicate semi/anti/outer
                # output rows)
                lsrc = self._motion_broadcast(left, ldist, rdist.nodes)
                nleft = len(plan.left.schema)
                rpos = tuple(
                    nleft + p for p in rdist.key_positions
                ) if rdist.key_positions else ()
                return rebuild(lsrc, right), Dist.sharded(
                    rdist.nodes, rdist.strategy, rpos
                )

        # general case: redistribute both sides by the join keys onto the
        # union nodeset (the squeue all-to-all, squeue.c:403+). Sides whose
        # keys are not simple columns are first projected to append the key.
        if not plan.left_keys:
            # cross join: broadcast the right side to the left's nodes
            if ldist.kind == "sharded":
                rsrc = self._motion_broadcast(right, rdist, ldist.nodes)
                return rebuild(left, rsrc), Dist.sharded(
                    ldist.nodes, ldist.strategy, out_key_positions
                )
            lc = self._to_single(left, ldist)
            rc = self._to_single(right, rdist)
            return rebuild(lc, rc), Dist.single(COORDINATOR)

        dest = tuple(
            sorted(set(ldist.nodes) | set(rdist.nodes))
            if ldist.kind == "sharded" and rdist.kind == "sharded"
            else (ldist.nodes if ldist.kind == "sharded" else rdist.nodes)
        )

        lsrc = self._motion_by_keys(
            left, ldist, plan.left_keys, dest, force=(jt == "full")
        )
        rsrc = self._motion_by_keys(
            right, rdist, plan.right_keys, dest, force=(jt == "full")
        )
        return rebuild(lsrc, rsrc), Dist.sharded(dest, DistStrategy.HASH, ())

    def _join_out_keys(self, plan: L.Join, ldist: Dist, jt: str):
        """Left-side key positions survive into the join output (left
        columns come first; semi/anti output only left columns). A
        FULL join null-extends the left side for unmatched right rows,
        so its output is NOT distributed by the left key — downstream
        dist-key shortcuts (grouping, FQS) must not assume it."""
        if jt == "full":
            return ()
        if ldist.kind != "sharded" or not ldist.key_positions:
            return ()
        return ldist.key_positions

    def _colocated(self, plan: L.Join, ldist: Dist, rdist: Dist) -> bool:
        if ldist.kind != "sharded" or rdist.kind != "sharded":
            return False
        if not ldist.key_positions or not rdist.key_positions:
            return False
        if ldist.strategy != rdist.strategy or ldist.nodes != rdist.nodes:
            return False
        if len(ldist.key_positions) != len(rdist.key_positions):
            return False
        # every (ldist key[i], rdist key[i]) pair must be equated
        pairs = set()
        for lk, rk in zip(plan.left_keys, plan.right_keys):
            li = _base_col(lk)
            ri = _base_col(rk)
            if li is not None and ri is not None:
                pairs.add((li, ri))
        want = list(zip(ldist.key_positions, rdist.key_positions))
        return all(p in pairs for p in want)

    def _motion_by_keys(self, plan, dist, keys, dest, force=False):
        """Redistribute ``plan`` by hash of join ``keys`` onto ``dest``.
        ``force`` redistributes even a replicated input — required for
        FULL joins, where an in-place replica would emit its unmatched
        rows once per dest node."""
        src_override = None
        if (
            dist.kind == "sharded"
            and dist.strategy == DistStrategy.HASH
            and dist.nodes == dest
            and dist.key_positions
            and len(keys) == len(dist.key_positions)
            and all(
                _base_col(k) == p for k, p in zip(keys, dist.key_positions)
            )
        ):
            return plan  # already hash-placed on these keys
        if dist.kind == "replicated":
            if not force and set(dest) <= set(dist.nodes):
                return plan
            # one replica is the truth: produce from a single node so
            # every row redistributes exactly once
            src_override = tuple(dist.nodes[:1])
        # ensure keys are plain output columns; append via Project if not
        positions = []
        exprs = None
        for k in keys:
            bc = _base_col(k)
            if bc is None:
                exprs = True
                break
            positions.append(bc)
        src_plan = plan
        if exprs:
            n = len(plan.schema)
            proj_exprs = tuple(
                [E.Col(i, c.type, c.name) for i, c in enumerate(plan.schema)]
                + list(keys)
            )
            proj_schema = tuple(
                list(plan.schema)
                + [L.OutCol(f"__k{i}", k.type) for i, k in enumerate(keys)]
            )
            src_plan = L.Project(plan, proj_exprs, proj_schema)
            positions = [n + i for i in range(len(keys))]
        src_nodes = (
            src_override if src_override is not None else dist.nodes
        )
        rs = self._cut(
            src_plan,
            src_nodes,
            "redistribute",
            tuple(positions),
            tuple(dest),
        )
        if exprs:
            # hide the appended key columns again
            back = tuple(
                E.Col(i, c.type, c.name) for i, c in enumerate(plan.schema)
            )
            return L.Project(rs, back, plan.schema)
        return rs

    def _motion_broadcast(self, plan, dist, dest):
        if dist.kind == "replicated" and set(dest) <= set(dist.nodes):
            return plan
        return self._cut(plan, dist.nodes, "broadcast", dest_nodes=tuple(dest))

    def _d_window(self, plan: L.Window):
        """Window functions need every row of a partition in one place;
        gather to the coordinator and evaluate there (the reference plans
        WindowAgg above the remote gather the same way unless the
        distribution happens to match the PARTITION BY — a colocation
        optimization left for later)."""
        child, dist = self._walk(plan.child)
        if dist.is_single:
            return L.Window(child, plan.specs, plan.schema), dist
        if dist.kind == "replicated":
            return (
                L.Window(child, plan.specs, plan.schema),
                Dist.single(dist.nodes[0]),
            )
        src = self._cut(child, dist.nodes, "gather")
        return (
            L.Window(src, plan.specs, plan.schema),
            Dist.single(COORDINATOR),
        )

    # -- sort / limit ------------------------------------------------------
    def _d_sort(self, plan: L.Sort):
        child, dist = self._walk(plan.child)
        if dist.is_single:
            return L.Sort(child, plan.keys, plan.schema), dist
        if dist.kind == "replicated":
            return L.Sort(child, plan.keys, plan.schema), Dist.single(dist.nodes[0])
        # local sort per node, merge-gather at the coordinator
        local = L.Sort(child, plan.keys, plan.schema)
        src = self._cut(local, dist.nodes, "gather", merge_keys=plan.keys)
        return L.Sort(src, plan.keys, plan.schema), Dist.single(COORDINATOR)

    def _d_limit(self, plan: L.Limit):
        child, dist = self._walk(plan.child)
        if dist.is_single:
            return L.Limit(child, plan.limit, plan.offset, plan.schema), dist
        if dist.kind == "replicated":
            return (
                L.Limit(child, plan.limit, plan.offset, plan.schema),
                Dist.single(dist.nodes[0]),
            )
        # push limit+offset below the gather, re-apply above (the
        # reference's limit pushdown, v2.4 release note item 3)
        if plan.limit is not None:
            pushed = L.Limit(child, plan.limit + plan.offset, 0, plan.schema)
        else:
            pushed = child
        src = self._cut(pushed, dist.nodes, "gather")
        return (
            L.Limit(src, plan.limit, plan.offset, plan.schema),
            Dist.single(COORDINATOR),
        )

    def _d_union(self, plan: L.Union):
        parts = []
        for inp in plan.inputs:
            p, d = self._walk(inp)
            parts.append(self._to_single(p, d))
        return L.Union(tuple(parts), plan.schema), Dist.single(COORDINATOR)

    def _d_remotesource(self, plan: RemoteSource):
        # already cut (shouldn't recurse here, but harmless)
        return plan, Dist.single(COORDINATOR)


def _base_col(e: E.TExpr) -> Optional[int]:
    """Output column position a key expression reduces to (through casts)."""
    if isinstance(e, E.Col):
        return e.index
    if isinstance(e, E.CastE):
        return _base_col(e.operand)
    return None


def distribute_statement(
    splan: L.StatementPlan, catalog: Catalog
) -> DistributedPlan:
    return Distributor(catalog).distribute(splan)

"""Logical plan optimization passes.

The slice of src/backend/optimizer we need for a columnar engine where
scans dominate:

- **Predicate pushdown + join-key extraction** (``pushdown_predicates``):
  WHERE conjuncts sink to the side of a join they reference, and
  cross-side equality conjuncts become the join's equi-keys — how
  comma-FROM queries (``FROM a, b WHERE a.x = b.y``) get real equi-joins.
  The reference does this in deconstruct_jointree / distribute_qual_to_rels
  (src/backend/optimizer/plan/initsplan.c).
- **Projection (column) pruning** (``prune_columns``) so Scans only
  materialize referenced columns — the columnar equivalent of PG's
  physical-tlist optimization (use_physical_tlist, createplan.c).

``optimize_statement`` runs both in order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.plan import logical as L
from opentenbase_tpu_torch.plan import texpr as E


def optimize_statement(
    plan: L.StatementPlan, catalog=None
) -> L.StatementPlan:
    plan = pushdown_predicates(plan)
    if catalog is not None:
        plan = reorder_joins(plan, catalog)
    return prune_columns(plan)


# ---------------------------------------------------------------------------
# Cost-based join reordering (make_join_rel / join_search_one_level,
# src/backend/optimizer/path/joinrels.c — greedy left-deep instead of DP)
# ---------------------------------------------------------------------------


def reorder_joins(plan: L.StatementPlan, catalog) -> L.StatementPlan:
    return L.StatementPlan(
        _reorder(plan.root, catalog),
        [_reorder(s, catalog) for s in plan.subplans],
    )


def _reorder(plan: L.LogicalPlan, catalog) -> L.LogicalPlan:
    if isinstance(plan, L.Join) and plan.join_type == "inner":
        # flatten the MAXIMAL inner-join cluster first, then recurse
        # only into its atomic inputs — recursing into Join children
        # first would wrap sub-clusters in Projects and hide the full
        # cluster from the greedy pass (4+ table joins would never see
        # all their inputs together)
        inputs, edges, residuals = _flatten_inner(plan)
        inputs = [(_reorder(p, catalog), off) for p, off in inputs]
        if len(inputs) >= 3:
            out = _greedy_order(plan, (inputs, edges, residuals), catalog)
            if out is not None:
                return out
        return _rebuild_cluster(plan, dict(
            (off, p) for p, off in inputs
        ))
    # non-cluster nodes: nested clusters under atomic inputs (semi
    # joins, aggregates) reorder independently
    return _map_children(plan, lambda p: _reorder(p, catalog))


def _rebuild_cluster(node: L.LogicalPlan, by_offset, offset=0):
    """Reconstruct an inner-join cluster with its (possibly reordered-
    internally) atomic inputs swapped in, preserving structure."""
    if isinstance(node, L.Join) and node.join_type == "inner":
        lw = _cluster_width(node.left)
        left = _rebuild_cluster(node.left, by_offset, offset)
        right = _rebuild_cluster(node.right, by_offset, offset + lw)
        return dataclasses.replace(node, left=left, right=right)
    return by_offset.get(offset, node)


def _cluster_width(node: L.LogicalPlan) -> int:
    return len(node.schema)


def _shift_cols(e: E.TExpr, delta: int) -> E.TExpr:
    if delta == 0:
        return e
    hi = E.max_col_index(e)
    return _remap_expr(e, {i: i + delta for i in range(hi + 1)})


def _flatten_inner(join: L.Join):
    """Flatten a maximal inner-equi-join tree into
    (inputs, edges, residuals) where inputs are (plan, offset) in the
    original concatenated column layout, and edges/residuals are exprs
    rebased to that global layout."""
    inputs: list[tuple[L.LogicalPlan, int]] = []
    edges: list[tuple[E.TExpr, E.TExpr]] = []
    residuals: list[E.TExpr] = []

    def walk(node, offset) -> int:
        if isinstance(node, L.Join) and node.join_type == "inner":
            lw = walk(node.left, offset)
            rw = walk(node.right, offset + lw)
            for lk, rk in zip(node.left_keys, node.right_keys):
                edges.append(
                    (_shift_cols(lk, offset), _shift_cols(rk, offset + lw))
                )
            if node.residual is not None:
                residuals.extend(
                    _shift_cols(c, offset)
                    for c in E.conjuncts(node.residual)
                )
            return lw + rw
        inputs.append((node, offset))
        return len(node.schema)

    walk(join, 0)
    return inputs, edges, residuals


def _greedy_order(join: L.Join, flat, catalog) -> Optional[L.LogicalPlan]:
    """Left-deep greedy join order: start from the smallest input, then
    repeatedly join the connected input producing the smallest estimated
    intermediate. Output column order is restored with a final Project,
    so the rewrite is invisible above."""
    from opentenbase_tpu_torch.plan import costs

    memo: dict = {}  # shared across all estimates in this ordering
    inputs, edges, residuals = flat
    n = len(inputs)
    total = sum(len(p.schema) for p, _ in inputs)
    owner_of: dict[int, int] = {}
    for i, (p, off) in enumerate(inputs):
        for k in range(len(p.schema)):
            owner_of[off + k] = i

    def owners(e) -> set:
        return {
            owner_of[c.index]
            for c in E.walk(e)
            if isinstance(c, E.Col)
        }

    # pending work items: ("edge", lk, rk, lown, rown) | ("res", c, own)
    pend: list = []
    for lk, rk in edges:
        lo, ro = owners(lk), owners(rk)
        if not lo or not ro:
            pend.append(("res", E.BinE("=", lk, rk, t.BOOL), lo | ro))
        else:
            pend.append(("edge", lk, rk, lo, ro))
    for c in residuals:
        pend.append(("res", c, owners(c)))

    est = [costs.estimate_rows(p, catalog, memo) for p, _ in inputs]
    connected = set()
    for item in pend:
        if item[0] == "edge":
            connected |= item[3] | item[4]
    start = min(
        range(n),
        key=lambda i: (i not in connected, est[i]),
    )
    placed = {start}
    cur = inputs[start][0]
    pos = {
        inputs[start][1] + k: k
        for k in range(len(inputs[start][0].schema))
    }
    cur_rows = est[start]

    def usable_edges(j):
        """Edges joinable when adding input j to the placed set."""
        out = []
        for item in pend:
            if item[0] != "edge":
                continue
            _t, lk, rk, lo, ro = item
            if lo <= placed and ro == {j}:
                out.append((item, lk, rk, False))
            elif ro <= placed and lo == {j}:
                out.append((item, rk, lk, True))
        return out

    while len(placed) < n:
        best_j, best_score, best_edges = None, None, []
        for j in range(n):
            if j in placed:
                continue
            ue = usable_edges(j)
            if not ue:
                continue
            ndv = costs.DEFAULT_NDV
            for _item, pk, jk, swapped in ue:
                pn = costs.expr_ndv(
                    _remap_expr(pk, pos), cur, catalog, memo
                ) or costs.DEFAULT_NDV
                jn = costs.expr_ndv(
                    _shift_cols(jk, -inputs[j][1]), inputs[j][0],
                    catalog, memo,
                ) or costs.DEFAULT_NDV
                ndv = max(ndv, pn, jn)
            score = cur_rows * est[j] / ndv
            if best_score is None or score < best_score:
                best_j, best_score, best_edges = j, score, ue
        if best_j is None:
            # no connected input: cross-join the smallest remaining
            best_j = min(
                (j for j in range(n) if j not in placed),
                key=lambda j: est[j],
            )
            best_edges = []
        jplan, joff = inputs[best_j]
        jwidth = len(jplan.schema)
        ncur = len(cur.schema)
        lkeys, rkeys = [], []
        for item, pk, jk, _swapped in best_edges:
            pend.remove(item)
            lkeys.append(_remap_expr(pk, pos))
            rkeys.append(_shift_cols(jk, -joff))
        new_pos = dict(pos)
        for k in range(jwidth):
            new_pos[joff + k] = ncur + k
        placed.add(best_j)
        # residuals (and edges never usable as keys, e.g. a side
        # spanning several inputs) whose inputs are all placed now
        res_here = []
        for item in list(pend):
            if item[0] == "res":
                if item[2] <= placed:
                    res_here.append(_remap_expr(item[1], new_pos))
                    pend.remove(item)
            elif (item[3] | item[4]) <= placed:
                res_here.append(_remap_expr(
                    E.BinE("=", item[1], item[2], t.BOOL), new_pos
                ))
                pend.remove(item)
        schema = tuple(cur.schema) + tuple(jplan.schema)
        cur = L.Join(
            cur, jplan, "inner", tuple(lkeys), tuple(rkeys),
            _and_all(res_here), schema,
        )
        pos = new_pos
        cur_rows = costs.estimate_rows(cur, catalog, memo)

    # anything never swept (it referenced only the very first input)
    leftover = []
    for item in pend:
        if item[0] == "res":
            leftover.append(_remap_expr(item[1], pos))
        else:
            leftover.append(_remap_expr(
                E.BinE("=", item[1], item[2], t.BOOL), pos
            ))
    if leftover:
        cur = L.Filter(cur, _and_all(leftover), cur.schema)

    # restore the original column order so the rewrite is transparent
    exprs = tuple(
        E.Col(pos[g], join.schema[g].type, join.schema[g].name)
        for g in range(total)
    )
    if all(pos[g] == g for g in range(total)):
        return cur
    return L.Project(cur, exprs, join.schema)


def prune_columns(plan: L.StatementPlan) -> L.StatementPlan:
    root = _prune(plan.root, None)
    subplans = [_prune(s, None) for s in plan.subplans]
    return L.StatementPlan(root, subplans)


# ---------------------------------------------------------------------------
# Predicate pushdown + join-key extraction
# ---------------------------------------------------------------------------


def pushdown_predicates(plan: L.StatementPlan) -> L.StatementPlan:
    return L.StatementPlan(
        _push(plan.root), [_push(s) for s in plan.subplans]
    )


def _and_all(conjs: list[E.TExpr]) -> Optional[E.TExpr]:
    if not conjs:
        return None
    out = conjs[0]
    for c in conjs[1:]:
        out = E.BinE("and", out, c, t.BOOL)
    return out


def _col_sides(e: E.TExpr, nleft: int) -> set[str]:
    sides: set[str] = set()
    for n in E.walk(e):
        if isinstance(n, E.Col):
            sides.add("L" if n.index < nleft else "R")
    return sides


def _subquery_free(e: E.TExpr) -> bool:
    return not any(isinstance(n, E.SubqueryParam) for n in E.walk(e))


def _shift_right(e: E.TExpr, nleft: int, ntotal: int) -> E.TExpr:
    mapping = {i: i - nleft for i in range(nleft, ntotal)}
    for i in range(nleft):
        mapping[i] = i  # unused, but keeps _remap_expr total
    return _remap_expr(e, mapping)


def _push(plan: L.LogicalPlan) -> L.LogicalPlan:
    if isinstance(plan, L.Filter):
        child = plan.child
        if isinstance(child, L.Filter):
            merged = L.Filter(
                child.child,
                E.BinE("and", child.predicate, plan.predicate, t.BOOL),
                child.child.schema,
            )
            return _push(merged)
        if isinstance(child, L.Join):
            jt = child.join_type
            if jt == "inner":
                j, _changed = _filter_into_join(child, plan.predicate)
                return _push_join_children(j)
            if jt in ("semi", "anti"):
                # output schema == left schema: the filter commutes with
                # the existence test
                new_left = L.Filter(
                    child.left, plan.predicate, child.left.schema
                )
                return _push(dataclasses.replace(child, left=new_left))
            if jt == "left":
                nleft = len(child.left.schema)
                down, keep = [], []
                for c in E.conjuncts(plan.predicate):
                    sides = _col_sides(c, nleft)
                    if sides <= {"L"} and _subquery_free(c):
                        down.append(c)
                    else:
                        keep.append(c)
                if down:
                    new_left = L.Filter(
                        child.left, _and_all(down), child.left.schema
                    )
                    j = _push_join_children(
                        dataclasses.replace(child, left=new_left)
                    )
                    if keep:
                        return L.Filter(j, _and_all(keep), plan.schema)
                    return j
        return L.Filter(_push(child), plan.predicate, plan.schema)

    if isinstance(plan, L.Join) and plan.join_type == "inner" and (
        plan.residual is not None
    ):
        base = dataclasses.replace(plan, residual=None)
        j, changed = _filter_into_join(base, plan.residual)
        if changed:
            return _push_join_children(j)
        return _push_join_children(plan)

    return _map_children(plan, _push)


def _push_join_children(j: L.Join) -> L.Join:
    return dataclasses.replace(
        j, left=_push(j.left), right=_push(j.right)
    )


def _filter_into_join(
    join: L.Join, pred: E.TExpr
) -> tuple[L.Join, bool]:
    """Split ``pred``'s conjuncts over an inner join: single-side
    conjuncts sink into that side, cross-side equalities become join
    keys, the rest stays as the join residual. Returns (join, changed) —
    changed means at least one conjunct sank or became a key (so the
    caller knows the residual shrank and re-processing terminates)."""
    nleft = len(join.left.schema)
    ntotal = len(join.schema)
    left_down: list[E.TExpr] = []
    right_down: list[E.TExpr] = []
    lkeys: list[E.TExpr] = []
    rkeys: list[E.TExpr] = []
    rest: list[E.TExpr] = []
    changed = False
    # fold the join's pre-existing residual through the same
    # classification: ON-clause extras sink/key-extract exactly like
    # WHERE conjuncts
    all_conjs = list(E.conjuncts(pred))
    if join.residual is not None:
        all_conjs += list(E.conjuncts(join.residual))
    for c in all_conjs:
        sides = _col_sides(c, nleft)
        if not _subquery_free(c):
            rest.append(c)
            continue
        if sides <= {"L"}:
            left_down.append(c)
            changed = True
            continue
        if sides <= {"R"}:
            right_down.append(_shift_right(c, nleft, ntotal))
            changed = True
            continue
        pair = _equi_pair(c, nleft, ntotal)
        if pair is not None:
            lk, rk = pair
            lkeys.append(lk)
            rkeys.append(rk)
            changed = True
            continue
        rest.append(c)
    left = join.left
    if left_down:
        left = L.Filter(left, _and_all(left_down), left.schema)
    right = join.right
    if right_down:
        right = L.Filter(right, _and_all(right_down), right.schema)
    out = L.Join(
        left,
        right,
        join.join_type,
        tuple(join.left_keys) + tuple(lkeys),
        tuple(join.right_keys) + tuple(rkeys),
        _and_all(rest),
        join.schema,
    )
    return out, changed


def _equi_pair(
    c: E.TExpr, nleft: int, ntotal: int
) -> Optional[tuple[E.TExpr, E.TExpr]]:
    """``left_expr = right_expr`` across the join boundary (either
    orientation) -> (left_key, right_key) with the right key rebased to
    the right child's schema."""
    if not (isinstance(c, E.BinE) and c.op == "="):
        return None
    a_sides = _col_sides(c.left, nleft)
    b_sides = _col_sides(c.right, nleft)
    if a_sides == {"L"} and b_sides == {"R"}:
        return c.left, _shift_right(c.right, nleft, ntotal)
    if a_sides == {"R"} and b_sides == {"L"}:
        return c.right, _shift_right(c.left, nleft, ntotal)
    return None


def _map_children(plan: L.LogicalPlan, fn) -> L.LogicalPlan:
    """Rebuild a node with ``fn`` applied to its child plan(s)."""
    if isinstance(plan, (L.Scan, L.ValuesScan)):
        return plan
    changes = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, L.LogicalPlan):
            changes[f.name] = fn(v)
        elif (
            isinstance(v, tuple) and v
            and all(isinstance(x, L.LogicalPlan) for x in v)
        ):
            changes[f.name] = tuple(fn(x) for x in v)
    if not changes:
        return plan
    return dataclasses.replace(plan, **changes)


def _remap_expr(e: E.TExpr, mapping: dict[int, int]) -> E.TExpr:
    if isinstance(e, E.Col):
        return E.Col(mapping[e.index], e.type, e.name)
    if isinstance(e, E.BinE):
        return E.BinE(e.op, _remap_expr(e.left, mapping), _remap_expr(e.right, mapping), e.type)
    if isinstance(e, E.UnaryE):
        return E.UnaryE(e.op, _remap_expr(e.operand, mapping), e.type)
    if isinstance(e, E.FuncE):
        return E.FuncE(e.name, tuple(_remap_expr(a, mapping) for a in e.args), e.type)
    if isinstance(e, E.CaseE):
        whens = tuple(
            (_remap_expr(c, mapping), _remap_expr(v, mapping)) for c, v in e.whens
        )
        default = _remap_expr(e.default, mapping) if e.default is not None else None
        return E.CaseE(whens, default, e.type)
    if isinstance(e, E.CastE):
        return E.CastE(_remap_expr(e.operand, mapping), e.type)
    if isinstance(e, E.IsNullE):
        return E.IsNullE(_remap_expr(e.operand, mapping), e.negated)
    if isinstance(e, E.InListE):
        return E.InListE(_remap_expr(e.operand, mapping), e.items, e.negated)
    if isinstance(e, E.LikeE):
        return E.LikeE(_remap_expr(e.operand, mapping), e.pattern, e.ilike, e.negated)
    return e  # Const, SubqueryParam


def _used_cols(e: E.TExpr, acc: set[int]) -> None:
    for n in E.walk(e):
        if isinstance(n, E.Col):
            acc.add(n.index)


def _prune(plan: L.LogicalPlan, required: Optional[set[int]]) -> L.LogicalPlan:
    """Rewrite ``plan`` so unused Scan columns underneath are pruned
    (``required`` = output columns the caller needs, None = all)."""
    new_plan, _ = _prune_node(plan, required)
    return new_plan


def _identity(n: int) -> dict[int, int]:
    return {i: i for i in range(n)}


def _prune_node(plan: L.LogicalPlan, required: Optional[set[int]]):
    n_out = len(plan.schema)
    req = set(range(n_out)) if required is None else set(required)

    if isinstance(plan, L.Scan):
        keep = sorted(req)
        if len(keep) == n_out:
            return plan, _identity(n_out)
        if not keep:
            keep = [0] if n_out else []  # keep one column for row count
        columns = tuple(plan.columns[i] for i in keep)
        schema = tuple(plan.schema[i] for i in keep)
        mapping = {old: new for new, old in enumerate(keep)}
        return L.Scan(plan.table, columns, schema), mapping

    if isinstance(plan, L.ValuesScan):
        keep = sorted(req)
        if len(keep) == n_out:
            return plan, _identity(n_out)
        rows = tuple(tuple(row[i] for i in keep) for row in plan.rows)
        schema = tuple(plan.schema[i] for i in keep)
        mapping = {old: new for new, old in enumerate(keep)}
        return L.ValuesScan(rows, schema), mapping

    if isinstance(plan, L.Filter):
        child_req = set(req)
        _used_cols(plan.predicate, child_req)
        child, cmap = _prune_node(plan.child, child_req)
        pred = _remap_expr(plan.predicate, cmap)
        # Filter passes through child columns; output = child output
        schema = child.schema
        newp = L.Filter(child, pred, schema)
        return newp, cmap

    if isinstance(plan, L.Project):
        keep = sorted(req)
        child_req: set[int] = set()
        for i in keep:
            _used_cols(plan.exprs[i], child_req)
        child, cmap = _prune_node(plan.child, child_req)
        exprs = tuple(_remap_expr(plan.exprs[i], cmap) for i in keep)
        schema = tuple(plan.schema[i] for i in keep)
        mapping = {old: new for new, old in enumerate(keep)}
        return L.Project(child, exprs, schema), mapping

    if isinstance(plan, L.Aggregate):
        # Always keep all group cols (grouping semantics); prune agg results.
        ngroups = len(plan.group_exprs)
        keep_aggs = sorted(i - ngroups for i in req if i >= ngroups)
        child_req: set[int] = set()
        for g in plan.group_exprs:
            _used_cols(g, child_req)
        for ai in keep_aggs:
            a = plan.aggs[ai]
            if a.arg is not None:
                _used_cols(a.arg, child_req)
        child, cmap = _prune_node(plan.child, child_req)
        group_exprs = tuple(_remap_expr(g, cmap) for g in plan.group_exprs)
        aggs = tuple(
            E.AggCall(
                plan.aggs[ai].func,
                _remap_expr(plan.aggs[ai].arg, cmap) if plan.aggs[ai].arg is not None else None,
                plan.aggs[ai].distinct,
                plan.aggs[ai].type,
            )
            for ai in keep_aggs
        )
        schema = tuple(plan.schema[:ngroups]) + tuple(
            plan.schema[ngroups + ai] for ai in keep_aggs
        )
        mapping = {i: i for i in range(ngroups)}
        for new, ai in enumerate(keep_aggs):
            mapping[ngroups + ai] = ngroups + new
        return L.Aggregate(child, group_exprs, aggs, schema), mapping

    if isinstance(plan, L.Join):
        nleft = len(plan.left.schema)
        semi = plan.join_type in ("semi", "anti")
        left_req: set[int] = set()
        right_req: set[int] = set()
        for i in req:
            if i < nleft:
                left_req.add(i)
            else:
                right_req.add(i - nleft)
        for k in plan.left_keys:
            _used_cols(k, left_req)
        for k in plan.right_keys:
            _used_cols(k, right_req)
        if plan.residual is not None:
            res_cols: set[int] = set()
            _used_cols(plan.residual, res_cols)
            for i in res_cols:
                if i < nleft:
                    left_req.add(i)
                else:
                    right_req.add(i - nleft)
        left, lmap = _prune_node(plan.left, left_req)
        right, rmap = _prune_node(plan.right, right_req)
        nleft_new = len(left.schema)
        left_keys = tuple(_remap_expr(k, lmap) for k in plan.left_keys)
        right_keys = tuple(_remap_expr(k, rmap) for k in plan.right_keys)
        combo_map: dict[int, int] = {}
        for old, new in lmap.items():
            combo_map[old] = new
        if not semi:
            for old, new in rmap.items():
                combo_map[nleft + old] = nleft_new + new
        residual = (
            _remap_expr(plan.residual, combo_map) if plan.residual is not None else None
        )
        if semi:
            schema = left.schema
        else:
            schema = tuple(left.schema) + tuple(right.schema)
        newp = L.Join(
            left, right, plan.join_type, left_keys, right_keys, residual, schema
        )
        return newp, combo_map

    if isinstance(plan, (L.Sort, L.Limit, L.Distinct)):
        # These pass through all child columns; keep them all (Distinct's
        # semantics depend on the full column set anyway).
        if isinstance(plan, L.Sort):
            child_req = set(range(len(plan.child.schema)))
            child, cmap = _prune_node(plan.child, child_req)
            keys = tuple(
                L.SortKey(_remap_expr(k.expr, cmap), k.descending, k.nulls_first)
                for k in plan.keys
            )
            return L.Sort(child, keys, child.schema), cmap
        child, cmap = _prune_node(plan.child, set(range(len(plan.child.schema))))
        if isinstance(plan, L.Limit):
            return L.Limit(child, plan.limit, plan.offset, child.schema), cmap
        return L.Distinct(child, child.schema), cmap

    if isinstance(plan, L.Window):
        # window specs address child columns positionally; keep the whole
        # child (the prep projection already narrowed the inputs)
        child, cmap = _prune_node(
            plan.child, set(range(len(plan.child.schema)))
        )
        ident = all(cmap.get(i) == i for i in range(len(plan.child.schema)))
        if not ident:
            # child refused the identity layout: restore it explicitly
            exprs = tuple(
                E.Col(cmap[i], c.type, c.name)
                for i, c in enumerate(plan.child.schema)
            )
            child = L.Project(child, exprs, plan.child.schema)
        return (
            L.Window(child, plan.specs, plan.schema),
            {i: i for i in range(len(plan.schema))},
        )

    if isinstance(plan, L.Union):
        inputs = []
        keep = sorted(req)
        for inp in plan.inputs:
            ni, imap = _prune_node(inp, set(keep))
            # A child is free to ignore the hint (Sort/Limit/Distinct keep
            # everything); align it to exactly `keep` in order via its
            # returned mapping, adding a Project when it doesn't line up.
            want = [imap[i] for i in keep]
            if want != list(range(len(ni.schema))):
                exprs = tuple(
                    E.Col(j, ni.schema[j].type, ni.schema[j].name) for j in want
                )
                schema_i = tuple(ni.schema[j] for j in want)
                ni = L.Project(ni, exprs, schema_i)
            inputs.append(ni)
        mapping = {old: new for new, old in enumerate(keep)}
        schema = tuple(plan.schema[i] for i in keep)
        return L.Union(tuple(inputs), schema), mapping

    if isinstance(plan, L.InsertPlan):
        src, _ = _prune_node(plan.source, None)
        return L.InsertPlan(plan.table, src, plan.columns), {}

    if isinstance(plan, (L.UpdatePlan, L.DeletePlan)):
        return plan, {}

    raise TypeError(f"prune: unhandled node {type(plan).__name__}")

"""Recursive-descent SQL parser.

Hand-written equivalent of the slice of src/backend/parser/gram.y the
framework supports, including the XL cluster DDL productions
(gram.y:307-313 CREATE NODE..., :2694 DISTRIBUTE BY, :4275 interval
partitioning, :11589 MOVE DATA, :11601 CREATE BARRIER). Expressions use
precedence climbing (c_expr/a_expr equivalent).
"""

from __future__ import annotations

import dataclasses

from opentenbase_tpu_torch.sql import ast as A
from opentenbase_tpu_torch.sql.lexer import LexError, Tok, Token, tokenize


class ParseError(ValueError):
    pass


# aggregate names whose arguments see base rows, not group keys —
# the grouping-set NULL substitution must not descend into them
_GS_AGG_NAMES = {"sum", "count", "avg", "min", "max"}


def _gs_eq(a, b) -> bool:
    """Structural equality between a referenced expr and a grouping
    key, lenient about a missing table qualifier on either side
    (t.a matches key a) — the parser has no scope to resolve against,
    so this approximates the analyzer's semantic match."""
    if isinstance(a, A.ColumnRef) and isinstance(b, A.ColumnRef):
        return a.name == b.name and (
            a.table == b.table or a.table is None or b.table is None
        )
    if type(a) is not type(b):
        return a == b
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, (tuple, list)):
                if (
                    not isinstance(vb, (tuple, list))
                    or len(va) != len(vb)
                    or any(
                        not _gs_eq(x, y) for x, y in zip(va, vb)
                    )
                ):
                    return False
            elif not _gs_eq(va, vb):
                return False
        return True
    return a == b


def _gs_rewrite(e, removed, all_keys, err):
    """One grouping-set branch's expression rewrite: grouped-out key
    exprs become NULL, grouping(...) becomes its bitmask constant
    (1-bit per argument, leftmost = most significant, set when the
    argument is grouped out). Aggregate arguments and subquery bodies
    are left untouched."""
    if e is None:
        return None
    for k in removed:
        if _gs_eq(e, k):
            return A.Literal(None)
    if isinstance(e, A.FuncCall):
        name = e.name.lower()
        if name == "grouping":
            if not e.args:
                err("grouping() requires arguments")
            val = 0
            for a in e.args:
                if not any(_gs_eq(a, k) for k in all_keys):
                    err(
                        "arguments to grouping() must be "
                        "grouping expressions"
                    )
                val = val * 2 + (
                    1 if any(_gs_eq(a, k) for k in removed) else 0
                )
            return A.Literal(val)
        if name in _GS_AGG_NAMES:
            return e
    if isinstance(e, A.Select):
        return e
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        kw = {
            f.name: _gs_walk_val(
                getattr(e, f.name), removed, all_keys, err
            )
            for f in dataclasses.fields(e)
        }
        return dataclasses.replace(e, **kw)
    return e


def _gs_mentions_grouping(vals) -> bool:
    """Cheap scan for a grouping(...) call anywhere in the exprs."""
    stack = list(vals)
    while stack:
        x = stack.pop()
        if x is None or isinstance(x, A.Select):
            continue
        if isinstance(x, A.FuncCall) and x.name.lower() == "grouping":
            return True
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(
                getattr(x, f.name) for f in dataclasses.fields(x)
            )
    return False


def _gs_walk_val(v, removed, all_keys, err):
    if isinstance(v, A.Select):
        return v
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _gs_rewrite(v, removed, all_keys, err)
    if isinstance(v, tuple):
        return tuple(_gs_walk_val(x, removed, all_keys, err) for x in v)
    if isinstance(v, list):
        return [_gs_walk_val(x, removed, all_keys, err) for x in v]
    return v


# binary operator precedence (higher binds tighter)
_PRECEDENCE = {
    "or": 1,
    "and": 2,
    # NOT handled as prefix at level 3
    "=": 4, "<>": 4, "!=": 4, "<": 4, "<=": 4, ">": 4, ">=": 4,
    "like": 4, "ilike": 4, "in": 4, "between": 4, "is": 4, "not": 4,
    "||": 5,
    "+": 6, "-": 6,
    "*": 7, "/": 7, "%": 7,
    "^": 8,
}

_COMPARISON = {"=", "<>", "!=", "<", "<=", ">", ">="}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        try:
            self.tokens = tokenize(sql)
        except LexError as e:
            raise ParseError(str(e)) from None
        self.pos = 0

    # -- token helpers --------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.tokens[self.pos]

    def peek(self, offset: int = 0) -> Token:
        i = min(self.pos + offset, len(self.tokens) - 1)
        return self.tokens[i]

    def advance(self) -> Token:
        tok = self.cur
        if tok.kind != Tok.EOF:
            self.pos += 1
        return tok

    def at_kw(self, *words: str) -> bool:
        """True if the next tokens are these keywords (case-folded idents)."""
        for i, w in enumerate(words):
            t = self.peek(i)
            if t.kind != Tok.IDENT or t.value != w:
                return False
        return True

    def eat_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.pos += len(words)
            return True
        return False

    def expect_kw(self, *words: str) -> None:
        if not self.eat_kw(*words):
            self.error(f"expected {' '.join(words).upper()}")

    def at_op(self, op: str) -> bool:
        return self.cur.kind == Tok.OP and self.cur.value == op

    def eat_op(self, op: str) -> bool:
        if self.at_op(op):
            self.pos += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            self.error(f"expected {op!r}")

    def ident(self, what: str = "identifier") -> str:
        if self.cur.kind != Tok.IDENT:
            self.error(f"expected {what}")
        return self.advance().value

    def error(self, msg: str):
        tok = self.cur
        got = tok.value if tok.kind != Tok.EOF else "end of input"
        line = self.sql.count("\n", 0, tok.pos) + 1
        raise ParseError(f"syntax error: {msg}, got {got!r} (line {line})")

    # -- entry ----------------------------------------------------------
    def parse_statements(self) -> list[A.Statement]:
        out = []
        while self.cur.kind != Tok.EOF:
            if self.eat_op(";"):
                continue
            out.append(self.parse_statement())
            if self.cur.kind != Tok.EOF and not self.eat_op(";"):
                self.error("expected ';' between statements")
        return out

    def parse_statement(self) -> A.Statement:
        t = self.cur
        if t.kind == Tok.OP and t.value == "(":
            return self.parse_select()
        if t.kind != Tok.IDENT:
            self.error("expected statement")
        kw = t.value
        if kw in ("select", "values", "with", "table"):
            return self.parse_select()
        if kw == "insert":
            return self.parse_insert()
        if kw == "update":
            return self.parse_update()
        if kw == "delete":
            return self.parse_delete()
        if kw == "create":
            return self.parse_create()
        if kw == "refresh":
            self.advance()
            self.expect_kw("materialized")
            self.expect_kw("view")
            concurrently = bool(self.eat_kw("concurrently"))
            return A.RefreshMatview(
                self.ident("materialized view name"), concurrently
            )
        if kw == "drop":
            return self.parse_drop()
        if kw == "truncate":
            return self.parse_truncate()
        if kw == "copy":
            return self.parse_copy()
        if kw in ("begin", "start"):
            return self.parse_begin()
        if kw == "commit":
            self.advance()
            self.eat_kw("transaction") or self.eat_kw("work")
            if self.eat_kw("prepared"):
                return A.CommitPrepared(self._string_lit())
            return A.CommitStmt()
        if kw in ("rollback", "abort"):
            self.advance()
            self.eat_kw("transaction") or self.eat_kw("work")
            if self.eat_kw("prepared"):
                return A.RollbackPrepared(self._string_lit())
            if self.eat_kw("to"):
                self.eat_kw("savepoint")
                return A.RollbackToSavepoint(self.ident("savepoint name"))
            return A.RollbackStmt()
        if kw == "savepoint":
            self.advance()
            return A.SavepointStmt(self.ident("savepoint name"))
        if kw == "release":
            self.advance()
            self.eat_kw("savepoint")
            return A.ReleaseSavepoint(self.ident("savepoint name"))
        if kw == "prepare":
            self.advance()
            if self.eat_kw("transaction"):
                return A.PrepareTransaction(self._string_lit())
            # PREPARE name [(types)] AS statement (prepare.c)
            name = self.ident("statement name")
            if self.eat_op("("):
                # parameter types are accepted and inferred; skip with
                # paren-depth tracking (numeric(10,2) nests) and an EOF
                # guard (a truncated PREPARE must error, not spin)
                depth = 1
                while depth:
                    if self.cur.kind == Tok.EOF:
                        self.error("unterminated parameter type list")
                    if self.at_op("("):
                        depth += 1
                    elif self.at_op(")"):
                        depth -= 1
                    self.advance()
            self.expect_kw("as")
            return A.PrepareStmt(name, self.parse_statement())
        if kw == "deallocate":
            self.advance()
            self.eat_kw("prepare")
            if self.eat_kw("all"):
                return A.DeallocateStmt(None)
            return A.DeallocateStmt(self.ident("statement name"))
        if kw == "explain":
            return self.parse_explain()
        if kw == "vacuum":
            self.advance()
            name = self.ident("table name") if self.cur.kind == Tok.IDENT else None
            return A.VacuumStmt(name)
        if kw == "analyze":
            self.advance()
            name = self.ident("table name") if self.cur.kind == Tok.IDENT else None
            return A.AnalyzeStmt(name)
        if kw == "set":
            return self.parse_set()
        if kw == "reset":
            # RESET name == SET name TO DEFAULT (guc.c): value None is
            # the reset sentinel (_x_setstmt restores the registry /
            # conf-file default)
            self.advance()
            name = self.ident("setting name")
            while self.eat_op("."):
                name += "." + self.ident("setting name")
            return A.SetStmt(name, None)
        if kw == "show":
            self.advance()
            name = self.ident("setting name")
            while self.eat_op("."):  # namespaced custom GUCs
                name += "." + self.ident("setting name")
            return A.ShowStmt(name)
        if kw == "alter":
            return self.parse_alter()
        if kw == "move":
            return self.parse_move_data()
        if kw == "clean":
            self.advance()
            self.expect_kw("sharding")
            return A.CleanSharding()
        if kw == "pause":
            self.advance()
            self.expect_kw("cluster")
            return A.PauseCluster()
        if kw == "unpause":
            self.advance()
            self.expect_kw("cluster")
            return A.UnpauseCluster()
        if kw == "execute":
            return self.parse_execute_direct()
        if kw in ("audit", "noaudit"):
            self.advance()
            kind = self.ident("audit action")
            if kind not in (
                "all", "select", "insert", "update", "delete", "copy", "ddl"
            ):
                self.error(f"unknown audit action {kind!r}")
            relation = None
            db_user = None
            whenever = "all"
            while True:
                if self.eat_kw("on"):
                    relation = self.ident("relation")
                elif self.eat_kw("by"):
                    db_user = self.ident("user")
                elif kw == "audit" and self.eat_kw("whenever"):
                    neg = bool(self.eat_kw("not"))
                    self.expect_kw("successful")
                    whenever = "not successful" if neg else "successful"
                else:
                    break
            if kw == "audit":
                return A.AuditStmt(kind, relation, db_user, whenever)
            return A.NoAuditStmt(kind, relation, db_user)
        if kw == "lock":
            self.advance()
            self.eat_kw("table")
            name = self.ident("table name")
            mode = None
            if self.eat_kw("in"):
                words = [self.ident("lock mode")]
                while not self.at_kw("mode"):
                    words.append(self.ident("lock mode"))
                self.expect_kw("mode")
                mode = " ".join(words)
            nowait = bool(self.eat_kw("nowait"))
            return A.LockTable(name, mode, nowait)
        self.error(f"unsupported statement {kw.upper()}")

    # -- SELECT ---------------------------------------------------------
    def parse_select(self) -> A.Select:
        # WITH name [(cols)] AS (select), ... — parse.c's CTE list.
        # Non-recursive only: bodies are statement-scoped views,
        # expanded before analysis (plan/views.py expand_ctes).
        ctes = []
        recursive = False
        if self.eat_kw("with"):
            recursive = self.eat_kw("recursive")
            while True:
                cname = self.ident("CTE name")
                aliases = []
                if self.eat_op("("):
                    aliases.append(self.ident("column alias"))
                    while self.eat_op(","):
                        aliases.append(self.ident("column alias"))
                    self.expect_op(")")
                self.expect_kw("as")
                self.expect_op("(")
                body = self.parse_select()
                self.expect_op(")")
                ctes.append((cname, aliases, body))
                if not self.eat_op(","):
                    break
        sel = self._select_core()
        sel.ctes = ctes
        sel.ctes_recursive = recursive
        while True:
            if self.at_kw("union"):
                self.advance()
                op = "union all" if self.eat_kw("all") else "union"
            elif self.at_kw("intersect"):
                self.advance()
                op = "intersect"
            elif self.at_kw("except"):
                self.advance()
                op = "except"
            else:
                break
            sel.set_ops.append((op, self._select_core()))
        if sel.set_ops:
            # ORDER BY / LIMIT after a set op bind to the whole chain; the
            # last branch's _order_limit grabbed them, so hoist.
            last = sel.set_ops[-1][1]
            if last.order_by and not sel.order_by:
                hoist = last.order_by
                if (
                    isinstance(last.from_clause, A.SubqueryRef)
                    and last.from_clause.alias == "__don"
                ):
                    # DISTINCT ON desugar rewrote the (chain-level)
                    # ORDER BY into hidden __oN refs private to the
                    # derived table — hoist the original exprs, kept
                    # as the inner __oN select items.
                    origs = {
                        i.alias: i.expr
                        for i in last.from_clause.query.items
                    }
                    hoist = [
                        A.SortItem(
                            origs[k.expr.name],
                            k.descending, k.nulls_first,
                        )
                        for k in hoist
                    ]
                sel.order_by, last.order_by = hoist, []
            if last.limit is not None and sel.limit is None:
                sel.limit, last.limit = last.limit, None
            if last.offset is not None and sel.offset is None:
                sel.offset, last.offset = last.offset, None
        # trailing ORDER BY / LIMIT on the outer chain
        self._order_limit(sel)
        if self.eat_kw("for"):
            if self.eat_kw("update"):
                sel.for_update = "update"
            elif self.eat_kw("share"):
                sel.for_update = "share"
            else:
                self.error("expected UPDATE or SHARE after FOR")
            sel.lock_nowait = bool(self.eat_kw("nowait"))
        return sel

    def _select_core(self) -> A.Select:
        if self.eat_op("("):
            sel = self.parse_select()
            self.expect_op(")")
            return sel
        if self.eat_kw("values"):
            # standalone VALUES lists (gram.y values_clause as a full
            # statement; also composes under set ops / ORDER BY)
            rows = [self._values_row()]
            while self.eat_op(","):
                rows.append(self._values_row())
            sel = A.Select(items=[])
            sel.values_rows = rows
            self._order_limit(sel)
            return sel
        if self.eat_kw("table"):
            # TABLE name == SELECT * FROM name (gram.y simple form)
            sel = A.Select(items=[A.SelectItem(A.Star())])
            sel.from_clause = A.RelRef(self.ident("table name"), None)
            self._order_limit(sel)
            return sel
        self.expect_kw("select")
        distinct = False
        on_exprs = None
        if self.eat_kw("distinct"):
            if self.eat_kw("on"):
                # DISTINCT ON (...) — desugared after the clause parse
                self.expect_op("(")
                on_exprs = [self.parse_expr()]
                while self.eat_op(","):
                    on_exprs.append(self.parse_expr())
                self.expect_op(")")
            else:
                distinct = True
        else:
            self.eat_kw("all")
        items = [self._select_item()]
        while self.eat_op(","):
            items.append(self._select_item())
        sel = A.Select(items=items, distinct=distinct)
        if on_exprs is not None:
            sel.distinct_on = on_exprs
        if self.eat_kw("from"):
            sel.from_clause = self._from_clause()
        if self.eat_kw("where"):
            sel.where = self.parse_expr()
        if self.eat_kw("group", "by"):
            sets = self._group_by_factors()
            if len(sets) == 1:
                sel.group_by = list(sets[0])
            else:
                sel.grouping_sets = sets
        if self.eat_kw("having"):
            sel.having = self.parse_expr()
        self._order_limit(sel)
        if sel.grouping_sets is not None:
            sel = self._desugar_grouping_sets(sel)
        elif sel.group_by and _gs_mentions_grouping(
            [it.expr for it in sel.items]
            + [sel.having]
            + [si.expr for si in sel.order_by]
        ):
            # single grouping set: every grouping() is 0 (validated
            # against the keys), including in ORDER BY
            rw = lambda x: _gs_rewrite(
                x, [], sel.group_by, self.error
            )
            sel.items = [
                A.SelectItem(rw(it.expr), it.alias)
                for it in sel.items
            ]
            sel.having = rw(sel.having)
            new_order = []
            for si in sel.order_by:
                ne = rw(si.expr)
                if ne != si.expr and isinstance(ne, A.Literal):
                    # grouping() folded to a constant — a constant
                    # sort key is a no-op (and a bare int literal
                    # would otherwise read as an ordinal)
                    continue
                new_order.append(
                    A.SortItem(ne, si.descending, si.nulls_first)
                )
            sel.order_by = new_order
        if sel.distinct_on is not None:
            sel = self._desugar_distinct_on(sel)
        return sel

    # -- GROUP BY ROLLUP / CUBE / GROUPING SETS -------------------------
    # (parse.c transformGroupingSet; expanded here into a UNION ALL of
    # plain grouped selects — one branch per grouping set — with
    # grouped-out key references replaced by NULL and grouping()
    # calls replaced by their per-set bitmask constants)

    def _group_by_factors(self) -> list:
        """Parse the GROUP BY list into grouping sets: each comma item
        is a factor (plain expr = one singleton set; rollup/cube/
        grouping sets = several); factors combine by cross product."""
        factors = [self._group_by_factor()]
        while self.eat_op(","):
            factors.append(self._group_by_factor())
        sets = [()]
        for f in factors:
            sets = [s + g for s in sets for g in f]
        if len(sets) > 64:
            self.error("too many grouping sets (max 64)")
        return sets

    def _group_by_factor(self) -> list:
        def paren_ahead():
            t = self.peek(1)
            return t.kind == Tok.OP and t.value == "("

        if self.at_kw("rollup") and paren_ahead():
            self.pos += 2
            exprs = [self.parse_expr()]
            while self.eat_op(","):
                exprs.append(self.parse_expr())
            self.expect_op(")")
            return [tuple(exprs[:i]) for i in range(len(exprs), -1, -1)]
        if self.at_kw("cube") and paren_ahead():
            self.pos += 2
            exprs = [self.parse_expr()]
            while self.eat_op(","):
                exprs.append(self.parse_expr())
            self.expect_op(")")
            if len(exprs) > 6:
                self.error("CUBE supports at most 6 expressions")
            out = []
            for mask in range(1 << len(exprs)):
                out.append(tuple(
                    e for i, e in enumerate(exprs) if mask >> i & 1
                ))
            return sorted(out, key=len, reverse=True)
        if self.at_kw("grouping", "sets"):
            t = self.peek(2)
            if t.kind == Tok.OP and t.value == "(":
                self.pos += 3
                out = []
                while True:
                    out.extend(self._grouping_set_item())
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
                return out
        return [(self.parse_expr(),)]

    def _grouping_set_item(self) -> list:
        """One element of a GROUPING SETS list: (), (e, ...), a bare
        expr, or a nested rollup/cube."""
        t = self.peek(1)
        nested = (
            (self.at_kw("rollup") or self.at_kw("cube"))
            and t.kind == Tok.OP and t.value == "("
        ) or self.at_kw("grouping", "sets")
        if nested:
            return self._group_by_factor()
        if self.at_op("("):
            # try a column-list set first; if the closing paren is
            # followed by more expression (e.g. (a+b)*2), backtrack
            # and reparse as a single scalar element
            mark = self.pos
            self.pos += 1
            if self.eat_op(")"):
                return [()]
            try:
                exprs = [self.parse_expr()]
                while self.eat_op(","):
                    exprs.append(self.parse_expr())
                self.expect_op(")")
                if self.at_op(",") or self.at_op(")"):
                    return [tuple(exprs)]
            except ParseError:
                pass
            self.pos = mark
        return [(self.parse_expr(),)]

    def _desugar_grouping_sets(self, sel: A.Select) -> A.Select:
        sets = sel.grouping_sets
        sel.grouping_sets = None
        if sel.distinct or sel.distinct_on is not None:
            self.error(
                "DISTINCT with multiple grouping sets is not supported"
            )
        # union (ordered) of key exprs across all sets
        all_keys = []
        for S in sets:
            for e in S:
                if not any(e == k for k in all_keys):
                    all_keys.append(e)
        branches = []
        for S in sets:
            removed = [
                k for k in all_keys if not any(k == e for e in S)
            ]
            rw = lambda x: _gs_rewrite(
                x, removed, all_keys, self.error
            )
            # a grouped-out key rewritten to NULL must keep its
            # output column name for the union header / chain ORDER BY
            b = A.Select(
                items=[
                    A.SelectItem(rw(it.expr), it.alias or (
                        it.expr.name
                        if isinstance(it.expr, A.ColumnRef) else None
                    ))
                    for it in sel.items
                ],
                from_clause=sel.from_clause,
                where=sel.where,
            )
            b.group_by = list(S)
            if sel.having is not None:
                b.having = rw(sel.having)
            branches.append(b)
        if _gs_mentions_grouping(
            [si.expr for si in sel.order_by]
        ):
            self.error(
                "grouping() in ORDER BY with multiple grouping sets "
                "is not supported — select it as a column and order "
                "by the alias"
            )
        base = branches[0]
        base.set_ops = [("union all", b) for b in branches[1:]]
        base.order_by = sel.order_by
        base.limit = sel.limit
        base.offset = sel.offset
        base.ctes = sel.ctes
        base.ctes_recursive = sel.ctes_recursive
        return base

    def _desugar_distinct_on(self, sel: A.Select) -> A.Select:
        """DISTINCT ON (e...) keeps the first row per e-group under the
        ORDER BY (PG's nodeUnique over a presorted input). Desugar:
        a row_number() window partitioned by the ON exprs inside a
        derived table, outer filter __rn = 1, outer ORDER BY over
        re-projected columns."""
        on_exprs = sel.distinct_on
        sel.distinct_on = None
        if sel.group_by or sel.having is not None:
            self.error(
                "DISTINCT ON with GROUP BY is not supported"
            )
        # Resolve ordinal (ORDER BY 2) and output-alias sort keys
        # against the select list first — the hidden-column
        # re-projection would otherwise turn them into constants /
        # unresolvable names (transformSortClause does this resolution
        # before transformDistinctOnClause sees the list).
        resolved = []
        for si in sel.order_by:
            e = si.expr
            if (
                isinstance(e, A.Literal)
                and isinstance(e.value, int)
                and not isinstance(e.value, bool)
            ):
                if not 1 <= e.value <= len(sel.items):
                    self.error(
                        f"ORDER BY position {e.value} is not in "
                        "select list"
                    )
                e = sel.items[e.value - 1].expr
            elif isinstance(e, A.ColumnRef) and e.table is None:
                for item in sel.items:
                    if item.alias == e.name:
                        e = item.expr
                        break
            resolved.append(
                A.SortItem(e, si.descending, si.nulls_first)
            )
        # PG's transformDistinctOnClause rule: sort items matching an
        # ON expr must form a prefix, and once a non-ON sort item is
        # seen every ON expr must already have been covered.
        skipped = False
        matched = []
        for si in resolved:
            if any(si.expr == oe for oe in on_exprs):
                if skipped:
                    self.error(
                        "SELECT DISTINCT ON expressions must match "
                        "initial ORDER BY expressions"
                    )
                matched.append(si.expr)
            else:
                skipped = True
        if skipped and any(
            all(oe != m for m in matched) for oe in on_exprs
        ):
            self.error(
                "SELECT DISTINCT ON expressions must match "
                "initial ORDER BY expressions"
            )
        # Inner names are positional (__c{i}) so duplicate output
        # names / aliases colliding with the hidden __rn column can't
        # make the outer re-projection ambiguous.
        inner_items = []
        out_aliases = []
        for i, item in enumerate(sel.items):
            if isinstance(item.expr, A.Star):
                self.error("DISTINCT ON with * is not supported")
            inner_items.append(A.SelectItem(item.expr, f"__c{i}"))
            out_aliases.append(item.alias or (
                item.expr.name
                if isinstance(item.expr, A.ColumnRef) else f"__c{i}"
            ))
        # ORDER BY exprs re-project as hidden columns so the outer
        # select can re-order after the window filter
        order_refs = []
        for j, si in enumerate(resolved):
            inner_items.append(
                A.SelectItem(si.expr, f"__o{j}")
            )
            order_refs.append(
                A.SortItem(
                    A.ColumnRef(f"__o{j}", None),
                    si.descending, si.nulls_first,
                )
            )
        inner_items.append(A.SelectItem(
            A.WindowCall(
                A.FuncCall("row_number", ()),
                tuple(on_exprs),
                tuple(resolved),
            ),
            "__rn",
        ))
        inner = A.Select(
            items=inner_items,
            from_clause=sel.from_clause,
            where=sel.where,
        )
        outer = A.Select(
            items=[
                A.SelectItem(A.ColumnRef(f"__c{i}", None), a)
                for i, a in enumerate(out_aliases)
            ],
            from_clause=A.SubqueryRef(inner, "__don"),
            where=A.BinOp(
                "=", A.ColumnRef("__rn", None), A.Literal(1)
            ),
            order_by=order_refs,
            limit=sel.limit,
            offset=sel.offset,
        )
        outer.ctes = sel.ctes
        outer.ctes_recursive = sel.ctes_recursive
        return outer

    def _order_limit(self, sel: A.Select) -> None:
        if self.eat_kw("order", "by"):
            sel.order_by = [self._sort_item()]
            while self.eat_op(","):
                sel.order_by.append(self._sort_item())
        while True:
            if self.eat_kw("limit"):
                sel.limit = None if self.eat_kw("all") else self.parse_expr()
            elif self.eat_kw("offset"):
                sel.offset = self.parse_expr()
            else:
                break

    def _select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.advance()
            return A.SelectItem(A.Star())
        # qualified star: t.*
        if (
            self.cur.kind == Tok.IDENT
            and self.peek(1).kind == Tok.OP
            and self.peek(1).value == "."
            and self.peek(2).kind == Tok.OP
            and self.peek(2).value == "*"
        ):
            table = self.advance().value
            self.advance()
            self.advance()
            return A.SelectItem(A.Star(table))
        expr = self.parse_expr()
        alias = None
        if self.eat_kw("as"):
            alias = self.ident("alias")
        elif self.cur.kind == Tok.IDENT and self.cur.value not in _CLAUSE_KEYWORDS:
            alias = self.advance().value
        return A.SelectItem(expr, alias)

    def _sort_item(self) -> A.SortItem:
        expr = self.parse_expr()
        desc = False
        if self.eat_kw("desc"):
            desc = True
        else:
            self.eat_kw("asc")
        nulls_first = None
        if self.eat_kw("nulls", "first"):
            nulls_first = True
        elif self.eat_kw("nulls", "last"):
            nulls_first = False
        return A.SortItem(expr, desc, nulls_first)

    def _from_clause(self) -> A.TableRef:
        ref = self._table_ref()
        while True:
            if self.eat_op(","):
                right = self._table_ref()
                ref = A.JoinRef("cross", ref, right)
            elif self._at_join():
                ref = self._join_tail(ref)
            else:
                return ref

    def _at_join(self) -> bool:
        return (
            self.at_kw("join")
            or self.at_kw("inner")
            or self.at_kw("left")
            or self.at_kw("right")
            or self.at_kw("full")
            or self.at_kw("cross")
        )

    def _join_tail(self, left: A.TableRef) -> A.TableRef:
        jt = "inner"
        if self.eat_kw("cross"):
            jt = "cross"
        elif self.eat_kw("inner"):
            jt = "inner"
        elif self.eat_kw("left"):
            jt = "left"
            self.eat_kw("outer")
        elif self.eat_kw("right"):
            jt = "right"
            self.eat_kw("outer")
        elif self.eat_kw("full"):
            jt = "full"
            self.eat_kw("outer")
        self.expect_kw("join")
        right = self._table_ref()
        cond = None
        using: tuple[str, ...] = ()
        if jt != "cross":
            if self.eat_kw("on"):
                cond = self.parse_expr()
            elif self.eat_kw("using"):
                self.expect_op("(")
                names = [self.ident("column")]
                while self.eat_op(","):
                    names.append(self.ident("column"))
                self.expect_op(")")
                using = tuple(names)
            else:
                self.error("expected ON or USING after JOIN")
        return A.JoinRef(jt, left, right, cond, using)

    def _table_ref(self) -> A.TableRef:
        if self.eat_op("("):
            if (
                self.at_kw("select") or self.at_kw("with")
                or self.at_kw("values") or self.at_op("(")
            ):
                query = self.parse_select()
                self.expect_op(")")
                alias = self._opt_alias()
                if alias is None:
                    raise ParseError("subquery in FROM must have an alias")
                return A.SubqueryRef(query, alias)
            ref = self._from_clause()
            self.expect_op(")")
            return ref
        name = self.ident("table name")
        alias = self._opt_alias()
        return A.RelRef(name, alias)

    def _opt_alias(self) -> str | None:
        if self.eat_kw("as"):
            return self.ident("alias")
        if self.cur.kind == Tok.IDENT and self.cur.value not in _CLAUSE_KEYWORDS:
            return self.advance().value
        return None

    # -- DML ------------------------------------------------------------
    def parse_insert(self) -> A.Insert:
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.ident("table name")
        columns: list[str] = []
        if self.at_op("(") :
            self.expect_op("(")
            columns.append(self.ident("column"))
            while self.eat_op(","):
                columns.append(self.ident("column"))
            self.expect_op(")")
        if self.eat_kw("values"):
            rows = [self._values_row()]
            while self.eat_op(","):
                rows.append(self._values_row())
            stmt = A.Insert(table, columns, rows)
        else:
            stmt = A.Insert(table, columns, [], query=self.parse_select())
        if self.eat_kw("on"):
            # ON CONFLICT [(col)] DO NOTHING | DO UPDATE SET c = e, ...
            # (gram.y opt_on_conflict; speculative insertion arbiter)
            self.expect_kw("conflict")
            target = None
            if self.eat_op("("):
                target = self.ident("conflict column")
                self.expect_op(")")
            self.expect_kw("do")
            if self.eat_kw("nothing"):
                stmt.on_conflict = (target, "nothing", [])
            else:
                self.expect_kw("update")
                self.expect_kw("set")
                sets = []
                while True:
                    col = self.ident("column")
                    self.expect_op("=")
                    sets.append((col, self.parse_expr()))
                    if not self.eat_op(","):
                        break
                stmt.on_conflict = (target, "update", sets)
        if self.eat_kw("returning"):
            stmt.returning = [self._select_item()]
            while self.eat_op(","):
                stmt.returning.append(self._select_item())
        return stmt

    def _values_row(self) -> list[A.Expr]:
        self.expect_op("(")
        row = [self._values_item()]
        while self.eat_op(","):
            row.append(self._values_item())
        self.expect_op(")")
        return row

    def _values_item(self) -> A.Expr:
        """One VALUES item: a bare literal ahead of ',' or ')' is its own
        primary (no operator or postfix continues it), the rest a full
        expression. A bulk INSERT's items are nearly all bare literals."""
        t, nxt = self.cur, self.peek(1)
        if (t.kind in (Tok.NUMBER, Tok.STRING) and nxt.kind == Tok.OP
                and nxt.value in (",", ")")):
            return self._primary()
        return self.parse_expr()

    def parse_update(self) -> A.Update:
        self.expect_kw("update")
        table = self.ident("table name")
        alias = (
            self.ident("alias")
            if self.cur.kind == Tok.IDENT and not self.at_kw("set")
            else None
        )
        self.expect_kw("set")
        assignments = [self._assignment()]
        while self.eat_op(","):
            assignments.append(self._assignment())
        from_table = None
        if self.eat_kw("from"):
            # UPDATE ... FROM source [alias] (one source table, the
            # working set of gram.y's from_clause on UPDATE)
            fname = self.ident("table name")
            falias = (
                self.ident("alias")
                if self.cur.kind == Tok.IDENT
                and not self.at_kw("where")
                and not self.at_kw("returning")
                else None
            )
            from_table = (fname, falias)
        where = self.parse_expr() if self.eat_kw("where") else None
        stmt = A.Update(table, assignments, where)
        stmt.alias = alias
        stmt.from_table = from_table
        if self.eat_kw("returning"):
            stmt.returning = [self._select_item()]
            while self.eat_op(","):
                stmt.returning.append(self._select_item())
        return stmt

    def _assignment(self) -> tuple[str, A.Expr]:
        name = self.ident("column")
        self.expect_op("=")
        return name, self.parse_expr()

    def parse_delete(self) -> A.Delete:
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.ident("table name")
        alias = (
            self.ident("alias")
            if self.cur.kind == Tok.IDENT
            and not self.at_kw("where") and not self.at_kw("using")
            and not self.at_kw("returning")
            else None
        )
        from_table = None
        if self.eat_kw("using"):
            fname = self.ident("table name")
            falias = (
                self.ident("alias")
                if self.cur.kind == Tok.IDENT
                and not self.at_kw("where")
                and not self.at_kw("returning")
                else None
            )
            from_table = (fname, falias)
        where = self.parse_expr() if self.eat_kw("where") else None
        stmt = A.Delete(table, where)
        stmt.alias = alias
        stmt.from_table = from_table
        if self.eat_kw("returning"):
            stmt.returning = [self._select_item()]
            while self.eat_op(","):
                stmt.returning.append(self._select_item())
        return stmt

    # -- CREATE ... -----------------------------------------------------
    def parse_create(self) -> A.Statement:
        self.expect_kw("create")
        if self.eat_kw("or", "replace"):
            if self.eat_kw("function"):
                return self._create_function(replace=True)
            self.expect_kw("view")
            return self._create_view(replace=True)
        if self.eat_kw("function"):
            return self._create_function(replace=False)
        if self.eat_kw("materialized"):
            self.expect_kw("view")
            return self._create_matview()
        if self.eat_kw("view"):
            return self._create_view(replace=False)
        if self.eat_kw("table"):
            return self._create_table()
        if self.at_kw("unique", "index") or self.at_kw("index"):
            unique = self.eat_kw("unique")
            self.expect_kw("index")
            name = self.ident("index name")
            self.expect_kw("on")
            table = self.ident("table name")
            self.expect_op("(")
            cols = [self.ident("column")]
            while self.eat_op(","):
                cols.append(self.ident("column"))
            self.expect_op(")")
            return A.CreateIndex(name, table, cols, unique)
        if self.eat_kw("foreign", "table"):
            name = self.ident("table name")
            self.expect_op("(")
            columns = [self._column_def()]
            while self.eat_op(","):
                columns.append(self._column_def())
            self.expect_op(")")
            self.expect_kw("server")
            server = self.ident("server name")
            options: dict = {}
            if self.eat_kw("options"):
                self.expect_op("(")
                while not self.eat_op(")"):
                    key = self.ident("option")
                    options[key] = self._string_lit()
                    self.eat_op(",")
            return A.CreateForeignTable(name, columns, server, options)
        if self.eat_kw("user") or self.eat_kw("role"):
            name = self.ident("user name")
            self.eat_kw("with")
            self.expect_kw("password")
            return A.CreateUser(name, self._string_lit())
        if self.eat_kw("node"):
            if self.eat_kw("group"):
                name = self.ident("group name")
                self.expect_kw("with")
                self.expect_op("(")
                members = [self.ident("node name")]
                while self.eat_op(","):
                    members.append(self.ident("node name"))
                self.expect_op(")")
                # cold/hot dual-group routing (pgxc_group): a COLD
                # group hosts archive tables whose scans must never
                # contend with the hot serving set
                kind = "hot"
                if self.eat_kw("cold"):
                    kind = "cold"
                elif self.eat_kw("hot"):
                    kind = "hot"
                return A.CreateNodeGroup(name, members, kind)
            return self._create_node()
        if self.eat_kw("publication"):
            name = self.ident("publication name")
            self.expect_kw("for")
            if self.eat_kw("all"):
                self.expect_kw("tables")
                tables = None
            else:
                self.expect_kw("table")
                tables = [self.ident("table name")]
                while self.eat_op(","):
                    tables.append(self.ident("table name"))
            nodes = None
            if self.eat_kw("on"):
                self.expect_kw("node")
                self.expect_op("(")
                nodes = [self.ident("node name")]
                while self.eat_op(","):
                    nodes.append(self.ident("node name"))
                self.expect_op(")")
            return A.CreatePublication(name, tables, nodes)
        if self.eat_kw("subscription"):
            name = self.ident("subscription name")
            self.expect_kw("connection")
            conninfo = self._string_lit()
            self.expect_kw("publication")
            pub = self.ident("publication name")
            copy_data = True
            if self.eat_kw("with"):
                self.expect_op("(")
                while not self.at_op(")"):
                    opt = self.ident("option")
                    self.expect_op("=")
                    val = self.advance().value
                    if opt == "copy_data":
                        copy_data = str(val).lower() in (
                            "on", "true", "yes", "1"
                        )
                    self.eat_op(",")
                self.expect_op(")")
            return A.CreateSubscription(name, conninfo, pub, copy_data)
        if self.eat_kw("resource", "group"):
            name = self.ident("resource group name")
            return A.CreateResourceGroup(name, self._wlm_options())
        if self.eat_kw("sharding", "group"):
            members: list[str] = []
            if self.eat_kw("to", "group"):
                members.append(self.ident("group name"))
            elif self.eat_op("("):
                members.append(self.ident("node name"))
                while self.eat_op(","):
                    members.append(self.ident("node name"))
                self.expect_op(")")
            return A.CreateShardingGroup(members)
        if self.eat_kw("barrier"):
            bid = self._string_lit() if self.cur.kind == Tok.STRING else None
            return A.CreateBarrier(bid)
        if self.eat_kw("sequence"):
            ine = bool(self.eat_kw("if", "not", "exists"))
            name = self.ident("sequence name")
            start, increment = 1, 1
            while True:
                if self.eat_kw("start"):
                    self.eat_kw("with")
                    start = self._int_lit()
                elif self.eat_kw("increment"):
                    self.eat_kw("by")
                    increment = self._int_lit()
                else:
                    break
            return A.CreateSequence(name, start, increment, ine)
        self.error("unsupported CREATE")

    def _create_table(self):
        if_not_exists = bool(self.eat_kw("if", "not", "exists"))
        name = self.ident("table name")
        if self.eat_kw("as"):
            # CREATE TABLE name AS select (ctas; default distribution)
            return A.CreateTableAs(name, self.parse_select(), if_not_exists)
        self.expect_op("(")
        columns = [self._column_def()]
        while self.eat_op(","):
            columns.append(self._column_def())
        self.expect_op(")")
        stmt = A.CreateTable(name, columns, if_not_exists=if_not_exists)
        while True:
            if self.eat_kw("distribute", "by"):
                strat = self.ident("distribution strategy")
                stmt.distribute_strategy = strat
                if strat in ("shard", "hash", "modulo", "range"):
                    self.expect_op("(")
                    stmt.distribute_keys.append(self.ident("column"))
                    while self.eat_op(","):
                        stmt.distribute_keys.append(self.ident("column"))
                    self.expect_op(")")
            elif self.eat_kw("to", "group"):
                stmt.to_group = self.ident("group name")
            elif self.eat_kw("partition", "by"):
                stmt.partition_by = self._partition_spec()
            else:
                break
        return stmt

    def _maybe_over(self, fn: A.FuncCall) -> A.Expr:
        """``f(...) [FILTER (WHERE ...)] [OVER (...)]`` — the FILTER
        clause desugars to CASE WHEN inside the aggregate argument
        (gram.y's filter_clause; nodeAgg applies aggfilter the same
        row-conditional way), then the over_clause."""
        if self.eat_kw("filter"):
            if fn.name not in ("count", "sum", "min", "max", "avg"):
                self.error(
                    f"FILTER specified, but {fn.name} is not an "
                    "aggregate function"
                )
            if len(fn.args) > 1:
                self.error(
                    "FILTER requires a single-argument aggregate"
                )
            self.expect_op("(")
            self.expect_kw("where")
            cond = self.parse_expr()
            self.expect_op(")")
            arg = (
                A.Literal(1) if fn.star or not fn.args else fn.args[0]
            )
            case = A.CaseExpr(None, ((cond, arg),), None)
            fn = A.FuncCall(
                fn.name, (case,), distinct=fn.distinct
            )
        if not self.eat_kw("over"):
            return fn
        self.expect_op("(")
        partition: list[A.Expr] = []
        order: list[A.SortItem] = []
        if self.eat_kw("partition", "by"):
            partition.append(self.parse_expr())
            while self.eat_op(","):
                partition.append(self.parse_expr())
        if self.eat_kw("order", "by"):
            order.append(self._sort_item())
            while self.eat_op(","):
                order.append(self._sort_item())
        frame = None
        if self.at_kw("range") or self.at_kw("groups"):
            self.error(
                "only ROWS window frames are supported"
            )
        if self.eat_kw("rows"):
            # ROWS BETWEEN <bound> AND <bound> | ROWS <bound>
            def bound():
                if self.eat_kw("unbounded"):
                    if self.eat_kw("preceding"):
                        return None, "p"
                    self.expect_kw("following")
                    return None, "f"
                if self.eat_kw("current"):
                    self.expect_kw("row")
                    return 0, "c"
                k = self._int_lit()
                if k < 0:
                    self.error(
                        "frame offset must not be negative"
                    )
                if self.eat_kw("preceding"):
                    return -k, "p"
                self.expect_kw("following")
                return k, "f"

            if self.eat_kw("between"):
                s_val, s_kind = bound()
                self.expect_kw("and")
                e_val, e_kind = bound()
            else:
                s_val, s_kind = bound()
                e_val, e_kind = 0, "c"
            if s_kind == "f" and s_val is None:
                self.error(
                    "frame start cannot be UNBOUNDED FOLLOWING"
                )
            if e_kind == "p" and e_val is None:
                self.error(
                    "frame end cannot be UNBOUNDED PRECEDING"
                )
            if (
                s_val is not None and e_val is not None
                and s_val > e_val
            ):
                self.error(
                    "frame starting bound cannot follow its ending "
                    "bound"
                )
            frame = (s_val, e_val)
        self.expect_op(")")
        return A.WindowCall(
            fn, tuple(partition), tuple(order), frame
        )

    def _partition_spec(self) -> dict:
        # PARTITION BY RANGE (col) [BEGIN (literal) STEP (literal unit)
        # PARTITIONS (n)] — interval partitioning, gram.y:4172
        self.expect_kw("range")
        self.expect_op("(")
        col = self.ident("column")
        self.expect_op(")")
        spec: dict = {"strategy": "range", "column": col}
        if self.eat_kw("begin"):
            self.expect_op("(")
            spec["begin"] = self._literal_value()
            self.expect_op(")")
            self.expect_kw("step")
            self.expect_op("(")
            spec["step"] = self._literal_value()
            if self.cur.kind == Tok.IDENT:
                spec["step_unit"] = self.advance().value  # month / day / ...
            self.expect_op(")")
            self.expect_kw("partitions")
            self.expect_op("(")
            spec["partitions"] = self._int_lit()
            self.expect_op(")")
        return spec

    def _simple_type_name(self) -> str:
        type_name = self.ident("type name")
        if type_name == "double" and self.eat_kw("precision"):
            type_name = "float8"
        elif type_name == "character":
            type_name = "varchar" if self.eat_kw("varying") else "char"
        if self.eat_op("("):  # precision args accepted, not recorded
            self._int_lit()
            while self.eat_op(","):
                self._int_lit()
            self.expect_op(")")
        return type_name

    def _create_function(self, replace: bool) -> A.CreateFunction:
        name = self.ident("function name")
        args: list[tuple[str, str]] = []
        self.expect_op("(")
        if not self.at_op(")"):
            while True:
                an = self.ident("argument name")
                args.append((an, self._simple_type_name()))
                if not self.eat_op(","):
                    break
        self.expect_op(")")
        self.expect_kw("returns")
        rettype = self._simple_type_name()
        # AS '<body>' LANGUAGE SQL|PLPGSQL (clauses in either order)
        body = None
        lang = "sql"
        while True:
            if self.eat_kw("as"):
                body = self._string_lit()
            elif self.eat_kw("language"):
                lang = self.ident("language")
                if lang not in ("sql", "plpgsql"):
                    self.error(
                        f"unsupported function language {lang!r} "
                        "(LANGUAGE SQL or PLPGSQL)"
                    )
            elif self.eat_kw("immutable") or self.eat_kw("stable") or (
                self.eat_kw("volatile")
            ):
                pass  # volatility accepted, not enforced
            else:
                break
        if body is None:
            self.error("CREATE FUNCTION requires AS '<body>'")
        return A.CreateFunction(
            name, args, rettype, body, replace, lang
        )

    def _column_def(self) -> A.ColumnDef:
        name = self.ident("column name")
        type_name = self.ident("type name")
        # multi-word types: double precision, character varying
        if type_name == "double" and self.eat_kw("precision"):
            type_name = "float8"
        elif type_name == "character":
            type_name = "varchar" if self.eat_kw("varying") else "char"
        type_args: tuple[int, ...] = ()
        if self.eat_op("("):
            args = [self._int_lit()]
            while self.eat_op(","):
                args.append(self._int_lit())
            self.expect_op(")")
            type_args = tuple(args)
        not_null = False
        primary_key = False
        default = None
        while True:
            if self.eat_kw("not", "null"):
                not_null = True
            elif self.eat_kw("null"):
                pass
            elif self.eat_kw("primary", "key"):
                primary_key = True
                not_null = True
            elif self.eat_kw("default"):
                default = self.parse_expr()
            else:
                break
        return A.ColumnDef(name, type_name, type_args, not_null, primary_key, default)

    def _create_node(self) -> A.CreateNode:
        name = self.ident("node name")
        return self._create_node_options(name)

    def _alter_cluster(self) -> A.AlterCluster:
        """Elastic-cluster DDL (rebalance/): ADD NODE joins a datanode
        and backfills its byte-even share of shard groups online;
        REMOVE NODE drains a node to zero owned shards then detaches
        it; REBALANCE re-levels the existing nodes. All three return
        immediately and rebalance in the background unless WAIT."""
        if self.eat_kw("add"):
            self.expect_kw("node")
            name = self.ident("node name")
            options: dict = {}
            if self.at_kw("with"):
                node = self._create_node_options(name)
                options = {
                    "type": node.node_type, "host": node.host,
                    "port": node.port, "primary": node.is_primary,
                    "preferred": node.is_preferred,
                }
            return A.AlterCluster(
                "add_node", name, options, wait=self.eat_kw("wait")
            )
        if self.eat_kw("remove") or self.eat_kw("drop"):
            self.expect_kw("node")
            name = self.ident("node name")
            return A.AlterCluster(
                "remove_node", name, wait=self.eat_kw("wait")
            )
        if self.eat_kw("rebalance"):
            return A.AlterCluster("rebalance", wait=self.eat_kw("wait"))
        self.error(
            "unsupported ALTER CLUSTER (expected ADD NODE, "
            "REMOVE NODE, or REBALANCE)"
        )

    def _create_node_options(self, name: str) -> A.CreateNode:
        """Parse ``WITH (type=..., host=..., port=..., ...)`` into a
        CreateNode — shared by CREATE NODE and ALTER CLUSTER ADD NODE
        so both accept the identical option surface."""
        self.expect_kw("with")
        self.expect_op("(")
        node_type, host, port = "datanode", "localhost", 0
        primary = preferred = False
        while not self.at_op(")"):
            opt = self.ident("node option")
            if opt == "type":
                self.eat_op("=")
                node_type = (
                    self._string_lit() if self.cur.kind == Tok.STRING
                    else self.ident("type")
                )
            elif opt == "host":
                self.eat_op("=")
                host = (
                    self._string_lit() if self.cur.kind == Tok.STRING
                    else self.ident("host")
                )
            elif opt == "port":
                self.eat_op("=")
                port = self._int_lit()
            elif opt == "primary":
                primary = True
            elif opt == "preferred":
                preferred = True
            else:
                self.error(f"unknown node option {opt!r}")
            self.eat_op(",")
        self.expect_op(")")
        return A.CreateNode(name, node_type, host, port, primary, preferred)

    def parse_alter(self) -> A.Statement:
        self.expect_kw("alter")
        if self.eat_kw("cluster"):
            return self._alter_cluster()
        if self.eat_kw("node"):
            name = self.ident("node name")
            self.expect_kw("with")
            self.expect_op("(")
            options: dict = {}
            while not self.at_op(")"):
                opt = self.ident("option")
                self.eat_op("=")
                if self.cur.kind == Tok.STRING:
                    options[opt] = self._string_lit()
                elif self.cur.kind == Tok.NUMBER:
                    options[opt] = self._int_lit()
                else:
                    options[opt] = True
                self.eat_op(",")
            self.expect_op(")")
            return A.AlterNode(name, options)
        if self.eat_kw("table"):
            return self._alter_table()
        if self.eat_kw("resource", "group"):
            name = self.ident("resource group name")
            return A.CreateResourceGroup(
                name, self._wlm_options(), alter=True
            )
        if self.eat_kw("user") or self.eat_kw("role"):
            name = self.ident("user name")
            if self.eat_kw("resource", "group"):
                return A.AlterRoleResourceGroup(
                    name, self.ident("resource group name")
                )
            if self.eat_kw("no", "resource", "group"):
                return A.AlterRoleResourceGroup(name, None)
            self.eat_kw("with")
            self.expect_kw("password")
            return A.CreateUser(name, self._string_lit(), alter=True)
        self.error("unsupported ALTER")

    def _wlm_options(self) -> dict:
        """WITH (key = value, ...) of resource-group DDL. Values:
        numbers, strings ('64MB'), or bare idents."""
        self.expect_kw("with")
        self.expect_op("(")
        options: dict = {}
        while not self.at_op(")"):
            key = self.ident("resource group option")
            self.eat_op("=")
            if self.cur.kind == Tok.STRING:
                options[key] = self._string_lit()
            elif self.cur.kind == Tok.NUMBER:
                options[key] = self._int_lit()
            elif self.cur.kind == Tok.IDENT:
                options[key] = self.advance().value
            else:
                self.error("expected resource group option value")
            self.eat_op(",")
        self.expect_op(")")
        return options

    def _create_matview(self) -> A.Statement:
        # CREATE MATERIALIZED VIEW name [WITH (distribute = shard(k) |
        # replication | roundrobin, incremental = on|off)] AS select —
        # the body's source text is captured verbatim (the durable
        # definition, as for CREATE VIEW)
        if_not_exists = bool(self.eat_kw("if", "not", "exists"))
        name = self.ident("materialized view name")
        options: dict = {}
        if self.at_kw("with"):
            options = self._matview_options()
        self.expect_kw("as")
        start = self.cur.pos
        query = self.parse_select()
        end = self.cur.pos if self.cur.kind != Tok.EOF else len(self.sql)
        text = self.sql[start:end].strip().rstrip(";").strip()
        return A.CreateMatview(name, query, text, options, if_not_exists)

    def _matview_options(self) -> dict:
        """WITH (distribute = strategy[(cols)], incremental = on|off)
        of matview DDL; '=' is optional, as in reloptions lists."""
        self.expect_kw("with")
        self.expect_op("(")
        options: dict = {}
        while not self.at_op(")"):
            key = self.ident("materialized view option")
            self.eat_op("=")
            if key == "distribute":
                strat = self.ident("distribution strategy")
                options["distribute"] = strat
                keys: list[str] = []
                if self.eat_op("("):
                    keys.append(self.ident("column"))
                    while self.eat_op(","):
                        keys.append(self.ident("column"))
                    self.expect_op(")")
                options["distribute_keys"] = keys
            elif key == "incremental":
                if self.cur.kind not in (Tok.IDENT, Tok.NUMBER):
                    self.error("expected on or off for incremental")
                v = str(self.advance().value).lower()
                options["incremental"] = v in ("on", "true", "yes", "1")
            else:
                self.error(
                    f"unknown materialized view option {key!r}"
                )
            self.eat_op(",")
        self.expect_op(")")
        return options

    def _create_view(self, replace: bool) -> A.Statement:
        # CREATE [OR REPLACE] VIEW name AS select  (view.c); the body's
        # source text is captured verbatim so the definition is durable
        # and printable without a deparser (pg_get_viewdef analog)
        name = self.ident("view name")
        self.expect_kw("as")
        start = self.cur.pos
        query = self.parse_select()
        end = self.cur.pos if self.cur.kind != Tok.EOF else len(self.sql)
        text = self.sql[start:end].strip().rstrip(";").strip()
        return A.CreateView(name, query, text, replace)

    def _alter_table(self) -> A.Statement:
        # ALTER TABLE name {ADD [COLUMN] def | DROP [COLUMN] name |
        #   DISTRIBUTE BY ... | ADD PARTITIONS (n)}  (tablecmds.c +
        #   the XL redistribution grammar, gram.y:2694)
        name = self.ident("table name")
        if self.eat_kw("distribute", "by"):
            strat = self.ident("distribution strategy")
            keys: list[str] = []
            if self.eat_op("("):
                keys.append(self.ident("column"))
                while self.eat_op(","):
                    keys.append(self.ident("column"))
                self.expect_op(")")
            return A.AlterTable(name, "distribute", strategy=strat, keys=keys)
        if self.eat_kw("add", "partitions"):
            self.expect_op("(")
            n = self._int_lit()
            self.expect_op(")")
            return A.AlterTable(name, "add_partitions", count=n)
        if self.eat_kw("add"):
            self.eat_kw("column")
            return A.AlterTable(name, "add_column", column=self._column_def())
        if self.eat_kw("drop"):
            self.eat_kw("column")
            return A.AlterTable(
                name, "drop_column", column_name=self.ident("column")
            )
        self.error("unsupported ALTER TABLE action")

    def parse_drop(self) -> A.Statement:
        self.expect_kw("drop")
        if self.eat_kw("materialized"):
            self.expect_kw("view")
            if_exists = bool(self.eat_kw("if", "exists"))
            name = self.ident("materialized view name")
            cascade = bool(self.eat_kw("cascade"))
            self.eat_kw("restrict")
            return A.DropMatview(name, if_exists, cascade)
        if self.eat_kw("view"):
            if_exists = bool(self.eat_kw("if", "exists"))
            return A.DropView(self.ident("view name"), if_exists)
        if self.eat_kw("table"):
            if_exists = bool(self.eat_kw("if", "exists"))
            names = [self.ident("table name")]
            while self.eat_op(","):
                names.append(self.ident("table name"))
            cascade = bool(self.eat_kw("cascade"))
            self.eat_kw("restrict")
            return A.DropTable(names, if_exists, cascade)
        if self.eat_kw("node"):
            if self.eat_kw("group"):
                return A.DropNodeGroup(self.ident("group name"))
            return A.DropNode(self.ident("node name"))
        if self.eat_kw("resource", "group"):
            if_exists = bool(self.eat_kw("if", "exists"))
            return A.DropResourceGroup(
                self.ident("resource group name"), if_exists
            )
        if self.eat_kw("user") or self.eat_kw("role"):
            if_exists = bool(self.eat_kw("if", "exists"))
            return A.DropUser(self.ident("user name"), if_exists)
        if self.eat_kw("sequence"):
            if_exists = bool(self.eat_kw("if", "exists"))
            return A.DropSequence(self.ident("sequence name"), if_exists)
        if self.eat_kw("publication"):
            return A.DropPublication(self.ident("publication name"))
        if self.eat_kw("subscription"):
            return A.DropSubscription(self.ident("subscription name"))
        if self.eat_kw("function"):
            if_exists = bool(self.eat_kw("if", "exists"))
            name = self.ident("function name")
            if self.eat_op("("):  # signature accepted, ignored
                while not self.eat_op(")"):
                    self.advance()
            return A.DropFunction(name, if_exists)
        self.error("unsupported DROP")

    def parse_truncate(self) -> A.TruncateTable:
        self.expect_kw("truncate")
        self.eat_kw("table")
        names = [self.ident("table name")]
        while self.eat_op(","):
            names.append(self.ident("table name"))
        return A.TruncateTable(names)

    # -- COPY -----------------------------------------------------------
    def parse_copy(self) -> A.CopyStmt:
        self.expect_kw("copy")
        table = self.ident("table name")
        columns: list[str] = []
        if self.eat_op("("):
            columns.append(self.ident("column"))
            while self.eat_op(","):
                columns.append(self.ident("column"))
            self.expect_op(")")
        if self.eat_kw("from"):
            direction = "from"
        elif self.eat_kw("to"):
            direction = "to"
        else:
            self.error("expected FROM or TO")
        if self.cur.kind == Tok.STRING:
            target = self._string_lit()
        elif self.eat_kw("stdin"):
            target = "STDIN"
        elif self.eat_kw("stdout"):
            target = "STDOUT"
        else:
            self.error("expected filename, STDIN, or STDOUT")
        options: dict = {}
        self.eat_kw("with")
        if self.eat_op("("):
            while not self.at_op(")"):
                opt = self.ident("copy option")
                if self.cur.kind == Tok.STRING:
                    options[opt] = self._string_lit()
                elif self.cur.kind == Tok.NUMBER:
                    options[opt] = self._literal_value()
                elif self.cur.kind == Tok.IDENT and self.cur.value not in (",",):
                    options[opt] = self.advance().value
                else:
                    options[opt] = True
                self.eat_op(",")
            self.expect_op(")")
        else:
            while self.cur.kind == Tok.IDENT:
                opt = self.advance().value
                if opt == "csv":
                    options["format"] = "csv"
                elif opt == "header":
                    options["header"] = True
                elif opt == "delimiter":
                    options["delimiter"] = self._string_lit()
                elif opt == "null":
                    options["null"] = self._string_lit()
                else:
                    self.error(f"unknown COPY option {opt!r}")
        return A.CopyStmt(table, columns, direction, target, options)

    # -- txn ------------------------------------------------------------
    def parse_begin(self) -> A.BeginStmt:
        self.advance()  # begin | start
        self.eat_kw("transaction") or self.eat_kw("work")
        isolation = None
        if self.eat_kw("isolation", "level"):
            if self.eat_kw("repeatable", "read"):
                isolation = "repeatable read"
            elif self.eat_kw("read", "committed"):
                isolation = "read committed"
            elif self.eat_kw("serializable"):
                isolation = "serializable"
            else:
                self.error("unknown isolation level")
        return A.BeginStmt(isolation)

    # -- EXPLAIN / SET / cluster ops ------------------------------------
    def parse_explain(self) -> A.ExplainStmt:
        self.expect_kw("explain")
        analyze = verbose = False
        if self.eat_op("("):
            while not self.at_op(")"):
                opt = self.ident("explain option")
                if opt == "analyze":
                    analyze = not self.at_kw("off")
                elif opt == "verbose":
                    verbose = not self.at_kw("off")
                self.eat_kw("on") or self.eat_kw("off") or self.eat_kw("true") or self.eat_kw(
                    "false"
                )
                self.eat_op(",")
            self.expect_op(")")
        else:
            while True:
                if self.eat_kw("analyze"):
                    analyze = True
                elif self.eat_kw("verbose"):
                    verbose = True
                else:
                    break
        return A.ExplainStmt(self.parse_statement(), analyze, verbose)

    def parse_set(self) -> A.SetStmt:
        self.expect_kw("set")
        self.eat_kw("local") or self.eat_kw("session")
        name = self.ident("setting name")
        while self.eat_op("."):  # namespaced custom GUCs (ext.knob)
            name += "." + self.ident("setting name")
        if not (self.eat_op("=") or self.eat_kw("to")):
            self.error("expected = or TO")
        if self.cur.kind == Tok.STRING:
            value: object = self._string_lit()
        elif self.cur.kind == Tok.NUMBER:
            value = self._literal_value()
        elif self.at_op("-"):
            # negative numeric values (SET auto_explain_min_duration_ms
            # = -1 — PG's "off" spelling for several GUCs);
            # _literal_value consumes the sign itself
            value = self._literal_value()
        else:
            value = self.ident("value")
            if (
                isinstance(value, str) and value.lower() == "default"
            ):
                value = None  # SET x TO DEFAULT == RESET x
        return A.SetStmt(name, value)

    def parse_move_data(self) -> A.MoveData:
        self.expect_kw("move")
        self.expect_kw("data")
        self.expect_kw("from")
        from_node = self.ident("node name")
        self.expect_kw("to")
        to_node = self.ident("node name")
        shard_ids: list[int] = []
        if self.eat_kw("shards"):
            self.expect_op("(")
            shard_ids.append(self._int_lit())
            while self.eat_op(","):
                shard_ids.append(self._int_lit())
            self.expect_op(")")
        return A.MoveData(from_node, to_node, shard_ids)

    def parse_execute_direct(self):
        self.expect_kw("execute")
        if not self.at_kw("direct"):
            # EXECUTE name [(args)] — run a prepared statement
            name = self.ident("statement name")
            args: list[A.Expr] = []
            if self.eat_op("("):
                if not self.at_op(")"):
                    args.append(self.parse_expr())
                    while self.eat_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
            return A.ExecuteStmt(name, args)
        self.expect_kw("direct")
        self.expect_kw("on")
        self.expect_op("(")
        nodes = [self.ident("node name")]
        while self.eat_op(","):
            nodes.append(self.ident("node name"))
        self.expect_op(")")
        query = A.Select([A.SelectItem(A.Literal(self._string_lit()))])
        # EXECUTE DIRECT ON (node) 'sql' — re-parse the inner SQL
        inner_sql = query.items[0].expr.value  # type: ignore[union-attr]
        inner = Parser(str(inner_sql)).parse_statement()
        return A.ExecuteDirect(nodes, inner)

    # -- literal helpers ------------------------------------------------
    def _string_lit(self) -> str:
        if self.cur.kind != Tok.STRING:
            self.error("expected string literal")
        return self.advance().value

    def _int_lit(self) -> int:
        neg = self.eat_op("-")
        if self.cur.kind != Tok.NUMBER:
            self.error("expected integer")
        v = self.advance().value
        iv = int(float(v)) if ("." in v or "e" in v.lower()) else int(v)
        return -iv if neg else iv

    def _literal_value(self) -> object:
        if self.cur.kind == Tok.STRING:
            return self._string_lit()
        neg = self.eat_op("-")
        if self.cur.kind != Tok.NUMBER:
            self.error("expected literal")
        v = self.advance().value
        num: object = float(v) if ("." in v or "e" in v.lower()) else int(v)
        return -num if neg else num  # type: ignore[operator]

    # ==================================================================
    # Expressions: precedence climbing
    # ==================================================================
    def parse_expr(self, min_prec: int = 0) -> A.Expr:
        left = self._unary()
        while True:
            op = self._peek_binop()
            if op is None or _PRECEDENCE[op] < min_prec:
                return left
            left = self._binop_tail(left, op)

    def _peek_binop(self) -> str | None:
        t = self.cur
        if t.kind == Tok.OP and t.value in _PRECEDENCE:
            return t.value
        if t.kind == Tok.IDENT:
            v = t.value
            if v in ("and", "or", "like", "ilike", "is", "in", "between"):
                return v
            if v == "not" and self.peek(1).kind == Tok.IDENT and self.peek(1).value in (
                "like",
                "ilike",
                "in",
                "between",
            ):
                return "not"
        return None

    def _binop_tail(self, left: A.Expr, op: str) -> A.Expr:
        if op == "not":
            self.advance()  # not
            inner = self._peek_binop()
            assert inner in ("like", "ilike", "in", "between")
            expr = self._binop_tail(left, inner)
            if isinstance(expr, A.BinOp):  # LIKE
                return A.UnaryOp("not", expr)
            if isinstance(expr, (A.InList, A.InSubquery)):
                return type(expr)(expr.operand, expr.items, True) if isinstance(
                    expr, A.InList
                ) else A.InSubquery(expr.operand, expr.query, True)
            if isinstance(expr, A.Between):
                return A.Between(expr.operand, expr.low, expr.high, True)
            return A.UnaryOp("not", expr)
        self.advance()
        prec = _PRECEDENCE[op]
        if op == "is":
            negated = bool(self.eat_kw("not"))
            if self.eat_kw("null"):
                return A.IsNull(left, negated)
            if self.eat_kw("true"):
                cmp = A.BinOp("=", left, A.Literal(True))
                return A.UnaryOp("not", cmp) if negated else cmp
            if self.eat_kw("false"):
                cmp = A.BinOp("=", left, A.Literal(False))
                return A.UnaryOp("not", cmp) if negated else cmp
            if self.eat_kw("distinct", "from"):
                right = self.parse_expr(prec + 1)
                return A.BinOp("is distinct from" if not negated else "is not distinct from", left, right)
            self.error("expected NULL/TRUE/FALSE after IS")
        if op == "between":
            symmetric = bool(self.eat_kw("symmetric"))
            low = self.parse_expr(_PRECEDENCE["between"] + 1)
            self.expect_kw("and")
            high = self.parse_expr(_PRECEDENCE["between"] + 1)
            if symmetric:
                # BETWEEN SYMMETRIC: two-sided OR over SHARED operand
                # nodes (frozen AST) — wrapping the bounds in
                # least/greatest would analyze and evaluate each bound
                # expression twice
                return A.BinOp(
                    "or",
                    A.Between(left, low, high),
                    A.Between(left, high, low),
                )
            return A.Between(left, low, high)
        if op == "in":
            self.expect_op("(")
            if self.at_kw("select") or self.at_kw("values") or (
                self.at_kw("with")
            ):
                q = self.parse_select()
                self.expect_op(")")
                return A.InSubquery(left, q)
            items = [self.parse_expr()]
            while self.eat_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            if isinstance(left, A.RowExpr):
                # row-value IN: (a, b) IN ((1, 2), ...) desugars to
                # OR-of-AND equalities (transformAExprIn's row case);
                # frozen AST nodes share safely, no copies
                ors = None
                for it in items:
                    if not isinstance(it, A.RowExpr) or (
                        len(it.items) != len(left.items)
                    ):
                        self.error(
                            "IN list entries must be rows of the "
                            "same arity"
                        )
                    ands = self._row_eq(left, it)
                    ors = (
                        ands if ors is None
                        else A.BinOp("or", ors, ands)
                    )
                return ors
            return A.InList(left, tuple(items))
        if op in ("like", "ilike"):
            right = self.parse_expr(prec + 1)
            if self.eat_kw("escape"):
                esc = self._string_lit()
                if len(esc) != 1:
                    self.error("ESCAPE must be a single character")
                if not (
                    isinstance(right, A.Literal)
                    and isinstance(right.value, str)
                ):
                    self.error("ESCAPE requires a literal pattern")
                # rewrite the custom escape to the matcher's backslash
                out = []
                i = 0
                pat = right.value
                while i < len(pat):
                    c = pat[i]
                    if c == esc:
                        if i + 1 >= len(pat):
                            self.error(
                                "LIKE pattern must not end with "
                                "escape character"
                            )
                        out.append("\\" + pat[i + 1])
                        i += 2
                        continue
                    if c == "\\":
                        out.append("\\\\")
                    else:
                        out.append(c)
                    i += 1
                right = A.Literal("".join(out))
            return A.BinOp(op, left, right)
        if op == "!=":
            op = "<>"
        right = self.parse_expr(prec + 1)
        if op in ("=", "<>") and (
            isinstance(left, A.RowExpr) or isinstance(right, A.RowExpr)
        ):
            # row comparison: (a, b) = (c, d) desugars to pairwise
            # equality; <> is its negation (transformAExprOp row case)
            if not (
                isinstance(left, A.RowExpr)
                and isinstance(right, A.RowExpr)
                and len(left.items) == len(right.items)
            ):
                self.error(
                    "row comparisons need rows of the same arity "
                    "on both sides"
                )
            ands = self._row_eq(left, right)
            return ands if op == "=" else A.UnaryOp("not", ands)
        return A.BinOp(op, left, right)

    @staticmethod
    def _row_eq(left: "A.RowExpr", right: "A.RowExpr") -> A.Expr:
        ands = None
        for lhs, rhs in zip(left.items, right.items):
            eq = A.BinOp("=", lhs, rhs)
            ands = eq if ands is None else A.BinOp("and", ands, eq)
        return ands

    def _unary(self) -> A.Expr:
        if self.eat_kw("not"):
            return A.UnaryOp("not", self.parse_expr(3))
        if self.eat_op("-"):
            operand = self._unary_postfix()
            if isinstance(operand, A.Literal) and isinstance(operand.value, (int, float)):
                return A.Literal(-operand.value)
            return A.UnaryOp("-", operand)
        if self.eat_op("+"):
            return self._unary_postfix()
        return self._unary_postfix()

    def _unary_postfix(self) -> A.Expr:
        expr = self._primary()
        while self.eat_op("::"):
            type_name = self.ident("type name")
            type_args: tuple[int, ...] = ()
            if self.eat_op("("):
                args = [self._int_lit()]
                while self.eat_op(","):
                    args.append(self._int_lit())
                self.expect_op(")")
                type_args = tuple(args)
            expr = A.Cast(expr, type_name, type_args)
        return expr

    def _primary(self) -> A.Expr:
        t = self.cur
        if t.kind == Tok.NUMBER:
            self.advance()
            v = t.value
            if "." in v or "e" in v.lower():
                return A.Literal(float(v))
            return A.Literal(int(v))
        if t.kind == Tok.STRING:
            self.advance()
            return A.Literal(t.value)
        if t.kind == Tok.PARAM:
            self.advance()
            return A.Param(int(t.value))
        if t.kind == Tok.OP and t.value == "(":
            self.advance()
            if self.at_kw("select") or self.at_kw("with"):
                q = self.parse_select()
                self.expect_op(")")
                return A.ScalarSubquery(q)
            expr = self.parse_expr()
            if self.at_op(","):
                # (a, b, ...) row constructor — desugared by IN
                parts = [expr]
                while self.eat_op(","):
                    parts.append(self.parse_expr())
                self.expect_op(")")
                return A.RowExpr(tuple(parts))
            self.expect_op(")")
            return expr
        if t.kind != Tok.IDENT:
            self.error("expected expression")
        kw = t.value
        if kw in _RESERVED:
            self.error("expected expression")
        if kw == "null":
            self.advance()
            return A.Literal(None)
        if kw == "true":
            self.advance()
            return A.Literal(True)
        if kw == "false":
            self.advance()
            return A.Literal(False)
        if kw == "case":
            return self._case_expr()
        if kw == "cast":
            self.advance()
            self.expect_op("(")
            operand = self.parse_expr()
            self.expect_kw("as")
            type_name = self.ident("type name")
            if type_name == "double" and self.eat_kw("precision"):
                type_name = "float8"
            elif type_name == "character" and self.eat_kw("varying"):
                type_name = "varchar"
            type_args: tuple[int, ...] = ()
            if self.eat_op("("):
                args = [self._int_lit()]
                while self.eat_op(","):
                    args.append(self._int_lit())
                self.expect_op(")")
                type_args = tuple(args)
            self.expect_op(")")
            return A.Cast(operand, type_name, type_args)
        if kw == "extract":
            self.advance()
            self.expect_op("(")
            field_name = self.ident("field")
            self.expect_kw("from")
            operand = self.parse_expr()
            self.expect_op(")")
            return A.Extract(field_name, operand)
        if kw == "exists":
            self.advance()
            self.expect_op("(")
            q = self.parse_select()
            self.expect_op(")")
            return A.ExistsSubquery(q)
        if kw == "interval":
            self.advance()
            text = self._string_lit()
            return A.FuncCall("interval", (A.Literal(text),))
        if kw in ("date", "timestamp") and self.peek(1).kind == Tok.STRING:
            self.advance()
            text = self._string_lit()
            return A.Cast(A.Literal(text), kw)
        # function call?
        if self.peek(1).kind == Tok.OP and self.peek(1).value == "(":
            name = self.advance().value
            self.advance()  # (
            if self.eat_op("*"):
                self.expect_op(")")
                return self._maybe_over(A.FuncCall(name, (), star=True))
            if self.at_op(")"):
                self.advance()
                return self._maybe_over(A.FuncCall(name, ()))
            distinct = bool(self.eat_kw("distinct"))
            args = [self.parse_expr()]
            if name == "substring" and self.eat_kw("from"):
                # substring(s FROM start [FOR length]) — gram.y's
                # substr_from/substr_for form of the comma call
                args.append(self.parse_expr())
                if self.eat_kw("for"):
                    args.append(self.parse_expr())
            else:
                while self.eat_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            return self._maybe_over(
                A.FuncCall(name, tuple(args), distinct=distinct)
            )
        # column ref, possibly qualified
        name = self.advance().value
        if self.at_op(".") and self.peek(1).kind == Tok.IDENT:
            self.advance()
            col = self.advance().value
            return A.ColumnRef(col, name)
        return A.ColumnRef(name)

    def _case_expr(self) -> A.CaseExpr:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        whens = []
        while self.eat_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            val = self.parse_expr()
            whens.append((cond, val))
        default = self.parse_expr() if self.eat_kw("else") else None
        self.expect_kw("end")
        return A.CaseExpr(operand, tuple(whens), default)


# fully reserved words: never valid as a bare column reference
_RESERVED = {
    "select", "from", "where", "group", "having", "order", "limit", "offset",
    "union", "intersect", "except", "join", "on", "when", "then", "else",
    "end", "and", "or", "insert", "update", "delete", "into", "values",
}

# keywords that terminate an implicit alias position
_CLAUSE_KEYWORDS = {
    "from", "where", "group", "having", "order", "limit", "offset", "union",
    "intersect", "except", "on", "using", "join", "inner", "left", "right",
    "full", "cross", "as", "and", "or", "not", "in", "like", "ilike", "is",
    "between", "when", "then", "else", "end", "asc", "desc", "nulls",
    "returning", "set", "values", "distribute", "to", "partition", "for",
}


def parse(sql: str) -> list[A.Statement]:
    """Parse a semicolon-separated script into statements."""
    return Parser(sql).parse_statements()


def parse_one(sql: str) -> A.Statement:
    stmts = parse(sql)
    if len(stmts) != 1:
        raise ParseError(f"expected exactly one statement, got {len(stmts)}")
    return stmts[0]

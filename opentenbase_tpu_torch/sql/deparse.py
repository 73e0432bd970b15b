"""AST -> SQL deparser — the ruleutils.c analog (deparse_query,
src/backend/utils/adt/ruleutils.c:5070).

The reference reverse-compiles Query trees to SQL for FQS/RemoteQuery
shipping and view definitions. Here plan shipping is the portable serde
(plan/serde.py), so the deparser's jobs are the tooling ones: rendering
view/query definitions, shipping statements to peers as text (EXECUTE
DIRECT), and debugging. Round-trip property (tested): parsing the
deparsed text yields a statement that evaluates identically.
"""

from __future__ import annotations

from opentenbase_tpu_torch.sql import ast as A


class DeparseError(ValueError):
    pass


def deparse(stmt: A.Statement) -> str:
    if isinstance(stmt, A.Select):
        return deparse_select(stmt)
    if isinstance(stmt, A.Insert):
        cols = f" ({', '.join(stmt.columns)})" if stmt.columns else ""
        if getattr(stmt, "query", None) is not None:
            return (
                f"insert into {stmt.table}{cols} "
                f"{deparse_select(stmt.query)}{_returning(stmt)}"
            )
        rows = ", ".join(
            "(" + ", ".join(_expr(v) for v in row) + ")"
            for row in stmt.values
        )
        return (
            f"insert into {stmt.table}{cols} values {rows}"
            f"{_returning(stmt)}"
        )
    if isinstance(stmt, A.Update):
        sets = ", ".join(
            f"{c} = {_expr(v)}" for c, v in stmt.assignments
        )
        where = f" where {_expr(stmt.where)}" if stmt.where else ""
        return f"update {stmt.table} set {sets}{where}{_returning(stmt)}"
    if isinstance(stmt, A.Delete):
        where = f" where {_expr(stmt.where)}" if stmt.where else ""
        return f"delete from {stmt.table}{where}{_returning(stmt)}"
    if isinstance(stmt, A.CreateMatview):
        ine = " if not exists" if stmt.if_not_exists else ""
        opts = []
        if stmt.options.get("distribute"):
            strat = stmt.options["distribute"]
            keys = stmt.options.get("distribute_keys") or []
            opts.append(
                "distribute = " + strat
                + (f"({', '.join(keys)})" if keys else "")
            )
        if "incremental" in stmt.options:
            opts.append(
                "incremental = "
                + ("on" if stmt.options["incremental"] else "off")
            )
        with_clause = f" with ({', '.join(opts)})" if opts else ""
        return (
            f"create materialized view{ine} {stmt.name}{with_clause} "
            f"as {deparse_select(stmt.query)}"
        )
    if isinstance(stmt, A.RefreshMatview):
        conc = " concurrently" if stmt.concurrently else ""
        return f"refresh materialized view{conc} {stmt.name}"
    if isinstance(stmt, A.DropMatview):
        ie = " if exists" if stmt.if_exists else ""
        casc = " cascade" if stmt.cascade else ""
        return f"drop materialized view{ie} {stmt.name}{casc}"
    raise DeparseError(f"cannot deparse {type(stmt).__name__}")


def _returning(stmt) -> str:
    items = getattr(stmt, "returning", None)
    if not items:
        return ""
    return " returning " + ", ".join(_item(i) for i in items)


def deparse_select(sel: A.Select) -> str:
    parts = ["select"]
    if sel.distinct:
        parts.append("distinct")
    parts.append(", ".join(_item(i) for i in sel.items))
    if sel.from_clause is not None:
        parts.append("from " + _tableref(sel.from_clause))
    if sel.where is not None:
        parts.append("where " + _expr(sel.where))
    if sel.group_by:
        parts.append(
            "group by " + ", ".join(_expr(g) for g in sel.group_by)
        )
    if sel.having is not None:
        parts.append("having " + _expr(sel.having))
    for op, branch in sel.set_ops:
        parts.append(f"{op} {deparse_select(branch)}")
    if sel.order_by:
        keys = []
        for k in sel.order_by:
            s = _expr(k.expr)
            if k.descending:
                s += " desc"
            if k.nulls_first is True:
                s += " nulls first"
            elif k.nulls_first is False:
                s += " nulls last"
            keys.append(s)
        parts.append("order by " + ", ".join(keys))
    if sel.limit is not None:
        parts.append("limit " + _expr(sel.limit))
    if sel.offset is not None:
        parts.append("offset " + _expr(sel.offset))
    if sel.for_update:
        parts.append(f"for {sel.for_update}")
        if sel.lock_nowait:
            parts.append("nowait")
    return " ".join(parts)


def _item(i: A.SelectItem) -> str:
    s = _expr(i.expr)
    if i.alias:
        s += f" as {i.alias}"
    return s


def _tableref(r: A.TableRef) -> str:
    if isinstance(r, A.RelRef):
        return r.name + (f" {r.alias}" if r.alias else "")
    if isinstance(r, A.SubqueryRef):
        return f"({deparse_select(r.query)}) {r.alias}"
    if isinstance(r, A.JoinRef):
        jt = r.join_type
        left = _tableref(r.left)
        right = _tableref(r.right)
        if jt == "cross":
            return f"{left} cross join {right}"
        word = {"inner": "join"}.get(jt, f"{jt} join")
        if r.using:
            return f"{left} {word} {right} using ({', '.join(r.using)})"
        on = f" on {_expr(r.condition)}" if r.condition is not None else ""
        return f"{left} {word} {right}{on}"
    raise DeparseError(f"cannot deparse table ref {type(r).__name__}")


def _expr(e: A.Expr) -> str:
    if isinstance(e, A.Literal):
        v = e.value
        if v is None:
            return "null"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        return str(v)
    if isinstance(e, A.ColumnRef):
        return f"{e.table}.{e.name}" if e.table else e.name
    if isinstance(e, A.Star):
        return f"{e.table}.*" if getattr(e, "table", None) else "*"
    if isinstance(e, A.Param):
        return f"${e.index}"
    if isinstance(e, A.BinOp):
        return f"({_expr(e.left)} {e.op} {_expr(e.right)})"
    if isinstance(e, A.UnaryOp):
        return f"({e.op} {_expr(e.operand)})"
    if isinstance(e, A.IsNull):
        n = "not " if e.negated else ""
        return f"({_expr(e.operand)} is {n}null)"
    if isinstance(e, A.Between):
        n = "not " if e.negated else ""
        return (
            f"({_expr(e.operand)} {n}between {_expr(e.low)} "
            f"and {_expr(e.high)})"
        )
    if isinstance(e, A.InList):
        n = "not " if e.negated else ""
        items = ", ".join(_expr(i) for i in e.items)
        return f"({_expr(e.operand)} {n}in ({items}))"
    if isinstance(e, A.InSubquery):
        n = "not " if e.negated else ""
        return (
            f"({_expr(e.operand)} {n}in ({deparse_select(e.query)}))"
        )
    if isinstance(e, A.ExistsSubquery):
        n = "not " if e.negated else ""
        return f"({n}exists ({deparse_select(e.query)}))"
    if isinstance(e, A.ScalarSubquery):
        return f"({deparse_select(e.query)})"
    if isinstance(e, A.FuncCall):
        if getattr(e, "star", False):
            return f"{e.name}(*)"
        d = "distinct " if getattr(e, "distinct", False) else ""
        args = ", ".join(_expr(a) for a in e.args)
        return f"{e.name}({d}{args})"
    if isinstance(e, A.WindowCall):
        base = _expr(e.func)
        over = []
        if e.partition_by:
            over.append(
                "partition by "
                + ", ".join(_expr(p) for p in e.partition_by)
            )
        if e.order_by:
            keys = []
            for k in e.order_by:
                s = _expr(k.expr)
                if k.descending:
                    s += " desc"
                if k.nulls_first is True:
                    s += " nulls first"
                elif k.nulls_first is False:
                    s += " nulls last"
                keys.append(s)
            over.append("order by " + ", ".join(keys))
        if e.frame is not None:
            def bnd(v, is_start):
                if v is None:
                    return (
                        "unbounded preceding" if is_start
                        else "unbounded following"
                    )
                if v == 0:
                    return "current row"
                if v < 0:
                    return f"{-v} preceding"
                return f"{v} following"

            over.append(
                f"rows between {bnd(e.frame[0], True)} "
                f"and {bnd(e.frame[1], False)}"
            )
        return f"{base} over ({' '.join(over)})"
    if isinstance(e, A.Cast):
        targs = (
            "(" + ", ".join(str(a) for a in e.type_args) + ")"
            if e.type_args else ""
        )
        return f"cast({_expr(e.operand)} as {e.type_name}{targs})"
    if isinstance(e, A.CaseExpr):
        out = ["case"]
        if getattr(e, "operand", None) is not None:
            out.append(_expr(e.operand))
        for cond, val in e.whens:
            out.append(f"when {_expr(cond)} then {_expr(val)}")
        if e.default is not None:
            out.append(f"else {_expr(e.default)}")
        out.append("end")
        return " ".join(out)
    if isinstance(e, A.Extract):
        return f"extract({e.field_name} from {_expr(e.operand)})"
    raise DeparseError(f"cannot deparse expr {type(e).__name__}")

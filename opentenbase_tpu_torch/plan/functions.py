"""SQL-language functions: registry + inline expansion.

The reference executes SQL functions through fmgr/functions.c and inlines
simple ones during planning (inline_function, optimizer/util/clauses.c).
Here CREATE FUNCTION ... LANGUAGE SQL stores a parsed body template and
every statement expands calls BEFORE analysis:

- a FROM-less single-expression body inlines as the expression itself
  (usable anywhere an expression is);
- a table-reading body inlines as a scalar subquery.

Argument references in the body (by name, or $1..$n positionally) are
substituted with the call's argument expressions; argument names shadow
same-named columns inside the body (callers pick distinct names to reach
both). Recursion is depth-limited — SQL functions are not recursive in
PG either.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass

from opentenbase_tpu_torch.sql import ast as A
from opentenbase_tpu_torch.sql import parse

MAX_DEPTH = 10


class FunctionError(RuntimeError):
    pass


@dataclass
class SqlFunction:
    name: str
    argnames: tuple[str, ...]
    argtypes: tuple[str, ...]
    rettype: str
    body: str  # original text (pg_proc / dump / recovery)
    template: object  # ("expr", Expr) | ("select", Select)

    @staticmethod
    def create(name, args, rettype, body) -> "SqlFunction":
        try:
            stmts = parse(body)
        except Exception as e:
            raise FunctionError(f"invalid function body: {e}")
        if len(stmts) != 1 or not isinstance(stmts[0], A.Select):
            raise FunctionError(
                "function body must be a single SELECT"
            )
        sel = stmts[0]
        if (
            sel.from_clause is None
            and len(sel.items) == 1
            and not sel.set_ops
            and not sel.group_by
            and sel.where is None
        ):
            template = ("expr", sel.items[0].expr)
        else:
            template = ("select", sel)
        return SqlFunction(
            name,
            tuple(a[0] for a in args),
            tuple(a[1] for a in args),
            rettype,
            body,
            template,
        )


def _subst_args(node, binding: dict):
    """Replace arg references (ColumnRef by name, Param by position) in a
    deep-copied template fragment."""
    if isinstance(node, A.ColumnRef) and node.table is None and (
        node.name in binding
    ):
        return binding[node.name]
    if isinstance(node, A.Param):
        key = f"${node.index}"
        if key in binding:
            return binding[key]
        return node
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = _subst_field(v, binding)
            if nv is not v:
                changes[f.name] = nv
        if changes:
            if getattr(node, "__dataclass_params__").frozen:
                return dataclasses.replace(node, **changes)
            for k, v in changes.items():
                setattr(node, k, v)
        return node
    return node


def _subst_field(v, binding):
    if isinstance(v, (A.Expr, A.Statement, A.TableRef, A.SelectItem,
                      A.SortItem)):
        return _subst_args(v, binding)
    if isinstance(v, list):
        out = [_subst_field(x, binding) for x in v]
        return out if any(a is not b for a, b in zip(out, v)) else v
    if isinstance(v, tuple):
        out = tuple(_subst_field(x, binding) for x in v)
        return out if any(a is not b for a, b in zip(out, v)) else v
    return v


def expand_calls(node, funcs: dict, depth: int = 0, pl_eval=None):
    """Rewrite FuncCall nodes whose name is a registered SQL function.
    Returns the (possibly replaced) node. Calls to PL/pgSQL functions
    (fn.language == 'plpgsql') are EVALUATED through ``pl_eval`` —
    their bodies are procedural, not inlinable — and replaced by the
    result literal; their arguments must fold to constants first (the
    reference evaluates them through SPI at executor time; this engine
    runs them at rewrite time, so only constant calls qualify)."""
    if depth > MAX_DEPTH:
        raise FunctionError(
            "SQL function nesting exceeds the recursion limit"
        )
    if isinstance(node, A.FuncCall) and node.name in funcs:
        fn = funcs[node.name]
        args = [
            expand_calls(a, funcs, depth, pl_eval) for a in node.args
        ]
        if len(args) != len(fn.argnames):
            raise FunctionError(
                f"function {fn.name}() expects {len(fn.argnames)} "
                f"arguments, got {len(args)}"
            )
        if getattr(fn, "language", "sql") == "plpgsql":
            if pl_eval is None:
                raise FunctionError(
                    f"plpgsql function {fn.name}() cannot run here"
                )
            vals = []
            for a in args:
                if not isinstance(a, A.Literal):
                    raise FunctionError(
                        f"plpgsql function {fn.name}() requires "
                        "constant arguments"
                    )
                vals.append(a.value)
            return A.Literal(pl_eval(fn, vals))
        binding = dict(zip(fn.argnames, args))
        for i, a in enumerate(args):
            binding[f"${i + 1}"] = a
        kind, tmpl = fn.template
        bound = _subst_args(copy.deepcopy(tmpl), binding)
        if kind == "expr":
            inlined = bound
        else:
            inlined = A.ScalarSubquery(bound)
        # the body may itself call SQL functions
        return expand_calls(inlined, funcs, depth + 1, pl_eval)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = _walk_field(v, funcs, depth, pl_eval)
            if nv is not v:
                changes[f.name] = nv
        if changes:
            if getattr(node, "__dataclass_params__").frozen:
                return dataclasses.replace(node, **changes)
            for k, v in changes.items():
                setattr(node, k, v)
    return node


def _walk_field(v, funcs, depth, pl_eval=None):
    if isinstance(v, (A.Expr, A.Statement, A.TableRef, A.SelectItem,
                      A.SortItem)):
        return expand_calls(v, funcs, depth, pl_eval)
    if isinstance(v, list):
        out = [_walk_field(x, funcs, depth, pl_eval) for x in v]
        return out if any(a is not b for a, b in zip(out, v)) else v
    if isinstance(v, tuple):
        out = tuple(_walk_field(x, funcs, depth, pl_eval) for x in v)
        return out if any(a is not b for a, b in zip(out, v)) else v
    return v

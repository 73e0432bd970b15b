"""PL/pgSQL subset: procedural function bodies.

The reference runs PL/pgSQL through src/pl/plpgsql (pl_gram.y grammar,
pl_exec.c interpreter). This is the same two-layer shape scaled to the
engine: a small recursive-descent parser builds a statement tree once at
CREATE FUNCTION time, and an interpreter executes it per call against a
Session — SQL statements inside the body (SELECT INTO, DML, PERFORM) run
through the ordinary engine, with PL variables substituted as literals
the way pl_exec.c binds them as parameters.

Supported grammar (the procedural core):

    [DECLARE  name type [:= expr]; ...]
    BEGIN
        name := expr;
        IF expr THEN ... [ELSIF expr THEN ...] [ELSE ...] END IF;
        WHILE expr LOOP ... END LOOP;
        FOR name IN expr .. expr [BY expr] LOOP ... END LOOP;
        RETURN expr;
        RAISE [EXCEPTION] 'format with %' [, expr ...];
        SELECT ... INTO var [, var ...] ...;
        <any other SQL statement>;   -- INSERT/UPDATE/DELETE/PERFORM
    END

Expressions are SQL expressions, evaluated as ``SELECT <expr>`` with
variables bound by literal substitution; a statement budget stops
runaway loops.

Name resolution: PL variables (and arguments) SHADOW same-named
columns in embedded SQL — pick distinct names to reach both (the same
rule the SQL-function inliner documents; PostgreSQL would raise an
ambiguity error where this engine substitutes the variable).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

MAX_STEPS = 100_000

_TOKEN_RE = re.compile(
    r"""
    \s+
  | --[^\n]*
  | '(?:[^']|'')*'          # string literal
  | \d+\.\d+ | \.\d+ | \d+  # numbers
  | :=|\.\.|<=|>=|<>|!=|\|\|
  | [A-Za-z_][A-Za-z_0-9]*
  | .
    """,
    re.VERBOSE,
)


class PlpgsqlError(RuntimeError):
    pass


def _tokenize(body: str) -> list[str]:
    out = []
    for m in _TOKEN_RE.finditer(body):
        t = m.group(0)
        if t.isspace() or t.startswith("--"):
            continue
        out.append(t)
    return out


def _is_ident(t: str) -> bool:
    return bool(re.fullmatch(r"[A-Za-z_][A-Za-z_0-9]*", t))


# -- statement tree ---------------------------------------------------------


@dataclass
class _Assign:
    name: str
    expr: list  # token span


@dataclass
class _If:
    arms: list  # [(cond tokens, stmts)]
    orelse: list


@dataclass
class _While:
    cond: list
    body: list


@dataclass
class _For:
    var: str
    lo: list
    hi: list
    step: list
    body: list


@dataclass
class _Return:
    expr: list


@dataclass
class _LoopCtl:
    kind: str  # 'exit' | 'continue'
    cond: list  # WHEN tokens ([] = unconditional)


@dataclass
class _ForQuery:
    var: str
    sql: list  # SELECT tokens (single output column)
    body: list


@dataclass
class _Raise:
    fmt: str
    args: list  # list of token spans
    level: str = "exception"  # 'exception' aborts; 'notice' logs


@dataclass
class _Sql:
    tokens: list
    into: list = field(default_factory=list)  # target var names


@dataclass
class Block:
    decls: list  # [(name, type, default tokens|None)]
    stmts: list


# -- parser -----------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: list[str]):
        self.t = tokens
        self.i = 0

    def peek(self, k: int = 0):
        j = self.i + k
        return self.t[j].lower() if j < len(self.t) else None

    def next(self) -> str:
        if self.i >= len(self.t):
            raise PlpgsqlError("unexpected end of function body")
        t = self.t[self.i]
        self.i += 1
        return t

    def expect(self, word: str) -> None:
        t = self.next()
        if t.lower() != word:
            raise PlpgsqlError(f"expected {word!r}, got {t!r}")

    def eat(self, word: str) -> bool:
        if self.peek() == word:
            self.i += 1
            return True
        return False

    def parse_block(self) -> Block:
        decls = []
        if self.eat("declare"):
            while self.peek() not in ("begin", None):
                name = self.next()
                if not _is_ident(name):
                    raise PlpgsqlError(f"bad variable name {name!r}")
                ty = self.next()
                default = None
                if self.eat(":=") or (
                    self.peek() == "default" and self.eat("default")
                ):
                    default = self._until(";")
                else:
                    self.expect(";")
                    decls.append((name.lower(), ty, None))
                    continue
                decls.append((name.lower(), ty, default))
        self.expect("begin")
        stmts = self._stmts(("end",))
        self.expect("end")
        self.eat(";")
        if self.i < len(self.t):
            raise PlpgsqlError(
                f"trailing tokens after END: {self.t[self.i]!r}"
            )
        return Block(decls, stmts)

    def _until(self, *stops: str) -> list:
        """Token span up to (and consuming) one of ``stops``. CASE
        expressions nest: their THEN/END tokens belong to the
        expression, not to the surrounding IF/LOOP grammar."""
        out = []
        depth = 0
        while True:
            t = self.next()
            tl = t.lower()
            if tl == "case":
                depth += 1
            elif depth > 0 and tl == "end":
                depth -= 1
            elif depth == 0 and tl in stops:
                return out
            out.append(t)

    def _stmts(self, stops: tuple) -> list:
        out = []
        while self.peek() is not None and self.peek() not in stops:
            out.append(self._stmt())
        return out

    def _stmt(self):
        p = self.peek()
        if p == "return":
            self.next()
            return _Return(self._until(";"))
        if p == "raise":
            self.next()
            level = "exception"
            for lv in ("exception", "notice", "warning", "info",
                       "debug", "log"):
                if self.eat(lv):
                    level = lv
                    break
            fmt_tok = self.next()
            if not fmt_tok.startswith("'"):
                raise PlpgsqlError("RAISE requires a format string")
            fmt = fmt_tok[1:-1].replace("''", "'")
            args = []
            while self.eat(","):
                span = []
                while self.peek() not in (",", ";", None):
                    span.append(self.next())
                args.append(span)
            self.expect(";")
            return _Raise(
                fmt, args,
                "exception" if level == "exception" else "notice",
            )
        if p == "if":
            self.next()
            arms = []
            cond = self._until("then")
            arms.append((cond, self._stmts(("elsif", "else", "end"))))
            while self.eat("elsif"):
                cond = self._until("then")
                arms.append(
                    (cond, self._stmts(("elsif", "else", "end")))
                )
            orelse = []
            if self.eat("else"):
                orelse = self._stmts(("end",))
            self.expect("end")
            self.expect("if")
            self.expect(";")
            return _If(arms, orelse)
        if p == "while":
            self.next()
            cond = self._until("loop")
            body = self._stmts(("end",))
            self.expect("end")
            self.expect("loop")
            self.expect(";")
            return _While(cond, body)
        if p == "for":
            self.next()
            var = self.next().lower()
            self.expect("in")
            if self.peek() == "select":
                # FOR var IN <query> LOOP (pl_exec.c's stmt_fors):
                # iterate the (single-column) result rows
                sql = self._until("loop")
                body = self._stmts(("end",))
                self.expect("end")
                self.expect("loop")
                self.expect(";")
                return _ForQuery(var, sql, body)
            lo = self._until("..")
            hi = []
            step = ["1"]
            while True:
                t = self.next()
                tl = t.lower()
                if tl == "loop":
                    break
                if tl == "by":
                    step = self._until("loop")
                    break
                hi.append(t)
            body = self._stmts(("end",))
            self.expect("end")
            self.expect("loop")
            self.expect(";")
            return _For(var, lo, hi, step, body)
        if p in ("exit", "continue"):
            kind = self.next().lower()
            cond: list = []
            if self.eat("when"):
                cond = self._until(";")
            else:
                self.expect(";")
            return _LoopCtl(kind, cond)
        # assignment: ident := expr ;
        if _is_ident(p or "") and self.peek(1) == ":=":
            name = self.next().lower()
            self.next()  # :=
            return _Assign(name, self._until(";"))
        # raw SQL statement (SELECT [INTO] / INSERT / UPDATE / DELETE /
        # PERFORM): capture tokens to ';', extracting the INTO targets
        toks = []
        into: list = []
        if self.eat("perform"):
            toks = ["select"]
        while True:
            t = self.next()
            if t == ";":
                break
            if t.lower() == "into" and toks and (
                toks[0].lower() == "select"
            ):
                while True:
                    v = self.next()
                    into.append(v.lower())
                    if not self.eat(","):
                        break
                continue
            toks.append(t)
        if not toks:
            raise PlpgsqlError("empty statement")
        return _Sql(toks, into)


# -- interpreter ------------------------------------------------------------


class _ReturnValue(Exception):
    def __init__(self, value):
        self.value = value


class _ExitLoop(Exception):
    pass


class _ContinueLoop(Exception):
    pass


def _format_raise(fmt: str, vals: list) -> str:
    """RAISE placeholder substitution: one left-to-right pass so a
    substituted value containing '%' is never re-consumed; '%%' is a
    literal percent."""
    out = []
    ai = 0
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%":
            if i + 1 < len(fmt) and fmt[i + 1] == "%":
                out.append("%")
                i += 2
                continue
            out.append(str(vals[ai]) if ai < len(vals) else "%")
            ai += 1
            i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _render_literal(v) -> str:
    import datetime
    import decimal

    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float, decimal.Decimal)):
        return str(v)
    if isinstance(v, datetime.datetime):
        return f"timestamp '{v.isoformat(sep=' ')}'"
    if isinstance(v, datetime.date):
        return f"date '{v.isoformat()}'"
    s = str(v).replace("'", "''")
    return f"'{s}'"


@dataclass
class PlpgsqlFunction:
    name: str
    argnames: tuple
    argtypes: tuple
    rettype: str
    body: str
    block: Block
    language = "plpgsql"

    @staticmethod
    def create(name, args, rettype, body) -> "PlpgsqlFunction":
        try:
            block = _Parser(_tokenize(body)).parse_block()
        except PlpgsqlError as e:
            raise PlpgsqlError(f"in function {name!r}: {e}")
        return PlpgsqlFunction(
            name,
            tuple(a.lower() for a, _t in args),
            tuple(t for _a, t in args),
            rettype,
            body,
            block,
        )

    # -- execution ---------------------------------------------------
    def execute(self, session, argvals):
        if len(argvals) != len(self.argnames):
            raise PlpgsqlError(
                f"{self.name}() expects {len(self.argnames)} "
                f"arguments, got {len(argvals)}"
            )
        env = dict(zip(self.argnames, argvals))
        budget = [MAX_STEPS]
        for name, _ty, default in self.block.decls:
            env[name] = (
                self._eval(session, default, env)
                if default is not None else None
            )
        try:
            self._run(session, self.block.stmts, env, budget)
        except _ReturnValue as r:
            return r.value
        except (_ExitLoop, _ContinueLoop):
            raise PlpgsqlError(
                "EXIT/CONTINUE cannot be used outside a loop"
            ) from None
        raise PlpgsqlError(
            f"control reached end of function {self.name!r} "
            "without RETURN"
        )

    def _run(self, session, stmts, env, budget) -> None:
        for st in stmts:
            budget[0] -= 1
            if budget[0] <= 0:
                raise PlpgsqlError(
                    f"function {self.name!r} exceeded "
                    f"{MAX_STEPS} statements (infinite loop?)"
                )
            if isinstance(st, _Return):
                raise _ReturnValue(
                    self._eval(session, st.expr, env)
                )
            if isinstance(st, _Assign):
                if st.name not in env:
                    raise PlpgsqlError(
                        f"unknown variable {st.name!r}"
                    )
                env[st.name] = self._eval(session, st.expr, env)
            elif isinstance(st, _If):
                done = False
                for cond, body in st.arms:
                    if self._eval(session, cond, env):
                        self._run(session, body, env, budget)
                        done = True
                        break
                if not done:
                    self._run(session, st.orelse, env, budget)
            elif isinstance(st, _While):
                while self._eval(session, st.cond, env):
                    budget[0] -= 1
                    if budget[0] <= 0:
                        raise PlpgsqlError(
                            f"function {self.name!r} exceeded "
                            f"{MAX_STEPS} statements"
                        )
                    try:
                        self._run(session, st.body, env, budget)
                    except _ContinueLoop:
                        continue
                    except _ExitLoop:
                        break
            elif isinstance(st, _For):
                lo = self._eval(session, st.lo, env)
                hi = self._eval(session, st.hi, env)
                step = self._eval(session, st.step, env)
                if not step:
                    raise PlpgsqlError("FOR step must not be zero")
                v = lo
                while (v <= hi) if step > 0 else (v >= hi):
                    env[st.var] = v
                    budget[0] -= 1
                    if budget[0] <= 0:
                        raise PlpgsqlError(
                            f"function {self.name!r} exceeded "
                            f"{MAX_STEPS} statements"
                        )
                    try:
                        self._run(session, st.body, env, budget)
                    except _ContinueLoop:
                        pass
                    except _ExitLoop:
                        break
                    v = v + step
            elif isinstance(st, _ForQuery):
                sql = self._subst(st.sql, env)
                rows = session.query(sql)
                if rows and len(rows[0]) != 1:
                    raise PlpgsqlError(
                        "FOR ... IN <query> needs a single-column "
                        "SELECT (record variables are not supported)"
                    )
                for (val,) in rows:
                    env[st.var] = val
                    budget[0] -= 1
                    if budget[0] <= 0:
                        raise PlpgsqlError(
                            f"function {self.name!r} exceeded "
                            f"{MAX_STEPS} statements"
                        )
                    try:
                        self._run(session, st.body, env, budget)
                    except _ContinueLoop:
                        continue
                    except _ExitLoop:
                        break
            elif isinstance(st, _LoopCtl):
                fire = (
                    True if not st.cond
                    else bool(self._eval(session, st.cond, env))
                )
                if fire:
                    raise (
                        _ExitLoop() if st.kind == "exit"
                        else _ContinueLoop()
                    )
            elif isinstance(st, _Raise):
                vals = [
                    self._eval(session, a, env) for a in st.args
                ]
                msg = _format_raise(st.fmt, vals)
                if st.level == "exception":
                    raise PlpgsqlError(msg)
                # NOTICE/WARNING/...: log and continue (elog level
                # below ERROR never aborts, elog.c)
                import logging

                logging.getLogger("opentenbase_tpu_torch.plpgsql").info(
                    "%s: %s", self.name, msg
                )
            elif isinstance(st, _Sql):
                self._run_sql(session, st, env)

    def _subst(self, tokens, env) -> str:
        out = []
        for t in tokens:
            key = t.lower() if _is_ident(t) else None
            if key is not None and key in env:
                out.append(_render_literal(env[key]))
            else:
                out.append(t)
        return " ".join(out)

    def _eval(self, session, tokens, env):
        sql = "select " + self._subst(tokens, env)
        rows = session.query(sql)
        return rows[0][0] if rows else None

    def _run_sql(self, session, st: _Sql, env) -> None:
        sql = self._subst(st.tokens, env)
        res = session.execute(sql)
        if st.into:
            row = res.rows[0] if res.rows else None
            for i, var in enumerate(st.into):
                if var not in env:
                    raise PlpgsqlError(
                        f"unknown INTO target {var!r}"
                    )
                env[var] = (
                    row[i] if row is not None and i < len(row)
                    else None
                )

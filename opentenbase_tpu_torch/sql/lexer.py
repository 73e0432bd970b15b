"""SQL lexer.

Equivalent scope: the token kinds src/backend/parser/scan.l produces, minus
exotica (dollar-quoting, unicode escapes, binary strings). Keywords are not
reserved at lex time — the parser decides contextually, like PG's
unreserved-keyword classes.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass


class Tok(enum.Enum):
    IDENT = "ident"
    NUMBER = "number"
    STRING = "string"
    PARAM = "param"  # $1, $2 ... (extended-protocol parameters)
    OP = "op"
    EOF = "eof"


@dataclass(frozen=True)
class Token:
    kind: Tok
    value: str
    pos: int  # character offset, for error messages

    def __repr__(self):
        return f"{self.kind.value}:{self.value}"


# Multi-char operators, longest first.
_OPERATORS = [
    "<>", "!=", ">=", "<=", "||", "::",
    "+", "-", "*", "/", "%", "^", "(", ")", ",", ".", ";", "=", "<", ">", "[", "]",
]
# the same operators by length: a two-character match wins, as the
# longest-first scan above gives, in one set lookup each
_OPS2 = frozenset(op for op in _OPERATORS if len(op) == 2)
_OPS1 = frozenset(op for op in _OPERATORS if len(op) == 1)
# a run of whitespace; an identifier's continuation: \w is exactly
# str.isalnum() or '_' (re's documented definition), '$' added
_WS = re.compile(r"[ \t\r\n]+")
_IDENT_CONT = re.compile(r"[\w$]*")
# a run of ASCII digits (str.isdigit() takes more: the scan steps over
# any other digit one at a time)
_DIGITS = re.compile(r"[0-9]+")


class LexError(ValueError):
    def __init__(self, msg: str, sql: str, pos: int):
        line = sql.count("\n", 0, pos) + 1
        col = pos - (sql.rfind("\n", 0, pos) + 1) + 1
        super().__init__(f"{msg} at line {line}, column {col}")
        self.pos = pos


def tokenize(sql: str) -> list[Token]:
    out: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in "(),":  # the commonest tokens; none starts anything longer
            out.append(Token(Tok.OP, c, i))
            i += 1
            continue
        if c in " \t\r\n":
            i = _WS.match(sql, i).end()
            continue
        if c == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and sql.startswith("/*", i):
            depth, j = 1, i + 2
            while j < n and depth:
                if sql.startswith("/*", j):
                    depth, j = depth + 1, j + 2
                elif sql.startswith("*/", j):
                    depth, j = depth - 1, j + 2
                else:
                    j += 1
            if depth:
                raise LexError("unterminated /* comment", sql, i)
            i = j
            continue
        if c == "'":
            # the literal's runs between quotes, a doubled '' one quote
            j = i + 1
            buf = []
            while True:
                k = sql.find("'", j)
                if k < 0:
                    raise LexError("unterminated string literal", sql, i)
                buf.append(sql[j:k])
                if k + 1 < n and sql[k + 1] == "'":  # escaped ''
                    buf.append("'")
                    j = k + 2
                    continue
                break
            out.append(Token(Tok.STRING, "".join(buf), i))
            i = k + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise LexError("unterminated quoted identifier", sql, i)
            out.append(Token(Tok.IDENT, sql[i + 1 : j], i))
            i = j + 1
            continue
        if c == "$" and i + 1 < n and sql[i + 1].isdigit():
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            out.append(Token(Tok.PARAM, sql[i + 1 : j], i))
            i = j
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    m = _DIGITS.match(sql, j)
                    j = m.end() if m else j + 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    sql[j + 1].isdigit() or sql[j + 1] in "+-"
                ):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            out.append(Token(Tok.NUMBER, sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            # '$' is a valid identifier char after the first (PG scan.l's
            # ident_cont); partition children are named parent$pK
            j = _IDENT_CONT.match(sql, i + 1).end()
            # Unquoted identifiers fold to lowercase (PG downcase_identifier).
            out.append(Token(Tok.IDENT, sql[i:j].lower(), i))
            i = j
            continue
        op = sql[i:i + 2]
        if op not in _OPS2:
            if c not in _OPS1:
                raise LexError(f"unexpected character {c!r}", sql, i)
            op = c
        out.append(Token(Tok.OP, op, i))
        i += len(op)
    out.append(Token(Tok.EOF, "", n))
    return out

"""The port's SQL lexer and its VALUES fast path (opentenbase_tpu_torch/
sql/lexer.py, parser.py ``_values_item``) held against the reference's:
seeded random strings over an alphabet of SQL's token starts, comment
and quote delimiters and non-ASCII letters and digits give the same
tokens (kind, value, position) or the same LexError, and seeded INSERT
... VALUES statements give the same statement trees."""

import random

import pytest

from opentenbase_tpu.sql import parse as ref_parse
from opentenbase_tpu.sql.lexer import LexError as RefLexError
from opentenbase_tpu.sql.lexer import tokenize as ref_tokenize
from opentenbase_tpu_torch.sql import parse as port_parse
from opentenbase_tpu_torch.sql.lexer import LexError as PortLexError
from opentenbase_tpu_torch.sql.lexer import tokenize as port_tokenize

ALPHABET = list("abcXYZ_$019 \t\r\n'\"-/*.,()<>=!|:+eE;[]%^?@") + [
    "²", "٣", "é", "中", "--", "/*", "*/", "''",
    "1e+", ".5", "1.2.3", "$1"]
VALUES_ITEMS = [
    "1", "-1", "1.5", "'a'", "'a'::date", "1e5", "null", "true", "1+2",
    "'x' || 'y'", "(1)", "$1", "date '1995-01-01'", "abs(-3)", "1 :: int",
    "'it''s'", ".5", "- 2.5", "(select 1)", "default", "current_date",
    "2 * 3", "'a' = 'b'"]


def _tokens(tokenize, error, sql):
    try:
        return [(t.kind.value, t.value, t.pos) for t in tokenize(sql)]
    except error as e:
        return ("LexError", str(e), e.pos)


@pytest.mark.parametrize("seed", range(4))
def test_tokens_are_the_references(seed):
    rng = random.Random(seed)
    for _ in range(5000):
        sql = "".join(rng.choice(ALPHABET)
                      for _ in range(rng.randint(0, 30)))
        assert (_tokens(port_tokenize, PortLexError, sql)
                == _tokens(ref_tokenize, RefLexError, sql)), sql


def _tree(parse, sql):
    try:
        return repr(parse(sql))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(2))
def test_values_rows_parse_as_the_references(seed):
    rng = random.Random(100 + seed)
    for _ in range(2000):
        rows = ",".join(
            "(" + ", ".join(rng.choice(VALUES_ITEMS)
                            for _ in range(rng.randint(1, 4))) + ")"
            for _ in range(rng.randint(1, 3)))
        tail = rng.choice(["", " returning k", " on conflict do nothing",
                           ";"])
        sql = f"insert into t values {rows}{tail}"
        assert _tree(port_parse, sql) == _tree(ref_parse, sql), sql

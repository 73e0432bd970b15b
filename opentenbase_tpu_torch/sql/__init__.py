"""SQL front end: lexer, AST, recursive-descent parser.

Replaces the reference's flex/bison front end (src/backend/parser/scan.l,
gram.y — 18k lines) with a compact hand-written recursive-descent parser
covering the analytic + transactional + cluster-DDL surface of SURVEY.md §2,
including the XL grammar extensions (DISTRIBUTE BY, CREATE NODE/GROUP,
MOVE DATA, CREATE BARRIER, EXECUTE DIRECT ON, PAUSE CLUSTER).
"""

from opentenbase_tpu_torch.sql.parser import parse, parse_one  # noqa: F401

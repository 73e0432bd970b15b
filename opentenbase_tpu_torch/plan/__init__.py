"""Query planning: analyzer, logical plan, distribution, physical fragments.

The reference splits this across src/backend/parser/analyze.c (binding),
src/backend/optimizer (paths + distribution), and src/backend/pgxc/plan
(FQS). Here:

- ``texpr``      — typed expression IR (the ExprState analog, pre-compiled).
- ``logical``    — logical operators with resolved schemas.
- ``analyze``    — AST -> logical plan binder/type-checker.
- ``distribute`` — Distribution property + fragment cutting (the
                   redistribute_path / make_remotesubplan analog).
"""

from opentenbase_tpu_torch.plan.analyze import analyze_select, analyze_statement  # noqa: F401

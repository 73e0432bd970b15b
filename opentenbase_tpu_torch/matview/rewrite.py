"""Serving-path rewrite: answer a query from a fresh matview (the
reference's opentenbase_tpu/matview/rewrite.py).

The planner-side half of the matview subsystem (OpenTenBase has no
equivalent — its matviews are only queryable by name; this is the
Napa-style serving path): when ``enable_matview_rewrite`` is on and an
incoming SELECT's canonical text exactly equals a matview's defining
query, and every base table is unchanged since the matview's last
refresh (version check against the cluster's table-write counters),
the query becomes a scan of the matview — visible in EXPLAIN as a
``Matview rewrite`` prelude line over a plain Scan.

Exact-match only, by design: the fingerprint is the deparsed canonical
text, so aliases/whitespace/case differences still match, but any
semantic difference (extra predicate, different aggregate) does not.
Containment-based rewriting (answering a narrower query from a wider
matview) is future work.
"""

from __future__ import annotations

from typing import Optional

from opentenbase_tpu_torch.matview.defs import fingerprint, is_fresh
from opentenbase_tpu_torch.sql import ast as A


def try_rewrite(cluster, sel: A.Select) -> Optional[tuple]:
    """(matview name, replacement Select) when ``sel`` exactly matches
    a fresh matview's defining query, else None."""
    if not cluster.matviews:
        return None
    # cheap pre-filter before the O(AST) canonicalization: a query
    # whose single FROM relation appears in no definition can never
    # fingerprint-match — skip the deparse for that (vast) majority
    fc = sel.from_clause
    if isinstance(fc, A.RelRef) and not any(
        isinstance(d.query.from_clause, A.RelRef)
        and d.query.from_clause.name == fc.name
        for d in cluster.matviews.values()
        if d.fingerprint is not None
    ):
        return None
    fp = fingerprint(sel)
    if fp is None:
        return None
    for name, d in cluster.matviews.items():
        if d.fingerprint != fp:
            continue
        if not cluster.catalog.has(name):
            continue
        if not is_fresh(cluster, d):
            continue
        return name, A.Select(
            items=[A.SelectItem(A.Star(), None)],
            from_clause=A.RelRef(name, None),
        )
    return None

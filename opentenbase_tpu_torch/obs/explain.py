"""Per-operator distributed EXPLAIN ANALYZE report (the reference's
opentenbase_tpu/obs/explain.py).

OpenTenBase's explain_dist.c gathers each plan node's instrumentation
from every datanode and prints one tree with min/max/avg per node.  The
host executor records the same thing (executor/local.py fills
``op_records`` pre-order while evaluating; executor/dist.py keeps one
list per in-process (fragment, node)), and this module merges and
formats it:

    Fragment 0: nodes=dn0,dn1 ->redistribute(0) [motion rows=8 bytes=512]
      Aggregate  rows=4 loops=2 avg=1.2 min=1.0 max=1.4 ms
        Scan t  rows=4 loops=2 avg=0.3 min=0.2 max=0.4 ms

``loops`` is the number of datanodes that ran the operator (the
reference prints the same aggregation for its N node copies); VERBOSE
adds the per-datanode breakdown under each operator.
"""

from __future__ import annotations

from opentenbase_tpu_torch.plan.distribute import COORDINATOR


def _node_name(node) -> str:
    return "cn" if node == COORDINATOR else f"dn{node}"


def _op_signature(ops) -> tuple:
    return tuple((r["depth"], r["op"]) for r in ops)


def _fmt_op(rec, rows, times, loops, indent) -> str:
    label = rec["op"]
    if rec.get("detail"):
        label += f" {rec['detail']}"
    avg = sum(times) / len(times)
    return (
        f"{indent}{'  ' * rec['depth']}{label}  rows={rows} "
        f"loops={loops} avg={avg:.3f} min={min(times):.3f} "
        f"max={max(times):.3f} ms"
    )


def _tree_lines(entries, verbose: bool, indent: str) -> list[str]:
    """Merge per-node operator records into one tree. Entries whose op
    sequences diverge (per-node zone pruning can change the evaluated
    shape) are printed per node instead of merged."""
    entries = [e for e in entries if e.get("ops")]
    if not entries:
        return [indent + "(no per-operator instrumentation: fragment "
                "ran in a remote DN process)"]
    sigs = {_op_signature(e["ops"]) for e in entries}
    lines: list[str] = []
    if len(sigs) == 1:
        for i, rec in enumerate(entries[0]["ops"]):
            times = [e["ops"][i]["ms"] for e in entries]
            rows = sum(e["ops"][i]["rows"] for e in entries)
            lines.append(_fmt_op(rec, rows, times, len(entries), indent))
            if verbose:
                for e in entries:
                    r = e["ops"][i]
                    lines.append(
                        f"{indent}{'  ' * rec['depth']}  on "
                        f"{_node_name(e['node'])}: rows={r['rows']} "
                        f"time={r['ms']:.3f} ms "
                        f"batch_rows={r['batch_rows']}"
                    )
        return lines
    for e in entries:  # divergent shapes: one tree per node
        lines.append(f"{indent}on {_node_name(e['node'])}:")
        for rec in e["ops"]:
            lines.append(
                _fmt_op(rec, rec["rows"], [rec["ms"]], 1, indent + "  ")
            )
    return lines


def analyze_report(dplan, ex, verbose: bool = False) -> list[str]:
    """EXPLAIN ANALYZE plan-node tree for a host-path run: ``ex`` is the
    DistExecutor that executed ``dplan`` with instrument_ops on.
    Subplan (InitPlan) entries are tagged and excluded — their fragment
    indices shadow the main plan's, and their per-fragment summaries
    already print as separate "Fragment N on dnX" lines."""
    by_frag: dict = {}
    for entry in ex.op_instrumentation:
        if entry.get("subplan") is not None:
            continue
        by_frag.setdefault(entry["fragment"], []).append(entry)
    lines: list[str] = []
    for frag in dplan.fragments:
        motion = frag.motion
        if frag.hash_positions:
            motion += f"({','.join(map(str, frag.hash_positions))})"
        head = (
            f"Fragment {frag.index}: nodes="
            f"{','.join(_node_name(n) for n in frag.nodes)} ->{motion}"
        )
        ms = ex.motion_stats.get(frag.index)
        if ms is not None:
            head += f" [motion rows={ms['rows']}"
            if ms.get("bytes") is not None:
                head += f" bytes={ms['bytes']}"
            if ms.get("peer"):
                head += " peer-exchange"
            if ms.get("ms") is not None:
                head += f" time={ms['ms']:.3f} ms"
            head += "]"
        lines.append(head)
        lines += _tree_lines(
            sorted(by_frag.get(frag.index, []), key=lambda e: e["node"]),
            verbose, "  ",
        )
    coord = by_frag.get(COORDINATOR, [])
    if coord:
        lines.append("Coordinator:")
        lines += _tree_lines(coord, verbose, "  ")
    return lines


def fragment_summary(ex) -> list[str]:
    """Per-(fragment, node) execution summary lines — rows/time plus the
    self-healing story (retries / failover) and zone pruning. Shared by
    EXPLAIN ANALYZE and auto_explain so both report identically."""
    lines: list[str] = []
    for i in ex.instrumentation:
        extra = ""
        if "total_blocks" in i:
            extra = (
                f" pruned={i['pruned_blocks']}/"
                f"{i['total_blocks']} blocks"
            )
        if i.get("retries"):
            extra += f" retries={i['retries']}"
        if i.get("failover"):
            extra += f" failover={i['failover']}"
        # a subplan's records are keyed "<subplan>:<fragment>": the
        # line names the fragment, as the reference's does
        frag = str(i["fragment"]).rsplit(":", 1)[-1]
        lines.append(
            f"Fragment {frag} on dn{i['node']}: "
            f"rows={i['rows']} time={i['ms']:.3f} ms" + extra
        )
    return lines


def recursive_union_lines(name: str, op: str, base_lines: list[str],
                          rec_lines: list[str]) -> list[str]:
    """The Recursive Union block a plain EXPLAIN of WITH RECURSIVE leads
    its report with (nodeRecursiveUnion.c's shape): the CTE's union
    operator, then the non-recursive and the recursive term's plans."""
    kind = "UNION" if op == "union" else "UNION ALL"
    return ([f'Recursive Union "{name}" ({kind})', "  Non-recursive term:"]
            + ["    " + ln for ln in base_lines]
            + ["  Recursive term:"]
            + ["    " + ln for ln in rec_lines])


def unrename_lines(lines: list[str], mapping: dict) -> list[str]:
    """The report with each internal stand-in table's name (``mapping``'s
    keys) printed as the CTE name it stands for."""
    for internal, public in mapping.items():
        lines = [ln.replace(internal, public) for ln in lines]
    return lines

"""Paired timing of TPC-H's refresh functions on the PyTorch port, one
port tree against another on the same host.

Each tree runs in a process of its own, in the order given (for example
parent, change, change, parent), over chip_smoke.py's phase 5c cluster:
make_q3_spec's TPC-H tables at ``--sf`` round robin over two datanodes.
A process times

* the parse alone of RF1's INSERT ... VALUES statements (host Python);
* RF1 as chip_smoke's phase 8 (a) issues it (INSERT ... VALUES of at
  most 5 000 rows, one transaction, committed);
* RF2 with each of ``--rf2-keys`` keys a DELETE ... WHERE ... IN (...)
  names, one transaction each, rolled back so that the next one deletes
  the same rows; the order of the key counts alternates from one
  process to the next.

Every count of inserted and deleted rows is checked against the
generator's. One JSON line a process, then the medians a tree.

    python tools/torch_refresh_pair.py --trees .benchtmp/parent . . \\
        .benchtmp/parent [--sf 10] [--device cuda]

A tree is a directory holding ``opentenbase_tpu_torch``; chip_smoke.py's
generators come from this script's checkout whatever the tree.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(tree: str, sf: float, keys: list, device: str,
            seed: int) -> dict:
    """One process's timings over ``tree``'s port (see the module
    docstring)."""
    import numpy as np

    sys.path.insert(0, os.path.abspath(tree))
    cs = _chip_smoke()
    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.sql import parse

    t0 = time.perf_counter()
    tables = cs.make_q3_spec(sf, seed)
    p15 = cs.make_phase15(tables, sf, seed)
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    for ddl in cs.SPEC15_DDL:
        s.execute(ddl)
    cs.bulk_append(cluster, "orders", tables["orders"])
    for name in ("customer", "lineitem"):
        cs.bulk_append(cluster, name, {**tables[name], **p15[name]})
    out = {"tree": tree, "load_s": time.perf_counter() - t0}

    rf1 = cs.make_rf1(tables, sf, seed)
    stmts = cs.rf1_sql(rf1)
    t1 = time.perf_counter()
    for sql in stmts:
        parse(sql)
    out["rf1_parse_ms"] = (time.perf_counter() - t1) * 1000
    ms, counts = cs.run_in_txn(s, stmts)
    n_o = len(rf1["orders"]["o_orderkey"])
    n_l = len(rf1["lineitem"]["l_orderkey"])
    if sum(counts) != n_o + n_l:
        raise AssertionError(f"RF1 inserted {sum(counts)}, not {n_o + n_l}")
    out.update(rf1_ms=ms, rf1_statements=len(stmts))

    rng = np.random.default_rng(seed + 200)
    okeys = tables["orders"]["o_orderkey"]
    gone = np.sort(okeys[rng.choice(len(okeys), n_o, replace=False)])
    lkeys = np.concatenate([tables["lineitem"]["l_orderkey"],
                            rf1["lineitem"]["l_orderkey"]])
    want = n_o + int(np.isin(lkeys, gone).sum())
    out["rf2"] = []
    for k in keys:
        rf2 = []
        for i in range(0, len(gone), k):
            ks = ", ".join(map(str, gone[i:i + k].tolist()))
            rf2.append(f"delete from orders where o_orderkey in ({ks})")
            rf2.append(f"delete from lineitem where l_orderkey in ({ks})")
        t1 = time.perf_counter()
        s.execute("begin")
        n = sum(s.execute(sql).rowcount for sql in rf2)
        ms = (time.perf_counter() - t1) * 1000
        s.execute("rollback")
        if n != want:
            raise AssertionError(f"RF2 ({k} keys) deleted {n}, not {want}")
        out["rf2"].append({"keys": k, "statements": len(rf2), "ms": ms})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", help="the trees, in run order")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--rf2-keys", type=int, nargs="+",
                    default=[1000, 5000])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one, args.sf, args.rf2_keys,
                                 args.device, args.seed)), flush=True)
        return 0
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0]
        print(f"card: {card}", flush=True)
    runs = []
    for i, tree in enumerate(args.trees):
        keys = args.rf2_keys if i % 2 == 0 else args.rf2_keys[::-1]
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree,
               "--sf", str(args.sf), "--device", args.device,
               "--seed", str(args.seed), "--rf2-keys", *map(str, keys)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for tree in dict.fromkeys(args.trees):
        mine = [r for r in runs if r["tree"] == tree]
        row = {k: statistics.median(r[k] for r in mine)
               for k in ("rf1_parse_ms", "rf1_ms")}
        for k in args.rf2_keys:
            row[f"rf2_{k}_keys_ms"] = statistics.median(
                x["ms"] for r in mine for x in r["rf2"] if x["keys"] == k)
        summary[tree] = row
    print(json.dumps({"medians": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

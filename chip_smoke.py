#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (opentenbase_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 42] [--rows 60000000] [--repeats 5]

Phases, one line each; any failure raises and exits non-zero:

1. card: the nvidia-smi name and power limit, and torch's device name;
2. build: every kernel of the main path compiled from csrc/ (nvcc);
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, exactly equal, over int32/int64/bool columns, G=1 and G=6,
   compact and full MVCC planes with invisible rows, ragged shards and
   one empty shard;
4. main path: Cluster(num_datanodes=2) on cuda, CREATE TABLE lineitem, a
   bulk append of ``--rows`` rows (60 M = TPC-H SF10, as bench.py
   measures it) made from ``--seed``, then TPC-H Q6 and Q1 through
   Session.query. The answers must equal a numpy computation over the
   same arrays exactly, and every kernel of the path must have launched;
5. timing: median end-to-end ms per query, the layers each timed on its
   own, the device busy and idle share of single queries from a
   torch.profiler trace, kernel ms from CUDA events, the plain
   version's ms, and the bytes-over-bandwidth bound.

The second-to-last lines are the kernel table as JSON and the nvidia-smi
line; the last line is the run's verdict as JSON. The script imports
neither jax nor the reference package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# HBM bandwidth of the SXM H100 (NVIDIA data sheet), bytes/s. The scan
# is bound by bytes: its few dozen integer operations a row are far
# below the card's ratio of operations to bytes.
HBM_RATE = {"NVIDIA H100 80GB HBM3": 3.35e12}

Q6 = (
    "select sum(l_extendedprice * l_discount) from lineitem "
    "where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' "
    "and l_discount between 0.05 and 0.07 and l_quantity < 24"
)
Q1 = (
    "select l_returnflag, l_linestatus, sum(l_quantity), "
    "sum(l_extendedprice), sum(l_extendedprice * l_discount), "
    "count(*) from lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)
LINEITEM_DDL = (
    "create table lineitem (l_orderkey bigint, l_quantity numeric(10,2), "
    "l_extendedprice numeric(12,2), l_discount numeric(4,2), "
    "l_shipdate date, l_returnflag int, l_linestatus int) "
    "distribute by roundrobin"
)


def make_lineitem(n: int, seed: int = 42):
    """The lineitem generator of bench.py (make_lineitem), copied."""
    rng = np.random.default_rng(seed)
    n_orders = max(n // 4, 1)
    return {
        "l_orderkey": rng.integers(1, n_orders + 1, n).astype(np.int64),
        "l_quantity": (rng.uniform(1, 51, n) * 100).astype(np.int64),
        "l_extendedprice": (rng.uniform(900, 105000, n)).astype(np.int64),
        "l_discount": rng.integers(0, 11, n).astype(np.int64),
        "l_shipdate": (8036 + rng.integers(0, 2556, n)).astype(np.int32),
        "l_returnflag": rng.integers(0, 3, n).astype(np.int32),
        "l_linestatus": rng.integers(0, 2, n).astype(np.int32),
    }


def bulk_append(cluster, table: str, arrays) -> None:
    """Pre-sharded append straight into the stores at one commit
    timestamp (bench.py's _bulk_append)."""
    from opentenbase_tpu_torch.storage.column import Column
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    meta = cluster.catalog.get(table)
    n = len(next(iter(arrays.values())))
    nn = len(meta.node_indices)
    commit_ts = cluster.gts.get_gts()
    for i, node in enumerate(meta.node_indices):
        sl = slice(i * n // nn, (i + 1) * n // nn)
        cols = {
            name: Column(meta.schema[name], arrays[name][sl])
            for name in meta.schema
        }
        batch = ColumnBatch(cols, sl.stop - sl.start)
        cluster.stores[node][table].append_batch(batch, commit_ts)


def _day(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def expected_q6(a) -> list:
    m = (
        (a["l_shipdate"] >= _day("1994-01-01"))
        & (a["l_shipdate"] < _day("1995-01-01"))
        & (a["l_discount"] >= 5) & (a["l_discount"] <= 7)
        & (a["l_quantity"] < 2400)
    )
    if not m.any():
        return [(None,)]
    s = int(np.sum(a["l_extendedprice"][m] * a["l_discount"][m]))
    return [(s / 10**4,)]


def expected_q1(a) -> list:
    m = a["l_shipdate"] <= _day("1998-09-02")
    rows = []
    for f in np.unique(a["l_returnflag"][m]):
        for st in np.unique(a["l_linestatus"][m]):
            g = m & (a["l_returnflag"] == f) & (a["l_linestatus"] == st)
            if not g.any():
                continue
            price = a["l_extendedprice"][g]
            rows.append((
                int(f), int(st),
                int(a["l_quantity"][g].sum()) / 100,
                int(price.sum()) / 100,
                int((price * a["l_discount"][g]).sum()) / 10**4,
                int(g.sum()),
            ))
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def hbm_rate(name: str) -> float:
    if name not in HBM_RATE:
        raise RuntimeError(f"no HBM rate known for {name!r}")
    return HBM_RATE[name]


def _cuda_ms(fn, iters: int) -> float:
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_cases(device, seed: int):
    """(name, cols, xmin, xmax, nrows, snap, spec) cases covering the
    kernel's branches: column widths, G=1/G=6, compact and full MVCC
    planes with invisible rows, ragged and empty shards."""
    import torch

    from opentenbase_tpu_torch import types as t
    from opentenbase_tpu_torch.ops import scan_agg as sa
    from opentenbase_tpu_torch.plan import texpr as E

    rng = np.random.default_rng(seed)
    S, R = 3, 1 << 16
    nrows = np.array([R - 123, 0, 40_000], dtype=np.int64)
    c0 = rng.integers(-5000, 5000, (S, R)).astype(np.int32)
    c1 = rng.integers(0, 9_000_000, (S, R)).astype(np.int64)
    c2 = rng.integers(0, 3, (S, R)).astype(np.int32)
    c3 = rng.integers(0, 2, (S, R)).astype(np.int64)
    c4 = rng.integers(0, 2, (S, R)).astype(np.bool_)
    cols = [torch.from_numpy(c).to(device) for c in (c0, c1, c2, c3, c4)]

    def C(i, ty=t.INT8):
        return E.Col(i, ty)

    def K(v, ty=t.INT8):
        return E.Const(v, ty)

    pred = E.BinE(
        "or",
        E.BinE("and", E.BinE(">=", C(0, t.INT4), K(-1000), t.BOOL),
               E.BinE("<", C(1), K(7_000_000), t.BOOL), t.BOOL),
        E.UnaryE("not", E.InListE(C(2, t.INT4), (K(1), K(2)), False), t.BOOL),
        t.BOOL,
    )
    key = sa.key_expr_from_decoders(
        [(2, 0, 3, 1), (3, 0, 2, 3)], [C(2, t.INT4), C(3)]
    )
    vals = [
        E.BinE("*", C(1), C(2, t.INT4), t.INT8),
        E.UnaryE("-", C(0, t.INT4), t.INT8),
        E.BinE("+", C(4, t.BOOL), K(7), t.INT8),
    ]
    grouped = sa.compile_spec([pred], key, vals, 6)
    scalar = sa.compile_spec(
        [E.BinE("<>", C(3), K(1), t.BOOL)],
        None, [E.BinE("-", C(1), C(0, t.INT4), t.INT8)],
    )
    # MVCC: compact planes with shard 2 invisible; full planes with a
    # third of the rows inserted after the snapshot and some deleted
    snap = 1000
    xmin_c = torch.tensor([[10], [2000], [2000]], dtype=torch.int64)
    xmax_c = torch.full((S, 1), 2**62, dtype=torch.int64)
    xmin_f = torch.from_numpy(
        rng.choice([5, 1000, 1500], (S, R)).astype(np.int64))
    xmax_f = torch.from_numpy(
        rng.choice([2**62, 2**62, 900, 1000, 1001], (S, R)).astype(np.int64))
    nr = torch.from_numpy(nrows).to(device)
    out = []
    for pname, xmin, xmax in (("compact", xmin_c, xmax_c),
                              ("full", xmin_f, xmax_f)):
        for sname, spec in (("G6", grouped), ("G1", scalar)):
            sel = [cols[i] for i in spec.cols]
            out.append((f"{sname}/{pname}", sel, xmin.to(device),
                        xmax.to(device), nr, snap, spec))
    return out


def check_kernel_vs_plain(device, seed: int, card: str) -> None:
    import torch

    from opentenbase_tpu_torch.ops import scan_agg as sa

    for name, cols, xmin, xmax, nr, snap, spec in kernel_cases(device, seed):
        ks, kc = sa.scan_agg(cols, xmin, xmax, nr, snap, spec)
        ps, pc = sa.scan_agg_plain(cols, xmin, xmax, nr, snap, spec)
        torch.cuda.synchronize()
        if not (torch.equal(ks, ps) and torch.equal(kc, pc)):
            raise AssertionError(f"scan_agg {name}: kernel != plain")
        if int(kc.sum()) == 0:
            raise AssertionError(f"scan_agg {name}: no row passed")
        print(f"kernel vs plain: scan_agg {name} equal "
              f"(rows passed {int(kc.sum())}) [{card}]", flush=True)


# ---------------------------------------------------------------------------
# phase 4/5: the main path
# ---------------------------------------------------------------------------


def run_main_path(args, device, card: str) -> dict:
    import torch

    from opentenbase_tpu_torch import Cluster
    from opentenbase_tpu_torch.ops import scan_agg as sa

    t0 = time.perf_counter()
    arrays = make_lineitem(args.rows, args.seed)
    cluster = Cluster(num_datanodes=2, device=device)
    s = cluster.session()
    s.execute(LINEITEM_DDL)
    bulk_append(cluster, "lineitem", arrays)
    print(f"load: {args.rows} rows in 2 datanodes, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    want = {"Q6": expected_q6(arrays), "Q1": expected_q1(arrays)}

    first_ms, launches = {}, {}
    for q, sql in (("Q6", Q6), ("Q1", Q1)):
        sa.scan_agg.launches = 0
        t1 = time.perf_counter()
        got = s.query(sql)
        first_ms[q] = (time.perf_counter() - t1) * 1000
        launches[q] = sa.scan_agg.launches
        if got != want[q]:
            raise AssertionError(f"{q}: port {got} != numpy {want[q]}")
        if launches[q] != 1:
            raise AssertionError(
                f"{q}: scan_agg launched {launches[q]} times, want 1")
        print(f"main path: {q} exact through the kernel (scan_agg "
              f"launches {launches[q]}; first run incl. upload "
              f"{first_ms[q]:.3f} ms) {got[:2]}... [{card}]", flush=True)

    e2e = {}
    for q, sql in (("Q6", Q6), ("Q1", Q1)):
        ts = []
        for _ in range(args.repeats):
            t1 = time.perf_counter()
            got = s.query(sql)
            ts.append((time.perf_counter() - t1) * 1000)
            if got != want[q]:
                raise AssertionError(f"{q}: answer changed between runs")
        e2e[q] = statistics.median(ts)
        print(f"end to end: {q} median {e2e[q]:.3f} ms over "
              f"{args.repeats} runs, {args.rows / e2e[q] * 1e3:.4g} rows/s "
              f"[{card}]", flush=True)
    breakdown = {q: layer_breakdown(cluster, sql, args.repeats)
                 for q, sql in (("Q6", Q6), ("Q1", Q1))}
    for q, b in breakdown.items():
        print(f"layers: {q} median ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in b.items()) + f" [{card}]", flush=True)
    trace = {}
    for q, sql in (("Q6", Q6), ("Q1", Q1)):
        trace[q] = trace_query(s, sql, args.repeats)
        tr = trace[q]
        idle = ("not measured (no device events in the trace)"
                if tr["idle_share"] is None else f"{tr['idle_share']:.4f}")
        print(f"trace: {q} one query under torch.profiler, median of "
              f"{args.repeats}: host {tr['wall_ms']:.3f} ms, device busy "
              f"{tr['busy_ms']:.3f} ms, idle share {idle}; device events "
              f"{tr['events']} [{card}]", flush=True)
    return {"cluster": cluster, "e2e": e2e, "launches": launches,
            "breakdown": breakdown, "trace": trace}


def trace_query(session, sql: str, repeats: int) -> dict:
    """Device busy time and idle share of single warm queries, each
    traced alone: busy is the union of the device intervals (kernels,
    copies, fills) in a torch.profiler trace of one Session.query, and
    the share is taken against the host clock around that same query,
    which the profiler's own host work lengthens."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's start-up, not measured
        session.query(sql)
    runs = []
    for _ in range(repeats):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            session.query(sql)
            t1 = time.perf_counter()
        dev = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        busy_us, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in dev):
            if b > end:
                busy_us += b - max(a, end)
                end = b
        wall = (t1 - t0) * 1e3
        runs.append({
            "wall_ms": wall, "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall if dev else None,
            "events": sorted({e.name for e in dev}),
        })
    runs.sort(key=lambda r: r["wall_ms"])
    return runs[len(runs) // 2]


def layer_breakdown(cluster, sql: str, repeats: int) -> dict:
    """Median ms of one warm query's layers, each timed on its own:
    parse + analyze + optimize + distribute on the host; the fused
    fragment (device-cache hit, kernel launch, copy of the partials to
    the host); the coordinator merge; and the device time of the
    fragment from CUDA events around it (output zeroing, the kernel, the
    copy back)."""
    import torch

    from opentenbase_tpu_torch.executor.local import LocalExecutor
    from opentenbase_tpu_torch.plan import analyze_statement
    from opentenbase_tpu_torch.plan.distribute import distribute_statement
    from opentenbase_tpu_torch.plan.optimize import optimize_statement
    from opentenbase_tpu_torch.sql import parse_one

    fx = cluster.fused_executor()
    cat = cluster.catalog
    out = {"plan": [], "fragment": [], "fragment_device": [], "merge": []}
    for _ in range(repeats):
        t0 = time.perf_counter()
        dplan = distribute_statement(optimize_statement(
            analyze_statement(parse_one(sql), cat), cat), cat)
        t1 = time.perf_counter()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        part = fx.fragment_output(dplan.fragments[0],
                                  cluster.gts.snapshot_ts())
        b.record()
        t2 = time.perf_counter()
        LocalExecutor(cat, {0: part}).run_plan(dplan.root)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        out["plan"].append((t1 - t0) * 1e3)
        out["fragment"].append((t2 - t1) * 1e3)
        out["fragment_device"].append(a.elapsed_time(b))
        out["merge"].append((t3 - t2) * 1e3)
    return {k: statistics.median(v) for k, v in out.items()}


def time_kernels(main: dict, card: str, rate: float) -> list:
    """Kernel, plain-version and bound times at the main path's shapes:
    the resident lineitem planes and the specs Q6 and Q1 compiled."""
    import torch

    from opentenbase_tpu_torch.ops import scan_agg as sa

    cluster = main["cluster"]
    fx = cluster.fused_executor()
    (dtab,) = fx.cache._tables.values()
    snap = cluster.gts.snapshot_ts()
    rows = []
    # the programs the main path compiled, in query order (Q6, Q1)
    for qname, (spec, _kinds, scan_cols) in zip(
        ("Q6", "Q1"), fx._programs.values()
    ):
        cols = [dtab.columns[scan_cols[i]] for i in spec.cols]
        args = (cols, dtab.xmin, dtab.xmax, dtab.nrows_dev, snap, spec)
        n0 = sa.scan_agg.launches
        ks, kc = sa.scan_agg(*args, max_nrows=int(dtab.nrows.max()))
        ps, pc = sa.scan_agg_plain(*args)
        err = max(int((ks - ps).abs().max()), int((kc - pc).abs().max()))
        if err:
            raise AssertionError(f"scan_agg {qname}: kernel != plain")
        ms = _cuda_ms(lambda: sa.scan_agg(
            *args, max_nrows=int(dtab.nrows.max())), 20)
        plain_ms = _cuda_ms(lambda: sa.scan_agg_plain(*args), 3)
        sa.scan_agg.launches = n0  # comparison launches are not counted
        nbytes = sa.spec_bytes(*args)
        bound = nbytes / rate * 1e3
        rows.append({
            "query": qname, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
            "max_abs_err": float(err),
        })
        print(f"kernel: scan_agg {qname} {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound:.4f} ms ({nbytes} bytes at "
              f"{rate / 1e12:.2f} TB/s; rows passed {int(kc.sum())}) "
              f"[{card}]", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--rows", type=int, default=60_000_000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "opentenbase_tpu_torch")):
        print("chip_smoke: opentenbase_tpu_torch not found beside the "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from opentenbase_tpu_torch.ops import scan_agg as sa

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch device {name}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    rate = hbm_rate(name)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    sa.build()
    sa._load()
    print(f"build: csrc/scan_agg.cu in {time.perf_counter() - t0:.3f} s",
          flush=True)

    check_kernel_vs_plain(device, args.seed, card)
    main_run = run_main_path(args, device, card)
    rows = time_kernels(main_run, card, rate)

    kernels = []
    for r in rows:
        kernels.append({
            "name": f"scan_agg ({r['query']} shape)",
            "route": "cuda",
            "source": "opentenbase_tpu_torch/csrc/scan_agg.cu",
            "replaces": "opentenbase_tpu/ops/pallas_scan.py:317",
            "launches": main_run["launches"][r["query"]],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels,
                      "e2e_ms": main_run["e2e"],
                      "layers_ms": main_run["breakdown"],
                      "trace": main_run["trace"],
                      "rows": args.rows, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

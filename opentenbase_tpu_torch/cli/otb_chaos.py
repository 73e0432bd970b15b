"""Seeded chaos-schedule runner (the reference's opentenbase_tpu/cli/
otb_chaos.py): the self-healing HA gate.

    python -m opentenbase_tpu_torch.cli.otb_chaos [--seed N]
        [--schedules K] [--duration S] [--datanodes D] [--detect-ms MS]
        [--beats B] [--sync-mode off|local|remote_write|on] [--keep]
        [--workdir DIR] [--device cpu]

Each schedule (seeds N .. N+K-1) builds a fresh topology (a coordinator,
WAL-streaming datanode standbys and an HAMonitor, on cuda:0 unless
``--device`` says otherwise), runs a randomized fault timeline (drop_conn,
delays, wal_torn stream tears, a datanode crash and revive, a primary
crash, a kill inside the promotion window) under live read-write
traffic, then checks the invariants (fault/schedule.py). One JSON
verdict line per run, then a ``chaos_gate`` summary line; exit code 4
on any violated invariant. A failing run replays from its printed seed
alone.

``--schedule crash`` is the one schedule the port runs; ``partition``
and ``multicn`` (ROADMAP A.9) and ``rebalance`` (A.8) are refused by
name.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

# the reference's other schedules, each with the ROADMAP item that
# brings its subsystem
REFUSED_SCHEDULES = {
    "partition": "A.9: its verdict rests on the result cache",
    "multicn": "A.9: multiple coordinators",
    "rebalance": "A.8: rebalance",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--schedule", default="crash",
                    choices=("crash",) + tuple(REFUSED_SCHEDULES),
                    help="crash: a randomized fault timeline with a "
                    "primary kill (the others are not ported)")
    ap.add_argument("--seed", type=int, default=1107,
                    help="base seed (schedules use seed..seed+K-1)")
    ap.add_argument("--schedules", type=int, default=5)
    ap.add_argument("--duration", type=float, default=6.0,
                    help="seconds of live traffic per schedule")
    ap.add_argument("--datanodes", type=int, default=2)
    ap.add_argument("--detect-ms", type=int, default=1200,
                    help="failover_detect_ms for the HA monitor")
    ap.add_argument("--beats", type=int, default=3,
                    help="consecutive missed beats before promotion")
    ap.add_argument("--keep", action="store_true",
                    help="keep each schedule's data directories")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--sync-mode", default="on",
                    choices=("off", "local", "remote_write", "on"),
                    help="the synchronous_commit rung to prove (remote "
                    "rungs: zero lost acked writes; off/local: a "
                    "contiguous lost tail only)")
    ap.add_argument("--device", default=None,
                    help="torch device of the topology (default cuda:0)")
    args = ap.parse_args(argv)
    if args.schedule in REFUSED_SCHEDULES:
        ap.error(f"--schedule {args.schedule} is not ported (ROADMAP "
                 f"{REFUSED_SCHEDULES[args.schedule]})")

    from opentenbase_tpu_torch.fault.schedule import (
        ChaosSchedule,
        run_schedule,
    )

    workdir = args.workdir or tempfile.mkdtemp(prefix="otb_chaos_")
    verdicts = []
    for k in range(args.schedules):
        seed = args.seed + k
        sched = ChaosSchedule.generate(
            seed, duration_s=args.duration, num_datanodes=args.datanodes)
        v = run_schedule(
            sched, f"{workdir}/seed{seed}", detect_ms=args.detect_ms,
            beats=args.beats, keep=args.keep, sync_mode=args.sync_mode,
            device=args.device)
        verdicts.append(v)
        print(json.dumps(v, default=str), flush=True)
    failed = [v["seed"] for v in verdicts if v["chaos_gate"] != "ok"]
    summary = {
        "chaos_gate": "ok" if not failed else "fail",
        "schedules": len(verdicts),
        "failed_seeds": failed,
        "acked_writes": sum(v.get("acked_writes", 0) for v in verdicts),
        "promotions": sum(v.get("promotions", 0) for v in verdicts),
        "replay_hint": (
            f"python -m opentenbase_tpu_torch.cli.otb_chaos --seed "
            f"{failed[0]} --schedules 1" if failed else ""),
    }
    print(json.dumps(summary, default=str), flush=True)
    return 4 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

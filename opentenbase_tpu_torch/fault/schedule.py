"""Seeded chaos schedules (the reference's opentenbase_tpu/fault/
schedule.py): randomized fault timelines over live read-write traffic,
with an invariant checker, replayable from one seed (the Jepsen nemesis
shape on the failpoint registry and the self-healing HA plane).

A schedule is generated from its seed: every event time, target, action
and probability is drawn at ``generate()`` time from
``random.Random(seed)``, so a seed gives the reference's events letter
for letter. While a run is active the fault plane's own randomness (every
``prob(p)`` draw, connect backoff jitter, wal_torn tear positions, the
failover backoff) comes from per-name child streams of the same seed
(``fault.set_chaos_seed``).

Every schedule mixes background drop_conn and delay faults on the
coordinator -> datanode RPCs, a wal_torn fault on the replication
stream, a crash_node on one datanode with a later revive, a crash of
the primary that the HAMonitor must detect and heal by promotion, and a
one-shot fault at ``dn/promote`` that kills the monitor's first
candidate mid-promote.

The verdict's invariants: no acknowledged write lost (on the remote
``synchronous_commit`` rungs; on ``off`` / ``local`` only a contiguous
tail per client), no phantom or duplicate row, no stale read or
accepted write (the revived ex-primary refuses both with 72000),
detection within its budget, every in-doubt gid resolved, and the
ex-primary rejoined as a standby with the same rows.

Not ported, each raising ``NotPorted`` with the ROADMAP item of its
subsystem: the rebalance schedule (A.8), the multi-coordinator schedule
(A.9) and the partition schedules (A.9: their verdict rests on a
result-cache probe).
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from opentenbase_tpu_torch import fault as _fault
from opentenbase_tpu_torch.errors import NotPorted


@dataclass
class ChaosEvent:
    at_s: float          # offset from run start
    kind: str            # arm_fault | crash_node | revive_node |
    #                      crash_primary
    spec: dict = field(default_factory=dict)

    def describe(self) -> str:
        items = ", ".join(f"{k}={v}" for k, v in sorted(self.spec.items()))
        return f"t+{self.at_s:.2f}s {self.kind}({items})"


@dataclass
class ChaosSchedule:
    seed: int
    duration_s: float
    num_datanodes: int
    events: list = field(default_factory=list)
    writers: int = 3
    readers: int = 2

    @classmethod
    def generate(
        cls,
        seed: int,
        duration_s: float = 6.0,
        num_datanodes: int = 2,
    ) -> "ChaosSchedule":
        """Deterministic schedule for ``seed``: same seed, same events,
        same times, same targets — the replay contract."""
        rng = random.Random(seed)
        ev: list[ChaosEvent] = []
        # background probability faults, armed early. prob() draws are
        # themselves routed through the schedule's per-site streams at
        # runtime (fault.set_chaos_seed), so the SPECS don't need seeds.
        ev.append(ChaosEvent(0.1, "arm_fault", {
            "site": "net/pool/rpc_send", "action": "drop_conn",
            "spec": f"prob({rng.uniform(0.004, 0.02):.4f})",
        }))
        # delay rides dn/dispatch, NOT dn/exec_fragment: the registry
        # holds one fault per site and the crash_node event below must
        # not replace the delay (nor the revive's clear disarm it)
        ev.append(ChaosEvent(0.1, "arm_fault", {
            "site": "dn/dispatch",
            "action": f"delay({rng.randint(5, 40)})",
            "spec": f"prob({rng.uniform(0.01, 0.05):.4f})",
        }))
        ev.append(ChaosEvent(0.15, "arm_fault", {
            "site": "repl/wal_stream", "action": "wal_torn",
            "spec": f"prob({rng.uniform(0.2, 0.6):.3f})",
        }))
        # one DN crash + revive, somewhere in the first half
        victim = rng.randrange(num_datanodes)
        t_dn = rng.uniform(0.4, duration_s * 0.35)
        ev.append(ChaosEvent(t_dn, "crash_node", {"node": victim}))
        ev.append(ChaosEvent(
            t_dn + rng.uniform(0.8, 1.6), "revive_node", {"node": victim},
        ))
        # the promotion-window kill: armed BEFORE the primary crash so
        # the monitor's FIRST promote attempt dies inside the window.
        # 'error' fails the promote RPC and leaves the candidate as a
        # healthy standby; 'crash_node' takes the whole candidate down
        # (it revives with the final cleanup). Either way the failover
        # loop must converge on another candidate.
        kill_action = rng.choice(["error", "crash_node"])
        t_crash = rng.uniform(duration_s * 0.45, duration_s * 0.65)
        ev.append(ChaosEvent(t_crash - 0.05, "arm_fault", {
            "site": "dn/promote", "action": kill_action, "spec": "once",
        }))
        ev.append(ChaosEvent(t_crash, "crash_primary", {}))
        ev.sort(key=lambda e: e.at_s)
        return cls(
            seed=seed, duration_s=duration_s,
            num_datanodes=num_datanodes, events=ev,
        )


class _Traffic:
    """Live randomized read-write traffic through RoutingClients.
    Writers insert unique (client, seq) rows and record every ACK;
    readers verify acked-watermark monotonicity on every read."""

    def __init__(self, topo, schedule: ChaosSchedule):
        self.topo = topo
        self.schedule = schedule
        self.stop_evt = threading.Event()
        self.acked: dict[int, int] = {}      # client -> max acked seq
        self.acked_set: set = set()          # (client, seq)
        self.indeterminate: set = set()      # errored attempts
        self.stale_reads: list = []
        self.reads_ok = 0
        self._mu = threading.Lock()
        self.threads: list[threading.Thread] = []

    def start(self) -> None:
        for w in range(self.schedule.writers):
            t = threading.Thread(
                target=self._writer, args=(w,), daemon=True
            )
            t.start()
            self.threads.append(t)
        for r in range(self.schedule.readers):
            t = threading.Thread(
                target=self._reader, args=(r,), daemon=True
            )
            t.start()
            self.threads.append(t)

    def stop(self) -> None:
        self.stop_evt.set()
        for t in self.threads:
            t.join(timeout=30)

    def _writer(self, cid: int) -> None:
        from opentenbase_tpu_torch.ha import RoutingClient

        rng = _fault.chaos_rng(f"traffic/writer{cid}") or random.Random(
            cid
        )
        rc = RoutingClient(self.topo)
        seq = 0
        while not self.stop_evt.is_set():
            seq += 1
            # occasionally a two-row batch spanning shards (a
            # multi-node txn exercising the implicit-2PC ship path);
            # usually a single-node write riding sync-commit
            batch = [seq]
            if rng.random() < 0.3:
                seq += 1
                batch.append(seq)
            vals = ",".join(
                f"({cid}, {s}, {cid * 1000000 + s})" for s in batch
            )
            try:
                rc.execute(f"insert into chaos_t values {vals}")
                with self._mu:
                    for s in batch:
                        self.acked_set.add((cid, s))
                    self.acked[cid] = max(
                        self.acked.get(cid, 0), batch[-1]
                    )
            except Exception:
                with self._mu:
                    for s in batch:
                        self.indeterminate.add((cid, s))
                self.stop_evt.wait(0.05)
            self.stop_evt.wait(0.01 + rng.random() * 0.02)
        rc.close()

    def _reader(self, rid: int) -> None:
        from opentenbase_tpu_torch.ha import RoutingClient

        rng = _fault.chaos_rng(f"traffic/reader{rid}") or random.Random(
            1000 + rid
        )
        rc = RoutingClient(self.topo)
        while not self.stop_evt.is_set():
            cid = rng.randrange(self.schedule.writers)
            with self._mu:
                floor = self.acked.get(cid, 0)
            try:
                rows = rc.query(
                    "select max(seq) from chaos_t "
                    f"where client = {cid}"
                )
                got = rows[0][0] or 0
                # an acked write is on every reachable standby
                # (synchronous_commit=on), so NO read — before or
                # after a failover — may show less than the acked
                # watermark captured before the read started
                if got < floor:
                    with self._mu:
                        self.stale_reads.append(
                            {"client": cid, "saw": int(got),
                             "acked_floor": int(floor)}
                        )
                else:
                    with self._mu:
                        self.reads_ok += 1
            except Exception:
                self.stop_evt.wait(0.05)
            self.stop_evt.wait(0.01 + rng.random() * 0.03)
        rc.close()


def run_schedule(
    schedule: ChaosSchedule,
    workdir: str,
    detect_ms: int = 1200,
    beats: int = 3,
    keep: bool = False,
    sync_mode: str = "on",
    device=None,
) -> dict:
    """Execute one seeded schedule end to end and return the verdict
    dict (chaos_gate ok/fail + every invariant's evidence).

    ``sync_mode`` is the cluster-wide ``synchronous_commit`` rung the
    run proves (ROADMAP item 4b — every mode must keep exactly what it
    promises, under the same crash schedule):

    - ``on`` / ``remote_write``: ZERO lost acked writes after the
      failover (remote-apply on every standby / quorum-acked receipt),
      and reads never regress below a client's acked watermark;
    - ``local`` / ``off``: the acked TAIL may be lost to the failover
      (replication is asynchronous), but the per-client lost run must
      be CONTIGUOUS — a survivor inside it is a replay hole, i.e.
      reordering, and fails; duplicates and phantoms fail in every
      mode.

    The topology runs on ``device`` (cuda:0 unless the caller passes
    another; ``HATopology``)."""
    from opentenbase_tpu_torch.ha import HAMonitor, HATopology

    os.makedirs(workdir, exist_ok=True)
    verdict: dict = {
        "seed": schedule.seed,
        "sync_mode": sync_mode,
        "events": [e.describe() for e in schedule.events],
        "violations": [],
    }
    _fault.set_chaos_seed(schedule.seed)
    topo = None
    mon = None
    traffic = None
    try:
        topo = HATopology(
            workdir, schedule.num_datanodes, 32, conf_gucs={
                "enable_fused_execution": "off",
                "synchronous_commit": sync_mode,
                "failover_detect_ms": detect_ms,
                "failover_beats": beats,
                "fragment_retries": 1,
                "fragment_retry_backoff_ms": 5,
                # bound every statement: a straggler standby's WAL
                # wait must cut at the deadline and self-heal, not
                # park a traffic thread for the DN's full 90s budget
                "statement_timeout": 5000,
            },
            device=device,
        )
        boot = topo.active_cluster.session()
        boot.execute(
            "create table chaos_t (client bigint, seq bigint, v bigint)"
            " distribute by shard(seq)"
        )
        mon = HAMonitor(topo, detect_ms=detect_ms, beats=beats).start()
        traffic = _Traffic(topo, schedule)
        traffic.start()
        t0 = time.monotonic()
        crash_wall: Optional[float] = None
        for ev in schedule.events:
            delay = t0 + ev.at_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if ev.kind == "arm_fault":
                _fault.inject(
                    ev.spec["site"], ev.spec["action"],
                    ev.spec.get("spec", ""),
                )
            elif ev.kind == "crash_node":
                _fault.inject(
                    "dn/exec_fragment", "crash_node",
                    f"node={ev.spec['node']}, once",
                )
            elif ev.kind == "revive_node":
                _fault.clear("dn/exec_fragment")
                topo.dns[ev.spec["node"]]._revive()
            elif ev.kind == "crash_primary":
                crash_wall = time.time()
                topo.crash_primary()
        # let the run play out, then quiesce
        left = t0 + schedule.duration_s - time.monotonic()
        if left > 0:
            time.sleep(left)
        # give the monitor room to finish healing before the checks
        deadline = time.time() + max(detect_ms / 1000.0 * 4, 8.0)
        while time.time() < deadline and topo.promoted_index is None:
            time.sleep(0.1)
        traffic.stop()
        mon.stop()
        # disarm every background fault; revive any still-crashed DN so
        # the invariant sweep can reach all vote journals, and make
        # sure every survivor follows the promoted timeline (a DN that
        # was crashed DURING the failover missed its repoint)
        _fault.clear()
        for dn in topo.dns:
            if dn._crashed:
                dn._revive()
        if topo.promoted_index is not None:
            host, wport = topo.active_wal_address()
            for j in range(len(topo.dns)):
                if j == topo.promoted_index:
                    continue
                try:
                    topo._dn_rpc(j, {
                        "op": "repl_repoint", "wal_host": host,
                        "wal_port": wport, "hgen": topo.generation,
                    })
                except Exception:
                    pass  # already on the new timeline, or truly gone
        _verify(schedule, topo, mon, traffic, crash_wall,
                detect_ms, beats, verdict, sync_mode)
    except Exception as e:  # harness failure IS a failed run
        verdict["violations"].append(
            {"invariant": "harness", "error": f"{type(e).__name__}: {e}"}
        )
    finally:
        _fault.clear()
        _fault.reset_stats()
        _fault.set_chaos_seed(None)
        if traffic is not None and not traffic.stop_evt.is_set():
            traffic.stop()
        if mon is not None:
            mon.stop()
        if topo is not None:
            topo.stop()
        if not keep:
            import shutil

            shutil.rmtree(workdir, ignore_errors=True)
    verdict["chaos_gate"] = "ok" if not verdict["violations"] else "fail"
    return verdict


def _verify(schedule, topo, mon, traffic, crash_wall,
            detect_ms, beats, verdict, sync_mode="on") -> None:
    from opentenbase_tpu_torch.net.client import WireError, connect_tcp

    bad = verdict["violations"]
    # quiesce the data plane before judging it: the repointed
    # survivors may still be replaying the promoted timeline, and a
    # verify scan racing that catch-up would stall on the WAL wait
    # (a latency artifact, not an invariant violation — slow machines
    # made it flaky). Bounded: a DN that never catches up still gets
    # judged below, via the scan's own failover path.
    active0 = topo.active_cluster
    deadline = time.time() + 20
    while time.time() < deadline:
        pos = active0.persistence.wal.position
        pings = [topo.dn_ping(i) for i in range(len(topo.dns))]
        if all(
            p is not None and (
                p.get("promoted") or int(p.get("applied") or 0) >= pos
            )
            for p in pings
        ):
            break
        time.sleep(0.1)
    mon_stats = mon.stats()  # guarded snapshot of the beat counters
    verdict["acked_writes"] = len(traffic.acked_set)
    verdict["indeterminate_writes"] = len(traffic.indeterminate)
    verdict["reads_ok"] = traffic.reads_ok
    verdict["promotions"] = mon_stats["promotions"]
    verdict["generation"] = topo.generation

    # -- invariant 4: auto-promotion within the detection budget ------
    if crash_wall is not None:
        if topo.promoted_index is None:
            bad.append({"invariant": "auto_promotion",
                        "error": "primary crashed but nothing promoted"})
        elif mon_stats["declared_dead_at"] is not None:
            latency_ms = (mon_stats["declared_dead_at"] - crash_wall) * 1000.0
            budget_ms = detect_ms + detect_ms / beats + 600
            verdict["detect_latency_ms"] = round(latency_ms, 1)
            verdict["detect_budget_ms"] = round(budget_ms, 1)
            if latency_ms > budget_ms:
                bad.append({
                    "invariant": "detection_budget",
                    "latency_ms": round(latency_ms, 1),
                    "budget_ms": round(budget_ms, 1),
                })

    # -- invariant 3b: the revived ex-primary is FENCED ----------------
    if crash_wall is not None and topo.promoted_index is not None:
        srv = topo.revive_ex_primary()
        stale = connect_tcp(srv.host, srv.port)
        probe_outcome = "refused"
        try:
            for sql, what in (
                ("select max(seq) from chaos_t where client = 0",
                 "read"),
                ("insert into chaos_t values (999, 1, 1)", "write"),
            ):
                try:
                    stale.execute(sql)
                    probe_outcome = f"accepted_{what}"
                    bad.append({
                        "invariant": "stale_generation",
                        "error": f"ex-primary ACCEPTED a {what}",
                    })
                except WireError as e:
                    if getattr(e, "sqlstate", None) != "72000":
                        probe_outcome = "wrong_sqlstate"
                        bad.append({
                            "invariant": "stale_generation",
                            "error": f"{what} refused without the "
                            f"fenced SQLSTATE: {e.sqlstate} {e}",
                        })
        finally:
            stale.close()
        # the verdict must agree with the violations list — a probe
        # that got through is recorded as what actually happened
        verdict["fenced_probe"] = probe_outcome

    # -- invariant 5: every in-doubt gid resolved ----------------------
    active = topo.active_cluster
    try:
        resolved = active.resolve_indoubt()
        verdict["indoubt_resolved"] = [list(r) for r in resolved]
    except Exception as e:
        bad.append({"invariant": "indoubt",
                    "error": f"resolver failed: {e}"})
    leftover = []
    for i, dn in enumerate(topo.dns):
        for e in dn._twophase_list():
            leftover.append((i, e["gid"]))
    if leftover:
        bad.append({"invariant": "indoubt",
                    "error": f"unresolved vote journals: {leftover}"})

    # -- invariants 1+2: lost / phantom / duplicate rows ---------------
    s = active.session()
    # the verify scans must never be cut by the traffic-plane
    # statement budget: a straggler fragment fails over to the
    # coordinator's own caught-up copy instead
    s.execute("set statement_timeout = 0")
    rows = s.query("select client, seq from chaos_t")
    seen: dict = {}
    for cid, seq in rows:
        seen[(cid, seq)] = seen.get((cid, seq), 0) + 1
    dups = [k for k, n in seen.items() if n > 1]
    if dups:
        bad.append({"invariant": "no_duplicates",
                    "rows": dups[:10], "count": len(dups)})
    lost = [k for k in traffic.acked_set if k not in seen]
    verdict["lost_acked_writes"] = len(lost)
    if sync_mode in ("on", "remote_write"):
        # the remote rungs promise ZERO lost acked writes across the
        # failover (remote-apply / quorum-acked receipt)
        if lost:
            bad.append({"invariant": "zero_lost_committed_writes",
                        "rows": sorted(lost)[:10], "count": len(lost)})
    elif lost:
        # off/local: replication is asynchronous, so the acked TAIL
        # may die with the primary — ONE contiguous per-client run of
        # acked seqs ending at the failover cut (the writer keeps
        # writing on the promoted timeline afterwards, so LATER acked
        # survivors are expected and fine). What must never happen is
        # a SCATTERED loss — lost 41, survived 45, lost 47 — because
        # the WAL is ordered and promotion takes a standby's applied
        # prefix: a hole inside the lost run means a frame was
        # replayed out of order or dropped mid-stream.
        lost_by_client: dict = {}
        for cid, s in lost:
            lost_by_client.setdefault(cid, []).append(s)
        holes = []
        for cid, lseqs in lost_by_client.items():
            lo, hi = min(lseqs), max(lseqs)
            acked_in_run = [
                s for (c2, s) in traffic.acked_set
                if c2 == cid and lo <= s <= hi
            ]
            if len(lseqs) != len(acked_in_run):
                holes.append({
                    "client": cid, "lost": sorted(lseqs)[:10],
                    "acked_in_run": len(acked_in_run),
                })
        if holes:
            bad.append({"invariant": "lost_tail_contiguous",
                        "holes": holes[:10], "count": len(holes)})
    attempted = traffic.acked_set | traffic.indeterminate
    phantom = [k for k in seen if k not in attempted and k[0] != 999]
    if phantom:
        bad.append({"invariant": "no_phantom_rows",
                    "rows": sorted(phantom)[:10],
                    "count": len(phantom)})
    verdict["final_rows"] = len(rows)

    # -- invariant 3a: monotone / non-stale reads ----------------------
    verdict["stale_reads"] = len(traffic.stale_reads)
    if traffic.stale_reads and sync_mode in ("on", "remote_write"):
        # under off/local an acked write may legitimately be invisible
        # on the promoted standby, so the acked-watermark floor only
        # binds on the remote rungs (recorded above either way)
        bad.append({"invariant": "zero_stale_reads",
                    "cases": traffic.stale_reads[:10],
                    "count": len(traffic.stale_reads)})
    if traffic.reads_ok == 0:
        bad.append({"invariant": "liveness",
                    "error": "no read ever succeeded"})
    if not traffic.acked_set:
        bad.append({"invariant": "liveness",
                    "error": "no write was ever acknowledged"})

    # -- invariant 6: the ex-primary resyncs ---------------------------
    if crash_wall is not None and topo.promoted_index is not None:
        sb = topo.rejoin_ex_primary()
        if not sb.wait_caught_up(active.persistence, timeout_s=15):
            bad.append({
                "invariant": "resync",
                "error": "rejoined ex-primary never caught up",
                "applied": sb.applied,
                "primary_wal": active.persistence.wal.position,
            })
        else:
            sb_rows = sb.session().query(
                "select client, seq from chaos_t"
            )
            if sorted(sb_rows) != sorted(rows):
                p_set = {tuple(r) for r in rows}
                s_set = {tuple(r) for r in sb_rows}
                bad.append({
                    "invariant": "resync",
                    "error": "rejoined standby diverges from primary",
                    "standby_rows": len(sb_rows),
                    "primary_rows": len(rows),
                    "missing_on_standby": sorted(p_set - s_set)[:10],
                    "extra_on_standby": sorted(s_set - p_set)[:10],
                })
            verdict["resync"] = {
                "applied": sb.applied, "rows": len(sb_rows),
            }


# the reference's partition scenarios (their schedule is refused, A.9)
PARTITION_SCENARIOS = ("asymmetric", "full", "gray_slow", "flapping")


def run_rebalance_schedule(seed: int, workdir: str, kill_phase: str = "copying",
                           keep: bool = False) -> dict:
    """The reference's elastic-rebalance crash schedule: refused, the
    port has no rebalance."""
    raise NotPorted("the rebalance chaos schedule (ROADMAP A.8: rebalance)")


def run_multicn_schedule(seed: int, workdir: str, duration_s: float = 4.0,
                         keep: bool = False) -> dict:
    """The reference's multi-coordinator crash schedule: refused, the
    port has no peer coordinators."""
    raise NotPorted("the multi-coordinator chaos schedule (ROADMAP A.9: "
                    "multiple coordinators)")


def run_partition_schedule(seed: int, workdir: str,
                           scenario: str = "asymmetric", **kw) -> dict:
    """The reference's network-partition schedule: refused, its verdict
    rests on a warmed result-cache probe and the port has no result
    cache."""
    raise NotPorted("the partition chaos schedule (ROADMAP A.9: its "
                    "verdict rests on the result cache)")


def run_partition_schedules(base_seed: int, count: int, workdir: str,
                            scenarios=PARTITION_SCENARIOS, **kw) -> list:
    """``count`` seeds x every scenario: refused as
    ``run_partition_schedule`` is."""
    raise NotPorted("the partition chaos schedule (ROADMAP A.9: its "
                    "verdict rests on the result cache)")


def run_schedules(
    base_seed: int,
    count: int,
    workdir: str,
    duration_s: float = 6.0,
    num_datanodes: int = 2,
    detect_ms: int = 1200,
    beats: int = 3,
    keep: bool = False,
    sync_mode: str = "on",
    device=None,
) -> list[dict]:
    """Run ``count`` distinct seeded schedules (seeds base..base+n-1);
    one verdict per schedule."""
    out = []
    for k in range(count):
        seed = base_seed + k
        sched = ChaosSchedule.generate(
            seed, duration_s=duration_s, num_datanodes=num_datanodes,
        )
        out.append(run_schedule(
            sched, os.path.join(workdir, f"seed{seed}"),
            detect_ms=detect_ms, beats=beats, keep=keep,
            sync_mode=sync_mode, device=device,
        ))
    return out

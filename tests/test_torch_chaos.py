"""The seeded chaos schedule in the port (opentenbase_tpu_torch/fault/
schedule.py and cli/otb_chaos.py) held against the reference: a seed
gives the reference's events letter for letter, and one run of each
schedule of tests/test_ha.py and tests/test_write_path.py ends with
every invariant green on the port (its topology on ``device="cpu"``):
seed 4242 for 4 s under synchronous_commit on, seed 3100 for 3 s under
off, local and remote_write, and otb_chaos's tier-1 drive, seed 1107
for 5 s. The runs' numbers (acknowledged writes, latencies) depend on
timing, so what is compared with the reference is the schedule and the
verdict's invariants, not the counts."""

from __future__ import annotations

import json

import pytest

import opentenbase_tpu.fault as ref_fault
import opentenbase_tpu_torch.fault as port_fault
from opentenbase_tpu.fault.schedule import ChaosSchedule as RefSchedule
from opentenbase_tpu_torch import NotPorted
from opentenbase_tpu_torch.cli import otb_chaos
from opentenbase_tpu_torch.fault import schedule as port_schedule
from opentenbase_tpu_torch.fault.schedule import ChaosSchedule, run_schedule


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (ref_fault, port_fault):
        f.clear()
        f.set_chaos_seed(None)
        f.install_matrix(None)
    yield
    for f in (ref_fault, port_fault):
        f.clear()
        f.reset_stats()
        f.set_chaos_seed(None)
        f.install_matrix(None)


def events(cls, seed: int, duration_s: float = 6.0, nd: int = 2) -> list:
    return [e.describe() for e in cls.generate(
        seed, duration_s=duration_s, num_datanodes=nd).events]


@pytest.mark.parametrize("seed", [1234, 1235, 4242])
def test_generate_gives_the_references_events(seed):
    """The same seed, duration and datanodes give the reference's
    events, times, targets and specs, letter for letter."""
    for duration, nd in ((6.0, 2), (4.0, 2), (3.0, 3)):
        assert (events(ChaosSchedule, seed, duration, nd)
                == events(RefSchedule, seed, duration, nd))
    a = ChaosSchedule.generate(seed, duration_s=6.0, num_datanodes=2)
    assert {e.kind for e in a.events} == {
        "arm_fault", "crash_node", "revive_node", "crash_primary"}
    assert {"net/pool/rpc_send", "repl/wal_stream", "dn/promote"} <= {
        e.spec.get("site") for e in a.events if e.kind == "arm_fault"}
    assert events(ChaosSchedule, seed) != events(ChaosSchedule, seed + 7)


def test_chaos_schedule_end_to_end(tmp_path):
    """tests/test_ha.py's acceptance: seed 4242 for 4 s (background
    drop_conn, delays and wal_torn, a datanode crash and revive, a kill
    in the promotion window, the primary's crash) under live traffic
    ends with every invariant green."""
    sched = ChaosSchedule.generate(4242, duration_s=4.0, num_datanodes=2)
    v = run_schedule(sched, str(tmp_path / "chaos"), detect_ms=900,
                     beats=3, device="cpu")
    assert v["chaos_gate"] == "ok", v["violations"]
    assert v["events"] == events(RefSchedule, 4242, 4.0)
    assert v["acked_writes"] > 0 and v["lost_acked_writes"] == 0
    assert v["promotions"] == 1
    assert v["fenced_probe"] == "refused"
    assert v["resync"]["rows"] == v["final_rows"]
    assert v["detect_latency_ms"] <= v["detect_budget_ms"]


@pytest.mark.parametrize("mode", ["off", "local", "remote_write"])
def test_chaos_schedule_sync_mode(mode, tmp_path):
    """tests/test_write_path.py's rungs: seed 3100 for 3 s; remote_write
    loses no acknowledged write, off and local at most a contiguous
    tail per client, and no mode duplicates or grows phantoms."""
    sched = ChaosSchedule.generate(3100, duration_s=3.0, num_datanodes=2)
    v = run_schedule(sched, str(tmp_path / f"chaos_{mode}"), detect_ms=900,
                     beats=3, sync_mode=mode, device="cpu")
    assert v["chaos_gate"] == "ok", v["violations"]
    assert v["sync_mode"] == mode
    assert v["acked_writes"] > 0
    assert v["promotions"] == 1
    if mode == "remote_write":
        assert v["lost_acked_writes"] == 0


def test_otb_chaos_seed_1107(tmp_path, capsys):
    """otb_chaos's tier-1 drive: one schedule of seed 1107 for 5 s, one
    verdict line and the summary, exit code 0."""
    rc = otb_chaos.main(["--seed", "1107", "--schedules", "1",
                         "--duration", "5", "--device", "cpu",
                         "--workdir", str(tmp_path / "w")])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    verdict, summary = lines
    assert rc == 0, verdict["violations"]
    assert verdict["seed"] == 1107
    assert verdict["events"] == events(RefSchedule, 1107, 5.0)
    assert summary["chaos_gate"] == "ok" and summary["schedules"] == 1
    assert summary["failed_seeds"] == [] and summary["promotions"] == 1


@pytest.mark.parametrize("schedule,item", [
    ("partition", "A.9"), ("multicn", "A.9"), ("rebalance", "A.8")])
def test_otb_chaos_refuses_the_schedules_not_ported(schedule, item,
                                                    capsys):
    with pytest.raises(SystemExit) as ei:
        otb_chaos.main(["--schedule", schedule, "--device", "cpu"])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert f"--schedule {schedule} is not ported (ROADMAP {item}" in err


@pytest.mark.parametrize("fn,item", [
    ("run_partition_schedule", "A.9"), ("run_partition_schedules", "A.9"),
    ("run_multicn_schedule", "A.9"), ("run_rebalance_schedule", "A.8")])
def test_schedules_not_ported_raise_by_name(fn, item, tmp_path):
    args = ((1201, 1, str(tmp_path)) if fn == "run_partition_schedules"
            else (1201, str(tmp_path)))
    with pytest.raises(NotPorted, match=f"ROADMAP {item}"):
        getattr(port_schedule, fn)(*args)

"""Spill-aware batch planner: size the radix hash-join table against a
device-memory budget, and the probe window of a bigger-than-budget
grouped top-k (the subset of the reference's
opentenbase_tpu/plan/batchplan.py the fused DAG reads).

A hash join whose build side outgrows its budget splits into passes
(src/backend/executor/nodeHash.c ExecHashIncreaseNumBatches in the
reference): the probe side stays resident and each pass probes one
transient table. The budget resolves in priority order:
  1. the ``device_memory_limit`` setting (bytes; 0 = unset),
  2. the op-specific environment override,
  3. the baked-in default for that op.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# defaults mirror the historical env knobs in executor/fused_dag.py
DEFAULT_EXCHANGE_BUDGET = 4_000_000_000
DEFAULT_WINDOW_BUDGET = 6_000_000_000
# a radix hash table is transient (freed after its join): allow it a
# fraction of the budget so probe/build residency still fits beside it
RADIX_TABLE_FRACTION = 4
RADIX_MAX_PASSES = 8
RADIX_TARGET_LOAD = 16  # average real keys per bucket the sizing aims at
RADIX_BUCKET_QUANTUM = 8  # bucket slots round up to a multiple of this


def next_pow2(n: int, floor: int = 1) -> int:
    p = max(int(floor), 1)
    while p < n:
        p <<= 1
    return p


def resolve_budget(
    device_memory_limit: int, env_name: str, default: int
) -> int:
    """One budget in bytes (see module docstring for the priority)."""
    if device_memory_limit and device_memory_limit > 0:
        return int(device_memory_limit)
    try:
        env = int(os.environ.get(env_name, 0))
    except ValueError:
        env = 0
    return env if env > 0 else int(default)


@dataclass(frozen=True)
class RadixPlan:
    """Static shape parameters for one bucket-padded radix hash join.

    ``partitions`` (power of two) × ``bucket`` slots is one pass's table;
    ``passes`` > 1 splits the build side into chunks probed one after
    another (multi-pass probe — nodeHash.c's nbatch, device-style:
    same probe residency, one transient table per pass)."""

    partitions: int
    bucket: int
    passes: int
    table_bytes: int  # per-pass footprint (keys + validity + indices)

    @property
    def slots(self) -> int:
        return self.partitions * self.bucket


def plan_radix_join(
    build_rows: int,
    probe_rows: int,
    budget: int,
    key_bytes: int = 8,
    idx_bytes: int = 4,
    quantum: int = RADIX_BUCKET_QUANTUM,
    target_load: int = RADIX_TARGET_LOAD,
    max_passes: int = RADIX_MAX_PASSES,
):
    """Size the radix table for a build side of ``build_rows`` (padded
    device width) against ``budget`` bytes. Returns a RadixPlan, or None
    when even ``max_passes`` passes can't fit a table — the caller keeps
    the sort-merge formulation (O(1) extra memory) instead.

    The bucket quantum keeps shapes static across batches: occupancy
    moves with the data, the table shape only moves in quantum steps, so
    repeat queries at similar scale reuse their compiled program."""
    if build_rows <= 0:
        return None
    slot_bytes = key_bytes + idx_bytes + 1  # +1: slot-validity plane
    cap = max(budget // RADIX_TABLE_FRACTION, 1)
    for passes in range(1, max_passes + 1):
        chunk = -(-build_rows // passes)
        partitions = next_pow2(max(chunk // target_load, 1))
        # headroom over the average load follows the balls-in-bins max
        # (~avg + sqrt(2 avg ln P)): avg + 4*sqrt(avg) + 8 keeps the
        # overflow flag a cold path for uniformly hashed keys at every
        # scale, rounded up to the quantum for shape reuse
        load = max(-(-chunk // partitions), 1)
        bucket = -(-int(load + 4 * load**0.5 + 8) // quantum) * quantum
        table_bytes = (partitions * bucket + 1) * slot_bytes
        if table_bytes <= cap:
            return RadixPlan(partitions, bucket, passes, table_bytes)
    return None


def probe_window_width(
    rows_per_shard: int, per_row_bytes: int, shards: int, budget: int,
    floor: int = 1024,
) -> int:
    """Power-of-two window width (dividing the power-of-two shard
    capacity) for streaming a bigger-than-budget probe side: halve until
    the window's sort operands fit, never below ``floor`` rows."""
    width = rows_per_shard
    while (
        shards * width * per_row_bytes > budget
        and width % 2 == 0 and width > floor
    ):
        width //= 2
    return width

"""Workload management: resource groups, admission control, load shedding
(the reference's opentenbase_tpu/wlm, as it is; a shed statement leaves
no server-log line, since the port has no log ring yet: ROADMAP A.7).

The coordinator-side resource-control layer OpenTenBase gets from
resource queues + statement_timeout machinery in tcop: every
resource-consuming statement is charged against its resource group
BEFORE any plan fragment is dispatched, and either admitted, parked in
a bounded FIFO queue, or shed with a SQLSTATE 53xxx error — graceful
degradation instead of unbounded thread/HBM contention.

Admission state machine (per statement):

    admit ──────────────► run ──► release
      │ group at concurrency/memory limit
      ▼
    queue (FIFO, bounded by queue_depth) ──► run ──► release
      │ queue full                │ statement_timeout in queue
      ▼                           ▼
    shed (SQLSTATE 53000/53200)  timeout (SQLSTATE 57014)

Surface: ``CREATE/ALTER/DROP RESOURCE GROUP ... WITH (concurrency=N,
memory_limit='64MB', queue_depth=N, priority=N)``, ``ALTER ROLE r
RESOURCE GROUP g``, the ``resource_group`` session GUC, and the
``pg_stat_wlm`` / ``pg_stat_wlm_queue`` / ``pg_resgroup_role`` views.
"""

from opentenbase_tpu_torch.wlm.manager import (
    DEFAULT_GROUP,
    AdmissionError,
    AdmissionTicket,
    ResourceGroup,
    WlmConfigError,
    WorkloadManager,
    parse_memory,
)

__all__ = [
    "DEFAULT_GROUP",
    "AdmissionError",
    "AdmissionTicket",
    "ResourceGroup",
    "WlmConfigError",
    "WorkloadManager",
    "parse_memory",
]

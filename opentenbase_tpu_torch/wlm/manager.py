"""Resource groups and the admission controller (the reference's
opentenbase_tpu/wlm/manager.py).

One ``WorkloadManager`` per cluster. Groups are catalog objects (their
DDL rides the WAL like every other DDL — storage/persist.py replays
``wlm_state`` records and checkpoints carry the full config); the
runtime side is a per-group counter block plus a FIFO wait queue
guarded by one manager-wide condition variable, the shape of
OpenTenBase's resource-queue lock in lock.c reduced to what a
thread-per-connection coordinator needs.

Thread-safety contract: every mutation of group state happens under
``self._cv``; waiters park on the condition and re-check themselves at
the queue head (FIFO — a later arrival can never overtake an earlier
one inside the same group).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

DEFAULT_GROUP = "default_group"

_ALLOWED_OPTIONS = ("concurrency", "memory_limit", "queue_depth", "priority")

_MEM_UNITS = {
    "b": 1,
    "kb": 1024,
    "mb": 1024**2,
    "gb": 1024**3,
    "tb": 1024**4,
}


class WlmConfigError(ValueError):
    """Bad resource-group DDL (unknown option, bad value, ...)."""


class AdmissionError(RuntimeError):
    """Statement refused by workload management.

    ``sqlstate`` is in the 53xxx "insufficient resources" class for
    sheds (53000 queue overflow, 53200 memory budget) and 57014
    (query_canceled) when the statement_timeout deadline expires while
    queued — the same codes OpenTenBase raises for resource
    exhaustion and cancellation, so clients retry or report them as such.
    """

    def __init__(self, msg: str, sqlstate: str = "53000"):
        super().__init__(msg)
        self.sqlstate = sqlstate


def parse_memory(value) -> int:
    """Memory option -> bytes. Accepts plain ints (bytes) or PG-style
    strings ('64MB', '512kB', '1GB')."""
    if isinstance(value, bool):
        raise WlmConfigError(f"invalid memory limit: {value!r}")
    if isinstance(value, (int, float)):
        n = int(value)
        if n < 0:
            raise WlmConfigError(f"invalid memory limit: {value!r}")
        return n
    s = str(value).strip().lower()
    for unit in sorted(_MEM_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            num = s[: -len(unit)].strip()
            try:
                n = int(float(num) * _MEM_UNITS[unit])
            except ValueError:
                break
            if n < 0:
                raise WlmConfigError(f"invalid memory limit: {value!r}")
            return n
    try:
        n = int(s)
    except ValueError:
        raise WlmConfigError(f"invalid memory limit: {value!r}") from None
    if n < 0:
        raise WlmConfigError(f"invalid memory limit: {value!r}")
    return n


class ResourceGroup:
    """One group: config (persisted) + runtime counters (not)."""

    def __init__(
        self,
        name: str,
        concurrency: int = 0,   # 0 = unlimited
        memory_limit: int = 0,  # bytes; 0 = unlimited
        queue_depth: int = 0,   # waiters allowed; 0 = shed immediately
        # informational only: budgets are per-group so admission has no
        # cross-group ordering to apply it to — accepted, persisted,
        # and surfaced in pg_stat_wlm; reserved for a future cross-group
        # scheduler (resource-queue priority in OpenTenBase)
        priority: int = 0,
    ):
        self.name = name
        self.concurrency = concurrency
        self.memory_limit = memory_limit
        self.queue_depth = queue_depth
        self.priority = priority
        # runtime
        self.running = 0
        self.mem_in_use = 0
        self.queue: list["_Waiter"] = []
        self.stats = {
            "admitted": 0,
            "queued": 0,
            "shed": 0,
            "timed_out": 0,
            # peak of SUM(charged estimates) — comparable to memory_limit
            "peak_memory": 0,
            "peak_running": 0,
            # largest single observed result (DistExecutor.note_bytes) —
            # a per-statement actual, deliberately NOT mixed into
            # peak_memory which tracks the budget charge
            "peak_result_bytes": 0,
            # cumulative milliseconds statements spent parked in this
            # group's admission queue (admitted, shed, or timed out —
            # every exit path pays its wait in)
            "queue_wait_ms": 0.0,
        }

    def limited(self) -> bool:
        return self.concurrency > 0 or self.memory_limit > 0

    def can_admit(self, est: int) -> bool:
        if self.concurrency > 0 and self.running >= self.concurrency:
            return False
        if self.memory_limit > 0 and self.mem_in_use + est > self.memory_limit:
            # a statement estimated under the limit must eventually fit
            # once the group drains; one estimated OVER the limit is
            # shed outright by admit()
            return False
        return True

    def config(self) -> dict:
        return {
            "concurrency": self.concurrency,
            "memory_limit": self.memory_limit,
            "queue_depth": self.queue_depth,
            "priority": self.priority,
        }

    def apply_options(self, options: dict) -> None:
        """Validate EVERYTHING, then mutate: an ALTER with one bad
        option must leave the live group untouched (the statement
        errors, so nothing is WAL-logged — a partial in-place change
        would silently diverge from the durable state)."""
        staged: dict = {}
        for key, value in options.items():
            if key not in _ALLOWED_OPTIONS:
                raise WlmConfigError(
                    f'unknown resource group option "{key}" '
                    f"(expected one of {', '.join(_ALLOWED_OPTIONS)})"
                )
            if key == "memory_limit":
                staged[key] = parse_memory(value)
                continue
            try:
                n = int(value)
            except (TypeError, ValueError):
                raise WlmConfigError(
                    f"invalid value for {key}: {value!r}"
                ) from None
            if n < 0:
                raise WlmConfigError(f"invalid value for {key}: {value!r}")
            staged[key] = n
        for key, n in staged.items():
            setattr(self, key, n)


class _Waiter:
    __slots__ = ("session_id", "query", "est", "enqueued_at")

    def __init__(self, session_id: int, query: str, est: int):
        self.session_id = session_id
        self.query = query
        self.est = est
        self.enqueued_at = time.monotonic()


class AdmissionTicket:
    """Held by an admitted statement; releasing frees the slot + memory
    charge. Idempotent — the session's finally path and error paths can
    both call release()."""

    __slots__ = ("_mgr", "group", "est", "_released")

    def __init__(self, mgr: "WorkloadManager", group: str, est: int):
        self._mgr = mgr
        self.group = group
        self.est = est
        self._released = False

    @property
    def released(self) -> bool:
        return self._released

    def note_bytes(self, nbytes: int) -> None:
        """Record actually-observed result bytes against the group's
        peak_result_bytes stat (estimates can undershoot; the view
        should show what really flowed)."""
        self._mgr.note_bytes(self.group, int(nbytes))

    def release(self) -> None:
        self._mgr._release(self)


class WorkloadManager:
    def __init__(self):
        self._mu = threading.RLock()
        self._cv = threading.Condition(self._mu)
        self.groups: dict[str, ResourceGroup] = {
            DEFAULT_GROUP: ResourceGroup(DEFAULT_GROUP)
        }
        # role name -> group name (pg_authid.rolresgroup analog)
        self.role_bindings: dict[str, str] = {}

    # -- DDL --------------------------------------------------------------
    def create_group(self, name: str, options: dict) -> None:
        with self._mu:
            if name in self.groups:
                raise WlmConfigError(
                    f'resource group "{name}" already exists'
                )
            g = ResourceGroup(name)
            g.apply_options(options)
            self.groups[name] = g

    def alter_group(self, name: str, options: dict) -> None:
        with self._cv:
            g = self.groups.get(name)
            if g is None:
                raise WlmConfigError(
                    f'resource group "{name}" does not exist'
                )
            g.apply_options(options)
            # limits may have widened: queued statements re-check
            self._cv.notify_all()

    def drop_group(self, name: str, if_exists: bool = False) -> bool:
        with self._mu:
            if name == DEFAULT_GROUP:
                raise WlmConfigError(
                    f'cannot drop resource group "{DEFAULT_GROUP}"'
                )
            g = self.groups.get(name)
            if g is None:
                if if_exists:
                    return False
                raise WlmConfigError(
                    f'resource group "{name}" does not exist'
                )
            if g.running or g.queue:
                raise WlmConfigError(
                    f'resource group "{name}" is busy '
                    f"({g.running} running, {len(g.queue)} queued)"
                )
            bound = sorted(
                r for r, gn in self.role_bindings.items() if gn == name
            )
            if bound:
                raise WlmConfigError(
                    f'resource group "{name}" is assigned to role(s) '
                    f"{', '.join(bound)}"
                )
            del self.groups[name]
            return True

    def bind_role(self, role: str, group: Optional[str]) -> None:
        with self._mu:
            if group is None:
                self.role_bindings.pop(role, None)
                return
            if group not in self.groups:
                raise WlmConfigError(
                    f'resource group "{group}" does not exist'
                )
            self.role_bindings[role] = group

    def group_for_role(self, role: str) -> str:
        with self._mu:
            return self.role_bindings.get(role, DEFAULT_GROUP)

    # -- persistence (WAL wlm_state records + checkpoint meta) ------------
    def dump_state(self) -> dict:
        with self._mu:
            return {
                "groups": {
                    name: g.config() for name, g in self.groups.items()
                },
                "roles": dict(self.role_bindings),
            }

    def load_state(self, payload: dict) -> None:
        """Replace the CONFIG with a dumped state (WAL redo/checkpoint
        restore). Runtime counters of groups that survive are kept —
        redo of a later ALTER must not zero live statistics."""
        with self._cv:
            groups = payload.get("groups") or {}
            for name, cfg in groups.items():
                g = self.groups.get(name)
                if g is None:
                    g = self.groups[name] = ResourceGroup(name)
                g.apply_options(cfg)
            for name in list(self.groups):
                if name not in groups and name != DEFAULT_GROUP:
                    del self.groups[name]
            self.role_bindings = dict(payload.get("roles") or {})
            self._cv.notify_all()

    # -- admission --------------------------------------------------------
    def _classify_locked(self, name: str, est: int):
        """Caller holds self._cv. Returns (group, ticket-or-None):
        ticket when admissible RIGHT NOW, None when the statement must
        queue; raises AdmissionError on a definite shed."""
        g = self.groups.get(name)
        if g is None:
            raise AdmissionError(
                f'resource group "{name}" does not exist', "42704"
            )
        if not g.limited():
            return g, self._admit_locked(g, est)
        if g.memory_limit > 0 and est > g.memory_limit:
            g.stats["shed"] += 1
            raise AdmissionError(
                f"out of memory: statement estimate {est} bytes "
                f'exceeds resource group "{name}" memory_limit '
                f"{g.memory_limit}",
                "53200",
            )
        if g.can_admit(est) and not g.queue:
            return g, self._admit_locked(g, est)
        if len(g.queue) >= g.queue_depth:
            g.stats["shed"] += 1
            raise AdmissionError(
                f'resource group "{name}" admission queue is full '
                f"(concurrency={g.concurrency}, "
                f"queue_depth={g.queue_depth})",
                "53000",
            )
        return g, None

    def try_admit(
        self, name: str, est: int = 0
    ) -> Optional[AdmissionTicket]:
        """Non-blocking admission: the uncontended fast path. Returns
        the ticket, raises on a definite shed, or returns None when the
        statement would have to queue (callers then release whatever
        outer locks must not be held across a wait and call admit())."""
        with self._cv:
            _g, ticket = self._classify_locked(name, max(int(est), 0))
            return ticket

    def admit(
        self,
        name: str,
        est: int = 0,
        timeout_ms: int = 0,
        session_id: int = 0,
        query: str = "",
    ) -> AdmissionTicket:
        """Admit, queue, or shed. Blocks (FIFO per group) while the
        group is at its concurrency/memory limit and the queue has
        room; ``timeout_ms`` (statement_timeout) bounds the wait."""
        with self._cv:
            est = max(int(est), 0)
            g, ticket = self._classify_locked(name, est)
            if ticket is not None:
                return ticket
            w = _Waiter(session_id, query, est)
            g.queue.append(w)
            g.stats["queued"] += 1
            deadline = (
                time.monotonic() + timeout_ms / 1000.0
                if timeout_ms and timeout_ms > 0
                else None
            )
            try:
                while True:
                    if g.memory_limit > 0 and est > g.memory_limit:
                        # ALTER shrank the budget below this waiter's
                        # estimate: it can never fit — shed instead of
                        # blocking the FIFO head forever
                        g.stats["shed"] += 1
                        raise AdmissionError(
                            f"out of memory: statement estimate {est} "
                            f'bytes exceeds resource group "{name}" '
                            f"memory_limit {g.memory_limit}",
                            "53200",
                        )
                    if g.queue and g.queue[0] is w and g.can_admit(est):
                        g.queue.pop(0)
                        # the next waiter may also fit (e.g. after an
                        # ALTER widened the limits)
                        self._cv.notify_all()
                        return self._admit_locked(g, est)
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            g.stats["timed_out"] += 1
                            # neutral wording: the bound may come from
                            # statement_timeout OR wlm_queue_timeout
                            raise AdmissionError(
                                "canceling statement: admission queue "
                                f'wait timeout in resource group '
                                f'"{name}"',
                                "57014",
                            )
                    self._cv.wait(remaining)
            finally:
                g.stats["queue_wait_ms"] += (
                    time.monotonic() - w.enqueued_at
                ) * 1000.0
                if w in g.queue:
                    g.queue.remove(w)
                    self._cv.notify_all()

    def _admit_locked(self, g: ResourceGroup, est: int) -> AdmissionTicket:
        g.running += 1
        g.mem_in_use += est
        g.stats["admitted"] += 1
        g.stats["peak_running"] = max(g.stats["peak_running"], g.running)
        g.stats["peak_memory"] = max(g.stats["peak_memory"], g.mem_in_use)
        return AdmissionTicket(self, g.name, est)

    def _release(self, ticket: AdmissionTicket) -> None:
        with self._cv:
            if ticket._released:
                return
            ticket._released = True
            g = self.groups.get(ticket.group)
            if g is not None:  # group may have been dropped meanwhile
                g.running = max(g.running - 1, 0)
                g.mem_in_use = max(g.mem_in_use - ticket.est, 0)
            self._cv.notify_all()

    def note_bytes(self, name: str, nbytes: int) -> None:
        with self._mu:
            g = self.groups.get(name)
            if g is not None and nbytes > g.stats["peak_result_bytes"]:
                g.stats["peak_result_bytes"] = nbytes

    # -- observability (pg_stat_wlm / pg_stat_wlm_queue) ------------------
    def stat_rows(self) -> list[tuple]:
        with self._mu:
            return [
                (
                    g.name,
                    g.concurrency,
                    g.memory_limit,
                    g.queue_depth,
                    g.priority,
                    g.running,
                    len(g.queue),
                    g.stats["admitted"],
                    g.stats["queued"],
                    g.stats["shed"],
                    g.stats["timed_out"],
                    g.stats["peak_memory"],
                    g.stats["peak_running"],
                    g.stats["peak_result_bytes"],
                    round(g.stats["queue_wait_ms"], 3),
                )
                for _, g in sorted(self.groups.items())
            ]

    def queue_rows(self) -> list[tuple]:
        now = time.monotonic()
        with self._mu:
            return [
                (
                    g.name,
                    w.session_id,
                    w.query[:100],
                    round((now - w.enqueued_at) * 1000.0, 3),
                    w.est,
                )
                for _, g in sorted(self.groups.items())
                for w in g.queue
            ]

    def binding_rows(self) -> list[tuple]:
        with self._mu:
            return sorted(self.role_bindings.items())

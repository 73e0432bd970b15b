"""Row and table locks with the deadlock check (subset of the reference's
opentenbase_tpu/lmgr.py).

A cluster-wide lock table keyed by (datanode, table, row_id) for row
locks and (datanode, table) for table locks. UPDATE and DELETE take row
locks on the rows they are about to mark, SELECT ... FOR UPDATE / FOR
SHARE on the rows it reads, INSERT a shared table lock, LOCK TABLE a
table lock in its mode's class (``table_lock_mode``). A waiter parks on
a condition variable; after ``deadlock_timeout_ms`` it looks for a
cycle through itself in the wait-for graph and, finding one, raises
DeadlockError (PG's policy: the detecting backend aborts itself). A
wait longer than ``lock_timeout_ms`` raises LockTimeout; NOWAIT raises
LockNotAvailable instead of waiting.

Blocking and the engine statement lock: the wire servers (net/) run
each statement under ``cluster._exec_lock`` (utils/rwlock.py), shared
or exclusive by statement class. A waiter that parked while holding
its slot would wedge the server: the holder of the awaited row lock
could never take the lock to COMMIT. So ``acquire`` releases whatever
slot the calling thread holds for the duration of the wait and takes
it back before returning, as the reference's does. Not ported: the
operator's cycle breaker (pg_unlock) and the pg_locks view.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional


class DeadlockError(RuntimeError):
    """Raised in the waiter chosen as deadlock victim; the session
    aborts the victim's whole transaction before surfacing it."""


class LockTimeout(RuntimeError):
    pass


class LockNotAvailable(RuntimeError):
    """NOWAIT could not acquire at once."""


# Row locks: "update" (exclusive) vs "share". Table locks: "shared"
# coexists with everything but exclusive; "exclusive" conflicts with
# every other lock on that table, row locks included.
ROW_UPDATE = "update"
ROW_SHARE = "share"
TABLE_SHARED = "shared"
TABLE_EXCLUSIVE = "exclusive"

# LOCK TABLE's modes that take the exclusive class; the others share
_EXCLUSIVE_TABLE_MODES = {
    "exclusive",
    "access exclusive",
    "share update exclusive",
    "share row exclusive",
}


@dataclass
class _Holder:
    session_id: int
    gxid: int
    mode: str


@dataclass
class _Waiter:
    session_id: int
    gxid: int
    mode: str
    keys: tuple


class LockManager:
    def __init__(self, cluster=None):
        # the cluster whose statement lock a waiter parks (None: no
        # statement lock to drop, as for a bare LockManager)
        self._cluster = cluster
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        # lock key -> holders. Row key: (node, table, row_id); table
        # key: (node, table).
        self._held: dict[tuple, list[_Holder]] = {}
        self._by_session: dict[int, set[tuple]] = {}
        self._waiters: dict[int, _Waiter] = {}

    # -- conflict rules --------------------------------------------------
    @staticmethod
    def _conflicts(mode_a: str, mode_b: str) -> bool:
        if ROW_SHARE == mode_a == mode_b:
            return False
        if TABLE_SHARED in (mode_a, mode_b):
            return TABLE_EXCLUSIVE in (mode_a, mode_b)
        return True

    def _blockers(self, keys, mode, session_id) -> list[_Holder]:
        """Holders that prevent this acquisition (a session never
        conflicts with itself). Caller holds ``_cv``."""
        out = []
        for key in keys:
            for h in self._held.get(key, ()):
                if h.session_id != session_id and self._conflicts(
                    h.mode, mode
                ):
                    out.append(h)
            if len(key) == 3:
                # a row lock is also blocked by an exclusive table lock
                for h in self._held.get(key[:2], ()):
                    if h.session_id != session_id and h.mode == (
                        TABLE_EXCLUSIVE
                    ):
                        out.append(h)
            elif mode == TABLE_EXCLUSIVE:
                # an exclusive table lock is blocked by any row lock on
                # that (node, table)
                for rk, hs in self._held.items():
                    if len(rk) == 3 and rk[:2] == key:
                        out.extend(
                            h for h in hs if h.session_id != session_id
                        )
        return out

    # -- acquisition -----------------------------------------------------
    def acquire(
        self,
        session_id: int,
        gxid: int,
        keys: list[tuple],
        mode: str,
        nowait: bool = False,
        lock_timeout_ms: int = 0,
        deadlock_timeout_ms: int = 1000,
    ) -> None:
        """Grant ``keys`` in ``mode`` to the session, waiting as long as
        a conflicting holder keeps them (at most ``lock_timeout_ms``
        where it is not 0; not at all with ``nowait``), with a deadlock
        check every ``deadlock_timeout_ms`` of waiting."""
        keys = tuple(keys)
        engine_lock = getattr(self._cluster, "_exec_lock", None)
        park_token = None
        start = time.monotonic()
        deadline = (start + lock_timeout_ms / 1000.0 if lock_timeout_ms
                    else None)
        dl_check_at = start + deadlock_timeout_ms / 1000.0
        try:
            with self._cv:
                while True:
                    if not self._blockers(keys, mode, session_id):
                        self._grant(session_id, gxid, keys, mode)
                        return
                    if nowait:
                        raise LockNotAvailable(
                            "could not obtain lock on row in relation "
                            f"{keys[0][1]!r}")
                    now = time.monotonic()
                    if deadline is not None and now >= deadline:
                        raise LockTimeout(
                            "canceling statement due to lock timeout")
                    self._waiters[session_id] = _Waiter(
                        session_id, gxid, mode, keys
                    )
                    if now >= dl_check_at:
                        cycle = self._cycle_through(session_id)
                        if cycle:
                            raise DeadlockError(
                                "deadlock detected: transactions "
                                + " -> ".join(str(g) for g in cycle)
                            )
                        dl_check_at = now + deadlock_timeout_ms / 1000.0
                    # park without the statement lock: neither its
                    # exclusive side nor a shared slot may be held while
                    # asleep (see the module docstring)
                    if park_token is None and engine_lock is not None:
                        park_token = engine_lock.park_release()
                    wait = min(0.05, dl_check_at - now)
                    if deadline is not None:
                        wait = min(wait, deadline - now)
                    self._cv.wait(timeout=max(wait, 0.005))
        finally:
            with self._cv:
                self._waiters.pop(session_id, None)
            if park_token is not None:
                engine_lock.park_reacquire(park_token)

    def _grant(self, session_id, gxid, keys, mode) -> None:
        """Caller holds ``_cv``."""
        for key in keys:
            hs = self._held.setdefault(key, [])
            if not any(
                h.session_id == session_id and h.mode == mode for h in hs
            ):
                hs.append(_Holder(session_id, gxid, mode))
            self._by_session.setdefault(session_id, set()).add(key)

    def release_all(self, session_id: int) -> None:
        with self._cv:
            for key in self._by_session.pop(session_id, ()):
                hs = self._held.get(key)
                if hs is None:
                    continue
                hs[:] = [h for h in hs if h.session_id != session_id]
                if not hs:
                    del self._held[key]
            self._cv.notify_all()

    # -- wait-for graph --------------------------------------------------
    def _graph(self) -> dict[int, set[int]]:
        """waiter session -> the sessions holding what it waits for.
        Caller holds ``_cv``."""
        g: dict[int, set[int]] = {}
        for w in self._waiters.values():
            for h in self._blockers(w.keys, w.mode, w.session_id):
                g.setdefault(w.session_id, set()).add(h.session_id)
        return g

    def _cycle_through(self, session_id: int) -> Optional[list[int]]:
        """The cycle containing ``session_id``, as a list of gxids (for
        the error message), else None. Caller holds ``_cv``."""
        g = self._graph()
        path: list[int] = []
        seen: set[int] = set()

        def dfs(s: int) -> Optional[list[int]]:
            if s in path:
                return path[path.index(s):]
            if s in seen:
                return None
            seen.add(s)
            path.append(s)
            for nxt in g.get(s, ()):  # a holder may itself be waiting
                got = dfs(nxt)
                if got is not None:
                    return got
            path.pop()
            return None

        cyc = dfs(session_id)
        if cyc is None or session_id not in cyc:
            return None
        # every cycle member has an outgoing wait edge: all are waiters
        return [self._waiters[s].gxid for s in cyc if s in self._waiters]


def table_lock_mode(sql_mode: Optional[str]) -> str:
    """LOCK TABLE ... IN <mode> MODE as a conflict class (no mode:
    ACCESS EXCLUSIVE, PG's default)."""
    if sql_mode is None:
        return TABLE_EXCLUSIVE
    return (TABLE_EXCLUSIVE if sql_mode.lower() in _EXCLUSIVE_TABLE_MODES
            else TABLE_SHARED)

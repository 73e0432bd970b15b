"""Reader-writer statement lock for the coordinator.

The reference gets statement concurrency from per-buffer/tuple locking +
MVCC; the columnar engine instead classifies statements: read-only
statements share the data plane (MVCC snapshots isolate them), while
writes/DDL take it exclusively. The exclusive side mimics
``threading.RLock`` (acquire/release/_is_owned, reentrant, context
manager) because the lock-manager wait loop (lmgr.py) releases and
re-acquires it around parks — existing exclusive users are unchanged.

Writer preference: once a writer is waiting, new readers queue behind it
(readers enter through the writer mutex), so writers cannot starve.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


@contextmanager
def parked(lock):
    """Release the statement-lock slot the current thread holds (and a
    writer's table mutexes) for the duration of the block: a statement
    waiting in an admission queue, or a CONCURRENTLY refresh's compute
    phase, holds nothing another session needs."""
    tok = lock.park_release() if hasattr(lock, "park_release") else None
    try:
        yield
    finally:
        if tok is not None:
            lock.park_reacquire(tok)


class RWStatementLock:
    def __init__(self):
        self._w = threading.RLock()
        self._cond = threading.Condition()
        self._readers = 0  # total shared holders (all groups)
        # shared holders by class: 'r' (read-only statements) and 'w'
        # (table-granular writers). The classes MIX, so a long reader
        # does not stall writers: every read captures each store once
        # under its ``_delta_mu`` (``ShardStore.scan_view``: rows,
        # version and MVCC log together; growth and vacuum REPLACE
        # arrays, never mutating captured ones — storage/table.py), its
        # snapshot comes from ``Cluster.clamped_snapshot``, below
        # every commit still stamping (engine.py), and the fused
        # executors' device cache refreshes from such captures under
        # ``cluster._fused_lock``. Exclusive statements (DDL, vacuum,
        # uncertain) still fence out everything.
        self._groups = {"r": 0, "w": 0}
        self.max_concurrent_table_writers = 0  # observability / tests
        self._table_writers = 0
        self._table_locks: dict = {}
        # which shared group (if any) the CURRENT thread holds — lets
        # the lock manager park a shared holder (release the slot so an
        # exclusive committer can pass) and re-acquire on wake
        self._tls = threading.local()

    # -- exclusive (RLock-compatible surface) ----------------------------
    def acquire(self) -> bool:
        self._w.acquire()
        with self._cond:
            while self._readers > 0:
                self._cond.wait()
        return True

    def release(self) -> None:
        self._w.release()

    def _is_owned(self) -> bool:
        return self._w._is_owned()

    def __enter__(self) -> "RWStatementLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- shared (class-based) ---------------------------------------------
    def _enter_shared(self, group: str) -> None:
        self._w.acquire()  # fence: exclusive holders/waiters first
        try:
            with self._cond:
                self._groups[group] += 1
                self._readers += 1
        finally:
            self._w.release()
        self._tls.group = group

    def _exit_shared(self, group: str) -> None:
        self._tls.group = None
        with self._cond:
            self._groups[group] -= 1
            self._readers -= 1
            if self._readers == 0 or self._groups[group] == 0:
                self._cond.notify_all()

    @contextmanager
    def _shared(self, group: str):
        self._enter_shared(group)
        try:
            yield
        finally:
            self._exit_shared(group)

    # -- lock-manager parking ---------------------------------------------
    def park_release(self):
        """Release whatever THIS THREAD holds — the exclusive side, a
        shared group slot, and (for table-granular writers) the
        per-table mutexes — so other sessions (including an exclusive
        committer that would otherwise deadlock against a parked shared
        holder, or another group's writer on the same table) can run
        while the caller sleeps in the lock manager or the WLM
        admission queue. A parked writer mutates nothing while asleep
        and reacquires mutexes-then-slot (write_tables order) on wake,
        so store mutation stays exclusive. Returns an opaque token for
        ``park_reacquire``; None when the thread holds nothing."""
        g = getattr(self._tls, "group", None)
        if g is not None:
            held = getattr(self._tls, "table_locks", None)
            self._exit_shared(g)
            if g == "w" and held:
                self._tls.table_locks = None
                names, locks = held
                for lk in reversed(locks):
                    lk.release()
                return ("wt", g, held)
            return ("s", g)
        if self._w._is_owned():
            self.release()
            return ("x",)
        return None

    def park_reacquire(self, token) -> None:
        if token is None:
            return
        if token[0] == "x":
            self.acquire()
        elif token[0] == "wt":
            _g, held = token[1], token[2]
            _names, locks = held
            for lk in locks:  # same sorted order as write_tables
                lk.acquire()
            self._enter_shared(_g)
            self._tls.table_locks = held
        else:
            self._enter_shared(token[1])

    # -- table-granular writers -------------------------------------------
    @contextmanager
    def write_tables(self, tables):
        """Writer-class shared access PLUS per-table mutexes: two
        writers touching disjoint table sets run concurrently; writers
        on the same table serialize; readers and DDL/uncertain
        statements are excluded (the reference's lock manager allows
        exactly this — RowExclusive coexists with RowExclusive on other
        relations, src/backend/storage/lmgr)."""
        names = sorted(set(tables))  # total order: no lock-order cycles
        with self._cond:
            locks = [
                self._table_locks.setdefault(n, threading.Lock())
                for n in names
            ]
        # table mutexes come BEFORE the group slot: a writer queued on a
        # same-table mutex must hold NO slot, or it would keep an
        # exclusive committer (whose commit the mutex holder may be
        # waiting on transitively through the lock manager) out forever
        for lk in locks:
            lk.acquire()
        try:
            with self._shared("w"):
                # visible to park_release: a parked writer must drop
                # these too (a queued same-table writer holding the
                # mutex would block every other group's writer)
                self._tls.table_locks = (names, locks)
                with self._cond:
                    self._table_writers += 1
                    self.max_concurrent_table_writers = max(
                        self.max_concurrent_table_writers,
                        self._table_writers,
                    )
                try:
                    yield
                finally:
                    self._tls.table_locks = None
                    with self._cond:
                        self._table_writers -= 1
        finally:
            for lk in reversed(locks):
                lk.release()

    # -- shared -----------------------------------------------------------
    @contextmanager
    def read(self):
        """Shared access: concurrent with other readers, excluded by any
        exclusive holder (entry passes through the writer mutex, which
        also gives writers preference over queued readers)."""
        with self._shared("r"):
            yield

"""Global timestamp service (GTS): the port's copy of the reference's
opentenbase_tpu/gtm/gts.py.

The reference's GTM (src/gtm/main/main.c, thread-per-connection over ~100
message types) issues GXIDs, global commit timestamps, snapshots and
sequences, and persists its state in an mmap'd store with its own WAL
and standby replication. This module keeps that contract with a small
core:

- ``GTSClock``: a monotonic hybrid timestamp, 44 bits of wall-clock ms
  and 20 bits of logical counter, so timestamps are globally ordered,
  roughly wall-time meaningful, and never repeat. Durability is the
  reserve-ahead watermark of gtm_store.c: a high watermark well above
  the last issued value is persisted, and a restart resumes beyond it,
  so a crash never reissues a timestamp (at the cost of a visible gap).
- ``GTSServer``: the transaction registry (begin, prepare, commit,
  abort, forget), the prepared-GID table that in-doubt recovery reads,
  cluster sequences with range reservation (gtm_seq.c get_rangemax),
  the node registry (register_gtm.c), and a standby feed hook.

A cluster talks to this object in process, or through gtm/server.py's
TCP front end, or to the C++ server (gtm/native) through gtm/client.py.
Failpoints (fault/): ``gtm/watermark`` at the clock's reserve-ahead
write, ``gtm/persist_nodes`` and ``gtm/persist_seqs`` at the node
registry's and the sequences' durability writes. Left out of the
reference's module: its log and trace rings.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Optional

from opentenbase_tpu_torch.fault import FAULT

GlobalTimestamp = int

_LOGICAL_BITS = 20
_LOGICAL_MASK = (1 << _LOGICAL_BITS) - 1
# the first valid timestamp; the storage sentinels (storage/table.py,
# PENDING_TS / INF_TS = 2**62, RESERVED_TS = 2**62 - 1) stay above every
# value this clock produces until 2^42 ms after 1970 (the year 2109)
FIRST_GTS: GlobalTimestamp = 1 << _LOGICAL_BITS


class GTSClock:
    """Monotonic hybrid-logical clock with a durable reserve-ahead
    watermark."""

    # the watermark's slack: 2^30 in hybrid units, 1 024 ms of the clock
    RESERVE = 1 << 30

    def __init__(self, store_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._store_path = store_path
        self._last: GlobalTimestamp = FIRST_GTS
        self._watermark: GlobalTimestamp = 0
        # the standby feed: every durable watermark advance is replicated,
        # so a promoted standby knows the ceiling of what the old primary
        # could have issued (read snapshots included)
        self.on_advance: Optional[Callable[[int], None]] = None
        if store_path and os.path.exists(store_path):
            with open(store_path) as f:
                state = json.load(f)
            # resume strictly above everything possibly issued
            self._last = max(self._last, int(state["watermark"]))
        self._advance_watermark()

    def _advance_watermark(self) -> None:
        """Caller holds ``_lock`` (or is ``__init__``)."""
        # failpoint: the reserve-ahead durability write (a promoted
        # standby's clock must still resume above the watermark)
        FAULT("gtm/watermark")
        self._watermark = self._last + self.RESERVE
        if self._store_path:
            tmp = self._store_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"watermark": self._watermark}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._store_path)

    def _next_locked(self) -> GlobalTimestamp:
        """Caller holds ``_lock``. One timestamp, no watermark check."""
        wall = int(time.time() * 1000) << _LOGICAL_BITS
        ts = wall if wall > self._last else self._last + 1
        if (ts & _LOGICAL_MASK) == _LOGICAL_MASK:
            ts += 1  # skip the counter's overflow boundary
        self._last = ts
        return ts

    def next(self) -> GlobalTimestamp:
        advanced: Optional[int] = None
        with self._lock:
            ts = self._next_locked()
            if ts >= self._watermark - (self.RESERVE >> 1):
                self._advance_watermark()
                advanced = self._watermark
        # replicated outside the clock lock: the fanout takes the
        # replication link's lock, and a standby's attach (which
        # snapshots state) takes them in the other order
        if advanced is not None and self.on_advance is not None:
            self.on_advance(advanced)
        return ts

    def next_n(self, n: int) -> list:
        """``n`` strictly increasing timestamps under one lock and at
        most one watermark fsync (group commit's range reservation)."""
        advanced: Optional[int] = None
        with self._lock:
            out = [self._next_locked() for _ in range(n)]
            if out and out[-1] >= self._watermark - (self.RESERVE >> 1):
                self._advance_watermark()
                advanced = self._watermark
        if advanced is not None and self.on_advance is not None:
            self.on_advance(advanced)
        return out

    def current(self) -> GlobalTimestamp:
        with self._lock:
            return self._last

    def advance(self, ts: GlobalTimestamp) -> None:
        """Move the clock to at least ``ts``, so the next timestamp is
        above it (rows recovered or carried in keep their stamps). The
        watermark follows as ``next`` would move it."""
        advanced: Optional[int] = None
        with self._lock:
            if ts <= self._last:
                return
            self._last = int(ts)
            if self._last >= self._watermark - (self.RESERVE >> 1):
                self._advance_watermark()
                advanced = self._watermark
        if advanced is not None and self.on_advance is not None:
            self.on_advance(advanced)


class GTSAdvanceError(RuntimeError):
    """A stamp too far ahead of the GTM's wall clock to move past: more
    than the watermark's reserve plus ``ADVANCE_WAIT_S`` (a writer with a
    skewed clock, or a storage sentinel taken for a commit timestamp)."""


# how long past the reserve window a cluster waits for a GTM over the
# wire to pass a stamp before it raises GTSAdvanceError
ADVANCE_WAIT_S = 5.0


def advance_limit_ms() -> int:
    """How far ahead of wall time, in ms, a stamp may lie and still be
    moved past: the watermark's reserve plus ``ADVANCE_WAIT_S``."""
    return (GTSClock.RESERVE >> _LOGICAL_BITS) + int(ADVANCE_WAIT_S * 1000)


def stamp_lead_ms(ts: GlobalTimestamp) -> int:
    """How far, in ms, the wall part of ``ts`` lies ahead of now."""
    return (int(ts) >> _LOGICAL_BITS) - int(time.time() * 1000)


class TxnState(Enum):
    ACTIVE = "active"
    PREPARED = "prepared"
    COMMITTED = "committed"
    ABORTED = "aborted"


@dataclass
class TxnInfo:
    gxid: int
    state: TxnState
    start_ts: GlobalTimestamp
    commit_ts: Optional[GlobalTimestamp] = None
    gid: Optional[str] = None  # the 2PC global identifier
    # participating datanode indices, recorded at prepare (pg_clean's
    # partnodes: the in-doubt resolver finds every branch by them)
    partnodes: tuple[int, ...] = ()


@dataclass
class _Sequence:
    name: str
    increment: int = 1
    next_value: int = 1
    min_value: int = 1
    max_value: int = 2**62
    cycle: bool = False


class GTSServer:
    """The GTM service object: timestamps, the transaction registry,
    sequences and the node registry.

    Thread-safe; every public method is one message of the reference's
    GTM protocol. ``on_replicate`` is the standby feed, called with
    (event, payload) after every durable state change.
    """

    def __init__(
        self,
        store_path: Optional[str] = None,
        on_replicate: Optional[Callable[[str, dict], None]] = None,
    ):
        self.clock = GTSClock(store_path)
        self._lock = threading.RLock()
        self._txns: dict[int, TxnInfo] = {}
        self._prepared: dict[str, TxnInfo] = {}
        self._seqs: dict[str, _Sequence] = {}
        self._next_gxid = 1
        self._on_replicate = on_replicate
        self.clock.on_advance = lambda wm: self._rep(
            "watermark", {"value": int(wm)}
        )
        self._rep("watermark", {"value": int(self.clock._watermark)})
        # sequence durability (gtm_store.c): a state file beside the
        # clock's, written log-ahead (the persisted next_value runs ahead
        # of the issued one, so a crash skips at most one window but
        # never reissues a value)
        self._seq_path = store_path + ".seq" if store_path else None
        self._seq_durable: dict[str, int] = {}
        if self._seq_path and os.path.exists(self._seq_path):
            with open(self._seq_path) as f:
                for name, st in json.load(f).items():
                    self._seqs[name] = _Sequence(
                        name, st["increment"], st["next_value"],
                        st["min_value"], st["max_value"], st["cycle"],
                    )
                    self._seq_durable[name] = st["next_value"]
        # the node registry (register_gtm.c): coordinators and datanodes
        # announce themselves; it survives a restart in its own file and
        # replicates to standbys
        self._nodes: dict[str, dict] = {}
        self._nodes_path = store_path + ".nodes" if store_path else None
        if self._nodes_path and os.path.exists(self._nodes_path):
            with open(self._nodes_path) as f:
                self._nodes = json.load(f)

    # -- node registration ------------------------------------------------
    def _persist_nodes(self) -> None:
        """Caller holds ``_lock``."""
        # failpoint: the node registry's durability (a promotion's
        # re-registration crosses it)
        FAULT("gtm/persist_nodes")
        if self._nodes_path is None:
            return
        tmp = self._nodes_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._nodes, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._nodes_path)

    def register_node(
        self, name: str, kind: str, host: str = "", port: int = 0,
    ) -> None:
        """A node announces itself; registering a name again updates its
        address (a restart on a new port)."""
        with self._lock:
            self._nodes[name] = {
                "kind": kind, "host": host, "port": int(port),
                "status": "connected",
            }
            self._persist_nodes()
            self._rep("node_register", {"name": name, **self._nodes[name]})

    def unregister_node(self, name: str) -> bool:
        with self._lock:
            existed = self._nodes.pop(name, None) is not None
            if existed:
                self._persist_nodes()
                self._rep("node_unregister", {"name": name})
            return existed

    def registered_nodes(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._nodes.items()}

    def _persist_seqs(self) -> None:
        """Caller holds ``_lock``."""
        # failpoint: an error is a GTM whose sequence store fsync
        # failed (nextval must not over-promise ranges)
        FAULT("gtm/persist_seqs")
        if self._seq_path is None:
            return
        state = {}
        for name, s in self._seqs.items():
            state[name] = {
                "increment": s.increment,
                "next_value": self._seq_durable.get(name, s.next_value),
                "min_value": s.min_value,
                "max_value": s.max_value,
                "cycle": s.cycle,
            }
        tmp = self._seq_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._seq_path)

    # -- timestamps -------------------------------------------------------
    def get_gts(self) -> GlobalTimestamp:
        return self.clock.next()

    def snapshot_ts(self) -> GlobalTimestamp:
        """A snapshot's timestamp: everything committed at or below it is
        visible."""
        return self.clock.next()

    # -- transactions -----------------------------------------------------
    def begin(self) -> TxnInfo:
        with self._lock:
            gxid = self._next_gxid
            self._next_gxid += 1
            info = TxnInfo(gxid, TxnState.ACTIVE, self.clock.next())
            self._txns[gxid] = info
            # a standby must not reissue this gxid after a promotion even
            # if the transaction never prepares or commits
            self._rep("begin", {"gxid": gxid})
            return info

    def prepare(self, gxid: int, gid: str, partnodes: tuple[int, ...]) -> None:
        with self._lock:
            info = self._txns.get(gxid)
            if info is None:
                # an in-doubt transaction recovered from the cluster WAL
                # registers again (the registry died with its process)
                info = TxnInfo(gxid, TxnState.ACTIVE, 0)
                self._txns[gxid] = info
                self._next_gxid = max(self._next_gxid, gxid + 1)
            info.state = TxnState.PREPARED
            info.gid = gid
            info.partnodes = partnodes
            self._prepared[gid] = info
            self._rep("prepare", {"gxid": gxid, "gid": gid,
                                  "partnodes": list(partnodes)})

    def commit(self, gxid: int) -> GlobalTimestamp:
        with self._lock:
            info = self._txns.get(gxid)
            if info is None:
                info = TxnInfo(gxid, TxnState.ACTIVE, 0)
                self._txns[gxid] = info
            info.commit_ts = self.clock.next()
            info.state = TxnState.COMMITTED
            if info.gid:
                self._prepared.pop(info.gid, None)
            self._rep("commit", {"gxid": gxid, "commit_ts": info.commit_ts})
            return info.commit_ts

    def commit_many(self, gxids) -> dict:
        """One clock range and one registry pass stamp every queued
        committer (group commit's GTS leg). Timestamps follow the list's
        order, so the caller's queue order is commit order."""
        gxids = list(gxids)
        # the range outside the registry lock (next()'s rule)
        tss = self.clock.next_n(len(gxids))
        with self._lock:
            for gxid, cts in zip(gxids, tss):
                info = self._txns.get(gxid)
                if info is None:
                    info = TxnInfo(gxid, TxnState.ACTIVE, 0)
                    self._txns[gxid] = info
                info.commit_ts = cts
                info.state = TxnState.COMMITTED
                if info.gid:
                    self._prepared.pop(info.gid, None)
                self._rep("commit", {"gxid": gxid, "commit_ts": cts})
        return dict(zip(gxids, tss))

    def abort(self, gxid: int) -> None:
        with self._lock:
            info = self._txns.get(gxid)
            if info is None:
                return
            info.state = TxnState.ABORTED
            if info.gid:
                self._prepared.pop(info.gid, None)
            self._rep("abort", {"gxid": gxid})

    def txn(self, gxid: int) -> Optional[TxnInfo]:
        with self._lock:
            return self._txns.get(gxid)

    def prepared_txns(self) -> list[TxnInfo]:
        """The in-doubt transactions (contrib/pg_clean's scan)."""
        with self._lock:
            return list(self._prepared.values())

    def forget(self, gxid: int) -> None:
        """Drop a finished transaction from the registry."""
        with self._lock:
            info = self._txns.pop(gxid, None)
            if info is not None and info.gid:
                self._prepared.pop(info.gid, None)

    # -- sequences --------------------------------------------------------
    def create_sequence(
        self,
        name: str,
        start: int = 1,
        increment: int = 1,
        min_value: int = 1,
        max_value: int = 2**62,
        cycle: bool = False,
    ) -> None:
        with self._lock:
            if name in self._seqs:
                raise ValueError(f"sequence {name!r} already exists")
            self._seqs[name] = _Sequence(
                name, increment, start, min_value, max_value, cycle
            )
            self._seq_durable[name] = start
            self._persist_seqs()
            self._rep(
                "seq_create",
                {"name": name, "start": start, "increment": increment,
                 "min": min_value, "max": max_value, "cycle": cycle},
            )

    def drop_sequence(self, name: str) -> None:
        with self._lock:
            self._seqs.pop(name, None)
            self._seq_durable.pop(name, None)
            self._persist_seqs()
            self._rep("seq_drop", {"name": name})

    def nextval(self, name: str, cache: int = 1) -> tuple[int, int]:
        """Reserve ``cache`` values; returns (first, last): the
        get_rangemax protocol (src/gtm/main/gtm_seq.c:76) that lets a
        coordinator take a statement's values in one round trip."""
        with self._lock:
            s = self._seqs.get(name)
            if s is None:
                raise KeyError(f"sequence {name!r} does not exist")
            first = s.next_value
            last = first + (cache - 1) * s.increment
            if last > s.max_value:
                if not s.cycle and first > s.max_value:
                    raise OverflowError(f"sequence {name!r} exhausted")
                last = s.max_value
            s.next_value = last + s.increment
            if s.cycle and s.next_value > s.max_value:
                s.next_value = s.min_value
            durable = self._seq_durable.get(name, first)
            # the durable mark runs ahead in the direction of travel, so
            # neither an ascending nor a descending sequence reissues
            passed = (
                s.next_value > durable
                if s.increment >= 0
                else s.next_value < durable
            )
            if passed:
                self._seq_durable[name] = s.next_value + 32 * s.increment
                self._persist_seqs()
            self._rep("seq_next", {"name": name, "next": s.next_value})
            return first, last

    def setval(self, name: str, value: int) -> None:
        with self._lock:
            s = self._seqs.get(name)
            if s is None:
                raise KeyError(f"sequence {name!r} does not exist")
            s.next_value = value
            self._seq_durable[name] = value
            self._persist_seqs()
            self._rep("seq_set", {"name": name, "value": value})

    # -- standby feed -----------------------------------------------------
    def _rep(self, event: str, payload: dict) -> None:
        if self._on_replicate is not None:
            self._on_replicate(event, payload)

    def state_snapshot(self) -> dict:
        """The full state a standby bootstraps from."""
        with self._lock:
            return {
                "next_gxid": self._next_gxid,
                "last_ts": self.clock.current(),
                "watermark": int(self.clock._watermark),
                "prepared": [
                    {"gxid": i.gxid, "gid": i.gid,
                     "partnodes": list(i.partnodes)}
                    for i in self._prepared.values()
                ],
                "sequences": {
                    n: {"next_value": s.next_value,
                        "increment": s.increment, "min": s.min_value,
                        "max": s.max_value, "cycle": s.cycle}
                    for n, s in self._seqs.items()
                },
                "nodes": {k: dict(v) for k, v in self._nodes.items()},
            }

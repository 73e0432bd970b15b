"""GTM standby replication and failover: the port's copy of the
reference's opentenbase_tpu/gtm/standby.py.

The reference runs a GTM standby fed by log shipping from the primary
(src/gtm/main/gtm_standby.c, replication.c, the MSG_BKUP_* messages) and
promotes it with ``gtm_ctl promote``. Here:

- ``GTSStandby`` bootstraps from the primary's ``state_snapshot()`` and
  applies the ``on_replicate`` event stream; every applied event
  advances ``applied_lsn``, so the lag is observable.
- ``promote()`` turns that state into a live ``GTSServer`` whose clock
  starts above everything the primary may have issued (the watermark
  jump: timestamps never regress or repeat across a failover).
- ``ReplicationLink`` wires a primary to standbys in process, and
  ``serve_feed`` / ``connect_feed`` carry the feed over TCP to a standby
  in another process, framed like the GTS native protocol.

Failpoints (fault/): ``gtm/feed`` per event, ``gtm/standby/accept``,
``gtm/standby/send`` and ``gtm/standby/recv`` per frame.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
from typing import Optional

from opentenbase_tpu_torch.fault import FAULT
from opentenbase_tpu_torch.gtm.gts import (
    GTSClock,
    GTSServer,
    TxnInfo,
    TxnState,
    _Sequence,
)
from opentenbase_tpu_torch.net.protocol import shutdown_and_close

log = logging.getLogger(__name__)


class GTSStandby:
    """Receives the primary's replication feed and can be promoted."""

    def __init__(self, snapshot: dict):
        self._lock = threading.Lock()
        self.applied_lsn = 0
        self._last_ts = int(snapshot["last_ts"])
        # the ceiling of everything the primary can issue without another
        # (replicated) watermark advance: read snapshots and begins are
        # never replicated as timestamps themselves
        self._watermark = int(snapshot.get("watermark", 0))
        self._next_gxid = int(snapshot["next_gxid"])
        self._prepared: dict[str, dict] = {
            p["gid"]: p for p in snapshot["prepared"]
        }
        self._seqs: dict[str, dict] = dict(snapshot["sequences"])
        self._nodes: dict[str, dict] = dict(snapshot.get("nodes", {}))
        self.promoted: Optional[GTSServer] = None

    # -- feed ---------------------------------------------------------------
    def apply(self, event: str, payload: dict) -> None:
        """One replication record (a MSG_BKUP_* message)."""
        with self._lock:
            self.applied_lsn += 1
            if event == "watermark":
                self._watermark = max(self._watermark, payload["value"])
            elif event == "begin":
                self._next_gxid = max(self._next_gxid, payload["gxid"] + 1)
            elif event == "prepare":
                self._prepared[payload["gid"]] = payload
                self._next_gxid = max(self._next_gxid, payload["gxid"] + 1)
            elif event in ("commit", "abort"):
                if event == "commit":
                    self._last_ts = max(self._last_ts, payload["commit_ts"])
                for gid, p in list(self._prepared.items()):
                    if p["gxid"] == payload["gxid"]:
                        del self._prepared[gid]
                self._next_gxid = max(self._next_gxid, payload["gxid"] + 1)
            elif event == "seq_create":
                self._seqs[payload["name"]] = {
                    "next_value": payload["start"],
                    "increment": payload.get("increment", 1),
                    "min": payload.get("min", 1),
                    "max": payload.get("max", 2**62),
                    "cycle": payload.get("cycle", False),
                }
            elif event == "seq_drop":
                self._seqs.pop(payload["name"], None)
            elif event in ("seq_next", "seq_set"):
                s = self._seqs.get(payload["name"])
                if s is not None:
                    s["next_value"] = payload.get(
                        "next", payload.get("value")
                    )
            elif event == "node_register":
                p = dict(payload)
                self._nodes[p.pop("name")] = p
            elif event == "node_unregister":
                self._nodes.pop(payload["name"], None)

    # -- failover -------------------------------------------------------------
    def promote(self, store_path: Optional[str] = None) -> GTSServer:
        """gtm_ctl promote: become the primary. The new clock starts above
        the old primary's durable watermark, so no timestamp is ever
        issued twice, not even one of commits replicated moments before
        the crash."""
        with self._lock:
            srv = GTSServer(store_path)
            # the replicated watermark is the ceiling of every timestamp
            # the old primary issued (commits, read snapshots, begins);
            # last_ts + RESERVE covers a standby attached before the
            # first watermark event
            with srv.clock._lock:
                srv.clock._last = max(
                    srv.clock._last,
                    self._last_ts + GTSClock.RESERVE,
                    self._watermark,
                )
                srv.clock._advance_watermark()
            srv._next_gxid = self._next_gxid
            for gid, p in self._prepared.items():
                info = TxnInfo(
                    p["gxid"], TxnState.PREPARED, 0, None, gid,
                    tuple(p["partnodes"]),
                )
                srv._txns[p["gxid"]] = info
                srv._prepared[gid] = info
            for name, s in self._seqs.items():
                srv._seqs[name] = _Sequence(
                    name, s["increment"], s["next_value"],
                    s.get("min", 1), s.get("max", 2**62),
                    s.get("cycle", False),
                )
                srv._seq_durable[name] = s["next_value"]
            srv._persist_seqs()
            # the node registry survives the failover (it is part of the
            # standby's backup)
            srv._nodes = {k: dict(v) for k, v in self._nodes.items()}
            srv._persist_nodes()
            self.promoted = srv
            log.warning("GTM standby promoted to primary (applied %d, %d "
                        "prepared)", self.applied_lsn, len(self._prepared))
            return srv


class ReplicationLink:
    """Wires a primary GTSServer to standbys (synchronous apply, the
    reference's default for a GTM standby)."""

    def __init__(self, primary: GTSServer):
        self.primary = primary
        self.standbys: list = []
        self.sent_lsn = 0
        self._lock = threading.Lock()
        # chained, not replaced: the cluster may already feed sequence
        # events into its WAL (engine.py's _seq_feed)
        self._chained = primary._on_replicate
        primary._on_replicate = self._fanout

    def attach(self, sink) -> tuple[dict, int]:
        """Snapshot the primary and subscribe ``sink`` (anything with
        .apply(event, payload)) atomically: no event falls between.

        The lock order is the fanout's (the GTS lock, then the link's):
        every replicated change holds the primary's lock when it reaches
        _fanout, so with the primary frozen no _rep is in flight."""
        with self.primary._lock:
            with self._lock:
                snap = self.primary.state_snapshot()  # an RLock: re-entered
                self.standbys.append(sink)
                return snap, self.sent_lsn

    def detach(self, sink) -> None:
        with self._lock:
            if sink in self.standbys:
                self.standbys.remove(sink)

    def add_standby(self) -> GTSStandby:
        # attach()'s lock order; the standby is whole before _fanout
        # can see it
        with self.primary._lock:
            with self._lock:
                sb = GTSStandby(self.primary.state_snapshot())
                sb.applied_lsn = self.sent_lsn
                self.standbys.append(sb)
                return sb

    def _fanout(self, event: str, payload: dict) -> None:
        if self._chained is not None:
            self._chained(event, payload)
        with self._lock:
            self.sent_lsn += 1
            for sb in self.standbys:
                sb.apply(event, payload)

    def lag(self, sb: GTSStandby) -> int:
        with self._lock:
            return self.sent_lsn - sb.applied_lsn


# -- the TCP transport (a standby in another process) -----------------------


def serve_feed(link: ReplicationLink, host: str = "127.0.0.1",
               port: int = 0) -> tuple[socket.socket, int, threading.Thread]:
    """Stream the snapshot and then the events to remote standbys (the
    walsender's part). Returns (listener, port, accept thread); closing
    the listener stops accepting."""
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind((host, port))
    lsock.listen(8)

    def pump(conn: socket.socket) -> None:
        import queue

        q: "queue.Queue[tuple[str, dict]]" = queue.Queue()

        class _QStandby:
            applied_lsn = 0

            def apply(self, event, payload):  # the feed into the queue
                q.put((event, payload))

        qsb = _QStandby()
        snap, lsn = link.attach(qsb)  # atomic: no event lost between
        try:
            _send(conn, {"snapshot": snap, "lsn": lsn})
            while True:
                event, payload = q.get()
                # failpoint: the feed (drop_conn severs the standby,
                # which resyncs on reconnect; delay a lagging standby)
                FAULT("gtm/feed", event=event)
                _send(conn, {"event": event, "payload": payload})
        except OSError:
            pass
        finally:
            link.detach(qsb)
            shutdown_and_close(conn)

    def accept_loop() -> None:
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            try:
                # a try of its own: an injected drop refuses one
                # standby's attach, never the feed's listener
                FAULT("gtm/standby/accept")
            except Exception as e:
                log.warning("standby feed attach refused: %r", e)
                shutdown_and_close(conn)
                continue
            threading.Thread(target=pump, args=(conn,), daemon=True).start()

    t = threading.Thread(target=accept_loop, daemon=True)
    t.start()
    return lsock, lsock.getsockname()[1], t


def connect_feed(host: str, port: int) -> tuple["GTSStandby", threading.Thread]:
    """A remote standby: bootstrap from the streamed snapshot and keep
    applying events (the walreceiver's part)."""
    sock = socket.create_connection((host, port), timeout=10)
    first = _recv(sock)
    if first is None:
        sock.close()
        raise ConnectionError("GTM feed closed before its snapshot")
    sock.settimeout(None)
    sb = GTSStandby(first["snapshot"])
    sb.applied_lsn = first["lsn"]

    def recv_loop() -> None:
        try:
            while True:
                msg = _recv(sock)
                if msg is None:
                    return
                sb.apply(msg["event"], msg["payload"])
        except OSError:
            return
        finally:
            sock.close()

    t = threading.Thread(target=recv_loop, daemon=True)
    t.start()
    return sb, t


def _send(sock: socket.socket, obj: dict) -> None:
    # failpoint: the primary dying mid-frame (a torn feed)
    FAULT("gtm/standby/send")
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv(sock: socket.socket):
    # failpoint: the standby's frame read
    FAULT("gtm/standby/recv")
    head = b""
    while len(head) < 4:
        chunk = sock.recv(4 - len(head))
        if not chunk:
            return None
        head += chunk
    (n,) = struct.unpack("<I", head)
    body = b""
    while len(body) < n:
        chunk = sock.recv(n - len(body))
        if not chunk:
            return None
        body += chunk
    return json.loads(body.decode())

"""Streaming replication: WAL shipping to a hot standby (the reference's
opentenbase_tpu/storage/replication.py, the same stream protocol).

- ``WalSender`` serves the primary's wal.log over TCP. A connecting
  standby reports its end offset; the sender streams every byte from
  there and keeps tailing the file, pipelined: frames stream ahead
  within a sliding window while the receiver's applied acks flow back
  on the same socket. The per-peer ack table is what
  ``synchronous_commit = remote_write`` consults.
- ``StandbyCluster`` is a port ``Cluster`` on an explicit device plus a
  walreceiver thread: incoming bytes append to its own wal.log and
  complete records are applied as they arrive, under the cluster's
  statement lock; read-only sessions see replicated commits at once
  (hot standby). It requests from its own offset, so a restart is a
  reconnect. A datanode process (dn/server.py) is one of these.

Self-healing HA (ha.py drives these):

- The handshake carries fencing generations both ways: the receiver
  announces its cluster's ``node_generation``, the sender answers with
  its own and its timeline base (``ha_promote_lsn``). A standby refuses
  to follow an older generation, and a sender refuses a follower from
  a newer one before any WAL byte: split-brain is a refused handshake.
- ``StandbyCluster.promote(generation=...)`` truncates the torn stream
  tail to the last complete record, re-logs direct-applied 2PC commits
  whose frame never streamed, logs the bumped generation as a durable
  ``ha_generation`` record, and goes read-write.
- ``rejoin_standby`` is the pg_rewind analog: probe the new primary's
  timeline base (``probe_timeline``), truncate the diverged local WAL
  past it, rebuild on the caller's device, and stream again.

Failpoints (fault/): ``repl/accept``, ``repl/ack_recv``,
``repl/wal_stream`` (its ``wal_torn`` action tears each chunk at
positions from ``site_rng``), ``repl/start_replication``,
``repl/wal_recv`` and ``repl/probe``; the connectivity matrix is
consulted at the attach, the stream and the probe.

Not ported: the reference's re-registration with the GTM after a
promotion (the port has no GTM).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Optional

from opentenbase_tpu_torch.fault import FAULT, NET_CHECK, site_rng
from opentenbase_tpu_torch.net.protocol import (
    REPL_PROBE,
    pack_repl_ack,
    pack_repl_hello,
    recv_repl_ack,
    recv_repl_hello,
    shutdown_and_close,
)
from opentenbase_tpu_torch.storage.persist import WAL, unpack_arrays

log = logging.getLogger(__name__)


class WalSender:
    """Primary-side WAL streamer (walsender.c), pipelined with a
    per-connection ack reader."""

    # bytes in flight (sent - acked) before the stream pauses for acks,
    # enforced once the peer's first ack arrived; a record larger than
    # the window still goes out whole (acks move by whole records)
    WINDOW_BYTES = 16 << 20
    CHUNK_BYTES = 1 << 20  # a read of the WAL file, a send

    def __init__(self, persistence, host: str = "127.0.0.1", port: int = 0,
                 poll_s: float = 0.05):
        self.persistence = persistence
        self.poll_s = poll_s
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(8)
        self.host, self.port = self._lsock.getsockname()
        self._stop = threading.Event()
        # conn id -> [peer_addr, sent_offset, acked_offset] (acked -1
        # until the peer's first ack)
        self._peers: dict = {}
        self._peers_mu = threading.Lock()
        # remote_write waiters park here; every ack wakes them
        self._ack_cv = threading.Condition(self._peers_mu)
        # staleness evidence: (wal_end_offset, monotonic_time) pairs; a
        # peer whose ack covers off was current at t
        self._pos_ring: list = []
        # the accepted connections: stop() severs them, so that nothing
        # written after it returns reaches a peer
        self._conns: set = set()
        persistence.wal_senders.append(self)
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def stop(self) -> None:
        """Stop accepting and sever every stream: once this returns, no
        byte the WAL gains reaches a standby (a crash's cut)."""
        self._stop.set()
        try:
            self.persistence.wal_senders.remove(self)
        except ValueError:
            pass
        shutdown_and_close(self._lsock)
        with self._peers_mu:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def peer_positions(self) -> list:
        """[(peer_addr, sent_offset)] of live standby connections."""
        with self._peers_mu:
            return [(ent[0], int(ent[1])) for ent in self._peers.values()]

    def peer_acks(self) -> list:
        """[(peer_addr, acked_offset)] of live standby connections that
        acked at least once (pg_stat_replication's flush_lsn)."""
        with self._peers_mu:
            return [(ent[0], int(ent[2]))
                    for ent in self._peers.values() if ent[2] >= 0]

    _RING_CAP = 1024

    def _note_position(self) -> None:
        off = int(self.persistence.wal.position)
        t = time.monotonic()
        with self._peers_mu:
            ring = self._pos_ring
            if ring and ring[-1][0] == off:
                ring[-1] = (off, t)
                return
            ring.append((off, t))
            if len(ring) > self._RING_CAP:
                del ring[: len(ring) - self._RING_CAP]

    def peer_staleness(self) -> list:
        """[(peer_addr, acked_offset, staleness_seconds)] for every peer
        that acked: 0.0 when its ack covers the WAL end, else the time
        since the newest recorded WAL end its ack covers (+inf with no
        evidence)."""
        now = time.monotonic()
        pos = int(self.persistence.wal.position)
        with self._peers_mu:
            ring = list(self._pos_ring)
            acks = [(ent[0], int(ent[2]))
                    for ent in self._peers.values() if ent[2] >= 0]
        out = []
        for addr, acked in acks:
            if acked >= pos:
                out.append((addr, acked, 0.0))
                continue
            proof = None
            for off, t in reversed(ring):
                if off <= acked:
                    proof = t
                    break
            out.append((addr, acked,
                        (now - proof) if proof is not None else float("inf")))
        return out

    def wait_quorum_acked(self, lsn: int, quorum: int,
                          deadline: float) -> bool:
        """Park until at least ``quorum`` peers acked ``lsn`` (woken by
        every ack) or ``deadline`` (monotonic) passes."""
        with self._ack_cv:
            while True:
                acks = sorted((int(e[2]) for e in self._peers.values()
                               if e[2] >= 0), reverse=True)
                if len(acks) >= quorum and acks[quorum - 1] >= lsn:
                    return True
                left = deadline - time.monotonic()
                if left <= 0 or self._stop.is_set():
                    return False
                self._ack_cv.wait(timeout=min(left, 0.25))

    def _ack_loop(self, conn: socket.socket) -> None:
        """Fold the receiver's applied-offset acks into the peer table;
        on the peer's death retire its entry (a stale entry would count
        in remote_write's quorum across a reconnect)."""
        try:
            while not self._stop.is_set():
                try:
                    # failpoint: a standby's ack stream (delay: the
                    # slowest standby; drop_conn: a standby whose acks
                    # a remote_write quorum may wait on)
                    FAULT("repl/ack_recv")
                    off = recv_repl_ack(conn)
                except (OSError, ConnectionError):
                    return
                with self._ack_cv:
                    ent = self._peers.get(id(conn))
                    if ent is not None and off > ent[2]:
                        ent[2] = off
                    self._ack_cv.notify_all()
        finally:
            with self._ack_cv:
                self._peers.pop(id(conn), None)
                self._ack_cv.notify_all()

    def _generation(self) -> int:
        """This timeline's fencing generation."""
        return int(self.persistence.cluster.node_generation)

    def _promote_lsn(self) -> int:
        """This timeline's base: the WAL offset where it stopped being a
        byte prefix of its predecessor's (0 for an original primary)."""
        return int(self.persistence.cluster.ha_promote_lsn)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            try:
                # failpoint: a standby's attach refused. A try of its
                # own: drop_conn is an OSError, which the accept's
                # handler would read as a closed listener
                FAULT("repl/accept")
            except Exception as e:
                log.warning("standby attach refused: %r", e)
                shutdown_and_close(conn)
                continue
            threading.Thread(target=self._stream, args=(conn,),
                             daemon=True).start()

    def _stream(self, conn: socket.socket) -> None:
        path = self.persistence.wal.path
        with self._peers_mu:
            if self._stop.is_set():
                conn.close()
                return
            self._conns.add(conn)
        try:
            peer = "unknown"
            try:
                a = conn.getpeername()
                peer = f"{a[0]}:{a[1]}"
            except OSError:
                pass
            try:
                offset, peer_gen = recv_repl_hello(conn)
            except ConnectionError:
                return
            # our generation and timeline base before any WAL byte
            conn.sendall(pack_repl_hello(self._generation(),
                                         self._promote_lsn()))
            if offset == REPL_PROBE:
                return  # a timeline probe: header only
            if peer_gen > self._generation():
                # a standby of a newer timeline: this node is a fenced
                # ex-primary, and not one divergent byte may cross
                log.warning("refusing standby %s with newer generation "
                            "(%d > %d): this node is a fenced ex-primary",
                            peer, peer_gen, self._generation())
                return
            with self._peers_mu:
                self._peers[id(conn)] = [peer, int(offset), -1]
            threading.Thread(target=self._ack_loop, args=(conn,),
                             daemon=True).start()
            ack_seen, rec_end = -2, 0
            with open(path, "rb") as f, open(path, "rb") as hf:
                f.seek(offset)
                while not self._stop.is_set():
                    self._note_position()
                    with self._ack_cv:
                        ent = self._peers.get(id(conn))
                        sent, acked = (ent[1], ent[2]) if ent else (0, -1)
                    if acked >= 0 and sent - acked > self.WINDOW_BYTES:
                        # the peer acks only whole records: the record it
                        # is short of goes out whole, however large, or
                        # neither side would ever move again
                        if acked != ack_seen:
                            ack_seen, rec_end = acked, _record_end(hf, acked)
                        if sent >= rec_end:
                            with self._ack_cv:
                                self._ack_cv.wait(timeout=0.25)
                            continue
                    chunk = f.read(self.CHUNK_BYTES)
                    if chunk:
                        # failpoint: wal_torn tears the chunk at byte
                        # positions from the fault's seeded stream
                        # (short writes the standby's reassembly must
                        # survive); drop_conn is the sender dying
                        act = FAULT("repl/wal_stream", bytes=len(chunk))
                        if act == "wal_torn" and len(chunk) > 1:
                            rng = site_rng("repl/wal_stream")
                            pos = 0
                            while pos < len(chunk):
                                cut = pos + rng.randint(
                                    1, max(len(chunk) - pos, 1))
                                conn.sendall(chunk[pos:cut])
                                pos = cut
                                time.sleep(0.001)  # distinct recvs
                        else:
                            conn.sendall(chunk)
                        with self._peers_mu:
                            ent = self._peers.get(id(conn))
                            if ent is not None:
                                ent[1] = f.tell()
                    else:
                        time.sleep(self.poll_s)
        except (OSError, ValueError):  # ValueError: the WAL was closed
            pass
        finally:
            with self._peers_mu:
                self._peers.pop(id(conn), None)
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass


def _record_end(f, offset: int) -> int:
    """The offset just past the WAL record that starts at ``offset``
    (``offset`` itself where its length is not written yet)."""
    f.seek(offset)
    head = f.read(4)
    if len(head) < 4:
        return offset
    return offset + 4 + struct.unpack("<I", head)[0]


def _records(buf, start: int):
    """Complete WAL records of ``buf`` from ``start``: yields (tag,
    header, arrays, end) and stops at the first incomplete one. The
    length is read first, so an incomplete large record costs nothing
    until its last byte arrives."""
    off = start
    n = len(buf)
    view = memoryview(buf)
    while n - off >= 5:
        length, tag = struct.unpack_from("<IB", buf, off)
        if length < 5:
            raise ValueError(f"corrupt WAL record at stream offset {off}")
        end = off + 4 + length
        if end > n:
            return
        (hlen,) = struct.unpack_from("<I", buf, off + 5)
        header = json.loads(bytes(view[off + 9: off + 9 + hlen]).decode())
        rest = view[off + 9 + hlen: end]
        arrays = unpack_arrays(bytes(rest)) if len(rest) else None
        yield chr(tag), header, arrays, end
        off = end


class StandbyCluster:
    """Hot standby: a replicated port cluster serving read-only
    queries on ``device`` (cuda:0 unless the caller passes another; no
    CUDA and no device is an error, as for ``Cluster``)."""

    # replayed inserts park as delta batches; a store holding this many
    # delta rows is folded into its base arrays (positions kept), so a
    # bulk load's frames are not reassembled by every scan
    FOLD_ROWS = 1 << 20

    def __init__(self, data_dir: str, num_datanodes: int = 2,
                 shard_groups: int = 256, device=None):
        from opentenbase_tpu_torch.engine import Cluster

        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        self.cluster = Cluster(num_datanodes, shard_groups, data_dir,
                               device=device)
        self.cluster.read_only = True
        p = self.cluster.persistence
        # redo until promote(): replayed sequence events are not logged
        # again (the local WAL stays a verbatim prefix of the primary's)
        p._in_recovery = True
        # gids whose writes this process applied from a shipped 2PC
        # journal (dn/server.py): the stream's matching 'G' frame is
        # skipped, exactly once across the two delivery paths. Volatile
        # on purpose: direct applies never enter the local WAL copy (a
        # verbatim prefix of the primary's), so after a restart the
        # stream's frame is the one that brings the rows.
        self.direct_applied: set = set()
        # called with the gid of every gid-tagged 'G' frame the stream
        # delivers (the datanode retires its journal entry)
        self.stream_txn_hook = None
        # gid -> (commit_ts, wire payload) of direct applies whose frame
        # has not streamed yet: a promotion re-logs them, so the
        # promoted WAL holds every row of the promoted stores
        self.pending_relog: dict = {}
        # True once promote() drained pending_relog: no stream delivers a
        # frame here any more, so a direct 2PC apply logs its own
        self.relog_closed = False
        self.promoted = False
        # bytes past the last complete record that promote() truncated
        self.torn_bytes = 0
        # the sender's generation and timeline base from its hello
        self.source_generation = 0
        self.source_promote_lsn = 0
        # what rejoin_standby truncated before this standby was built
        self.truncated_bytes = 0
        # replay the local WAL copy (a restarted or rewound standby)
        t0 = time.perf_counter()
        self.applied = 0
        for tag, header, arrays, off in WAL.read_records(p.wal.path):
            self._apply_one(tag, header, arrays)
            self.applied = off
        self.replay_s = time.perf_counter() - t0
        self._sock: Optional[socket.socket] = None
        self.repl_addr = ""
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # why the stream ended, when it did not end by stop()
        self.stream_error: Optional[str] = None

    # -- walreceiver ------------------------------------------------------
    def start_replication(self, host: str, port: int) -> "StandbyCluster":
        # failpoint: the attach itself (a standby that cannot rejoin)
        FAULT("repl/start_replication", host=host, port=port)
        # the matrix: a standby on a cut link cannot attach
        NET_CHECK(host, port, timeout_s=10)
        my_gen = self.cluster.node_generation
        self._sock = socket.create_connection((host, port), timeout=10)
        try:
            self._sock.sendall(pack_repl_hello(self.applied, my_gen))
            self._sock.settimeout(10)
            sender_gen, promote_lsn = recv_repl_hello(self._sock)
            self._sock.settimeout(None)
        except Exception:
            shutdown_and_close(self._sock)
            self._sock = None
            raise
        if sender_gen < my_gen:
            # never follow an older timeline (a revived ex-primary's
            # walsender trying to capture us back)
            shutdown_and_close(self._sock)
            self._sock = None
            raise RuntimeError(
                f"stale generation: walsender at {host}:{port} serves "
                f"generation {sender_gen}, we are at {my_gen}")
        if sender_gen > my_gen and self.applied > promote_lsn:
            # our tail reaches past the new timeline's base: those
            # records came from the old timeline and are applied here
            shutdown_and_close(self._sock)
            self._sock = None
            raise RuntimeError(
                f"diverged: applied {self.applied} is past the new "
                f"timeline base {promote_lsn}; rewind required "
                "(storage.replication.rejoin_standby)")
        self.source_generation = sender_gen
        self.source_promote_lsn = promote_lsn
        try:
            a = self._sock.getsockname()
            self.repl_addr = f"{a[0]}:{a[1]}"
        except OSError:
            self.repl_addr = ""
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()
        return self

    def _recv_loop(self) -> None:
        p = self.cluster.persistence
        buf = bytearray()
        acked = -1
        while not self._stop.is_set():
            try:
                # failpoint: the walreceiver stalling (delay) or dying
                # (drop_conn) as under a network partition
                FAULT("repl/wal_recv")
                # the matrix: a cut mid-stream severs the receiver
                peer = self._sock.getpeername()
                NET_CHECK(peer[0], peer[1])
                chunk = self._sock.recv(1 << 20)
            except OSError as e:
                self._stream_end(f"walreceiver connection lost: {e}")
                return
            if not chunk:
                self._stream_end("walreceiver stream ended by peer")
                return
            # durable first (written to our own wal.log), then applied
            p.wal._f.write(chunk)
            p.wal._f.flush()
            buf += chunk
            try:
                consumed = self._drain(buf)
            except Exception as e:  # a record the port cannot apply
                self._stream_end(f"walreceiver apply failed: "
                                 f"{type(e).__name__}: {e}")
                return
            if consumed:
                del buf[:consumed]
            if self.applied > acked:
                # the pipelined ack: the applied offset, on the same
                # socket (best effort: a failed send means the stream is
                # dying, and the next recv says so)
                try:
                    self._sock.sendall(pack_repl_ack(self.applied))
                    acked = self.applied
                except OSError:
                    pass

    def _stream_end(self, msg: str) -> None:
        if not self._stop.is_set():
            self.stream_error = msg
            log.warning("%s (applied %d)", msg, self.applied)

    def _drain(self, buf) -> int:
        """Apply every complete record in ``buf``, each under the
        cluster's statement lock (a hot-standby reader never sees half a
        frame); returns the bytes consumed. ``applied`` is the absolute
        WAL offset: the buffer's start plus what was consumed."""
        consumed = 0
        for tag, header, arrays, end in _records(buf, 0):
            with self.cluster._exec_lock:
                self._apply_one(tag, header, arrays)
                self.applied += end - consumed
            consumed = end
        return consumed

    def _apply_one(self, tag, header, arrays) -> None:
        c = self.cluster
        if tag == "B":
            c.barriers.append((header["name"], header["ts"]))
            return
        if tag == "G":
            gid = header.get("gid")
            if gid:
                if self.stream_txn_hook is not None:
                    self.stream_txn_hook(gid)
                self.pending_relog.pop(gid, None)
                if gid in self.direct_applied:
                    # the shipped journal already applied this commit
                    self.direct_applied.discard(gid)
                    return
        c.persistence._apply(tag, header, arrays)
        if tag == "G":
            for wm in header["writes"]:
                store = c.stores.get(wm.get("node"), {}).get(wm["table"])
                if (wm.get("kind") == "ins" and store is not None
                        and store.pending_delta_rows >= self.FOLD_ROWS):
                    store.compact()

    def note_direct_apply(self, gid: str, commit_ts: int, wire_writes):
        """A 2PC decision applied ``gid``'s journaled write set directly
        (dn/server.py); its 'G' frame is still in flight."""
        self.pending_relog[gid] = (int(commit_ts), wire_writes)

    # -- client surface ---------------------------------------------------
    def session(self):
        """A read-only session whose statements run under the cluster's
        statement lock, excluding WAL apply in flight."""
        inner = self.cluster.session()
        lock = self.cluster._exec_lock

        class _LockedSession:
            # the session itself: its last route and executor
            session = inner

            def execute(self, sql):
                with lock:
                    return inner.execute(sql)

            def query(self, sql):
                return self.execute(sql).rows

        return _LockedSession()

    def restart_replication(self, host: str,
                            port: int) -> "StandbyCluster":
        """Stop the stream, drop a torn tail past the last complete
        record, and stream again from our own offset."""
        self.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._stop = threading.Event()
        self.stream_error = None
        p = self.cluster.persistence
        try:
            if os.path.getsize(p.wal.path) > self.applied:
                p.wal.truncate_to(self.applied)
        except OSError:
            pass
        return self.start_replication(host, port)

    def lag_bytes(self, primary_persistence) -> int:
        return primary_persistence.wal.position - self.applied

    def wait_caught_up(self, primary_persistence,
                       timeout_s: float = 10.0) -> bool:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            if self.lag_bytes(primary_persistence) <= 0:
                return True
            if self.stream_error is not None:
                return False
            time.sleep(0.02)
        return False

    def promote(self, generation: Optional[int] = None):
        """pg_ctl promote: stop the stream, finish recovery, go
        read-write. The local WAL is truncated to ``applied`` (a sender
        that died mid-frame leaves partial record bytes, and the new
        timeline's first append must start on a record boundary);
        direct-applied 2PC commits whose frame never streamed are
        re-logged in commit order; the bumped fencing generation is
        logged as a durable ``ha_generation`` record. The re-log and
        the bump are atomic under the statement lock, so a phase 2 of
        the doomed primary either lands before them (and is re-logged)
        or sees the new generation and refuses. Returns the cluster."""
        from opentenbase_tpu_torch.plan import serde

        self.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
        c = self.cluster
        p = c.persistence
        torn = 0
        try:
            end = os.path.getsize(p.wal.path)
            if end > self.applied:
                torn = end - self.applied
                p.wal.truncate_to(self.applied)
        except OSError:
            pass
        self.torn_bytes = torn
        c.ha_promote_lsn = self.applied
        if generation is None:
            generation = c.node_generation + 1
        p._in_recovery = False
        p._finish_recovery()
        relogged = 0
        with c._exec_lock:
            for gid, (cts, wire) in sorted(self.pending_relog.items(),
                                           key=lambda kv: kv[1][0]):
                sub, arrays = serde.frame_from_wire(wire)
                p.wal.append(b"G", {"commit_ts": cts, "writes": sub,
                                    "gid": gid}, arrays or None)
                p._record_decision(gid, "commit", cts)
                relogged += 1
            self.pending_relog.clear()
            p.log_ddl({"op": "ha_generation",
                       "generation": int(generation)})
            c.node_generation = int(generation)
            self.relog_closed = True
        c.ha_stats["promotions"] = c.ha_stats.get("promotions", 0) + 1
        c.read_only = False
        self.promoted = True
        # announce the topology to the GTM again, under the promoted
        # role (register_gtm.c's re-registration after a promotion)
        c._gtm_register_all()
        log.warning("standby promoted to read-write primary (applied %d, "
                    "generation %d, re-logged 2PC %d, torn tail %d bytes)",
                    self.applied, int(generation), relogged, torn)
        return c

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            shutdown_and_close(self._sock)

    def close(self) -> None:
        """Stop the stream, wait for the receiver, close the WAL."""
        self.stop()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.cluster.close()


def probe_timeline(host: str, port: int, timeout: float = 10.0):
    """(generation, promote_lsn) of the walsender at host:port: the
    probe handshake, header only, no stream."""
    # failpoint: the rejoin's first contact with the new primary
    FAULT("repl/probe", host=host, port=port)
    NET_CHECK(host, port, timeout_s=timeout)
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.sendall(pack_repl_hello(REPL_PROBE, 0))
        return recv_repl_hello(sock)
    finally:
        shutdown_and_close(sock)


def local_generation(wal_path: str) -> int:
    """The highest ha_generation recorded in a WAL file (0 without
    one), from the record headers alone."""
    gen = 0
    try:
        for tag, header, _a, _off in WAL.read_records(
                wal_path, decode_arrays=False):
            if tag == "D" and header.get("op") == "ha_generation":
                gen = max(gen, int(header.get("generation", 0)))
    except OSError:
        pass
    return gen


def rejoin_standby(data_dir: str, host: str, port: int,
                   num_datanodes: int = 2, shard_groups: int = 256,
                   device=None) -> StandbyCluster:
    """The pg_rewind analog: a demoted ex-primary's data directory
    follows the new primary's walsender at host:port, as a read-only
    standby on ``device`` (cuda:0 unless the caller passes another).

    A standby's WAL is a verbatim prefix of its primary's, so the new
    primary's WAL and the ex-primary's agree byte for byte up to the
    promotion point (the sender's ``promote_lsn``). What the ex-primary
    logged past it belongs to the dead timeline: commits that never
    streamed, which no client of the promoted cluster saw. They are
    truncated, the stores rebuilt from the truncated log, and the
    stream resumes from our own (now shared) offset. The standby's
    ``truncated_bytes`` says how much went."""
    gen, promote_lsn = probe_timeline(host, port)
    wal_path = os.path.join(data_dir, "wal.log")
    my_gen = local_generation(wal_path)
    if my_gen > gen:
        raise RuntimeError(
            f"refusing rejoin: local generation {my_gen} is NEWER than "
            f"the target's {gen} — the target is the stale node")
    truncated = 0
    try:
        end = WAL.scan_end(wal_path)
    except OSError:
        end = 0
    if my_gen < gen and end > promote_lsn >= 0:
        truncated = end - promote_lsn
        with open(wal_path, "r+b") as f:
            f.truncate(promote_lsn)
    # a checkpoint past the divergence point holds rows of the dead
    # timeline
    ckpt = os.path.join(data_dir, "checkpoint.json")
    if truncated and os.path.exists(ckpt):
        try:
            with open(ckpt) as f:
                if int(json.load(f).get("wal_position", 0)) > promote_lsn:
                    os.unlink(ckpt)
        except (OSError, ValueError):
            pass
    sb = StandbyCluster(data_dir, num_datanodes, shard_groups, device=device)
    sb.truncated_bytes = truncated
    try:
        sb.start_replication(host, port)
    except BaseException:
        sb.close()
        raise
    log.warning("ex-primary rejoined as standby (truncated %d bytes, "
                "generation %d, resumed from %d)", truncated, gen,
                sb.applied)
    return sb

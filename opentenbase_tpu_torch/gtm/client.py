"""Client of the native GTS server (gtm/native/gts_server.cpp), the port's
copy of the reference's opentenbase_tpu/gtm/client.py.

The backend's GTM client library (the reference's gtm.c and
gtm_client.c): it speaks the length-prefixed binary protocol documented
in the server's source, byte for byte the reference's, and duck-types
gtm/gts.py's GTSServer, so a cluster runs on either
(``Cluster(gts_backend="native")``). It talks to the C++ server, to a
GTSFrontend (gtm/server.py) and to a GTSProxy (gtm/proxy.py) alike, the
reference's as well as the port's.

``NativeGTS.spawn()`` builds the server from the port's own source with
``g++ -O2 -std=c++17`` on first use, into ``opentenbase_tpu_torch/build/
gtm/`` (git-ignored; the binary is named by the source's digest and
written under a temporary name, then renamed, so concurrent builds
never see half a file), and runs it as its own process.

Failpoints (fault/): ``gtm/client/rpc`` (with the connectivity
matrix's check) at every request, ``gtm/client/recv`` mid-reply and
``gtm/client/failover`` at the reconnect. Left out of the reference's
client: the trace envelope (OP_TRACED, OP_TRACE_FETCH) with its
capability probe and that probe's ``gtm/client/probe`` failpoint, the
wait-event and per-statement accounting, ``NativeGTS(standby=,
connect_retries=)`` and ``repoint``. A lost connection is retried on the
same endpoint, then on the standby ``set_standby`` named (``failovers``
counts the switches).
"""

from __future__ import annotations

import hashlib
import logging
import os
import socket
import struct
import subprocess
import threading
import weakref
from typing import Optional

from opentenbase_tpu_torch.fault import FAULT, NET_CHECK
from opentenbase_tpu_torch.gtm.gts import GlobalTimestamp, TxnInfo, TxnState
from opentenbase_tpu_torch.net.protocol import shutdown_and_close

log = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "native", "gts_server.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "build", "gtm")

OP_GET_GTS = 0x01
OP_BEGIN = 0x02
OP_COMMIT = 0x03
OP_ABORT = 0x04
OP_PREPARE = 0x05
OP_LIST_PREPARED = 0x06
OP_FORGET = 0x07
OP_SEQ_CREATE = 0x08
OP_SEQ_NEXT = 0x09
OP_SEQ_DROP = 0x0A
OP_SEQ_SET = 0x0B
OP_SNAPSHOT = 0x0C
OP_PING = 0x0D
# node registration (register_gtm.c): length-prefixed strings, so the
# C++ server implements the same ops without JSON
OP_NODE_REGISTER = 0x0E
OP_NODE_UNREGISTER = 0x0F
OP_NODE_LIST = 0x10
# batched commit grant (group commit): payload <H count> + count x <q
# gxid>, reply count x <q commit_ts> in request order. The C++ server
# does not know the op and answers status 1: the client then commits
# gxid by gxid for the rest of the connection (the reference's protocol)
OP_COMMIT_MANY = 0x13


def _lp(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<H", len(b)) + b


def _recv_exact_from(sock: socket.socket, n: int) -> bytes:
    # failpoint: the GTM's reply stream stalling or vanishing mid-frame
    FAULT("gtm/client/recv")
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise GTSProtocolError("connection closed")
        out += chunk
    return out


def build_server(build_dir: str = BUILD_DIR) -> str:
    """The server binary built from this package's source (compiled when
    no binary of the source's digest exists yet); returns its path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(build_dir, exist_ok=True)
    binary = os.path.join(build_dir, f"gts_server-{digest}")
    if os.path.exists(binary):
        return binary
    tmp = f"{binary}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", tmp, _SRC],
                       check=True, capture_output=True)
        os.replace(tmp, binary)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return binary


class GTSProtocolError(RuntimeError):
    pass


def _reap(proc: subprocess.Popen) -> None:
    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


class NativeGTS:
    """Socket client of a running GTS server. Thread-safe: one socket,
    each request and its reply under a lock (the reference's
    per-backend connection)."""

    def __init__(self, host: str, port: int):
        from opentenbase_tpu_torch.net.client import connect_with_retry

        self.host = host
        self.port = port
        # a GTM still binding its listener after a spawn costs a few
        # retries, not a refused connection
        self._sock = connect_with_retry(host, port, timeout=10, retries=3)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None
        self._finalizer = None
        # a local mirror of transaction state, for TxnInfo
        self._txns: dict[int, TxnInfo] = {}
        # the GTM standby (gtm_standby.c's client side): where a lost
        # connection fails over once the primary refuses; the first
        # primary is kept, so a later loss tries it first again
        self._primary: tuple = (host, port)
        self._standby: Optional[tuple] = None
        self.failovers = 0

    @property
    def pid(self) -> Optional[int]:
        """The server process's pid, when this client spawned it."""
        return self._proc.pid if self._proc is not None else None

    # -- lifecycle ---------------------------------------------------------
    @staticmethod
    def spawn(state_dir: str, port: int = 0) -> "NativeGTS":
        """Build the server if needed and run it as its own process with
        its state under ``state_dir``; returns a client connected to it.
        The server is reaped by ``close()``, or when the client is
        collected."""
        binary = build_server()
        os.makedirs(state_dir, exist_ok=True)
        if port == 0:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
        proc = subprocess.Popen(
            [binary, str(port), state_dir],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
        try:
            # wait for the READY line
            line = proc.stdout.readline().decode()
            if "GTS READY" not in line:
                raise GTSProtocolError(f"server failed to start: {line!r}")
            client = NativeGTS("127.0.0.1", port)
        except BaseException:
            proc.kill()
            proc.wait()
            raise
        client._proc = proc
        client._finalizer = weakref.finalize(client, _reap, proc)
        return client

    def close(self) -> None:
        try:
            # shutdown and close: the server drops the connection now
            shutdown_and_close(self._sock)
        finally:
            if self._proc is not None:
                _reap(self._proc)
            if self._finalizer is not None:
                self._finalizer.detach()

    def kill_server(self) -> None:
        """SIGKILL the spawned server (a crash); a respawn from its state
        directory follows (``Cluster.gts`` takes the new client)."""
        if self._proc is not None:
            self._proc.kill()
            self._proc.wait()

    # -- wire --------------------------------------------------------------
    def _rpc(self, op: int, payload: bytes = b"") -> bytes:
        msg = struct.pack("<IB", 1 + len(payload), op) + payload
        with self._lock:
            try:
                # failpoint: the request boundary every grant crosses
                FAULT("gtm/client/rpc", op=op)
                # the matrix: a cut coordinator -> GTM leg fails the
                # grant like a peer reset
                NET_CHECK(self.host, self.port, timeout_s=10)
                self._sock.sendall(msg)
                hdr = self._recv_exact(4)
                (length,) = struct.unpack("<I", hdr)
                body = self._recv_exact(length)
            except (OSError, GTSProtocolError) as e:
                # the connection lost mid-exchange: reconnect once instead
                # of failing the session (gtm.c reconnects the same way)
                body = self._reconnect_rpc(msg, e)
        status = body[0]
        if status != 0:
            # a completed exchange the server refused (an unknown op is
            # status 1): the status tells a capability probe from a
            # transport failure, which raises without one
            err = GTSProtocolError(f"op {op:#x} failed")
            err.status = status
            raise err
        return body[1:]

    def set_standby(self, host: str, port: int) -> None:
        """The standby's address, the failover target of a lost
        connection."""
        self._standby = (str(host), int(port))

    def _reconnect_rpc(self, msg: bytes, err: Exception) -> bytes:
        """Reconnect, to the current endpoint first (a fast restart),
        then the first primary and the standby, and retry the one
        request in flight. Caller holds the lock. The retried ops are
        safe to repeat: grants are fresh values, commit, abort, forget
        and prepare are idempotent per gxid, and a begin twice burns a
        number."""
        from opentenbase_tpu_torch.net.client import connect_with_retry

        # failpoint: the reconnect-and-retry ladder itself
        FAULT("gtm/client/failover")
        candidates = [(self.host, self.port)]
        for cand in (self._primary, self._standby):
            if cand is not None and cand not in candidates:
                candidates.append(cand)
        for host, port in candidates:
            try:
                sock = connect_with_retry(host, port, timeout=10, retries=1)
            except Exception as e:
                log.debug("GTM candidate %s:%s unreachable: %r", host, port,
                          e)
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                sock.sendall(msg)
                hdr = _recv_exact_from(sock, 4)
                (length,) = struct.unpack("<I", hdr)
                body = _recv_exact_from(sock, length)
            except (OSError, GTSProtocolError):
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = sock
            if (host, port) != (self.host, self.port):
                log.warning("GTM connection failed over from %s:%s to "
                            "%s:%s (%s)", self.host, self.port, host, port,
                            err)
                self.host, self.port = host, port
                self.failovers += 1
            return body
        log.error("GTM unreachable: %s", err)
        raise GTSProtocolError(f"GTM unreachable: {err}") from err

    def _recv_exact(self, n: int) -> bytes:
        return _recv_exact_from(self._sock, n)

    # -- the GTSServer surface ---------------------------------------------
    def get_gts(self) -> GlobalTimestamp:
        return struct.unpack("<q", self._rpc(OP_GET_GTS))[0]

    def snapshot_ts(self) -> GlobalTimestamp:
        return struct.unpack("<q", self._rpc(OP_SNAPSHOT))[0]

    def ping(self) -> bool:
        try:
            return self._rpc(OP_PING) == b"\x01"
        except (OSError, GTSProtocolError):
            return False

    def begin(self) -> TxnInfo:
        gxid, start_ts = struct.unpack("<qq", self._rpc(OP_BEGIN))
        info = TxnInfo(gxid, TxnState.ACTIVE, start_ts)
        self._txns[gxid] = info
        return info

    def commit(self, gxid: int) -> GlobalTimestamp:
        ts = struct.unpack(
            "<q", self._rpc(OP_COMMIT, struct.pack("<q", gxid))
        )[0]
        info = self._txns.get(gxid)
        if info is not None:
            info.state = TxnState.COMMITTED
            info.commit_ts = ts
        return ts

    # OP_COMMIT_MANY: None = not asked yet, False = the server answered
    # status 1 once (the C++ server): commit gxid by gxid from then on
    _commit_many_capable: Optional[bool] = None

    def commit_many(self, gxids) -> dict:
        """One round trip stamps every queued committer. Against a server
        without the op it commits gxid by gxid, and a failed grant maps
        to an Exception value for its own gxid (the batcher raises it in
        the session that owns it) instead of failing the batch."""
        gxids = list(gxids)
        if not gxids:
            return {}
        if self._commit_many_capable is not False and len(gxids) > 1:
            payload = struct.pack("<H", len(gxids)) + b"".join(
                struct.pack("<q", g) for g in gxids)
            try:
                body = self._rpc(OP_COMMIT_MANY, payload)
            except GTSProtocolError as e:
                if getattr(e, "status", None) is None:
                    # a transport failure, not the server's answer: the
                    # lost batch may have been stamped, so committing
                    # again could give a gxid two timestamps
                    raise
                self._commit_many_capable = False
            else:
                self._commit_many_capable = True
                tss = struct.unpack(f"<{len(gxids)}q", body)
                for gxid, ts in zip(gxids, tss):
                    info = self._txns.get(gxid)
                    if info is not None:
                        info.state = TxnState.COMMITTED
                        info.commit_ts = ts
                return dict(zip(gxids, tss))
        out: dict = {}
        for g in gxids:
            try:
                out[g] = self.commit(g)
            except Exception as e:
                log.warning("commit grant of gxid %d failed: %s", g, e)
                out[g] = e
        return out

    def abort(self, gxid: int) -> None:
        self._rpc(OP_ABORT, struct.pack("<q", gxid))
        info = self._txns.get(gxid)
        if info is not None:
            info.state = TxnState.ABORTED

    def prepare(self, gxid: int, gid: str, partnodes: tuple[int, ...]) -> None:
        g = gid.encode()
        payload = struct.pack("<qH", gxid, len(g)) + g
        payload += struct.pack("<H", len(partnodes))
        for n in partnodes:
            payload += struct.pack("<i", n)
        self._rpc(OP_PREPARE, payload)
        info = self._txns.get(gxid)
        if info is not None:
            info.state = TxnState.PREPARED
            info.gid = gid
            info.partnodes = tuple(partnodes)

    def prepared_txns(self) -> list[TxnInfo]:
        body = self._rpc(OP_LIST_PREPARED)
        (n,) = struct.unpack_from("<H", body, 0)
        off = 2
        out = []
        for _ in range(n):
            (gxid,) = struct.unpack_from("<q", body, off)
            off += 8
            (gl,) = struct.unpack_from("<H", body, off)
            off += 2
            gid = body[off : off + gl].decode()
            off += gl
            (m,) = struct.unpack_from("<H", body, off)
            off += 2
            nodes = struct.unpack_from(f"<{m}i", body, off) if m else ()
            off += 4 * m
            out.append(
                TxnInfo(gxid, TxnState.PREPARED, 0, None, gid, tuple(nodes))
            )
        return out

    def forget(self, gxid: int) -> None:
        self._rpc(OP_FORGET, struct.pack("<q", gxid))
        self._txns.pop(gxid, None)

    def txn(self, gxid: int) -> Optional[TxnInfo]:
        return self._txns.get(gxid)

    # -- node registration -------------------------------------------------
    def register_node(
        self, name: str, kind: str, host: str = "", port: int = 0,
    ) -> None:
        self._rpc(
            OP_NODE_REGISTER,
            _lp(name) + _lp(kind) + _lp(host) + struct.pack("<i", int(port)),
        )

    def unregister_node(self, name: str) -> bool:
        return self._rpc(OP_NODE_UNREGISTER, _lp(name)) == b"\x01"

    def registered_nodes(self) -> dict:
        body = self._rpc(OP_NODE_LIST)
        (n,) = struct.unpack_from("<H", body, 0)
        off = 2
        out = {}
        for _ in range(n):
            rec = []
            for _f in range(3):
                (ln,) = struct.unpack_from("<H", body, off)
                off += 2
                rec.append(body[off:off + ln].decode())
                off += ln
            (port,) = struct.unpack_from("<i", body, off)
            off += 4
            out[rec[0]] = {
                "kind": rec[1], "host": rec[2], "port": port,
                "status": "connected",
            }
        return out

    # -- sequences ---------------------------------------------------------
    def create_sequence(self, name: str, start: int = 1, increment: int = 1,
                        min_value: int = 1, max_value: int = 2**62,
                        cycle: bool = False) -> None:
        nm = name.encode()
        try:
            self._rpc(
                OP_SEQ_CREATE,
                struct.pack("<H", len(nm)) + nm
                + struct.pack("<qq", start, increment),
            )
        except GTSProtocolError:
            raise ValueError(f"sequence {name!r} already exists")

    def drop_sequence(self, name: str) -> None:
        nm = name.encode()
        self._rpc(OP_SEQ_DROP, struct.pack("<H", len(nm)) + nm)

    def nextval(self, name: str, cache: int = 1) -> tuple[int, int]:
        nm = name.encode()
        try:
            body = self._rpc(
                OP_SEQ_NEXT,
                struct.pack("<H", len(nm)) + nm + struct.pack("<q", cache),
            )
        except GTSProtocolError:
            raise KeyError(f"sequence {name!r} does not exist")
        return struct.unpack("<qq", body)

    def setval(self, name: str, value: int) -> None:
        nm = name.encode()
        try:
            self._rpc(
                OP_SEQ_SET,
                struct.pack("<H", len(nm)) + nm + struct.pack("<q", value),
            )
        except GTSProtocolError:
            raise KeyError(f"sequence {name!r} does not exist")

"""TCP front end for a GTSServer, the port's copy of the reference's
opentenbase_tpu/gtm/server.py.

It speaks the wire protocol of gtm/native/gts_server.cpp (opcodes in
gtm/client.py), so ``NativeGTS`` connects to either implementation: the
C++ server for a standalone GTM, this wrapper to serve an in-process
GTSServer (a just-promoted standby, say) to remote backends, as the
reference's one gtm binary serves as primary, standby or proxy.
Failpoints (fault/): ``gtm/frontend/accept``, ``gtm/server/serve``
between frames, ``gtm/server/recv`` mid-frame and ``gtm/grant`` in
every verb's dispatch. Left out of the reference's module: the trace
envelope.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Optional

from opentenbase_tpu_torch.fault import FAULT

from opentenbase_tpu_torch.gtm import client as C
from opentenbase_tpu_torch.gtm.gts import GTSServer
from opentenbase_tpu_torch.net.protocol import shutdown_and_close

log = logging.getLogger(__name__)


class GTSFrontend:
    """Thread-per-connection TCP server over a GTSServer (GTM_ThreadMain,
    src/gtm/main/main.c:3383)."""

    def __init__(self, gts: GTSServer, host: str = "127.0.0.1", port: int = 0):
        self.gts = gts
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(64)
        self.host, self.port = self._lsock.getsockname()
        self._accept: Optional[threading.Thread] = None
        # live backend sockets: the accept thread adds while stop()
        # sweeps, and _stopping closes the window where a connection
        # accepted just before stop() would miss the sweep
        self._conns: set = set()
        self._conns_mu = threading.Lock()
        self._stopping = False

    def start(self) -> "GTSFrontend":
        self._accept = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept.start()
        return self

    def stop(self) -> None:
        """Stop serving and sever live backends: a stopped GTM must look
        dead to its clients (their next RPC fails over), not keep
        answering on half-open sockets."""
        log.warning("GTM front end stopping on %s:%s", self.host, self.port)
        self._stopping = True
        shutdown_and_close(self._lsock)
        with self._conns_mu:
            conns = list(self._conns)
        for conn in conns:
            shutdown_and_close(conn)

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            try:
                # a try of its own: an injected drop severs one backend,
                # never the front end's accept thread
                FAULT("gtm/frontend/accept")
            except Exception as e:
                log.warning("backend attach refused: %r", e)
                shutdown_and_close(conn)
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_mu:
                self._conns.add(conn)
            if self._stopping:
                # stop() may have swept before the add
                shutdown_and_close(conn)
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    # -- one backend connection ------------------------------------------
    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                # failpoint: a backend severed between frames
                FAULT("gtm/server/serve")
                head = self._recv_exact(conn, 4)
                if head is None:
                    return
                (length,) = struct.unpack("<I", head)
                body = self._recv_exact(conn, length)
                if body is None:
                    return
                op, payload = body[0], body[1:]
                try:
                    out = self._dispatch(op, payload)
                except ConnectionError:
                    return  # the backend went away: no reply
                except Exception:
                    # the wire's error frame, the C++ server's contract
                    conn.sendall(struct.pack("<I", 1) + b"\x01")
                    continue
                conn.sendall(struct.pack("<I", 1 + len(out)) + b"\x00" + out)
        except OSError:
            return
        finally:
            with self._conns_mu:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, op: int, p: bytes) -> bytes:
        # failpoint: every GTM verb. error is a failed grant (the
        # backend sees a protocol error and may fail over); delay a slow
        # GTM; drop_conn tears this backend's connection
        FAULT("gtm/grant", op=op)
        g = self.gts
        if op in (C.OP_GET_GTS, C.OP_SNAPSHOT):
            fn = g.get_gts if op == C.OP_GET_GTS else g.snapshot_ts
            return struct.pack("<q", fn())
        if op == C.OP_PING:
            return b"\x01"
        if op == C.OP_BEGIN:
            info = g.begin()
            return struct.pack("<qq", info.gxid, info.start_ts)
        if op == C.OP_COMMIT:
            (gxid,) = struct.unpack_from("<q", p, 0)
            return struct.pack("<q", g.commit(gxid))
        if op == C.OP_COMMIT_MANY:
            (m,) = struct.unpack_from("<H", p, 0)
            gxids = struct.unpack_from(f"<{m}q", p, 2) if m else ()
            tsmap = g.commit_many(gxids)
            return b"".join(struct.pack("<q", tsmap[gx]) for gx in gxids)
        if op == C.OP_ABORT:
            (gxid,) = struct.unpack_from("<q", p, 0)
            g.abort(gxid)
            return b""
        if op == C.OP_FORGET:
            (gxid,) = struct.unpack_from("<q", p, 0)
            g.forget(gxid)
            return b""
        if op == C.OP_PREPARE:
            (gxid,) = struct.unpack_from("<q", p, 0)
            off = 8
            (gl,) = struct.unpack_from("<H", p, off)
            off += 2
            gid = p[off : off + gl].decode()
            off += gl
            (m,) = struct.unpack_from("<H", p, off)
            off += 2
            nodes = struct.unpack_from(f"<{m}i", p, off) if m else ()
            g.prepare(gxid, gid, tuple(nodes))
            return b""
        if op == C.OP_LIST_PREPARED:
            txns = g.prepared_txns()
            out = struct.pack("<H", len(txns))
            for t in txns:
                gid = (t.gid or "").encode()
                out += struct.pack("<q", t.gxid)
                out += struct.pack("<H", len(gid)) + gid
                out += struct.pack("<H", len(t.partnodes))
                for n in t.partnodes:
                    out += struct.pack("<i", n)
            return out
        if op == C.OP_SEQ_CREATE:
            (nl,) = struct.unpack_from("<H", p, 0)
            name = p[2 : 2 + nl].decode()
            start, inc = struct.unpack_from("<qq", p, 2 + nl)
            g.create_sequence(name, start, inc)
            return b""
        if op == C.OP_SEQ_NEXT:
            (nl,) = struct.unpack_from("<H", p, 0)
            name = p[2 : 2 + nl].decode()
            (cache,) = struct.unpack_from("<q", p, 2 + nl)
            first, last = g.nextval(name, cache)
            return struct.pack("<qq", first, last)
        if op == C.OP_SEQ_DROP:
            (nl,) = struct.unpack_from("<H", p, 0)
            g.drop_sequence(p[2 : 2 + nl].decode())
            return b""
        if op == C.OP_SEQ_SET:
            (nl,) = struct.unpack_from("<H", p, 0)
            name = p[2 : 2 + nl].decode()
            (value,) = struct.unpack_from("<q", p, 2 + nl)
            g.setval(name, value)
            return b""
        if op == C.OP_NODE_REGISTER:
            off = 0
            rec = []
            for _f in range(3):
                (ln,) = struct.unpack_from("<H", p, off)
                off += 2
                rec.append(p[off:off + ln].decode())
                off += ln
            (port,) = struct.unpack_from("<i", p, off)
            if not rec[0]:
                raise ValueError("empty node name")  # the C++ server's rule
            g.register_node(rec[0], rec[1], rec[2], port)
            return b""
        if op == C.OP_NODE_UNREGISTER:
            (nl,) = struct.unpack_from("<H", p, 0)
            name = p[2:2 + nl].decode()
            return b"\x01" if g.unregister_node(name) else b"\x00"
        if op == C.OP_NODE_LIST:
            nodes = g.registered_nodes()
            out = struct.pack("<H", len(nodes))
            for name, d in sorted(nodes.items()):
                for s in (name, d.get("kind", ""), d.get("host", "")):
                    b = s.encode()
                    out += struct.pack("<H", len(b)) + b
                out += struct.pack("<i", int(d.get("port", 0)))
            return out
        raise ValueError(f"unknown op {op:#x}")

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        # failpoint: a backend vanishing mid-frame
        FAULT("gtm/server/recv")
        out = b""
        while len(out) < n:
            chunk = conn.recv(n - len(out))
            if not chunk:
                return None
            out += chunk
        return out

"""GTM proxy, the connection concentrator (src/gtm/proxy/proxy_main.c):
the port's copy of the reference's opentenbase_tpu/gtm/proxy.py.

Thousands of backends each holding a GTM connection is the bottleneck
the reference's proxy exists for: backends connect to a local proxy,
which funnels every request over one upstream connection. This proxy
speaks the native GTS wire protocol on both sides (``NativeGTS`` clients
and the C++ or Python GTM servers are oblivious to it) and keeps per-op
counters (gtm_stat.c). Failpoints (fault/): ``gtm/proxy/accept``,
``gtm/proxy/serve`` per request, ``gtm/proxy/recv`` per frame read and
``gtm/proxy_upstream`` at the shared upstream exchange.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from collections import Counter
from typing import Optional

from opentenbase_tpu_torch.fault import FAULT
from opentenbase_tpu_torch.gtm.client import NativeGTS
from opentenbase_tpu_torch.net.protocol import shutdown_and_close

log = logging.getLogger(__name__)


class GTSProxy:
    def __init__(self, upstream_host: str, upstream_port: int,
                 host: str = "127.0.0.1", port: int = 0):
        self.upstream_host, self.upstream_port = upstream_host, upstream_port
        # one upstream connection for every frontend (NativeGTS
        # serializes request and reply under its lock: the concentration)
        self.upstream = NativeGTS(upstream_host, upstream_port)
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(128)
        self.host, self.port = self._lsock.getsockname()
        self.stats: Counter = Counter()
        # guards the frontend count and the stats: every frontend runs
        # its own _serve thread
        self._fr_mu = threading.Lock()
        self.frontends = 0
        self._stop = threading.Event()
        self._accept: Optional[threading.Thread] = None

    def start(self) -> "GTSProxy":
        self._accept = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        shutdown_and_close(self._lsock)
        self.upstream.close()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            try:
                # a try of its own: drop_conn is an OSError the accept's
                # handler would read as a closed listener
                FAULT("gtm/proxy/accept")
            except Exception as e:
                log.warning("proxy frontend attach refused: %r", e)
                shutdown_and_close(conn)
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        with self._fr_mu:
            self.frontends += 1
        try:
            while not self._stop.is_set():
                # failpoint: one frontend's request loop (error and
                # drop_conn sever this frontend; delay a slow hop)
                FAULT("gtm/proxy/serve")
                head = _recv_exact(conn, 4)
                if head is None:
                    return
                (length,) = struct.unpack("<I", head)
                if length == 0:  # a malformed frame: drop the client
                    return
                body = _recv_exact(conn, length)
                if body is None:
                    return
                with self._fr_mu:
                    self.stats[body[0]] += 1
                reply = self._exchange(head + body)
                if reply is None:
                    return  # the upstream failed mid-exchange
                conn.sendall(reply)
        except (OSError, RuntimeError):
            return
        finally:
            with self._fr_mu:
                self.frontends -= 1
            try:
                conn.close()
            except OSError:
                pass

    def _exchange(self, frame: bytes) -> Optional[bytes]:
        """One request and its reply over the shared upstream socket. A
        failed exchange leaves the stream's framing unknown, so the
        connection is replaced before another frontend could read a
        stale reply as its own, and this request is not retried (BEGIN
        is not idempotent)."""
        with self.upstream._lock:
            try:
                # failpoint: the one upstream socket (drop_conn drives
                # the connection's replacement below)
                FAULT("gtm/proxy_upstream")
                self.upstream._sock.sendall(frame)
                rhead = self.upstream._recv_exact(4)
                (rlen,) = struct.unpack("<I", rhead)
                rbody = self.upstream._recv_exact(rlen)
                return rhead + rbody
            except (OSError, RuntimeError):
                try:
                    self.upstream._sock.close()
                except OSError:
                    pass
                try:
                    self.upstream._sock = socket.create_connection(
                        (self.upstream_host, self.upstream_port), timeout=10
                    )
                    self.upstream._sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                except OSError:
                    pass  # the next exchange fails fast and retries anew
                return None


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    out = b""
    while len(out) < n:
        try:
            # failpoint: a torn frontend frame (drop_conn is an OSError)
            FAULT("gtm/proxy/recv")
            chunk = sock.recv(n - len(out))
        except OSError:
            return None
        if not chunk:
            return None
        out += chunk
    return out

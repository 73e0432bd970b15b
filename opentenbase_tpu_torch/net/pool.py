"""Connection pool for coordinator -> datanode channels (the reference's
opentenbase_tpu/net/pool.py).

The reference runs a pooler process handing pooled libpq connections to
backends (PoolManagerGetConnections, src/backend/pgxc/pool/poolmgr.c).
Here the pool is an in-process object with the same contract: acquire a
warm framed-RPC channel to a datanode (opening lazily up to ``size``),
release it back, discard broken ones, and answer pooler-stat queries.
A peer that refuses a caller's stale fencing generation raises
``ChannelFenced`` (SQLSTATE 72000), never a retryable ``ChannelError``.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

from opentenbase_tpu_torch.fault import FAULT, NET_CHECK
from opentenbase_tpu_torch.net.protocol import (
    encode_frame,
    recv_frame_sized,
    shutdown_and_close,
)


class ChannelError(RuntimeError):
    """A channel failed (I/O, a peer that closed, or an error frame)."""


class ChannelFenced(ChannelError):
    """The peer refused the op because the caller's node_generation is
    stale: the caller is an ex-primary that missed a promotion. Not a
    transient failure: the only reaction is to demote (SQLSTATE
    72000); a retry or a failover to the caller's own stores would
    serve the stale data the fence refuses."""

    sqlstate = "72000"

    def __init__(self, msg: str, peer_generation=None):
        super().__init__(msg)
        self.peer_generation = peer_generation


class Channel:
    """One persistent framed connection (a pooled libpq slot)."""

    def __init__(
        self, host: str, port: int, timeout: float = 30.0,
        connect_retries: int = 3,
    ):
        from opentenbase_tpu_torch.net.client import connect_with_retry

        self.host, self.port = host, port
        self.sock = connect_with_retry(
            host, port, timeout=timeout, retries=connect_retries
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._timeout = timeout
        self.broken = False

    def rpc(self, msg: dict, timeout_s: Optional[float] = None) -> dict:
        """One request/response. ``timeout_s`` overrides the socket
        deadline for this call; a cut call marks the channel broken so
        the pool discards it.

        The request is encoded before any byte touches the wire (an
        unencodable or oversized message fails with the channel still
        usable). Once the send starts, any failure marks the channel
        broken: a request with no response consumed leaves the stream
        desynced. The response carries ``_wire``: [bytes sent, bytes
        received] of this call."""
        frame = encode_frame(msg)  # may raise: channel untouched
        try:
            if timeout_s is not None:
                self.sock.settimeout(timeout_s)
            FAULT("net/pool/rpc_send", op=msg.get("op"))
            # the matrix: an established channel on a cut link fails
            # here like a peer reset (broken, so the pool discards it)
            NET_CHECK(self.host, self.port,
                      timeout_s=(timeout_s if timeout_s is not None
                                 else self._timeout))
            self.sock.sendall(frame)
            FAULT("net/pool/rpc_recv", op=msg.get("op"))
            resp, nrecv = recv_frame_sized(self.sock)
        except OSError as e:
            self.broken = True
            raise ChannelError(f"channel I/O failed: {e}") from e
        except BaseException:
            self.broken = True  # desynced: request in flight, no reply
            raise
        finally:
            if timeout_s is not None and not self.broken:
                self.sock.settimeout(self._timeout)
        if resp is None:
            self.broken = True
            raise ChannelError("channel closed by peer")
        if "error" in resp:
            if resp.get("fenced"):
                raise ChannelFenced(resp["error"],
                                    peer_generation=resp.get("gen"))
            raise ChannelError(resp["error"])
        resp["_wire"] = [len(frame), nrecv]
        return resp

    def close(self) -> None:
        # shutdown first: the DN-side thread blocked in recv on this
        # channel wakes now instead of sleeping out its timeout
        shutdown_and_close(self.sock)


class ChannelPool:
    """Bounded pool of channels to ONE datanode."""

    def __init__(
        self, host: str, port: int, size: int = 4,
        rpc_timeout: float = 120.0,
    ):
        self.host, self.port, self.size = host, port, size
        self.rpc_timeout = rpc_timeout
        self._idle: list[Channel] = []
        self._lock = threading.Lock()
        self._total = 0
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self.stats = {"acquired": 0, "opened": 0, "discarded": 0}

    def acquire(self, timeout: float = 30.0) -> Channel:
        with self._cv:
            while True:
                if self._closed:
                    raise ChannelError("pool closed")
                if self._idle:
                    ch = self._idle.pop()
                    self.stats["acquired"] += 1
                    return ch
                if self._total < self.size:
                    self._total += 1
                    break
                if not self._cv.wait(timeout):
                    raise ChannelError("pool exhausted")
        try:
            ch = Channel(self.host, self.port, timeout=self.rpc_timeout)
        except Exception as e:
            # the reserved slot goes back, or the pool leaks capacity
            with self._cv:
                self._total -= 1
                self._cv.notify()
            raise ChannelError(f"connect failed: {e}") from e
        with self._cv:
            self.stats["opened"] += 1
            self.stats["acquired"] += 1
        return ch

    def release(self, ch: Channel) -> None:
        with self._cv:
            if ch.broken or self._closed:
                self._total -= 1
                self.stats["discarded"] += 1
                ch.close()
            else:
                self._idle.append(ch)
            self._cv.notify()

    def rpc(self, msg: dict, timeout_s: Optional[float] = None) -> dict:
        """Acquire -> call -> release."""
        ch = self.acquire()
        try:
            return ch.rpc(msg, timeout_s=timeout_s)
        finally:
            self.release(ch)

    def occupancy(self) -> dict:
        """{'size', 'in_use', 'idle'} under the pool lock."""
        with self._lock:
            idle = len(self._idle)
            return {
                "size": self.size,
                "in_use": max(self._total - idle, 0),
                "idle": idle,
            }

    def close(self) -> None:
        """Close idle channels and refuse new acquires; channels in
        flight close as they are released."""
        with self._cv:
            self._closed = True
            for ch in self._idle:
                ch.close()
            self._total -= len(self._idle)
            self._idle.clear()
            self._cv.notify_all()

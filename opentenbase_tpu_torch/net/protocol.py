"""Framing for the coordinator wire protocol and the replication
handshake (the reference's opentenbase_tpu/net/protocol.py, byte for
byte).

Frame := u32 length | payload (UTF-8 JSON object):

  request:  {"q": "<sql>"}                      simple query
            {"op": "auth", ...}, {"op": "proof", ...}   SCRAM (auth.py)
            {"op": "close"}                     terminate session
  response: {"tag": str, "columns": [..], "rows": [[..]], "rowcount": int,
             "wal_pos": int}
            {"error": str, "sqlstate": str}
            {"ok": true}                        for op messages

Decimal, date and timestamp values travel as tagged objects
({"$dec": ...}, {"$d": ...}, {"$ts": ...}) and are revived on receipt.
A frame whose payload the u32 cannot describe raises ``FrameTooLarge``
before any byte is sent. The same frames carry the datanode RPCs
(dn/server.py) and the coordinator's channels to them (pool.py).

Replication (storage/replication.py): the walreceiver opens with 16
bytes (its start offset, its fencing generation), the walsender answers
16 (its generation, its timeline base) before any WAL byte; then the
receiver reports its applied offset as 8-byte acks on the same socket.
"""

from __future__ import annotations

import datetime
import decimal
import json
import socket
import struct

from opentenbase_tpu_torch.errors import FrameTooLarge
from opentenbase_tpu_torch.fault import FAULT

MAX_FRAME_PAYLOAD = 2**32 - 1


def _default(o):
    if isinstance(o, decimal.Decimal):
        return {"$dec": str(o)}
    if isinstance(o, datetime.datetime):
        return {"$ts": o.isoformat()}
    if isinstance(o, datetime.date):
        return {"$d": o.isoformat()}
    raise TypeError(f"unserializable {type(o)}")


def _revive(o):
    if isinstance(o, dict) and len(o) == 1:
        if "$dec" in o:
            return decimal.Decimal(o["$dec"])
        if "$ts" in o:
            return datetime.datetime.fromisoformat(o["$ts"])
        if "$d" in o:
            return datetime.date.fromisoformat(o["$d"])
    return o


def _revive_tree(x):
    if isinstance(x, list):
        return [_revive_tree(v) for v in x]
    if isinstance(x, dict):
        r = _revive(x)
        if r is not x:
            return r
        return {k: _revive_tree(v) for k, v in x.items()}
    return x


def shutdown_and_close(sock: socket.socket) -> None:
    """Teardown that wakes a thread blocked in accept()/recv() on this
    socket (close() alone does not)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


# -- streaming-replication handshake --------------------------------
REPL_PROBE = -1
_REPL_HELLO = "<qq"
REPL_HELLO_LEN = struct.calcsize(_REPL_HELLO)
_REPL_ACK = "<q"
REPL_ACK_LEN = struct.calcsize(_REPL_ACK)


def pack_repl_hello(a: int, b: int) -> bytes:
    return struct.pack(_REPL_HELLO, a, b)


def recv_repl_hello(sock: socket.socket) -> tuple[int, int]:
    """One complete hello; ConnectionError when the peer closes
    mid-handshake."""
    data = _recv_exact(sock, REPL_HELLO_LEN)
    if data is None:
        raise ConnectionError("peer closed during replication handshake")
    return struct.unpack(_REPL_HELLO, data)


def pack_repl_ack(offset: int) -> bytes:
    return struct.pack(_REPL_ACK, offset)


def recv_repl_ack(sock: socket.socket) -> int:
    """One ack frame (the receiver's applied offset); ConnectionError on
    peer close."""
    data = _recv_exact(sock, REPL_ACK_LEN)
    if data is None:
        raise ConnectionError("peer closed the replication ack channel")
    return struct.unpack(_REPL_ACK, data)[0]


def encode_frame(obj: dict) -> bytes:
    """A frame's bytes, built before any byte touches a socket: a value
    that cannot be encoded, or a payload past the u32 length
    (``FrameTooLarge``), leaves the connection clean."""
    data = json.dumps(obj, default=_default).encode()
    if len(data) > MAX_FRAME_PAYLOAD:
        raise FrameTooLarge(
            f"wire frame of {len(data)} bytes exceeds the "
            f"{MAX_FRAME_PAYLOAD}-byte frame limit (u32 length)"
        )
    return struct.pack("<I", len(data)) + data


def send_frame(sock: socket.socket, obj: dict) -> None:
    # failpoint at the shared frame-send boundary: every JSON-wire peer
    # (sessions, datanode replies, the GTM) crosses it
    FAULT("net/protocol/send")
    sock.sendall(encode_frame(obj))


def recv_frame(sock: socket.socket) -> dict | None:
    return recv_frame_sized(sock)[0]


def recv_frame_sized(sock: socket.socket) -> tuple[dict | None, int]:
    """(the next frame, its bytes on the wire); (None, 0) at a close."""
    head = _recv_exact(sock, 4)
    if head is None:
        return None, 0
    (length,) = struct.unpack("<I", head)
    body = _recv_exact(sock, length)
    if body is None:
        return None, 0
    return _revive_tree(json.loads(body.decode())), 4 + length


def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:
    """``n`` bytes into one preallocated buffer (a large frame arrives
    in many reads: appending them would copy quadratically)."""
    # failpoint: a peer stalling or vanishing mid-frame (torn reads)
    FAULT("net/protocol/recv")
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf

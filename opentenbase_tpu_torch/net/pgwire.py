"""PostgreSQL wire protocol (v3) front end (the reference's
opentenbase_tpu/net/pgwire.py, serving the port's sessions).

The reference speaks the FE/BE protocol from src/backend/libpq +
src/backend/tcop/postgres.c (message grammar in
src/interfaces/libpq/fe-protocol3.c); every PG client library — psql,
libpq, JDBC, psycopg — talks this byte format. The JSON-framed
coordinator wire (net/server.py) stays the internal fast path; this
front end closes the client-surface gap (VERDICT r4 missing-5) by
serving the same sessions over the standard protocol:

- StartupMessage / SSLRequest ('N' refusal) / CancelRequest
- trust auth when no roles exist, RFC 5802 SCRAM-SHA-256 (SASL
  AuthenticationSASL/Continue/Final, the scram-common.c construction
  over the SAME stored verifiers as the JSON wire) otherwise
- simple query 'Q' -> RowDescription/DataRow/CommandComplete/
  ReadyForQuery with transaction status
- extended protocol: Parse/Bind/Describe/Execute/Close/Sync over the
  engine's $n Params (_subst_params is the Bind step)
- text-format results with PG type OIDs inferred per column

Known simplification: Describe on a portal answers NoData (column
metadata arrives with the Execute's RowDescription); binary format
codes are rejected. Statements run under the same statement-lock
classes as the JSON wire (net/server.py ``classify``).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import secrets
import socket
import struct
import threading
from typing import Optional

from opentenbase_tpu_torch.fault import FAULT
from opentenbase_tpu_torch.net import auth as sa
from opentenbase_tpu_torch.net.protocol import shutdown_and_close
from opentenbase_tpu_torch.net.server import (
    rollback_on_disconnect,
    run_classified,
)
from opentenbase_tpu_torch.sql import parse

_PROTO_V3 = 196608
_SSL_REQUEST = 80877103
_CANCEL_REQUEST = 80877102
_GSSENC_REQUEST = 80877104

# PG type OIDs (pg_type.h)
_OID_BOOL, _OID_INT8, _OID_INT4 = 16, 20, 23
_OID_TEXT, _OID_FLOAT4, _OID_FLOAT8 = 25, 700, 701
_OID_NUMERIC, _OID_DATE, _OID_TIMESTAMP = 1700, 1082, 1114


def _infer_oid(values) -> int:
    import datetime
    import decimal

    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return _OID_BOOL
        if isinstance(v, int):
            return _OID_INT8
        if isinstance(v, float):
            return _OID_FLOAT8
        if isinstance(v, decimal.Decimal):
            return _OID_NUMERIC
        if isinstance(v, datetime.datetime):
            return _OID_TIMESTAMP
        if isinstance(v, datetime.date):
            return _OID_DATE
        return _OID_TEXT
    return _OID_TEXT


def _text_value(v) -> Optional[bytes]:
    if v is None:
        return None
    if isinstance(v, bool):
        return b"t" if v else b"f"
    if isinstance(v, float):
        return repr(v).encode()
    return str(v).encode()


def _command_tag(res) -> str:
    cmd = res.command
    if cmd == "SELECT":
        return f"SELECT {res.rowcount}"
    if cmd == "INSERT":
        return f"INSERT 0 {res.rowcount}"
    if cmd in ("UPDATE", "DELETE", "COPY", "MOVE"):
        return f"{cmd} {res.rowcount}"
    return cmd


# -- SCRAM-SHA-256 server core (RFC 5802), in two pure steps

def scram_server_first(cluster, user: str, client_first: str) -> tuple:
    """(state, server_first_text) from the SASLInitialResponse payload.
    Unknown users get a mock verifier (auth.c's mock authentication) so
    the flow never leaks which roles exist."""
    bare = client_first.split(",", 2)[2]
    fields = dict(
        f.split("=", 1) for f in bare.split(",") if "=" in f
    )
    cnonce = fields.get("r", "")
    verifier = cluster.users.get(user)
    real = verifier is not None
    if verifier is None:
        verifier = {  # mock: all-zero keys can never validate
            "salt": secrets.token_bytes(16).hex(),
            "iterations": sa.ITERATIONS,
            "stored_key": "00" * 32,
            "server_key": "00" * 32,
        }
    nonce = cnonce + secrets.token_hex(12)
    salt_b64 = base64.b64encode(
        bytes.fromhex(verifier["salt"])
    ).decode()
    server_first = (
        f"r={nonce},s={salt_b64},i={verifier['iterations']}"
    )
    return {
        "bare": bare, "verifier": verifier, "real": real,
        "nonce": nonce, "server_first": server_first,
    }, server_first


def scram_verify_final(state: dict, client_final: str) -> tuple:
    """(ok, b"v="+server_signature) from the final SASLResponse. The
    check is uniform for real and unknown users (no timing tell)."""
    verifier = state["verifier"]
    ffields = dict(
        f.split("=", 1) for f in client_final.split(",") if "=" in f
    )
    proof_b64 = ffields.pop("p", "")
    without_proof = client_final.rsplit(",p=", 1)[0]
    auth_msg = (
        f"{state['bare']},{state['server_first']},{without_proof}"
    ).encode()
    try:
        proof = base64.b64decode(proof_b64)
        stored_key = bytes.fromhex(verifier["stored_key"])
        client_sig = hmac.new(
            stored_key, auth_msg, hashlib.sha256
        ).digest()
        client_key = bytes(a ^ b for a, b in zip(proof, client_sig))
        ok = (
            ffields.get("r") == state["nonce"]
            and state["real"]
            and hmac.compare_digest(
                hashlib.sha256(client_key).digest(), stored_key
            )
        )
    except (ValueError, KeyError):
        # malformed base64/hex from the client is a failed proof, not
        # a server error (binascii.Error subclasses ValueError)
        ok = False
    server_sig = hmac.new(
        bytes.fromhex(verifier["server_key"]), auth_msg, hashlib.sha256
    ).digest()
    return ok, b"v=" + base64.b64encode(server_sig)


def emit_result(conn: "_Conn", res) -> None:
    """RowDescription + DataRows + CommandComplete for one result."""
    if res.columns:
        ncols = len(res.columns)
        oids = [
            _infer_oid([r[i] for r in res.rows[:50]])
            for i in range(ncols)
        ]
        conn.row_description(res.columns, oids)
        for row in res.rows:
            conn.data_row(row)
    conn.command_complete(_command_tag(res))


class _Conn:
    """One backend connection: framing + message builders."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._out = bytearray()

    # -- receive ---------------------------------------------------------
    def _read_exact(self, n: int) -> bytes:
        # failpoint: a v3 client vanishing or stalling mid-message
        FAULT("net/pgwire/recv")
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client disconnected")
            buf += chunk
        return buf

    def read_startup(self):
        (ln,) = struct.unpack("!I", self._read_exact(4))
        body = self._read_exact(ln - 4)
        (code,) = struct.unpack("!I", body[:4])
        params = {}
        if code == _PROTO_V3:
            parts = body[4:].split(b"\0")
            for k, v in zip(parts[::2], parts[1::2]):
                if k:
                    params[k.decode()] = v.decode()
        return code, params

    def read_message(self):
        tag = self._read_exact(1)
        (ln,) = struct.unpack("!I", self._read_exact(4))
        return tag, self._read_exact(ln - 4)

    # -- send ------------------------------------------------------------
    def put(self, tag: bytes, body: bytes = b"") -> None:
        self._out += tag + struct.pack("!I", len(body) + 4) + body

    def flush(self) -> None:
        # failpoint: the response path (drop_conn: the client's socket
        # dying under a half-written result)
        FAULT("net/pgwire/send")
        if self._out:
            self.sock.sendall(bytes(self._out))
            self._out.clear()

    def send_raw(self, data: bytes) -> None:
        FAULT("net/pgwire/send_raw")
        self.sock.sendall(data)

    # -- message builders ------------------------------------------------
    def auth(self, code: int, extra: bytes = b"") -> None:
        self.put(b"R", struct.pack("!I", code) + extra)

    def parameter_status(self, k: str, v: str) -> None:
        self.put(b"S", k.encode() + b"\0" + v.encode() + b"\0")

    def ready(self, status: bytes) -> None:
        self.put(b"Z", status)
        self.flush()

    def error(self, message: str, sqlstate: str = "XX000") -> None:
        body = (
            b"SERROR\0"
            + b"C" + sqlstate.encode() + b"\0"
            + b"M" + message.encode("utf-8", "replace") + b"\0\0"
        )
        self.put(b"E", body)

    def row_description(self, names, oids) -> None:
        body = struct.pack("!H", len(names))
        for name, oid in zip(names, oids):
            body += (
                name.encode() + b"\0"
                + struct.pack("!IhIhih", 0, 0, oid, -1, -1, 0)
            )
        self.put(b"T", body)

    def data_row(self, row) -> None:
        body = struct.pack("!H", len(row))
        for v in row:
            tv = _text_value(v)
            if tv is None:
                body += struct.pack("!i", -1)
            else:
                body += struct.pack("!i", len(tv)) + tv
        self.put(b"D", body)

    def command_complete(self, tag: str) -> None:
        self.put(b"C", tag.encode() + b"\0")


class PgWireServer:
    """TCP front end speaking the FE/BE v3 protocol over engine
    Sessions, with the same read/write/exclusive statement classing as
    the JSON wire."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0):
        self.cluster = cluster
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(16)
        self.host, self.port = self._lsock.getsockname()
        self._stop = threading.Event()
        self._accept: Optional[threading.Thread] = None
        self._exec_lock = cluster._exec_lock

    def start(self) -> "PgWireServer":
        self._accept = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        shutdown_and_close(self._lsock)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._lsock.accept()
            except OSError:
                return
            try:
                # failpoint: a refused or dropped v3 client at accept;
                # the accept loop survives any injected action
                FAULT("net/pgwire/accept")
            except Exception:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve, args=(sock,), daemon=True
            ).start()

    # -- per-connection loop ---------------------------------------------
    def _serve(self, sock: socket.socket) -> None:
        conn = _Conn(sock)
        session = self.cluster.session()
        try:
            code, params = conn.read_startup()
            while code in (_SSL_REQUEST, _GSSENC_REQUEST):
                conn.send_raw(b"N")  # no TLS on this listener
                code, params = conn.read_startup()
            if code == _CANCEL_REQUEST:
                return
            if code != _PROTO_V3:
                conn.error(
                    f"unsupported frontend protocol {code}", "08P01"
                )
                conn.flush()
                return
            user = params.get("user", "")
            if self.cluster.users:
                if not self._sasl_auth(conn, user):
                    return
            if user:
                # the startup user (trust mode) or the proven identity:
                # its role's resource group admits its statements
                session.user = user
            conn.auth(0)  # AuthenticationOk
            conn.parameter_status("server_version", "10.0 (opentenbase_tpu)")
            conn.parameter_status("client_encoding", "UTF8")
            conn.parameter_status("DateStyle", "ISO, MDY")
            conn.parameter_status("integer_datetimes", "on")
            conn.put(b"K", struct.pack("!II", 0, 0))  # BackendKeyData
            conn.ready(self._txn_status(session))
            self._message_loop(conn, session)
        except (ConnectionError, OSError):
            pass
        finally:
            self._conn_cleanup(session)
            try:
                sock.close()
            except OSError:
                pass

    def _txn_status(self, session) -> bytes:
        return b"T" if session.txn is not None else b"I"

    def _conn_cleanup(self, session) -> None:
        rollback_on_disconnect(self.cluster, session)
        session.close()  # a WLM slot still held goes back now

    @staticmethod
    def _sqlstate_of(e: Exception) -> str:
        state = getattr(e, "sqlstate", None)
        if state:
            return state
        return "42601" if "syntax" in str(e).lower() else "XX000"

    # -- auth ------------------------------------------------------------
    def _sasl_auth(self, conn: _Conn, user: str) -> bool:
        """RFC 5802 SCRAM-SHA-256 over the stored verifiers (the same
        salted credentials the JSON wire uses; scram-common.c). A mock
        salt is served for unknown users (auth.c's mock auth)."""
        conn.auth(10, b"SCRAM-SHA-256\0\0")
        conn.flush()
        tag, body = conn.read_message()
        if tag != b"p":
            conn.error("expected SASLInitialResponse", "28000")
            conn.flush()
            return False
        mech, rest = body.split(b"\0", 1)
        if mech != b"SCRAM-SHA-256":
            conn.error("unsupported SASL mechanism", "28000")
            conn.flush()
            return False
        (ln,) = struct.unpack("!i", rest[:4])
        client_first = rest[4:4 + ln].decode()
        # gs2 header "n,," then "n=<user>,r=<nonce>"
        state, server_first = scram_server_first(
            self.cluster, user, client_first
        )
        conn.auth(11, server_first.encode())  # SASLContinue
        conn.flush()
        tag, body = conn.read_message()
        if tag != b"p":
            conn.error("expected SASLResponse", "28000")
            conn.flush()
            return False
        ok, server_sig = scram_verify_final(state, body.decode())
        if not ok:
            conn.error(
                f'password authentication failed for user "{user}"',
                "28P01",
            )
            conn.flush()
            return False
        conn.auth(12, server_sig)  # SASLFinal
        return True

    # -- statement execution under the lock classes ----------------------
    def _run(self, session, fn, sql=None):
        if sql is None:
            with self._exec_lock:
                return fn()
        return run_classified(self.cluster, session, sql, fn)

    def _emit_result(self, conn: _Conn, res) -> None:
        emit_result(conn, res)

    # -- message loop -----------------------------------------------------
    def _message_loop(self, conn: _Conn, session) -> None:
        prepared: dict = {}   # name -> (ast|None, query)
        portals: dict = {}    # name -> bound ast|None
        while not self._stop.is_set():
            tag, body = conn.read_message()
            if tag == b"X":
                return
            if tag == b"Q":
                self._simple_query(conn, session, body)
                continue
            try:
                if tag == b"P":
                    name, rest = body.split(b"\0", 1)
                    query, prest = rest.split(b"\0", 1)
                    (noids,) = struct.unpack_from("!H", prest, 0)
                    oids = struct.unpack_from(f"!{noids}I", prest, 2)
                    stmts = parse(query.decode())
                    prepared[name.decode()] = (
                        stmts[0] if stmts else None,
                        query.decode(),
                        list(oids),
                    )
                    conn.put(b"1")  # ParseComplete
                elif tag == b"B":
                    portal, rest = body.split(b"\0", 1)
                    stmt_name, rest = rest.split(b"\0", 1)
                    off = 0
                    (nfmt,) = struct.unpack_from("!H", rest, off)
                    off += 2
                    fmts = struct.unpack_from(f"!{nfmt}h", rest, off)
                    off += 2 * nfmt
                    if any(f == 1 for f in fmts):
                        raise ValueError(
                            "binary parameter format not supported"
                        )
                    ast, q, oids = prepared.get(
                        stmt_name.decode(), (None, "", [])
                    )
                    (nparams,) = struct.unpack_from("!H", rest, off)
                    off += 2
                    values = []
                    for pi in range(nparams):
                        (ln,) = struct.unpack_from("!i", rest, off)
                        off += 4
                        if ln == -1:
                            values.append(None)
                        else:
                            oid = oids[pi] if pi < len(oids) else 0
                            values.append(
                                self._param_value(
                                    rest[off:off + ln].decode(), oid
                                )
                            )
                            off += ln
                    # result-format codes: binary results unsupported
                    (nrf,) = struct.unpack_from("!H", rest, off)
                    off += 2
                    rfmts = struct.unpack_from(f"!{nrf}h", rest, off)
                    if any(f == 1 for f in rfmts):
                        raise ValueError(
                            "binary result format not supported"
                        )
                    if ast is not None and nparams:
                        from opentenbase_tpu_torch.engine import (
                            _subst_params,
                        )

                        ast = _subst_params(ast, values)
                    portals[portal.decode()] = (ast, q)
                    conn.put(b"2")  # BindComplete
                elif tag == b"D":
                    conn.put(b"n")  # NoData (metadata at Execute)
                elif tag == b"E":
                    portal, _rest = body.split(b"\0", 1)
                    entry = portals.get(portal.decode())
                    if entry is None or entry[0] is None:
                        conn.put(b"I")  # EmptyQueryResponse
                    else:
                        ast, q = entry
                        res = self._run_ast(session, ast, q)
                        self._emit_result(conn, res)
                elif tag == b"C":
                    conn.put(b"3")  # CloseComplete
                elif tag == b"H":
                    conn.flush()
                elif tag == b"S":
                    conn.ready(self._txn_status(session))
                else:
                    raise ValueError(
                        f"unsupported message {tag!r}"
                    )
            except Exception as e:
                conn.error(f"{type(e).__name__}: {e}", self._sqlstate_of(e))
                # skip to Sync (extended-protocol error recovery)
                while True:
                    t2, _b2 = conn.read_message()
                    if t2 == b"S":
                        conn.ready(self._txn_status(session))
                        break
                    if t2 == b"X":
                        return

    def _param_value(self, s: str, oid: int = 0):
        """Text-format parameter -> Python value, honoring the Parse
        message's declared type OID; untyped (oid 0) falls back to
        numeric-looking inference."""
        import decimal

        if oid in (25, 1042, 1043, 18, 19):  # text/char/varchar/name
            return s
        if oid in (20, 23, 21, 26):  # int8/int4/int2/oid
            return int(s)
        if oid == _OID_NUMERIC:
            return decimal.Decimal(s)
        if oid in (_OID_FLOAT4, _OID_FLOAT8):
            return float(s)
        if oid == _OID_BOOL:
            return s.lower() in ("t", "true", "1", "yes", "on")
        if oid != 0:
            return s
        try:
            return int(s)
        except ValueError:
            pass
        try:
            return decimal.Decimal(s)
        except ArithmeticError:  # InvalidOperation: not a number
            return s

    def _run_ast(self, session, ast, sql=None):
        def fn():
            return session._execute_one(ast)

        return self._run(session, fn, sql=sql)

    def _simple_query(self, conn: _Conn, session, body: bytes) -> None:
        sql = body.rstrip(b"\0").decode()
        if not sql.strip():
            conn.put(b"I")  # EmptyQueryResponse
            conn.ready(self._txn_status(session))
            return
        try:
            res = self._run(
                session, lambda: session.execute(sql), sql=sql
            )
            self._emit_result(conn, res)
        except Exception as e:
            conn.error(f"{type(e).__name__}: {e}", self._sqlstate_of(e))
        conn.ready(self._txn_status(session))

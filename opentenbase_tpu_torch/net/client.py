"""Client library (the reference's opentenbase_tpu/net/client.py): a
wire session against a ``ClusterServer`` with the in-process
``Session``'s surface (``execute``, ``query``), so the CLIs and tests
are agnostic to transport. ``RoutingClient`` / ``connect_any`` keep one
session over a list of coordinator endpoints and never replay a write
whose reply was lost (08007). Not ported: TLS."""

from __future__ import annotations

import random
import secrets
import socket
import time
from dataclasses import dataclass, field

from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.fault import FAULT, NET_CHECK, chaos_rng
from opentenbase_tpu_torch.net import auth as sa
from opentenbase_tpu_torch.net.protocol import (
    recv_frame,
    send_frame,
    shutdown_and_close,
)


class WireError(RuntimeError):
    """A statement error the server reported; ``sqlstate`` carries its
    class when it sent one."""

    sqlstate: str | None = None


class RetryExhausted(WireError):
    """The connect failed after every bounded retry."""


class AuthError(WireError):
    """The authentication handshake failed (including a server that
    could not prove it holds the verifier)."""


def connect_with_retry(
    host: str,
    port: int,
    timeout: float = 30.0,
    retries: int = 3,
    backoff_s: float = 0.05,
    backoff_max_s: float = 2.0,
) -> socket.socket:
    """TCP connect with bounded retries, exponential backoff and jitter
    (a listener still binding costs a few retries, not a failure).
    ``retries`` counts the attempts after the first."""
    attempts = max(int(retries), 0) + 1
    last: Exception | None = None
    made = 0
    for i in range(attempts):
        try:
            made += 1
            # failpoint shared by every wire client (sessions, datanode
            # channels, the GTM): drop_conn is a node refusing, which
            # drives the retry ladder
            FAULT("net/client/connect", host=host, port=port)
            # the connectivity matrix: a cut link refuses like a dead
            # host, a gray link eats the connect deadline
            NET_CHECK(host, port, timeout_s=timeout)
            return socket.create_connection((host, port), timeout=timeout)
        except OSError as e:
            last = e
            # only a restarting listener's failures are worth retrying
            if not isinstance(e, (ConnectionRefusedError,
                                  ConnectionResetError,
                                  ConnectionAbortedError)):
                break
            if i == attempts - 1:
                break
            delay = min(backoff_s * (2 ** i), backoff_max_s)
            # under a chaos schedule the jitter comes from the
            # schedule's stream for this destination, so a failing run
            # replays its reconnect timing from its seed
            rng = chaos_rng(f"net/client/backoff:{host}:{port}")
            draw = rng.random() if rng is not None else random.random()
            time.sleep(delay * (0.5 + draw * 0.5))
    raise RetryExhausted(
        f"connect to {host}:{port} failed after {made} attempt(s): {last}"
    ) from last


@dataclass
class WireResult:
    """Mirrors engine.Result."""

    command: str
    rows: list = field(default_factory=list)
    columns: list = field(default_factory=list)
    rowcount: int = 0
    # the server's WAL end just after this statement (0 without a WAL)
    wal_pos: int = 0


class ClientSession:
    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 30.0,
        user: str | None = None,
        password: str | None = None,
        ssl: bool = False,
        ssl_ca: str | None = None,
        connect_retries: int = 3,
    ):
        if ssl or ssl_ca:
            raise NotPorted("TLS on the coordinator wire")
        self._host, self._port = host, port
        self._timeout = timeout
        self._sock = connect_with_retry(
            host, port, timeout=timeout, retries=connect_retries
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if user is not None:
            self._authenticate(user, password or "")

    def _authenticate(self, user: str, password: str) -> None:
        """Client half of the SCRAM flow (auth.py): prove the password
        without sending it, then check the server's signature."""
        # the credential exchange is a boundary of its own: a drop here
        # surfaces as an auth failure, not a hang
        FAULT("net/client/auth")
        client_nonce = secrets.token_hex(16)
        send_frame(self._sock, {
            "op": "auth", "user": user, "client_nonce": client_nonce,
        })
        chal = recv_frame(self._sock)
        if chal is None or not all(
            k in chal for k in ("salt", "nonce", "iterations")
        ):
            raise AuthError("malformed auth challenge")
        authmsg = sa.auth_message(
            user, client_nonce, chal["nonce"], chal["salt"]
        )
        proof = sa.client_proof(
            password, chal["salt"], int(chal["iterations"]), authmsg
        )
        send_frame(self._sock, {"op": "proof", "proof": proof})
        fin = recv_frame(self._sock)
        if fin is None or "error" in fin:
            raise AuthError((fin or {}).get("error", "connection closed"))
        if not sa.verify_server(
            password, chal["salt"], int(chal["iterations"]), authmsg,
            str(fin.get("server_sig", "")),
        ):
            raise AuthError("server failed to prove identity")

    def execute(self, sql: str) -> WireResult:
        FAULT("net/client/send")
        # the matrix: an established session dies mid-statement when
        # its link is cut
        NET_CHECK(self._host, self._port, timeout_s=self._timeout)
        send_frame(self._sock, {"q": sql})
        FAULT("net/client/recv")
        resp = recv_frame(self._sock)
        if resp is None:
            raise WireError("connection closed by server")
        if "error" in resp:
            err = WireError(resp["error"])
            err.sqlstate = resp.get("sqlstate")
            raise err
        return WireResult(
            resp["tag"],
            [tuple(r) for r in resp["rows"]],
            resp["columns"],
            resp["rowcount"],
            int(resp.get("wal_pos", 0)),
        )

    def query(self, sql: str) -> list[tuple]:
        return self.execute(sql).rows

    def close(self) -> None:
        try:
            # failpoint: the goodbye frame racing a dying peer
            FAULT("net/client/close")
            send_frame(self._sock, {"op": "close"})
            recv_frame(self._sock)
        except OSError:
            pass
        finally:
            # wakes the server's backend even when the close frame
            # never made it out
            shutdown_and_close(self._sock)

    def __enter__(self) -> "ClientSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect_tcp(host: str = "127.0.0.1", port: int = 5433,
                **kw) -> ClientSession:
    return ClientSession(host, port, **kw)


class RoutingClient:
    """Multi-coordinator client — libpq's multi-host conninfo
    (``host=cn0,cn1 target_session_attrs=any``) for the serving plane.

    Takes every CN's SQL endpoint and keeps ONE live session, chosen
    round-robin across instances so a fleet of clients spreads over the
    fleet of CNs (any CN serves any statement: peers execute reads
    locally and forward writes to the primary themselves). When the
    current CN dies mid-statement the client fails over to the next
    endpoint and retries ONCE — but only outside an open transaction
    and only for connection-class errors; an in-transaction failure
    surfaces to the caller, who alone knows what to replay.
    """

    _next_start = 0  # instance-level round-robin seed, wraps harmlessly

    def __init__(self, endpoints: list, **kw):
        if not endpoints:
            raise ValueError("RoutingClient needs at least one endpoint")
        self._endpoints = [(str(h), int(p)) for h, p in endpoints]
        self._kw = kw
        self._idx = RoutingClient._next_start % len(self._endpoints)
        RoutingClient._next_start += 1
        self._conn: ClientSession | None = None
        self._in_txn = False
        # session state replayed onto the next CN after a failover
        # (the pgbouncer server_reset_query inverse: we RESTORE state)
        self._session_state: list[str] = []

    @property
    def endpoint(self) -> tuple:
        """The (host, port) currently serving this client."""
        return self._endpoints[self._idx]

    def _connect(self) -> ClientSession:
        if self._conn is None:
            last: Exception | None = None
            for _ in range(len(self._endpoints)):
                host, port = self._endpoints[self._idx]
                try:
                    self._conn = ClientSession(host, port, **self._kw)
                    break
                except (OSError, WireError) as e:
                    last = e
                    self._idx = (self._idx + 1) % len(self._endpoints)
            if self._conn is None:
                raise RetryExhausted(
                    f"no coordinator reachable among "
                    f"{self._endpoints}: {last}"
                ) from last
            for state_sql in self._session_state:
                self._conn.execute(state_sql)
        return self._conn

    def _note(self, sql: str) -> None:
        s = sql.strip().lower()
        if s.startswith("begin") or s.startswith("start transaction"):
            self._in_txn = True
        elif s.startswith("commit") or s.startswith("rollback"):
            self._in_txn = False
        elif s.startswith("set ") and not s.startswith("set transaction"):
            self._session_state.append(sql)

    # statement prefixes whose replay is harmless: pure reads and
    # session-state changes. Everything else (INSERT/UPDATE/DELETE/DDL,
    # COMMIT above all) may have been APPLIED before the link died —
    # retrying it on another CN double-writes. The 2PC layer learned
    # this as the 08006 in-doubt rule; the client layer gets the
    # matching 08007 "transaction resolution unknown".
    _RETRY_SAFE = (
        "select", "show", "explain", "with", "values",
        "set", "reset", "begin", "start", "rollback",
    )

    @classmethod
    def _retry_safe(cls, sql: str) -> bool:
        head = sql.lstrip().split(None, 1)
        return bool(head) and head[0].lower().rstrip(";") in cls._RETRY_SAFE

    def execute(self, sql: str) -> WireResult:
        # connect phase is its own loop (and safe to rotate endpoints:
        # nothing has been sent) — keep it out of the retry decision
        conn = self._connect()
        try:
            res = conn.execute(sql)
        except (OSError, WireError) as e:
            if isinstance(e, WireError) and not (
                "connection closed" in str(e)
                or (e.sqlstate or "").startswith("08")
            ):
                raise  # statement error, not a dead CN
            self._drop()
            if self._in_txn:
                self._in_txn = False
                raise WireError(
                    f"coordinator lost mid-transaction: {e}"
                ) from e
            self._idx = (self._idx + 1) % len(self._endpoints)
            if not self._retry_safe(sql):
                # the statement may have committed before the reply was
                # lost: the outcome is INDETERMINATE and only the caller
                # can decide whether to replay (after reading back)
                err = WireError(
                    f"statement outcome unknown (connection lost after "
                    f"send, not retried): {e}"
                )
                err.sqlstate = "08007"
                raise err from e
            res = self._connect().execute(sql)
        self._note(sql)
        return res

    def query(self, sql: str) -> list[tuple]:
        return self.execute(sql).rows

    def _drop(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                shutdown_and_close(conn._sock)
            except OSError:
                pass

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            # graceful goodbye; ClientSession.close already ends with
            # shutdown_and_close on its socket
            conn.close()

    def __enter__(self) -> "RoutingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect_any(endpoints: list, **kw) -> RoutingClient:
    """Open a routed session against a multi-coordinator cluster;
    ``endpoints`` is [(host, port), ...] of every CN's SQL front end."""
    return RoutingClient(endpoints, **kw)

"""Coordinator TCP front end (the reference's opentenbase_tpu/net/
server.py): one thread per connection, each owning a port ``Session``
against the shared in-process cluster, speaking the JSON frames of
protocol.py.

Statements from concurrent connections run under the cluster's
statement lock (``cluster._exec_lock``, utils/rwlock.py), by class
(``classify``): a plain SELECT outside a transaction shares the data
plane with other readers, autocommit DML takes it per table (writers of
disjoint tables overlap), and everything else (DDL, explicit
transactions, anything uncertain) takes it exclusively. A statement that
waits on a row lock parks its slot (lmgr.py). A ``ping`` frame is
answered before authentication with the cluster's role (coordinator,
standby, or fenced), fencing generation and serving lease: the HA
failure detector's probe (ha.py). TLS is not ported: a server asked
for it refuses to start.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import logging
import os
import secrets
import socket
import threading
from typing import Optional

from opentenbase_tpu_torch.errors import NotPorted
from opentenbase_tpu_torch.fault import (
    FAULT,
    FaultDropConnection,
    set_thread_actor,
)
from opentenbase_tpu_torch.net import auth as sa
from opentenbase_tpu_torch.net.protocol import (
    recv_frame,
    send_frame,
    shutdown_and_close,
)
from opentenbase_tpu_torch.sql import ast as A
from opentenbase_tpu_torch.sql import parse

log = logging.getLogger(__name__)


def _walk_ast(node):
    """Generic AST walk over dataclass fields, nested lists and tuples
    included (INSERT's VALUES rows, a SELECT's set operations)."""
    if isinstance(node, (list, tuple)):
        for x in node:
            yield from _walk_ast(x)
        return
    if not dataclasses.is_dataclass(node) or isinstance(node, type):
        return
    yield node
    for f in dataclasses.fields(node):
        yield from _walk_ast(getattr(node, f.name))


def _writing_functions(cluster) -> set:
    """The functions a call of which may write: every PL/pgSQL function
    (its body runs INSERT, UPDATE and DELETE inside the calling
    statement), and every SQL function whose body calls one."""
    import re

    names = {n for n, fn in cluster.functions.items()
             if getattr(fn, "language", "sql") == "plpgsql"}
    grew = bool(names)
    while grew:
        grew = False
        for n, fn in cluster.functions.items():
            if n not in names and any(
                    re.search(rf"\b{re.escape(w)}\s*\(", fn.body or "",
                              re.IGNORECASE) for w in names):
                names.add(n)
                grew = True
    return names


def classify(cluster, sql: str, session):
    """The statement's lock class, from one parse:

    - ("read", None): a single plain SELECT (no FOR UPDATE) outside a
      transaction, calling no function that may write: shares the data
      plane with other readers.
    - ("write", tables): a single autocommit INSERT/UPDATE/DELETE of one
      known plain table (and UPDATE ... FROM's or DELETE ... USING's
      known source) with no subquery: shares the data plane with
      writers of other tables.
    - ("excl", None): everything else, parse errors included (they then
      surface from the statement's own execution)."""
    if session.txn is not None:
        return "excl", None
    try:
        stmts = parse(sql)
    except Exception:
        return "excl", None
    if len(stmts) != 1:
        return "excl", None
    st = stmts[0]
    writers = _writing_functions(cluster)
    if writers and any(isinstance(n, A.FuncCall) and n.name in writers
                       for n in _walk_ast(st)):
        # a PL/pgSQL body's writes would run beside a writer of the same
        # table without that table's mutex (the reference classes such a
        # SELECT a read)
        return "excl", None
    if isinstance(st, A.Select):
        if st.for_update is not None:
            return "excl", None
        # a FROM-less admin or sequence call changes state
        # (pg_resolve_indoubt, pg_unlock_execute, nextval, setval); a
        # refused one fails in its own execution
        from opentenbase_tpu_torch.engine import Session

        mutating = (Session._ADMIN_FUNCS | set(Session._ADMIN_REFUSED)
                    | set(Session._SEQ_FUNCS))
        for item in st.items:
            for node in _walk_ast(item.expr):
                if isinstance(node, A.FuncCall) and node.name in mutating:
                    return "excl", None
        return "read", None
    if isinstance(st, (A.Insert, A.Update, A.Delete)):
        if isinstance(st, A.Insert) and st.query is not None:
            return "excl", None
        for node in _walk_ast(st):
            if isinstance(node, (A.InSubquery, A.ExistsSubquery,
                                 A.ScalarSubquery)):
                return "excl", None
        # UPDATE ... FROM / DELETE ... USING: the source's mutex too
        tables = {st.table}
        if getattr(st, "from_table", None) is not None:
            tables.add(st.from_table[0])
        if not all(cluster.catalog.has(t) for t in tables):
            return "excl", None
        # a partitioned parent's rows land in its children, and a
        # foreign table's refusal comes from its own execution
        if any(t in cluster.partitions
               or cluster.catalog.get(t).foreign is not None
               for t in tables):
            return "excl", None
        return "write", tables
    return "excl", None


def run_classified(cluster, session, sql: str, fn):
    """``fn()`` under the statement lock of ``sql``'s class."""
    lock = cluster._exec_lock
    kind, tables = classify(cluster, sql, session)
    if kind == "read":
        with lock.read():
            return fn()
    if kind == "write":
        with lock.write_tables(tables):
            return fn()
    with lock:
        return fn()


def rollback_on_disconnect(cluster, session) -> None:
    """Abort a transaction a dropped connection left open (the
    backend-exit cleanup of the reference's tcop loop), under the
    exclusive lock: the abort rewrites shared store state."""
    if session.txn is None:
        return
    try:
        with cluster._exec_lock:
            session.execute("rollback")
    except Exception as e:
        log.warning("rollback on disconnect failed (session %s): %r",
                    session.session_id, e)


class ClusterServer:
    def __init__(
        self,
        cluster,
        host: str = "127.0.0.1",
        port: int = 0,
        ssl_cert: Optional[str] = None,
        ssl_key: Optional[str] = None,
    ):
        if ssl_cert or ssl_key:
            raise NotPorted("TLS on the coordinator wire")
        self.cluster = cluster
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(64)
        self.host, self.port = self._lsock.getsockname()
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: list[threading.Thread] = []
        # accepted sockets of live backends, force-closed on stop()
        self._conns: set = set()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ClusterServer":
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._accept_thread = t
        return self

    def stop(self) -> None:
        self._stop.set()
        shutdown_and_close(self._lsock)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        # a client that never sends its close frame must not hold the
        # shutdown hostage
        for c in list(self._conns):
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in list(self._conn_threads):
            t.join(timeout=5)

    def __enter__(self) -> "ClusterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- loops -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._lsock.accept()
            except OSError:
                return  # listener closed
            try:
                # failpoint: a coordinator refusing or dropping a new
                # backend; the accept loop survives any injected action
                FAULT("net/server/accept")
            except Exception:
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.add(conn)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()
            self._conn_threads = [
                x for x in self._conn_threads if x.is_alive()
            ]
            self._conn_threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        # every wire op this backend makes for its client travels under
        # the coordinator's name in the connectivity matrix: a cut of
        # the coordinator's egress severs work done for a client too
        set_thread_actor(
            getattr(self.cluster, "coordinator_name", "cn0") or "cn0")
        session = self.cluster.session()
        # trust while no role exists; once one does, the SCRAM exchange
        # comes before the first statement
        authed = not self.cluster.users
        try:
            while not self._stop.is_set():
                msg = recv_frame(conn)
                if msg is None:
                    break
                if msg.get("op") == "close":
                    send_frame(conn, {"ok": True})
                    break
                if msg.get("op") == "ping":
                    # the HA failure detector's liveness probe (ha.py),
                    # answered before auth, carrying the fencing
                    # generation and the live role
                    send_frame(conn, self._ping())
                    continue
                if msg.get("op") == "auth":
                    authed = self._scram_exchange(conn, msg)
                    if authed:
                        # the proven identity: its role's resource
                        # group admits its statements
                        session.user = str(msg.get("user", session.user))
                    continue
                if not authed:
                    send_frame(
                        conn,
                        {"error": "AuthError: authentication required"},
                    )
                    continue
                sql = msg.get("q")
                if sql is None:
                    send_frame(conn, {"error": "malformed request"})
                    continue
                try:
                    # failpoint: statement dispatch. drop_conn tears the
                    # backend down mid-protocol; error reaches the
                    # client as an error frame
                    FAULT("net/server/dispatch")
                    res = run_classified(
                        self.cluster, session, sql,
                        lambda: session.execute(sql))
                    p = self.cluster.persistence
                    send_frame(conn, {
                        "tag": res.command,
                        "columns": res.columns,
                        "rows": [list(r) for r in res.rows],
                        "rowcount": res.rowcount,
                        # the WAL end after the statement
                        "wal_pos": int(p.wal.position) if p else 0,
                    })
                except FaultDropConnection:
                    raise  # sever this backend like a peer reset
                except Exception as e:
                    frame = {"error": f"{type(e).__name__}: {e}"}
                    sqlstate = getattr(e, "sqlstate", None)
                    if sqlstate:
                        frame["sqlstate"] = sqlstate
                    send_frame(conn, frame)
        except OSError:
            # the client vanished mid-frame, or stop() disconnected it
            pass
        finally:
            self._conns.discard(conn)
            rollback_on_disconnect(self.cluster, session)
            session.close()  # a WLM slot still held goes back now
            try:
                conn.close()
            except OSError:
                pass

    def _ping(self) -> dict:
        c = self.cluster
        role = ("fenced" if c.ha_demoted
                else "standby" if c.read_only else "coordinator")
        lease = c.serving_lease
        lease_ms = lease.remaining_ms() if lease is not None else -1
        p = c.persistence
        return {"ok": True, "role": role,
                "generation": int(c.node_generation),
                "lease_valid": lease is None or lease_ms > 0,
                "lease_remaining_ms": lease_ms,
                "applied": int(p.wal.position) if p is not None else 0}

    def _scram_exchange(self, conn: socket.socket, msg: dict) -> bool:
        """Server half of the SCRAM flow (auth.py). True when the client
        proved the password. Unknown users get a fake salt, stable per
        user and keyed by a per-cluster secret, so the flow does not
        tell which roles exist."""
        # failpoint: a client vanishing mid-handshake leaves no half
        # authenticated backend
        FAULT("net/server/scram")
        user = str(msg.get("user", ""))
        client_nonce = str(msg.get("client_nonce", ""))
        verifier = self.cluster.users.get(user)
        if verifier is None:
            secret = getattr(self.cluster, "_mock_salt_secret", None)
            if secret is None:
                secret = os.urandom(16)
                self.cluster._mock_salt_secret = secret
            fake_salt = hmac.new(
                secret, user.encode(), hashlib.sha256
            ).hexdigest()[:32]
            verifier = {
                "salt": fake_salt,
                "iterations": sa.ITERATIONS,
                "stored_key": "00" * 32,
                "server_key": "00" * 32,
            }
        nonce = client_nonce + secrets.token_hex(16)
        send_frame(conn, {
            "salt": verifier["salt"],
            "iterations": verifier["iterations"],
            "nonce": nonce,
        })
        reply = recv_frame(conn)
        if reply is None or reply.get("op") != "proof":
            send_frame(conn, {"error": "AuthError: handshake aborted"})
            return False
        authmsg = sa.auth_message(user, client_nonce, nonce, verifier["salt"])
        # the all-zero fake verifier never validates: one check for real
        # and unknown users alike
        if sa.verify_proof(verifier, str(reply.get("proof", "")), authmsg):
            send_frame(conn, {
                "ok": True,
                "server_sig": sa.server_signature(verifier, authmsg),
            })
            return True
        send_frame(
            conn, {"error": f'AuthError: authentication failed for "{user}"'}
        )
        return False

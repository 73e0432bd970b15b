"""Datanode executor server: a process boundary for fragments (the
reference's opentenbase_tpu/dn/server.py).

A datanode process is

- a ``StandbyCluster`` following the coordinator's WAL over streaming
  replication (storage/replication.py): its copy of the data plane,
  kept by the same redo as a hot standby, on the process's device;
- a framed-RPC server (net/protocol.py) that runs portable plan
  fragments (plan/serde.py) with the port's ``LocalExecutor`` on that
  device, against its local shard stores at the coordinator's snapshot,
  after its replay reached the coordinator's WAL position (``min_lsn``,
  read-your-writes);
- a 2PC participant: ``2pc_prepare`` journals the vote with the shipped
  write set (fsynced with it), ``2pc_commit`` applies the journal ahead
  of the stream, exactly once against the stream's gid-tagged frame;
- a peer-exchange endpoint: producer fragments push their partitions
  straight to the consumer datanodes (``exch_put``);
- a promotion candidate (self-healing HA, ha.py): ``promote`` turns its
  standby into a read-write coordinator with a SQL front end and a
  walsender in this process, on its device; ``repl_repoint`` re-points
  a surviving standby at the promoted walsender (rewinding a diverged
  one); every op may carry the caller's fencing generation
  (``hgen``), and a caller behind this node's generation is refused
  with SQLSTATE 72000 (``fenced``); ``lease_grant`` records a
  coordinator's serving lease.

Ops: ping, query (a replica read), exec_fragment, cancel_fragment,
exch_put, exch_take, 2pc_prepare, 2pc_commit, 2pc_abort, 2pc_list,
lease_grant, promote, repl_repoint, fault_arm, fault_clear, fault_stats.
A fragment with ``parallel`` > 1
splits a qualifying partial aggregate's base scan over that many
row-block workers (executor/local.py ``run_fragment_parallel``;
``parallel_fragments`` counts them); its block workers poll the
fragment's cancel token at every operator boundary, as the serial
executor does.

Failpoints (fault/): ``dn/accept``, ``dn/serve``, ``dn/dispatch``,
``dn/query``, ``dn/exec_fragment``, the 2PC verbs' before and
``:after_journal`` sites, ``dn/batch_apply``, ``dn/promote`` and
``dn/repoint``. A ``crash_node`` action at any of them takes the node
down (``_simulate_crash``: the listener closed, every request but the
fault-control ops dropped unanswered); ``fault_clear`` on a surviving
channel revives it (``_revive``). Refused by name: the log and trace
rings (log_fetch, trace_fetch) and rebalance (rebalance_*).

Run as a module (on cuda:0 unless ``--device`` says otherwise; with no
CUDA and no ``--device cpu`` it refuses to start):

  python -m opentenbase_tpu_torch.dn.server --data-dir D --wal-host H
      --wal-port P [--listen-port N] [--device cpu]

It prints "READY <port>" once serving.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import sys
import threading
import time
from typing import Optional

from opentenbase_tpu_torch import fault as _fault
from opentenbase_tpu_torch.fault import FAULT, FaultDropConnection
from opentenbase_tpu_torch.net.protocol import (
    encode_frame,
    recv_frame,
    shutdown_and_close,
)

log = logging.getLogger(__name__)

# ops of the reference's datanode that the port refuses, by name
_REFUSED = {
    "log_fetch": "the datanode log ring",
    "trace_fetch": "the datanode trace ring",
    "rebalance_apply": "rebalance", "rebalance_finalize": "rebalance",
}


# answered even on a node with an injected crash
_FAULT_OPS = ("fault_arm", "fault_clear", "fault_stats")


class FragmentCancelled(RuntimeError):
    """The coordinator sent cancel_fragment for this fragment's token."""


class DNServer:
    def __init__(
        self,
        data_dir: str,
        wal_host: str,
        wal_port: int,
        num_datanodes: int = 2,
        shard_groups: int = 256,
        host: str = "127.0.0.1",
        port: int = 0,
        device=None,
    ):
        from opentenbase_tpu_torch.storage.replication import StandbyCluster

        # kept for the repoint's rewind: a diverged survivor rebuilds its
        # standby over the same data directory
        self._data_dir = data_dir
        self._num_datanodes = num_datanodes
        self._shard_groups = shard_groups
        self.standby = StandbyCluster(data_dir, num_datanodes, shard_groups,
                                      device=device)
        self.device = self.standby.cluster.device
        # gids the stream resolved (their 'G' frame arrived): a late or
        # repeated decision must not apply the journal again
        # (insertion-ordered, bounded, oldest evicted first)
        self._stream_resolved: dict = {}
        self.stats: dict = {}
        self._stats_mu = threading.Lock()
        # peer exchange: (xid, dest) -> {from: wire batch}; consumers
        # wait on the condition until every producer's part arrived
        self._exch: dict = {}
        self._exch_born: dict = {}
        self._exch_cv = threading.Condition()
        self._peer_pools: dict = {}
        self._peer_mu = threading.Lock()
        # 'G' frames already in the local WAL copy were applied by the
        # standby's replay: retire their journals before a repeated
        # 2pc_commit could apply them twice
        from opentenbase_tpu_torch.storage.persist import WAL

        for tag, header, _a, _off in WAL.read_records(
            self.standby.cluster.persistence.wal.path, decode_arrays=False
        ):
            if tag == "G" and header.get("gid"):
                self._on_stream_txn(header["gid"])
        self.standby.stream_txn_hook = self._on_stream_txn
        self.standby.start_replication(wal_host, wal_port)
        # self-healing HA: the promoted front end and walsender (None
        # until ``promote``), the fencing generation learned from wire
        # ops (a monotone maximum; the stream-learned half is the
        # standby cluster's node_generation), and the serving-lease
        # grants: holder -> (generation, monotonic deadline)
        self._promoted_srv = None
        self._promoted_walsender = None
        self._promote_mu = threading.Lock()
        self._hgen = 0
        self._leases: dict = {}
        self._lease_mu = threading.Lock()
        # tokens the coordinator abandoned (insertion-ordered, bounded)
        self._cancelled: dict = {}
        self._cancel_mu = threading.Lock()
        self._inflight = 0
        # an injected crash_node: the listener is closed and only the
        # fault-control ops are answered, until ``_revive``
        self._crashed = False
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(32)
        self.host, self.port = self._lsock.getsockname()
        self._stop = threading.Event()
        # accepted connections: stop() severs them as a dying process
        # would, so no pooled channel is answered after it
        self._conns: set = set()
        self._conns_mu = threading.Lock()

    def start(self) -> "DNServer":
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        shutdown_and_close(self._lsock)
        with self._conns_mu:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        with self._peer_mu:
            for pool in self._peer_pools.values():
                try:
                    pool.close()
                except Exception:
                    pass
            self._peer_pools.clear()
        with self._promote_mu:
            promoted = (self._promoted_srv, self._promoted_walsender)
        for part in promoted:
            if part is not None:
                try:
                    part.stop()
                except Exception:
                    pass
        self.standby.stop()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            try:
                # failpoint: a just-accepted coordinator connection
                # refused or dropped. A try of its own: drop_conn is an
                # OSError, which the accept's handler would read as a
                # closed listener
                FAULT("dn/accept")
            except Exception as e:
                log.warning("connection refused at accept: %r", e)
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_mu:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    # -- RPC loop ---------------------------------------------------------
    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                # failpoint at the datanode's own frame boundary
                FAULT("dn/serve")
                msg = recv_frame(conn)
                if msg is None:
                    break
                if self._crashed and msg.get("op") not in _FAULT_OPS:
                    # an injected crash: no reply (the fault-control
                    # ops stay answerable on a surviving channel, so a
                    # harness can always disarm and revive)
                    break
                try:
                    reply = self._dispatch(msg)
                    frame = encode_frame(reply)
                except FaultDropConnection:
                    break  # dropped without a reply, as a dying process
                except Exception as e:
                    # the error travels as the reply (an oversized
                    # reply fails in encode_frame, before any byte)
                    log.warning("dispatch error for op %r: %s: %s",
                                msg.get("op"), type(e).__name__, e)
                    frame = encode_frame(
                        {"error": f"{type(e).__name__}: {e}"})
                if self._stop.is_set():
                    break  # a stopped node answers nothing more
                conn.sendall(frame)
        except OSError:
            pass
        finally:
            with self._conns_mu:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _bump(self, key: str, by: int = 1) -> None:
        with self._stats_mu:
            self.stats[key] = self.stats.get(key, 0) + by

    # -- injected crashes -------------------------------------------------
    def _simulate_crash(self) -> None:
        """The crash_node action: stop accepting and stop answering. The
        object survives; to every peer the node is gone mid-request."""
        self._crashed = True
        shutdown_and_close(self._lsock)
        self._bump("injected_crashes")
        log.warning("injected crash_node: datanode down (listener closed, "
                    "connections dropping)")

    def _revive(self) -> None:
        """Undo an injected crash: listen again on the same port (a
        harness's process respawn)."""
        if not self._crashed:
            return
        lsock = socket.socket()
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self.host, self.port))
        lsock.listen(32)
        self._lsock = lsock
        self._crashed = False
        threading.Thread(target=self._accept_loop, daemon=True).start()
        self._bump("revives")
        log.warning("datanode revived: listening again on %d", self.port)

    def _failpoint(self, site: str, **ctx):
        """One FAULT site with the datanode's crash_node semantics (the
        node taken down, this request severed with no reply); returns
        the action for any other site-handled reaction."""
        act = FAULT(site, **ctx)
        if act == "crash_node":
            self._simulate_crash()
            raise FaultDropConnection("injected datanode crash")
        return act

    def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        # the fault-control ops answer even on a crashed node
        if op == "fault_arm":
            _fault.inject(str(msg["site"]), str(msg["action"]),
                          str(msg.get("spec") or ""))
            return {"ok": True}
        if op == "fault_clear":
            n = _fault.clear(msg.get("site"))
            if self._crashed:
                self._revive()  # disarm and respawn in one message
            return {"ok": True, "cleared": n}
        if op == "fault_stats":
            return {"ok": True, "rows": [list(r) for r in _fault.stats()]}
        if op in _REFUSED:
            return {"error": f"NotPorted: {op} ({_REFUSED[op]})"}
        # the fencing gate: a caller behind this node's generation is a
        # stale ex-primary partitioned through a promotion, refused so
        # that it demotes; a caller ahead advances the learned one
        hg = msg.get("hgen")
        if hg is not None:
            hg = int(hg)
            cur = self.effective_generation()
            if hg < cur:
                self._bump("fenced_refusals")
                log.warning("fenced stale-generation op %r (caller %d < "
                            "node %d)", op, hg, cur)
                return {
                    "error": (f"stale generation: {op} carries generation "
                              f"{hg} but this node follows generation "
                              f"{cur}; caller must demote and resync"),
                    "fenced": True, "gen": cur, "sqlstate": "72000",
                }
            with self._promote_mu:  # never regress under a race
                if hg > self._hgen:
                    self._hgen = hg
        self._failpoint("dn/dispatch", op=op)
        if op == "lease_grant":
            # below the gate: a stale generation's renewal is refused
            # fenced, which is how a partitioned ex-primary learns it
            # must demote
            holder = str(msg.get("holder") or "cn0")
            ttl_ms = int(msg.get("ttl_ms") or 0)
            with self._lease_mu:
                self._leases[holder] = (int(msg.get("hgen") or 0),
                                        time.monotonic() + ttl_ms / 1000.0)
            self._bump("lease_grants")
            return {"ok": True}
        if op == "cancel_fragment":
            tok = str(msg.get("token") or "")
            with self._cancel_mu:
                self._cancelled[tok] = time.time()
                while len(self._cancelled) > 1024:
                    self._cancelled.pop(next(iter(self._cancelled)))
            self._bump("cancel_requests")
            return {"ok": True}
        if op == "ping":
            self._exch_gc()
            with self._stats_mu:
                st = dict(self.stats)
                inflight = self._inflight
            gen = self.effective_generation()
            with self._promote_mu:
                promoted = self._promoted_srv
            out = {
                "ok": True, "applied": self.standby.applied,
                "dml_stats": st, "inflight": inflight,
                "repl_addr": self.standby.repl_addr,
                "stream_error": self.standby.stream_error,
                "device": str(self.device),
                "rss_bytes": _rss_bytes(),
                "device_peak_bytes": _device_peak(self.device),
                "generation": gen,
                "lease_remaining_ms": self._stale_lease_remaining_ms(gen),
                "role": "coordinator" if promoted is not None
                else "datanode",
            }
            if promoted is not None:
                out["promoted"] = True
                out["coordinator_port"] = promoted.port
            return out
        if op == "query":
            # above the promoted fence: a promoted node's data is still
            # the freshest copy, so replica reads keep working
            return self._query(msg)
        if op == "promote":
            return self._promote(msg)
        if op == "repl_repoint":
            return self._repoint(msg)
        with self._promote_mu:
            promoted = self._promoted_srv
        if promoted is not None:
            # a promoted node owns its data read-write: replication-role
            # ops from a partitioned old coordinator would write behind
            # the new primary's back
            return {
                "error": "stale generation: datanode has been promoted "
                "to coordinator; replication-role ops refused — caller "
                "must demote and resync",
                "fenced": True, "gen": self.effective_generation(),
                "sqlstate": "72000",
            }
        if op == "exec_fragment":
            return self._exec_fragment(msg)
        if op == "2pc_prepare":
            return self._twophase_prepare(msg)
        if op == "2pc_commit":
            return self._twophase_finish(msg, committed=True)
        if op == "2pc_abort":
            return self._twophase_finish(msg, committed=False)
        if op == "2pc_list":
            entries = self._twophase_list()
            return {"ok": True, "gids": [e["gid"] for e in entries],
                    "entries": entries}
        if op == "exch_put":
            return self._exch_put(msg)
        if op == "exch_take":
            return self._exch_take(msg)
        return {"error": f"unknown op {op}"}

    # -- two-phase commit participant -------------------------------------
    # The vote is a fsynced journal entry under <data_dir>/prepared_2pc
    # that carries the transaction's write set (twophase.c's state
    # files): PREPARE persists gid and data before the coordinator's
    # commit stamp; COMMIT applies the journal through the stream-replay
    # code path (read-your-writes without waiting for the stream), the
    # gid-tagged 'G' frame deduplicating the two paths exactly once;
    # ABORT discards; 2pc_list feeds the coordinator's orphan sweep.

    def _twophase_dir(self) -> str:
        d = os.path.join(self.standby.data_dir, "prepared_2pc")
        os.makedirs(d, exist_ok=True)
        return d

    def _on_stream_txn(self, gid: str) -> None:
        """The stream applied (or is about to apply) ``gid``'s frame:
        its journal is resolved."""
        self._stream_resolved[gid] = None
        while len(self._stream_resolved) > 4096:
            self._stream_resolved.pop(next(iter(self._stream_resolved)))
        try:
            os.unlink(os.path.join(self._twophase_dir(), gid))
        except OSError:
            pass

    def _twophase_prepare(self, msg: dict) -> dict:
        gid = str(msg["gid"])
        if not gid or "/" in gid or gid.startswith("."):
            return {"error": f"bad gid {gid!r}"}
        # before the vote reaches the disk: a node that never voted
        self._failpoint("dn/2pc_prepare", gid=gid)
        d = self._twophase_dir()
        tmp = os.path.join(d, f".{gid}.tmp")
        path = os.path.join(d, gid)
        entry = {
            "gid": gid,
            "gxid": msg.get("gxid"),
            "participants": msg.get("participants") or [],
            "prepared_at": time.time(),
        }
        if msg.get("writes") is not None:
            entry["writes"] = msg["writes"]
        with open(tmp, "w") as f:
            json.dump(entry, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)  # the rename itself must be durable
        finally:
            os.close(dfd)
        self._bump("2pc_prepared")
        # after the journal is durable: the vote exists, its ack is lost
        # (the in-doubt shape pg_resolve_indoubt drives to a decision)
        self._failpoint("dn/2pc_prepare:after_journal", gid=gid)
        return {"ok": True}

    def _twophase_finish(self, msg: dict, committed: bool) -> dict:
        gid = str(msg["gid"])
        verb = "2pc_commit" if committed else "2pc_abort"
        # the decision arrived, nothing applied or retired yet: a lost
        # phase-2 delivery
        self._failpoint(f"dn/{verb}", gid=gid)
        path = os.path.join(self._twophase_dir(), gid)
        try:
            with open(path) as f:
                entry = json.load(f)
        except FileNotFoundError:
            # presumed abort: finishing an unknown gid is a no-op (the
            # prepare never arrived, or the stream resolved it)
            return {"ok": True, "known": False}
        except ValueError:
            entry = {}
        applied = False
        if committed and entry.get("writes") is not None:
            applied = self._apply_journal(gid, entry, msg)
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        # applied and the journal retired, the ack lost
        self._failpoint(f"dn/{verb}:after_journal", gid=gid)
        return {"ok": True, "known": True, "applied": applied}

    def _apply_journal(self, gid: str, entry: dict, msg: dict) -> bool:
        """Apply a journaled write set to our stores through the stream
        replay's code path, exactly once across the two delivery paths
        (``direct_applied`` tells the stream to skip the frame;
        ``_stream_resolved`` tells us the stream won). A replica behind
        the frame (a table's DDL or dictionary values not streamed yet)
        defers to the stream."""
        from opentenbase_tpu_torch.plan import serde

        c = self.standby.cluster
        with c._exec_lock:
            # the fence again, under the lock promote() bumps the
            # generation under: a phase 2 from the deposed generation
            # that lost the race must not write a row the promoted WAL
            # never carries
            hg = msg.get("hgen")
            if hg is not None and int(hg) < self.effective_generation():
                self._bump("fenced_refusals")
                return False
            if (gid in self._stream_resolved
                    or gid in self.standby.direct_applied):
                return False
            commit_ts = msg.get("commit_ts")
            if commit_ts is None:
                return False
            sub, arrays = serde.frame_from_wire(entry["writes"])
            # the batch-apply boundary: an error leaves direct_applied
            # unset, so the stream's gid-tagged frame applies it once
            self._failpoint("dn/batch_apply", gid=gid, frames=len(sub))
            if c.persistence.frame_apply_gap(sub):
                self._bump("dml_deferred_gap")
                return False
            header = {"commit_ts": int(commit_ts), "writes": sub,
                      "gid": gid}
            c.persistence._apply("G", header, arrays)
            if self.standby.relog_closed:
                # this node is the promoted primary (the in-doubt
                # resolver after promote): no stream brings this frame,
                # so it is logged here
                c.persistence.wal.append(b"G", header, arrays or None)
                c.persistence._record_decision(gid, "commit",
                                               int(commit_ts))
            else:
                self.standby.direct_applied.add(gid)
                # until the stream's frame lands, a promotion re-logs it
                self.standby.note_direct_apply(gid, int(commit_ts),
                                               entry["writes"])
            self._bump("dml_direct_applied")
        return True

    def _twophase_list(self) -> list:
        out = []
        d = self._twophase_dir()
        try:
            names = sorted(g for g in os.listdir(d) if not g.startswith("."))
        except OSError:
            return []
        now = time.time()
        for g in names:
            age = None
            try:
                with open(os.path.join(d, g)) as f:
                    age = now - float(json.load(f).get("prepared_at") or 0.0)
            except (OSError, ValueError):
                pass
            out.append({"gid": g, "age_s": age})
        return out

    # -- peer exchange -----------------------------------------------------
    # Producer datanodes partition their output and push each part to the
    # consumer's exchange store; the coordinator ships the address book
    # and sees row counts only (squeue.c's consumer-keyed queues).

    # below the coordinator channel's rpc timeout: a missing part means a
    # dead producer, reported as the datanode's own error
    EXCH_WAIT_S = 60.0

    def _exch_gc(self, max_age_s: float = 600.0) -> None:
        now = time.time()
        with self._exch_cv:
            for k in [k for k, born in self._exch_born.items()
                      if now - born > max_age_s]:
                self._exch.pop(k, None)
                self._exch_born.pop(k, None)

    def _exch_put(self, msg: dict) -> dict:
        key = (str(msg["xid"]), int(msg["dest"]))
        with self._exch_cv:
            self._exch.setdefault(key, {})[int(msg["from"])] = msg["batch"]
            self._exch_born.setdefault(key, time.time())
            self._exch_cv.notify_all()
        self._bump("exch_parts_in")
        self._exch_gc()
        return {"ok": True}

    def _exch_wait(self, xid: str, dest: int, producers,
                   timeout_s: float = EXCH_WAIT_S, cancelled=None):
        """Every producer's part, in producer order, or None at the
        timeout or a cancel. Pops the entry (consumed once)."""
        key = (str(xid), int(dest))
        deadline = time.time() + timeout_s
        with self._exch_cv:
            while True:
                parts = self._exch.get(key, {})
                if all(int(p) in parts for p in producers):
                    self._exch.pop(key, None)
                    self._exch_born.pop(key, None)
                    return [parts[int(p)] for p in producers]
                if cancelled is not None and cancelled():
                    return None
                left = deadline - time.time()
                if left <= 0:
                    return None
                self._exch_cv.wait(min(left, 0.25))

    def _exch_take(self, msg: dict) -> dict:
        from opentenbase_tpu_torch.plan import serde

        self._exch_gc()
        parts = self._exch_wait(msg["xid"], int(msg["dest"]),
                                msg.get("producers") or [])
        if parts is None:
            return {"error": "exchange timeout"}
        return {"ok": True, "parts": [
            serde.batch_to_wire(*p) if isinstance(p, tuple) else p
            for p in parts]}

    def _peer(self, host: str, port: int):
        from opentenbase_tpu_torch.net.pool import ChannelPool

        key = (host, int(port))
        with self._peer_mu:
            pool = self._peer_pools.get(key)
            if pool is None:
                pool = ChannelPool(host, int(port), size=2, rpc_timeout=300)
                self._peer_pools[key] = pool
            return pool

    def _motion_push(self, out, mo: dict, plan, counts=None) -> int:
        """Push each part of ``out`` to its consumer, remote pushes in
        parallel; the self-part stays a batch (no socket, no
        serialization). A redistribute's rows come grouped by
        destination with ``counts`` (slots hashed on the device), else
        they are partitioned here. Returns the bytes pushed over
        sockets."""
        from opentenbase_tpu_torch.executor.dist import (
            _slice,
            partition_batch,
        )
        from opentenbase_tpu_torch.plan import serde

        dest = mo["dest"]  # [[node, host, port], ...]
        parts: dict = {}
        if mo["kind"] == "broadcast":
            for dn, _h, _p in dest:
                parts[int(dn)] = out
        elif counts is not None:
            start = 0
            for (dn, _h, _p), c in zip(dest, counts):
                parts[int(dn)] = _slice(out, start, start + c)
                start += c
        else:  # redistribute: the one routing formula
            idx_by = partition_batch(out, mo["hash_positions"], len(dest))
            for di in range(len(dest)):
                parts[int(dest[di][0])] = out.take(idx_by[di])
        wire: dict = {}  # a broadcast serializes its one batch once
        errors: list = []
        sent: list = []
        pushers = []
        for dn, host_, port_ in dest:
            payload = {"op": "exch_put", "xid": mo["xid"], "dest": int(dn),
                       "from": int(mo["from"])}
            if (host_, int(port_)) == (self.host, self.port):
                # the self-part, as (batch, schema) for a later exch_take
                self._exch_put({**payload,
                                "batch": (parts[int(dn)], plan.schema)})
                continue
            b = parts[int(dn)]
            if id(b) not in wire:
                wire[id(b)] = serde.batch_to_wire(b, plan.schema)
            payload["batch"] = wire[id(b)]

            def push(h=host_, p=port_, pl=payload):
                try:
                    resp = self._peer(h, p).rpc(pl)
                    sent.append(resp["_wire"][0])
                    self._bump("exch_parts_out")
                except Exception as e:
                    log.warning("motion push to %s:%s failed: %s", h, p, e)
                    errors.append(e)

            th = threading.Thread(target=push, daemon=True)
            th.start()
            pushers.append(th)
        for th in pushers:
            th.join()
        if errors:
            raise errors[0]
        return sum(sent)

    # -- self-healing HA ----------------------------------------------------
    def effective_generation(self) -> int:
        """The highest fencing generation this node knows: from wire ops,
        from replayed ha_generation records, or its own promotion."""
        return max(self._hgen, self.standby.cluster.node_generation)

    def _stale_lease_remaining_ms(self, new_gen: int) -> int:
        """The longest a serving lease of a generation older than
        ``new_gen`` may still run: what failover waits out before it
        flips client routing."""
        now = time.monotonic()
        worst = 0.0
        with self._lease_mu:
            for gen, deadline in self._leases.values():
                if gen < new_gen and deadline > now:
                    worst = max(worst, deadline - now)
        return int(worst * 1000.0)

    def _promote(self, msg: dict) -> dict:
        """This datanode becomes the coordinator: its standby holds the
        whole replicated state, so it finishes recovery (the torn tail
        truncated, unstreamed direct applies re-logged, the bumped
        generation logged), goes read-write, and opens a SQL front end
        and a walsender in this process, on its device. Idempotent."""
        from opentenbase_tpu_torch.net.server import ClusterServer
        from opentenbase_tpu_torch.storage.replication import WalSender

        with self._promote_mu:
            if self._promoted_srv is None:
                # inside the promotion window: a schedule killing the
                # candidate mid-promote moves the failover to the next
                self._failpoint("dn/promote")
                gen = msg.get("generation")
                c = self.standby.promote(
                    generation=int(gen) if gen is not None else None)
                self._hgen = max(self._hgen, c.node_generation)
                self._promoted_srv = ClusterServer(c).start()
                self._promoted_walsender = WalSender(c.persistence)
                self._bump("promoted")
            c = self.standby.cluster
            out = {
                "ok": True,
                "port": self._promoted_srv.port,
                "generation": int(c.node_generation),
                "promote_lsn": int(c.ha_promote_lsn),
                "torn_bytes": int(self.standby.torn_bytes),
                "lease_remaining_ms": self._stale_lease_remaining_ms(
                    int(c.node_generation)),
                "wal_port": self._promoted_walsender.port,
                # the promoted coordinator's GTM registry: it registered
                # again under its new role
                "gtm_nodes": sorted(c.gtm_registered_nodes()),
            }
            return out

    def _repoint(self, msg: dict) -> dict:
        """Re-point this standby's walreceiver at the promoted node's
        walsender and stream from our own offset (a torn tail truncated
        first); a survivor past the new timeline's base is rewound."""
        from opentenbase_tpu_torch.storage.replication import probe_timeline

        self._failpoint("dn/repoint")
        with self._promote_mu:
            promoted = self._promoted_srv
        if promoted is not None:
            return {"error": "node is a promoted coordinator; "
                             "it does not follow anyone"}
        host = str(msg.get("wal_host") or "127.0.0.1")
        port = int(msg["wal_port"])
        try:
            _gen, promote_lsn = probe_timeline(host, port)
            if 0 <= promote_lsn < int(self.standby.applied):
                # a still-live deposed primary streamed frames here past
                # the promotion point: streaming on would fork
                return self._repoint_rewind(host, port, promote_lsn)
            self.standby.restart_replication(host, port)
        except Exception as e:
            log.error("repoint to %s:%s failed: %s", host, port, e)
            return {"error": f"repoint failed: {type(e).__name__}: {e}"}
        self._bump("repoints")
        log.warning("walreceiver re-pointed at %s:%s (resumed from %d)",
                    host, port, self.standby.applied)
        return {"ok": True, "applied": self.standby.applied}

    def _repoint_rewind(self, host: str, port: int,
                        promote_lsn: int) -> dict:
        """Rewind a diverged survivor onto the promoted timeline: stop
        the old stream, close the old cluster, and rebuild through
        ``rejoin_standby`` (the WAL truncated at the promotion point,
        the stores replayed from it, the stream restarted)."""
        from opentenbase_tpu_torch.storage.replication import rejoin_standby

        old = self.standby
        rewound = int(old.applied) - int(promote_lsn)
        try:
            old.close()
        except Exception as e:
            log.warning("rewind: closing the old standby failed: %s", e)
        try:
            sb = rejoin_standby(self._data_dir, host, port,
                                self._num_datanodes, self._shard_groups,
                                device=self.device)
        except Exception as e:
            log.error("repoint rewind to %s:%s failed: %s", host, port, e)
            return {"error": f"repoint rewind failed: "
                             f"{type(e).__name__}: {e}"}
        sb.stream_txn_hook = self._on_stream_txn
        self.standby = sb
        self._bump("repoints")
        self._bump("repoint_rewinds")
        log.warning("diverged survivor rewound %d bytes to promotion point "
                    "%d and re-pointed at %s:%s", rewound, promote_lsn,
                    host, port)
        return {"ok": True, "applied": sb.applied, "rewound": rewound}

    # -- reads ------------------------------------------------------------
    def _wait_applied(self, lsn: int, timeout_s: float = 90.0,
                      cancelled=None) -> bool:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            if self.standby.applied >= lsn:
                return True
            if cancelled is not None and cancelled():
                return False
            if self.standby.stream_error is not None:
                return False
            time.sleep(0.002)
        return False

    def _query(self, msg: dict) -> dict:
        """One read-only statement on this node's hot standby (a replica
        read); ``min_lsn`` is the caller's read-your-writes floor."""
        from opentenbase_tpu_torch.engine import SQLError

        min_lsn = int(msg.get("min_lsn", 0))
        if min_lsn and not self._wait_applied(min_lsn, timeout_s=10.0):
            return {"error": f"replication lag: replica read floor "
                             f"{min_lsn} not reached (applied "
                             f"{self.standby.applied})",
                    "sqlstate": "72001"}
        self._failpoint("dn/query")
        t0 = time.perf_counter()
        try:
            res = self.standby.session().execute(str(msg.get("sql", "")))
        except SQLError as e:
            return {"error": str(e), "sqlstate": e.sqlstate}
        self._bump("replica_reads")
        return {
            "ok": True, "tag": res.command, "columns": list(res.columns),
            "rows": [list(r) for r in res.rows], "rowcount": res.rowcount,
            "applied": self.standby.applied,
            "ms": (time.perf_counter() - t0) * 1000.0,
        }

    def _exec_fragment(self, msg: dict) -> dict:
        with self._stats_mu:
            self._inflight += 1
        try:
            return self._exec_fragment_inner(msg, int(msg["node"]))
        finally:
            with self._stats_mu:
                self._inflight -= 1

    def _exec_fragment_inner(self, msg: dict, node: int) -> dict:
        from opentenbase_tpu_torch import types as t
        from opentenbase_tpu_torch.executor.dist import concat_batches
        from opentenbase_tpu_torch.executor.local import (
            LocalExecutor,
            run_fragment_parallel,
        )
        from opentenbase_tpu_torch.plan import serde

        self._failpoint("dn/exec_fragment", node=node)
        t_start = time.perf_counter()
        token = msg.get("cancel_token")

        def cancelled() -> bool:
            return token is not None and token in self._cancelled

        def cancel_check() -> None:
            if cancelled():
                raise FragmentCancelled("fragment canceled by coordinator")

        min_lsn = int(msg.get("min_lsn", 0))
        if min_lsn and not self._wait_applied(min_lsn, cancelled=cancelled):
            if cancelled():
                self._bump("fragments_cancelled")
                return {"error": "fragment canceled by coordinator"}
            return {"error": "replication lag: wal position not reached"}
        wait_ms = (time.perf_counter() - t_start) * 1000.0
        plan = serde.loads_plan(msg["plan"])
        c = self.standby.cluster
        inputs = {int(k): serde.batch_from_wire(v, c.catalog)
                  for k, v in (msg.get("inputs") or {}).items()}
        try:
            # peer-exchanged inputs, outside the statement lock so redo
            # keeps flowing while we wait on peers
            for k, spec in (msg.get("exchanges") or {}).items():
                cancel_check()
                parts = self._exch_wait(spec["xid"], node,
                                        spec.get("producers") or [],
                                        cancelled=cancelled)
                if parts is None:
                    cancel_check()
                    return {"error": f"exchange {spec['xid']} timed out"}
                inputs[int(k)] = concat_batches(
                    [p[0] if isinstance(p, tuple)
                     else serde.batch_from_wire(p, c.catalog)
                     for p in parts])
            subquery_values = [
                (v, t.SqlType(t.TypeId(ty[0]), ty[1], ty[2]))
                for v, ty in (msg.get("subquery_values") or [])]
            mo = msg.get("motion")
            t_run = time.perf_counter()
            # under the standby's statement lock: redo never interleaves
            # with a fragment's read
            with c._exec_lock:
                cancel_check()
                fold = not msg.get("delta_scan", True)
                # polled at every operator boundary, in each block
                # worker too: an abandoned fragment stops at the next
                check = cancel_check if token is not None else None
                out, counts, ex = None, None, None
                k = int(msg.get("parallel", 1))
                if k > 1:
                    # within-fragment row-block workers; None: the shape
                    # or the size does not qualify, the serial path runs
                    out = run_fragment_parallel(
                        c.catalog, c.stores.get(node, {}),
                        msg.get("snapshot_ts"), plan, inputs,
                        subquery_values, k, device=self.device,
                        fold_on_read=fold, cancel_check=check)
                    if out is not None:
                        self._bump("parallel_fragments")
                if out is None:
                    ex = LocalExecutor(
                        c.catalog, inputs, stores=c.stores.get(node, {}),
                        snapshot_ts=msg.get("snapshot_ts"),
                        subquery_values=subquery_values, device=self.device,
                        fold_on_read=fold, cancel_check=check)
                    part = None
                    if mo is not None and mo["kind"] == "redistribute":
                        # slots on the device, as the in-process loop does
                        part = ex.run_plan_partitioned(
                            plan, mo["hash_positions"], len(mo["dest"]))
                    out, counts = ((ex.run_plan(plan), None) if part is None
                                   else part)
            run_ms = (time.perf_counter() - t_run) * 1000.0
            info = {"pruned_blocks": ex.zone_pruned_blocks if ex else 0,
                    "total_blocks": ex.zone_total_blocks if ex else 0,
                    "h2d_bytes": ex.h2d_bytes if ex else 0,
                    "wait_ms": wait_ms, "run_ms": run_ms}
            cancel_check()
            if mo is not None:
                # producer side: push the parts peer to peer; the
                # coordinator gets the row count only
                pushed = self._motion_push(out, mo, plan, counts)
                return {"ok": True, "rows": out.nrows, "bytes_out": pushed,
                        "ms": (time.perf_counter() - t_start) * 1000.0,
                        **info}
            return {"batch": serde.batch_to_wire(out, plan.schema),
                    "ms": (time.perf_counter() - t_start) * 1000.0, **info}
        except FragmentCancelled:
            self._bump("fragments_cancelled")
            return {"error": "fragment canceled by coordinator"}
        finally:
            if token is not None:
                with self._cancel_mu:
                    self._cancelled.pop(token, None)


def _rss_bytes() -> int:
    """This process's resident set (VmRSS), 0 where /proc has none."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _device_peak(device) -> Optional[int]:
    import torch

    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--wal-host", required=True)
    ap.add_argument("--wal-port", type=int, required=True)
    ap.add_argument("--listen-port", type=int, default=0)
    ap.add_argument("--num-datanodes", type=int, default=2)
    ap.add_argument("--shard-groups", type=int, default=256)
    ap.add_argument("--metrics-port", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the datanode (default cuda:0)")
    args = ap.parse_args(argv)
    if args.metrics_port:
        ap.error("--metrics-port is not ported (no metrics exporter)")
    try:
        srv = DNServer(args.data_dir, args.wal_host, args.wal_port,
                       args.num_datanodes, args.shard_groups,
                       port=args.listen_port, device=args.device).start()
    except RuntimeError as e:
        ap.error(str(e))
    print(f"READY {srv.port}", flush=True)
    done = threading.Event()
    import signal

    signal.signal(signal.SIGTERM, lambda *a: done.set())
    signal.signal(signal.SIGINT, lambda *a: done.set())
    # a timed wait: CPython runs the handler only in the main thread,
    # and a SIGTERM the kernel hands to another thread would never
    # wake an untimed one
    while not done.wait(0.5):
        pass
    t0 = time.perf_counter()
    srv.stop()
    t1 = time.perf_counter()
    srv.standby.close()
    print(f"STOPPED {srv.port}: server {t1 - t0:.3f} s, standby and WAL "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Self-healing HA (the reference's opentenbase_tpu/ha.py): the failure
detector, automatic standby promotion, fencing generations and the
resync after a failover.

The reference survives node loss with GTM standby promotion, datanode
and coordinator HA through streaming replication and ``pg_rewind``, and
``clean2pc`` for in-doubt transactions. This module is the controller
(the pgxc_ctl / Patroni role): it watches the primary's heartbeats,
declares it dead after a configured budget, promotes the most caught-up
datanode (``DNServer`` ``promote``, i.e. ``StandbyCluster.promote``),
re-points client routing and every surviving standby's WAL stream at
the promoted node, drives in-doubt 2PC votes to the promoted WAL's
decision, and later rewinds the ex-primary back in as a standby
(``storage/replication.rejoin_standby``).

Topology:

    primary Cluster ──ClusterServer── clients (RoutingClient)
        │ WalSender
        ├──────────────► DNServer 0 (StandbyCluster; candidate)
        └──────────────► DNServer 1 (StandbyCluster; candidate)

Every datanode server is both the executor of its node and a full hot
standby of the coordinator's WAL, so any of them can take over. A
promotion bumps a WAL-durable fencing generation (``node_generation``);
datanode RPCs carry it, a stale caller is refused with SQLSTATE 72000
and demotes itself (``Session._ha_demote``), and the walsender
handshake refuses a follow across timelines.

``HATopology`` runs its coordinator and datanode servers in this
process on ``device`` (cuda:0 unless the caller passes another; without
CUDA and without ``device="cpu"`` it raises, as ``Cluster`` does).

Zero lost acknowledged writes needs ``synchronous_commit = on`` in the
topology's conf: a commit is acknowledged only once every reachable
datanode applied its frame, so whichever the monitor promotes (the
reachable one with the highest ``applied``) holds every acknowledged
write.

The RPC half of a failover (ping and pick, promote, the fencing ping,
``repl_repoint``, the timeline probe, restarting in-process standbys)
is one function over (host, port) endpoints, ``failover_endpoints``:
``HATopology.failover`` drives it for its datanodes, and anything else
holding datanode processes can call it directly.

Failpoints (fault/): ``ha/probe`` (with the connectivity matrix's check
on the probe leg), ``ha/lease_renew``, ``ha/lease_check`` and
``ha/failover``. The monitor's probes travel as actor ``monitor`` and a
lease's renewals under the coordinator's name, and a failed failover's
backoff jitter comes from ``chaos_rng("ha/failover_backoff")`` under a
chaos schedule (fault/schedule.py).
"""

from __future__ import annotations

import logging
import os
import random
import socket
import threading
import time
from typing import Optional

from opentenbase_tpu_torch.fault import (
    FAULT,
    NET_CHECK,
    chaos_rng,
    set_thread_actor,
)
from opentenbase_tpu_torch.net.protocol import (
    recv_frame,
    send_frame,
    shutdown_and_close,
)

log = logging.getLogger(__name__)


def _probe_ping(host: str, port: int, timeout_s: float = 0.5):
    """One liveness probe against a ClusterServer: a fresh socket, no
    retry (a dead primary answers 'down' in one refused connect), a
    short deadline."""
    # failpoint: the failure detector's own probe (delay: a slow
    # network making a live primary look dead; drop_conn: a probe eaten
    # by a partition)
    FAULT("ha/probe", host=host, port=port)
    # the matrix: the probe leg is the one an asymmetric partition cuts
    NET_CHECK(host, port, timeout_s=timeout_s)
    sock = socket.create_connection((host, port), timeout=timeout_s)
    try:
        sock.settimeout(timeout_s)
        send_frame(sock, {"op": "ping"})
        resp = recv_frame(sock)
        if resp is None or not resp.get("ok"):
            return None
        return resp
    finally:
        shutdown_and_close(sock)


def _endpoint_rpc(host: str, port: int, msg: dict, timeout_s: float,
                  retries: int = 1) -> dict:
    """One RPC to a datanode process on a channel of its own."""
    from opentenbase_tpu_torch.net.pool import Channel

    ch = Channel(host, port, timeout=timeout_s, connect_retries=retries)
    try:
        return ch.rpc(msg, timeout_s=timeout_s)
    finally:
        ch.close()


def failover_endpoints(endpoints: list, generation: int, *, note=None,
                       standbys=(), ping_timeout_s: float = 2.0,
                       rpc_timeout_s: float = 15.0) -> dict:
    """The RPC half of a failover over datanode processes at
    ``endpoints`` ([(host, port), ...], index = datanode):

    1. ping each and pick the reachable ones, highest applied LSN first;
    2. ``promote`` the best with ``generation`` (a failed candidate
       moves the loop to the next best);
    3. fence every survivor at once (a ping carrying the promoted
       generation), so a still live deposed primary cannot land a
       phase 2 in a survivor while the heavier repoints run, then
       ``repl_repoint`` each at the promoted walsender;
    4. with ``standbys`` given, probe the promoted walsender's timeline
       (``probe_timeline``) and restart each in-process entry (a
       ``StandbyCluster``) on it; one past the timeline's base would
       fork, and raises (it needs ``rejoin_standby``'s rewind).

    ``note(kind, **fields)`` records each step (``HATopology._note``).
    Returns {"ok", "candidates", "applied" (each endpoint's applied LSN,
    None where its ping failed), "promoted", "resp" (the promote reply),
    "repointed" {node: reply}, "timeline" (generation, base) or None,
    "ms" {step: milliseconds}}; "ok" is False when no candidate
    promoted."""
    from opentenbase_tpu_torch.storage.replication import probe_timeline

    _note = note or (lambda kind, **fields: None)
    ms: dict = {}
    cands = []
    applied: list = [None] * len(endpoints)
    for i, (host, port) in enumerate(endpoints):
        try:
            p = _endpoint_rpc(host, port, {"op": "ping"}, ping_timeout_s,
                              retries=0)
        except Exception:
            continue
        if p.get("ok"):
            applied[i] = int(p.get("applied") or 0)
            cands.append((applied[i], i))
    cands.sort(reverse=True)
    out = {"ok": False, "candidates": [i for _a, i in cands],
           "applied": applied, "promoted": None, "resp": None,
           "repointed": {}, "timeline": None, "ms": ms}
    promoted = None
    t0 = time.perf_counter()
    for _applied, i in cands:
        host, port = endpoints[i]
        try:
            resp = _endpoint_rpc(host, port, {
                "op": "promote", "generation": generation,
                "hgen": generation}, rpc_timeout_s)
            if resp.get("ok"):
                promoted = (i, resp)
                break
        except Exception as e:
            _note("promote_failed", candidate=i, error=str(e)[:200])
    ms["promote"] = (time.perf_counter() - t0) * 1000.0
    if promoted is None:
        return out
    i, resp = promoted
    out.update(ok=True, promoted=i, resp=resp)
    wal_host = endpoints[i][0]
    wal_port = int(resp.get("wal_port") or 0)
    new_gen = int(resp["generation"])
    _note("promoted", node=i, generation=new_gen,
          promote_lsn=int(resp.get("promote_lsn") or 0),
          sql_port=int(resp["port"]), wal_port=wal_port)
    survivors = [j for j in range(len(endpoints)) if j != i]
    t0 = time.perf_counter()
    for j in survivors:
        try:
            _endpoint_rpc(*endpoints[j], {"op": "ping", "hgen": new_gen},
                          ping_timeout_s)
        except Exception as e:
            _note("fence_failed", node=j, error=str(e)[:200])
    for j in survivors:
        try:
            rp = _endpoint_rpc(*endpoints[j], {
                "op": "repl_repoint", "wal_host": wal_host,
                "wal_port": wal_port, "hgen": new_gen}, rpc_timeout_s)
            out["repointed"][j] = rp
            if rp.get("ok"):
                _note("repointed", node=j,
                      applied=int(rp.get("applied") or 0))
            else:
                _note("repoint_failed", node=j,
                      error=str(rp.get("error"))[:200])
        except Exception as e:
            _note("repoint_failed", node=j, error=str(e)[:200])
    ms["repoint"] = (time.perf_counter() - t0) * 1000.0
    if wal_port and standbys:
        try:
            out["timeline"] = tuple(probe_timeline(wal_host, wal_port))
        except Exception as e:
            _note("timeline_probe_failed", error=str(e)[:200])
        t0 = time.perf_counter()
        for sb in standbys:
            base = out["timeline"][1] if out["timeline"] else None
            if base is None or sb.applied > base:
                raise RuntimeError(
                    f"standby at {sb.applied} cannot follow the promoted "
                    f"timeline (base {base}) without a rewind")
            sb.restart_replication(wal_host, wal_port)
        ms["restart"] = (time.perf_counter() - t0) * 1000.0
    return out


class ServingLease:
    """A serving lease scoped to the WAL generation (the Patroni TTL
    role).

    The fencing generations stop a stale ex-primary the moment it sends
    a datanode an RPC, but a statement that sends none would still be
    served. The lease inverts the direction: the coordinator must prove
    recent contact with a datanode quorum before it serves any
    statement. A renewal thread sends ``lease_grant`` with the
    coordinator's generation to every datanode each ``ttl / 3``; a
    majority of grants extends the expiry, computed from a timestamp
    taken before the fan-out.

    An expired lease is recoverable: statements are refused (72000)
    while it is invalid and served again once a renewal succeeds. A
    fenced grant reply (a datanode at a newer generation) is permanent:
    the cluster demotes.

    ``HATopology.failover`` waits out the surviving datanodes' view of
    outstanding old-generation leases (``lease_remaining_ms`` in the
    promote reply) plus ``skew_ms`` before it flips client routing; the
    detection budget exceeding the TTL is checked when the conf
    loads (config.py)."""

    def __init__(self, cluster, endpoints: list, ttl_ms: int,
                 skew_ms: int = 100, name: str = "cn0"):
        self.cluster = cluster
        self.endpoints = [(str(h), int(p)) for h, p in endpoints]
        self.ttl_ms = int(ttl_ms)
        self.skew_ms = int(skew_ms)
        self.name = name
        self._mu = threading.Lock()
        self._expires = 0.0  # monotonic deadline; 0 = never held
        self._fenced = False
        self._was_valid = False  # the valid -> expired edge, counted once
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # channels of its own, not the statement pools: a renewal stuck
        # on a cut link must never starve a statement
        self._chans: dict = {}

    def _grant_one(self, i: int, timeout_s: float) -> bool:
        from opentenbase_tpu_torch.net.pool import Channel, ChannelFenced

        host, port = self.endpoints[i]
        ch = self._chans.get(i)
        try:
            if ch is None or ch.broken:
                ch = self._chans[i] = Channel(
                    host, port, timeout=timeout_s, connect_retries=0)
            resp = ch.rpc({
                "op": "lease_grant", "holder": self.name,
                "hgen": int(self.cluster.node_generation),
                "ttl_ms": self.ttl_ms,
            }, timeout_s=timeout_s)
            return bool(resp.get("ok"))
        except ChannelFenced:
            # a datanode at a newer generation refused us: a stale
            # ex-primary never serves again on this timeline
            with self._mu:
                self._fenced = True
            self._bump("self_demotions")
            self.cluster.ha_demoted = True
            return False
        except Exception:
            return False

    def renew(self) -> bool:
        """One renewal round; True when a datanode majority granted."""
        FAULT("ha/lease_renew", holder=self.name)
        with self._mu:
            if self._fenced:
                return False
        base = time.monotonic()  # before the fan-out: conservative
        timeout_s = max(self.ttl_ms / 3000.0, 0.05)
        grants = sum(1 for i in range(len(self.endpoints))
                     if self._grant_one(i, timeout_s))
        if grants >= len(self.endpoints) // 2 + 1:
            with self._mu:
                if not self._fenced:
                    self._expires = base + self.ttl_ms / 1000.0
                    self._was_valid = True
            return True
        return False

    def valid(self) -> bool:
        """The statement gate, checked before every statement."""
        FAULT("ha/lease_check", holder=self.name)
        with self._mu:
            if self._fenced:
                return False
            ok = time.monotonic() < self._expires
            expired = not ok and self._was_valid
            if expired:
                self._was_valid = False
        if expired:
            self._bump("lease_expirations")
            self._bump("self_demotions")
        return ok

    def remaining_ms(self) -> int:
        with self._mu:
            if self._fenced:
                return 0
            return max(int((self._expires - time.monotonic()) * 1000.0), 0)

    def _bump(self, key: str) -> None:
        st = self.cluster.ha_stats
        st[key] = st.get(key, 0) + 1

    def start(self) -> "ServingLease":
        self.renew()  # hold a lease before the first statement
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        # the renewal leg carries the coordinator's own name, so a
        # partition can cut coordinator -> datanodes while clients
        # still reach the coordinator
        set_thread_actor(self.name)
        interval = max(self.ttl_ms / 3000.0, 0.02)
        while not self._stop.wait(interval):
            try:
                self.renew()
            except Exception:
                pass  # an unrenewed lease simply runs out

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for ch in self._chans.values():
            try:
                ch.close()
            except Exception:
                pass
        self._chans.clear()


class HATopology:
    """One self-healing deployment: a primary coordinator and N datanode
    servers that double as promotion candidates, with what failover
    needs (the active address, the generation, the ex-primary's data
    directory for the rewind). ``events`` records each step.

    ``conf_gucs`` is written to every node's opentenbase.conf before
    the nodes are built, so the primary's sessions and a promoted
    node's run under the same settings."""

    def __init__(
        self,
        data_dir: str,
        num_datanodes: int = 2,
        shard_groups: int = 32,
        conf_gucs: Optional[dict] = None,
        device=None,
    ):
        from opentenbase_tpu_torch.dn.server import DNServer
        from opentenbase_tpu_torch.engine import Cluster
        from opentenbase_tpu_torch.net.server import ClusterServer
        from opentenbase_tpu_torch.storage.replication import WalSender

        self.data_dir = data_dir
        self.num_datanodes = num_datanodes
        self.shard_groups = shard_groups
        self.conf_gucs = dict(conf_gucs or {})
        self._mu = threading.Lock()
        self.events: list[dict] = []
        dirs = [os.path.join(data_dir, "cn")] + [
            os.path.join(data_dir, f"dn{i}") for i in range(num_datanodes)]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
            if self.conf_gucs:
                with open(os.path.join(d, "opentenbase.conf"), "w") as f:
                    for k, v in sorted(self.conf_gucs.items()):
                        if isinstance(v, bool):
                            v = "on" if v else "off"
                        f.write(f"{k} = {v}\n")
        self.primary_data_dir = dirs[0]
        self.primary = Cluster(num_datanodes, shard_groups,
                               self.primary_data_dir, device=device)
        self.device = self.primary.device
        self.dns: list = []
        self.server = self.sender = None
        try:
            self.server = ClusterServer(self.primary).start()
            self.sender = WalSender(self.primary.persistence, poll_s=0.01)
            for i in range(num_datanodes):
                dn = DNServer(dirs[1 + i], self.sender.host,
                              self.sender.port, num_datanodes,
                              shard_groups, device=self.device).start()
                self.dns.append(dn)
                self.primary.attach_datanode(
                    i, "127.0.0.1", dn.port, pool_size=2, rpc_timeout=30.0)
        except BaseException:
            self._teardown_nodes()
            raise
        self.generation = 0
        self.primary_dead = False
        self._active_cluster = self.primary
        self._active_addr = (self.server.host, self.server.port)
        self._active_wal = (self.sender.host, self.sender.port)
        self.promoted_index: Optional[int] = None
        self.ex_primary_server = None  # the fencing probe's revival
        self.ex_primary_standby = None  # the rejoined StandbyCluster
        # the serving lease and the flap hysteresis
        self.lease_ttl_ms = int(self.conf_gucs.get("lease_ttl_ms") or 0)
        self.lease_skew_ms = int(self.conf_gucs.get("lease_skew_ms") or 100)
        self.failover_cooldown_ms = int(
            self.conf_gucs.get("failover_cooldown_ms") or 2000)
        self.cooldown_until = 0.0  # monotonic
        self.lease: Optional[ServingLease] = None
        self.promoted_lease: Optional[ServingLease] = None
        self._dn_endpoints = [("127.0.0.1", dn.port) for dn in self.dns]
        if self.lease_ttl_ms > 0:
            self.lease = ServingLease(
                self.primary, self._dn_endpoints, self.lease_ttl_ms,
                self.lease_skew_ms, name="cn0").start()
            self.primary.serving_lease = self.lease

    # -- addresses --------------------------------------------------------
    def active_address(self) -> tuple[str, int]:
        with self._mu:
            return self._active_addr

    def active_wal_address(self) -> tuple[str, int]:
        with self._mu:
            return self._active_wal

    @property
    def active_cluster(self):
        with self._mu:
            return self._active_cluster

    def _note(self, kind: str, **fields) -> dict:
        rec = {"kind": kind, "t": time.time(), **fields}
        self.events.append(rec)
        return rec

    # -- probing ----------------------------------------------------------
    def probe_primary(self, timeout_s: float = 0.5):
        host, port = self.active_address()
        try:
            return _probe_ping(host, port, timeout_s)
        except Exception:
            return None

    def dn_ping(self, i: int, timeout_s: float = 2.0):
        try:
            return _endpoint_rpc("127.0.0.1", self.dns[i].port,
                                 {"op": "ping"}, timeout_s, retries=0)
        except Exception:
            return None

    def _dn_rpc(self, i: int, msg: dict, timeout_s: float = 15.0):
        return _endpoint_rpc("127.0.0.1", self.dns[i].port, msg, timeout_s)

    # -- the primary's death ----------------------------------------------
    def crash_primary(self) -> None:
        """Kill the coordinator as far as one process can: sever every
        client, cut the WAL stream, close its datanode pools. The
        Cluster object stays open: the 'disk and frozen process' that
        ``revive_ex_primary`` revives and ``rejoin_ex_primary``
        rewinds."""
        with self._mu:
            if self.primary_dead:
                return
            self.primary_dead = True
        self._note("crash_primary")
        for part in (self.sender, self.server):
            try:
                part.stop()
            except Exception:
                pass
        for pool in list(self.primary.dn_channels.values()):
            try:
                pool.close()
            except Exception:
                pass

    # -- failover ---------------------------------------------------------
    def failover(self, reason: str = "") -> dict:
        """The promotion sequence, each step in ``events``; once a
        candidate promoted, later calls return the recorded state:

        1. pick the reachable candidate with the highest applied LSN;
        2. ``promote`` it with the bumped fencing generation (a failed
           candidate moves on to the next best);
        3. fence every survivor at once (a ping carrying the new
           generation), then ``repl_repoint`` it at the promoted
           walsender;
        4. attach the survivors to the promoted cluster as its datanode
           channels and resolve in-doubt 2PC votes against the promoted
           WAL;
        5. flip client routing to the promoted SQL port.

        Steps 1-3 are ``failover_endpoints``."""
        # failpoint: the controller's own failover (error: a controller
        # dying mid-failover; the monitor's next beat retries)
        FAULT("ha/failover")
        with self._mu:
            if self.promoted_index is not None:
                return {"ok": True, "already": True,
                        "promoted": self.promoted_index}
            if time.monotonic() < self.cooldown_until:
                self._note("failover_suppressed", cooldown_ms_left=int(
                    (self.cooldown_until - time.monotonic()) * 1000))
                return {"ok": False, "cooldown": True,
                        "error": "failover suppressed by heal cooldown"}
            gen = self.generation + 1
        rec = self._note("failover_start", reason=reason, generation=gen)
        res = failover_endpoints(
            [("127.0.0.1", dn.port) for dn in self.dns], gen,
            note=self._note)
        rec["candidates"] = res["candidates"]
        if not res["ok"]:
            self._note("failover_failed", reason="no candidate promoted")
            return {"ok": False, "error": "no candidate promoted"}
        i, resp = res["promoted"], res["resp"]
        dn = self.dns[i]
        newc = dn.standby.cluster
        wal_port = int(resp.get("wal_port") or 0)
        new_gen = int(resp["generation"])
        for j in range(len(self.dns)):
            if j == i:
                continue
            try:
                newc.attach_datanode(j, "127.0.0.1", self.dns[j].port,
                                     pool_size=2)
            except Exception as e:
                self._note("attach_failed", node=j, error=str(e)[:200])
        # in-doubt 2PC: the promoted node's own vote journals first (it
        # is the node, not reachable over its channels), then the
        # survivors'; the promoted WAL decides: a commit record commits,
        # its absence is presumed abort
        own = 0
        try:
            for e in dn._twophase_list():
                gid = e["gid"]
                d = newc.persistence.gid_decision(gid)
                if d is not None and d[0] == "commit":
                    dn._twophase_finish({"gid": gid, "commit_ts": d[1]},
                                        committed=True)
                else:
                    dn._twophase_finish({"gid": gid}, committed=False)
                own += 1
        except Exception as e:
            self._note("own_indoubt_failed", error=str(e)[:200])
        resolved = []
        try:
            resolved = newc.resolve_indoubt()
        except Exception as e:
            self._note("resolve_indoubt_failed", error=str(e)[:200])
        self._note("indoubt_resolved", own_journals=own,
                   resolved=[list(r) for r in resolved])
        # before any client routes to the new primary, every lease the
        # old generation could still hold must have run out
        if self.lease_ttl_ms > 0:
            wait_ms = (int(resp.get("lease_remaining_ms") or 0)
                       + self.lease_skew_ms)
            if wait_ms > 0:
                self._note("lease_wait", wait_ms=wait_ms)
                time.sleep(wait_ms / 1000.0)
        newc.coordinator_name = f"dn{i}"
        if self.lease_ttl_ms > 0 and self.promoted_lease is None:
            self.promoted_lease = ServingLease(
                newc, self._dn_endpoints, self.lease_ttl_ms,
                self.lease_skew_ms, name=f"dn{i}").start()
            newc.serving_lease = self.promoted_lease
        with self._mu:
            self.generation = new_gen
            self.promoted_index = i
            self._active_cluster = newc
            self._active_addr = ("127.0.0.1", int(resp["port"]))
            if wal_port:
                self._active_wal = ("127.0.0.1", wal_port)
        self._note("failover_done", node=i)
        return {"ok": True, "promoted": i, "port": int(resp["port"]),
                "generation": new_gen}

    def note_heal(self) -> None:
        """A declared-dead primary answered a probe again before a
        failover won: arm the cooldown ``failover`` honors, so a
        flapping link cannot promote on every dip."""
        with self._mu:
            self.cooldown_until = (time.monotonic()
                                   + self.failover_cooldown_ms / 1000.0)
            c = self._active_cluster
        c.ha_stats["partition_heals"] = c.ha_stats.get(
            "partition_heals", 0) + 1
        self._note("primary_healed", cooldown_ms=self.failover_cooldown_ms)

    # -- the ex-primary: the fencing probe and the rejoin ----------------
    def revive_ex_primary(self):
        """Bring the dead coordinator back without resyncing it (the
        split-brain the fencing generations exist for): its datanode
        channels re-attached, its SQL port open. The first op it sends
        carries its stale generation and is refused (72000), demoting
        it."""
        from opentenbase_tpu_torch.net.server import ClusterServer

        for i, dn in enumerate(self.dns):
            self.primary.attach_datanode(i, "127.0.0.1", dn.port,
                                         pool_size=2)
        self.ex_primary_server = ClusterServer(self.primary).start()
        self._note("ex_primary_revived", port=self.ex_primary_server.port)
        return self.ex_primary_server

    def rejoin_ex_primary(self):
        """Rewind the ex-primary's data directory onto the promoted
        timeline and stream it: it comes back as the new standby, on
        this topology's device."""
        from opentenbase_tpu_torch.storage.replication import rejoin_standby

        if self.ex_primary_server is not None:
            try:
                self.ex_primary_server.stop()
            except Exception:
                pass
            self.ex_primary_server = None
        for node in list(self.primary.dn_channels):
            self.primary.detach_datanode(node)
        # release the dead process's WAL before the rewind truncates it
        try:
            self.primary.close()
        except Exception:
            pass
        host, port = self.active_wal_address()
        sb = rejoin_standby(self.primary_data_dir, host, port,
                            self.num_datanodes, self.shard_groups,
                            device=self.device)
        self.ex_primary_standby = sb
        self._note("ex_primary_rejoined", applied=sb.applied,
                   truncated_bytes=sb.truncated_bytes)
        return sb

    # -- teardown ---------------------------------------------------------
    def _teardown_nodes(self) -> None:
        for part in [self.server, self.sender] + list(self.dns):
            if part is not None:
                try:
                    part.stop()
                except Exception:
                    pass
        for dn in self.dns:
            try:
                dn.standby.close()
            except Exception:
                pass
        self.primary.close()

    def stop(self) -> None:
        for lease in (self.lease, self.promoted_lease):
            if lease is not None:
                try:
                    lease.stop()
                except Exception:
                    pass
        if self.ex_primary_server is not None:
            try:
                self.ex_primary_server.stop()
            except Exception:
                pass
        if self.ex_primary_standby is not None:
            try:
                self.ex_primary_standby.close()
            except Exception:
                pass
        with self._mu:
            primary_dead = self.primary_dead
        if not primary_dead:
            for part in (self.server, self.sender):
                try:
                    part.stop()
                except Exception:
                    pass
        for c in {self.active_cluster, self.primary}:
            for node in list(c.dn_channels):
                try:
                    c.detach_datanode(node)
                except Exception:
                    pass
        for dn in self.dns:
            try:
                dn.stop()
            except Exception:
                pass
        for dn in self.dns:
            try:
                dn.standby.close()
            except Exception:
                pass
        for c in {self.active_cluster, self.primary}:
            try:
                c.close()
            except Exception:
                pass


class HAMonitor:
    """The failure detector and auto-promotion loop: probes the active
    coordinator every ``failover_detect_ms / failover_beats`` ms; after
    ``failover_beats`` consecutive missed beats it declares the primary
    dead and drives ``HATopology.failover``. A single missed beat never
    promotes; a failed failover backs off exponentially with jitter.
    ``detect_ms`` and ``beats`` override the topology's conf (a chaos
    schedule sets them)."""

    def __init__(self, topology: HATopology, detect_ms: Optional[int] = None,
                 beats: Optional[int] = None):
        conf = topology.conf_gucs
        if detect_ms is None:
            detect_ms = int(conf.get("failover_detect_ms") or 3000)
        if beats is None:
            beats = int(conf.get("failover_beats") or 3)
        self.topology = topology
        self.detect_ms = int(detect_ms)
        self.beats = max(int(beats), 1)
        self.interval_s = self.detect_ms / self.beats / 1000.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()  # the beat counters
        self.misses = 0
        self.declared_dead_at: Optional[float] = None
        self.promotions = 0
        self.last_failover: Optional[dict] = None
        self.failover_retry_max_ms = int(
            conf.get("failover_retry_max_ms") or 10000)
        self._fo_attempts = 0
        self._next_fo_at = 0.0  # monotonic
        self.failover_retries = 0

    def start(self) -> "HAMonitor":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        # the monitor's probes travel as "monitor" in the matrix: the leg
        # an asymmetric partition severs while clients still connect
        set_thread_actor("monitor")
        while not self._stop.wait(self.interval_s):
            try:
                self._beat()
            except Exception as e:
                self.topology._note("monitor_error", error=str(e)[:200])

    def _beat(self) -> None:
        topo = self.topology
        if topo.promoted_index is not None:
            return  # failed over: this monitor's job is done
        probe = topo.probe_primary(timeout_s=min(self.interval_s, 0.5))
        if probe is not None:
            with self._mu:
                healed = self.declared_dead_at is not None
                self.misses = 0
                self.declared_dead_at = None
                self._fo_attempts = 0
                self._next_fo_at = 0.0
            if healed:
                topo.note_heal()
            return
        with self._mu:
            self.misses += 1
            misses = self.misses
            declare = misses >= self.beats and self.declared_dead_at is None
            if declare:
                self.declared_dead_at = time.time()
        if misses < self.beats:
            return
        if declare:
            topo._note("declared_dead", misses=misses,
                       detect_ms=self.detect_ms, beats=self.beats)
        with self._mu:
            if time.monotonic() < self._next_fo_at:
                return
        res = topo.failover(reason=f"{misses} consecutive missed beats")
        with self._mu:
            self.last_failover = res
            if res.get("ok") and not res.get("already"):
                self.promotions += 1
                self._fo_attempts = 0
                self._next_fo_at = 0.0
            elif not res.get("ok"):
                self._fo_attempts += 1
                self.failover_retries += 1
                delay = min(self.interval_s * (2 ** self._fo_attempts),
                            self.failover_retry_max_ms / 1000.0)
                # full jitter, replayable from a chaos schedule's seed
                rng = chaos_rng("ha/failover_backoff")
                draw = rng.random() if rng is not None else random.random()
                self._next_fo_at = (time.monotonic()
                                    + delay * (0.5 + draw * 0.5))
        if not res.get("ok"):
            st = topo.active_cluster.ha_stats
            st["failover_retries"] = st.get("failover_retries", 0) + 1

    def stats(self) -> dict:
        with self._mu:
            return {
                "misses": self.misses,
                "declared_dead_at": self.declared_dead_at,
                "promotions": self.promotions,
                "last_failover": self.last_failover,
                "failover_retries": self.failover_retries,
            }


class RoutingClient:
    """Client routing that follows the active coordinator: a thin
    ClientSession wrapper that resolves ``HATopology.active_address``
    again whenever its connection dies or the server answers with the
    fenced SQLSTATE (72000: it reached a stale ex-primary). Statement
    errors are not retried here; the caller decides."""

    def __init__(self, topology: HATopology, timeout: float = 15.0):
        self.topology = topology
        self.timeout = timeout
        self._sess = None

    def _drop(self) -> None:
        if self._sess is not None:
            try:
                self._sess.close()
            except Exception:
                pass
            self._sess = None

    def _ensure(self):
        from opentenbase_tpu_torch.net.client import ClientSession

        if self._sess is None:
            host, port = self.topology.active_address()
            self._sess = ClientSession(host, port, timeout=self.timeout,
                                       connect_retries=1)
        return self._sess

    def execute(self, sql: str):
        from opentenbase_tpu_torch.net.client import WireError

        try:
            return self._ensure().execute(sql)
        except WireError as e:
            if (getattr(e, "sqlstate", None) == "72000"
                    or "connection closed" in str(e)):
                self._drop()  # a stale or dead node: resolve again
            raise
        except OSError:
            self._drop()
            raise

    def query(self, sql: str):
        return self.execute(sql).rows

    def close(self) -> None:
        self._drop()

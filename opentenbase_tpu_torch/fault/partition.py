"""The seeded connectivity matrix (the reference's
opentenbase_tpu/fault/partition.py) — asymmetric partitions and gray links.

The failpoint registry (fault/__init__.py) injects failures at ONE
named site; a network partition is a property of a *pair* of nodes, and
the failures that actually split brains are asymmetric: the monitor
cannot see the primary while clients still can (a gray switch port, an
iptables rule on one leg, an overloaded NIC queue). Following the
Jepsen nemesis model, this module keeps a process-global matrix of
directed (src actor -> dst endpoint) rules that every wire boundary
consults through ``NET_CHECK(host, port)``:

    cut(src, dst)            drop the directed link (ConnectionReset)
    partition(a_group, b_group)  cut all pairs, both directions
    slow_link(src, dst, ms)  gray link: delay (or blow the caller's
                             deadline when ms exceeds it)
    heal(src, dst) / heal_all()  lift rules; fires the
                             ``fault/partition_heal`` failpoint

Endpoints are registered by listen port (``register_endpoint``), so the
check resolves a (host, port) connect/send target back to a node name.
The SOURCE side is a thread-local actor name: the HA monitor thread
runs under ``net_actor("monitor")``, a CN's lease-renewal thread under
its own name, and everything else defaults to ``"client"`` — which is
exactly what makes monitor⊘primary-while-clients↔primary expressible.

With no matrix installed the check is one module-global ``is None``
test, the same zero-cost discipline as FAULT(). Rules accept ``"*"``
wildcards on either side. All mutation is lock-protected; the schedule
seed governs any randomized use through ``chaos_rng`` at the caller.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional

from opentenbase_tpu_torch.fault import FAULT, FaultDropConnection

_tl = threading.local()


def current_actor() -> str:
    return getattr(_tl, "actor", "client")


def set_thread_actor(name: Optional[str]) -> None:
    """Pin THIS thread's actor name for matrix checks (None resets to
    the default ``client``). Long-lived loops (HA monitor, lease
    renewal) pin once at thread start."""
    _tl.actor = name or "client"


class net_actor:
    """Context manager: run a block as ``name`` for matrix purposes."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._prev = getattr(_tl, "actor", None)
        _tl.actor = self.name
        return self

    def __exit__(self, *exc):
        if self._prev is None:
            try:
                del _tl.actor
            except AttributeError:
                pass
        else:
            _tl.actor = self._prev


class NetMatrix:
    """Directed connectivity rules between named actors/endpoints."""

    def __init__(self):
        self._mu = threading.Lock()
        self._ports: dict[int, str] = {}      # listen port -> node name
        self._cuts: set[tuple] = set()        # (src, dst) directed
        self._slow: dict[tuple, int] = {}     # (src, dst) -> ms
        self.stats = {"drops": 0, "delays": 0, "heals": 0}

    # -- topology registry ------------------------------------------------
    def register_endpoint(self, name: str, *ports: int) -> None:
        """Map every listen port of ``name`` (SQL front end, DN RPC,
        walsender...) back to the node, so a connect target resolves."""
        with self._mu:
            for p in ports:
                self._ports[int(p)] = name

    def endpoint_for_port(self, port: int) -> Optional[str]:
        with self._mu:
            return self._ports.get(int(port))

    # -- rule management --------------------------------------------------
    def cut(self, src: str, dst: str) -> None:
        """Drop the DIRECTED src->dst link ("*" wildcards either side).
        One-directional on purpose: asymmetric partitions are the whole
        point."""
        with self._mu:
            self._cuts.add((src, dst))

    def partition(self, group_a, group_b) -> None:
        """Full split: cut every a<->b pair in both directions."""
        with self._mu:
            for a in group_a:
                for b in group_b:
                    self._cuts.add((a, b))
                    self._cuts.add((b, a))

    def slow_link(self, src: str, dst: str, ms: int) -> None:
        """Gray link: src->dst traffic is delayed ``ms`` (and times out
        instead when the delay exceeds the caller's own deadline)."""
        with self._mu:
            self._slow[(src, dst)] = int(ms)

    def heal(self, src: str, dst: str) -> int:
        """Lift rules matching (src, dst) exactly, both cut and slow.
        Returns the number of rules removed; fires the
        ``fault/partition_heal`` failpoint when any were."""
        with self._mu:
            n = 0
            if (src, dst) in self._cuts:
                self._cuts.discard((src, dst))
                n += 1
            if self._slow.pop((src, dst), None) is not None:
                n += 1
            if n:
                self.stats["heals"] += 1
        if n:
            self._heal_fired(src, dst)
        return n

    def heal_all(self) -> int:
        with self._mu:
            n = len(self._cuts) + len(self._slow)
            self._cuts.clear()
            self._slow.clear()
            if n:
                self.stats["heals"] += 1
        if n:
            self._heal_fired("*", "*")
        return n

    def _heal_fired(self, src: str, dst: str) -> None:
        """The one heal boundary: a targeted heal() and a blanket
        heal_all() both announce through this failpoint."""
        FAULT("fault/partition_heal", src=src, dst=dst)

    # -- queries ----------------------------------------------------------
    def _match(self, rules, src: str, dst: str):
        for key in ((src, dst), (src, "*"), ("*", dst), ("*", "*")):
            if key in rules:
                return key
        return None

    def is_cut(self, src: str, dst: str) -> bool:
        with self._mu:
            return self._match(self._cuts, src, dst) is not None

    def slow_ms(self, src: str, dst: str) -> int:
        with self._mu:
            key = self._match(self._slow, src, dst)
            return self._slow[key] if key is not None else 0

    def partitioned_peers(self, name: str) -> list:
        """Endpoint names this node currently cannot reach (outbound
        cuts from ``name``) — the pg_cluster_health column."""
        with self._mu:
            known = sorted(set(self._ports.values()) - {name})
            out = []
            for peer in known:
                if self._match(self._cuts, name, peer) is not None:
                    out.append(peer)
            return out

    def describe(self) -> dict:
        with self._mu:
            return {
                "cuts": sorted(self._cuts),
                "slow": sorted(
                    (s, d, ms) for (s, d), ms in self._slow.items()
                ),
                "stats": dict(self.stats),
            }


# THE hot-path gate, same discipline as fault._ARMED: module-global
# None unless a chaos run installed a matrix.
_MATRIX: Optional[NetMatrix] = None


def install_matrix(m: Optional[NetMatrix]) -> Optional[NetMatrix]:
    """Install (or, with None, remove) the process connectivity matrix;
    returns the previous one."""
    global _MATRIX
    prev, _MATRIX = _MATRIX, m
    return prev


def active_matrix() -> Optional[NetMatrix]:
    return _MATRIX


def partitioned_peers(name: str) -> list:
    m = _MATRIX
    return m.partitioned_peers(name) if m is not None else []


def NET_CHECK(host: str, port: int, timeout_s: Optional[float] = None) -> None:
    """Consult the matrix for the current thread's actor sending to
    (host, port). No-op when no matrix is installed or the port is not
    a registered endpoint. A cut link raises FaultDropConnection (the
    same ConnectionResetError every wire path already handles); a slow
    link sleeps — and when the delay would blow the caller's own
    deadline, sleeps out the deadline and raises socket.timeout, which
    is what a real gray link does to a bounded probe."""
    m = _MATRIX
    if m is None:
        return
    dst = m.endpoint_for_port(port)
    if dst is None:
        return
    src = current_actor()
    if m.is_cut(src, dst):
        with m._mu:
            m.stats["drops"] += 1
        raise FaultDropConnection(
            f"partition: {src}->{dst} ({host}:{port}) is cut"
        )
    ms = m.slow_ms(src, dst)
    if ms > 0:
        with m._mu:
            m.stats["delays"] += 1
        if timeout_s is not None and ms / 1000.0 > timeout_s:
            time.sleep(timeout_s)
            raise socket.timeout(
                f"gray link: {src}->{dst} slower ({ms}ms) than "
                f"deadline ({timeout_s}s)"
            )
        time.sleep(ms / 1000.0)

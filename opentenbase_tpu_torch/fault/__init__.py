"""The failpoint registry (the reference's opentenbase_tpu/fault/__init__.py).

Every distributed boundary of the engine carries a named FAULT site:

    from opentenbase_tpu_torch.fault import FAULT
    FAULT("dn/exec_fragment", node=node)

With nothing armed the call is one module-dict lookup returning None: no
allocation, no branch beyond ``is None``. Arming goes through SQL admin
functions on a session with ``fault_injection = on``:

    select pg_fault_inject('dn/exec_fragment', 'error', 'node=1, every(1)')
    select pg_fault_clear()

Actions
    error        raise FaultError at the site
    delay(ms)    sleep ms, then continue
    hang(ms)     sleep ms (an unresponsive peer; a name of its own so
                 pg_stat_faults reads honestly)
    drop_conn    raise FaultDropConnection, a ConnectionResetError, so
                 every net path treats it as a peer reset
    crash_node   site-handled: a datanode server stops listening and
                 drops every connection (the process stays)
    wal_torn     site-handled: the walsender tears the outgoing chunk at
                 byte-arbitrary positions

Triggers (evaluated per armed-site hit, deterministically)
    once         fire on the first hit, then disarm           (default)
    every(n)     fire on every n-th hit
    after(n)     skip the first n hits, fire on all later ones
    prob(p, s)   fire with probability p from random.Random(s)

Extra ``k=v`` items in the spec are context filters matched against the
keyword arguments the site passes (``node=1`` fires only for that
datanode's hits). Hits that do not match do not count.

The registry is per process. ``pg_fault_inject`` on the coordinator
forwards the arm and the clear to every attached datanode process
(dn/server.py ``fault_arm`` / ``fault_clear``); ``pg_stat_faults``
aggregates both. A firing is logged on this module's logger (the
reference writes it to its server-log ring, which the port does not
have yet).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)

__all__ = [
    "FAULT",
    "FaultError",
    "FaultDropConnection",
    "ACTIONS",
    "inject",
    "clear",
    "stats",
    "armed",
    "site_rng",
    "wait_rows",
    "set_chaos_seed",
    "chaos_seed",
    "chaos_rng",
    # connectivity matrix (fault/partition.py) — re-exported so wire
    # boundaries import one module for both failure planes
    "NET_CHECK",
    "NetMatrix",
    "install_matrix",
    "active_matrix",
    "partitioned_peers",
    "net_actor",
    "set_thread_actor",
    "current_actor",
]


class FaultError(RuntimeError):
    """Injected failure (the ``error`` action). ``sqlstate`` classes it
    as an internal error so the wire front ends report it plainly."""

    sqlstate = "XX000"


class FaultDropConnection(ConnectionResetError):
    """Injected connection loss (the ``drop_conn`` action). Inherits
    ConnectionResetError (itself a ConnectionError/OSError) so every
    existing I/O path — channel discard, walreceiver exit, server loop
    teardown, and crucially connect_with_retry's retryable-class check —
    treats it exactly like a real peer reset without knowing about
    faults."""


# action name -> takes_ms_arg. crash_node / wal_torn are *site-handled*:
# FAULT() returns the action string and the hosting code reacts (a
# generic raise could not stop a listener or tear a TCP chunk).
ACTIONS = {
    "error": False,
    "delay": True,
    "hang": True,
    "drop_conn": False,
    "crash_node": False,
    "wal_torn": False,
}

_SITE_HANDLED = {"crash_node", "wal_torn"}


class _Fault:
    """One armed failpoint."""

    __slots__ = (
        "site", "action", "ms", "trigger", "n", "p", "seed",
        "filters", "hits", "fired", "_rng", "_disarmed",
    )

    def __init__(self, site, action, ms, trigger, n, p, seed, filters):
        self.site = site
        self.action = action
        self.ms = ms
        self.trigger = trigger      # once | every | after | prob
        self.n = n
        self.p = p
        self.seed = seed
        self.filters = filters      # dict of ctx key -> expected str value
        self.hits = 0               # armed-site evaluations (post-filter)
        self.fired = 0
        self._rng = random.Random(seed) if trigger == "prob" else None
        self._disarmed = False

    # -- trigger ---------------------------------------------------------
    def _should_fire(self) -> bool:
        self.hits += 1
        if self._disarmed:
            return False
        if self.trigger == "once":
            self._disarmed = True
            return True
        if self.trigger == "every":
            return self.hits % self.n == 0
        if self.trigger == "after":
            return self.hits > self.n
        # prob(p, seed): one deterministic draw per hit — replaying the
        # same seed replays the same fire/skip pattern exactly. Inside
        # an active chaos schedule the draw comes from the schedule's
        # own per-site stream instead, so the WHOLE run replays from
        # the one schedule seed (fault/schedule.py).
        rng = chaos_rng(f"fault/{self.site}") or self._rng
        return rng.random() < self.p

    def _matches(self, ctx: dict) -> bool:
        if not self.filters:
            return True
        for k, want in self.filters.items():
            if str(ctx.get(k)) != want:
                return False
        return True

    def evaluate(self, ctx: dict) -> Optional[str]:
        # a fault WITH filters never matches a site that passes no
        # context: the filter key simply isn't there (same rule as a
        # present-but-different value), not a wildcard
        if not self._matches(ctx):
            return None
        with _mu:
            st = _stats.setdefault(self.site, [0, 0, 0])
            st[1] += 1
            fire = self._should_fire()
            if fire:
                self.fired += 1
                st[2] += 1
                if self._disarmed and _ARMED.get(self.site) is self:
                    # compare-and-remove THIS fault only: an operator
                    # may have re-armed the site concurrently, and a
                    # blind pop would silently disarm their fresh fault
                    _ARMED.pop(self.site, None)
        if not fire:
            return None
        # every firing leaves a log record, so a chaos run can be
        # reconstructed from the log as well as from pg_stat_faults
        log.info("fault fired at %r: %s (fired %d)%s", self.site,
                 self.action_str(), self.fired,
                 "".join(f" {k}={v}" for k, v in ctx.items()))
        if self.action == "error":
            raise FaultError(f"fault injected at {self.site!r}")
        if self.action in ("delay", "hang"):
            # the injected stall is a real wait: record it so
            # pg_stat_wait_events tells the truth about where a chaos
            # run's time went (type FaultInjection, event = the site)
            t0 = time.monotonic()
            time.sleep(self.ms / 1000.0)
            waited_ms = (time.monotonic() - t0) * 1000.0
            with _mu:
                ent = _wait_stats.setdefault(self.site, [0, 0.0])
                ent[0] += 1
                ent[1] += waited_ms
            return self.action
        if self.action == "drop_conn":
            raise FaultDropConnection(
                f"fault injected at {self.site!r}: connection dropped"
            )
        return self.action  # crash_node / wal_torn: the site reacts

    def describe(self) -> str:
        if self.trigger == "every":
            trig = f"every({self.n})"
        elif self.trigger == "after":
            trig = f"after({self.n})"
        elif self.trigger == "prob":
            trig = f"prob({self.p}, {self.seed})"
        else:
            trig = "once"
        if self.filters:
            trig += ", " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.filters.items())
            )
        return trig

    def action_str(self) -> str:
        if self.action in ("delay", "hang"):
            return f"{self.action}({self.ms})"
        return self.action


# -- chaos-schedule RNG (fault/schedule.py) -----------------------------
# While a seeded chaos run is active, EVERY source of randomness the
# fault plane touches — prob(p) fault draws armed without an explicit
# seed, connect_with_retry's backoff jitter (net/client.py), the
# schedule's own event/traffic choices — derives from ONE schedule seed
# so a failing run replays from that seed alone. Per-NAME child streams
# (not one shared stream) keep the replay honest under threads: each
# named consumer draws its own deterministic sequence regardless of how
# the OS interleaves them.
_CHAOS_SEED: Optional[int] = None
_chaos_rngs: dict = {}
# own lock, NOT _mu: chaos_rng is consulted from inside
# _Fault._should_fire, which already runs under _mu
_chaos_mu = threading.Lock()


def set_chaos_seed(seed: Optional[int]) -> None:
    """Arm (or, with None, disarm) the schedule-owned RNG plane. Also
    resets the derived per-name streams so a re-run of the same seed
    replays the same draw sequences."""
    global _CHAOS_SEED
    with _chaos_mu:
        _CHAOS_SEED = seed
        _chaos_rngs.clear()


def chaos_seed() -> Optional[int]:
    return _CHAOS_SEED


def chaos_rng(name: str) -> Optional[random.Random]:
    """The deterministic child stream for ``name`` (None when no chaos
    run is active). The child seed mixes the schedule seed with the
    name through a stable hash — Python's builtin hash() is salted per
    process and would break replay."""
    if _CHAOS_SEED is None:
        return None
    with _chaos_mu:
        if _CHAOS_SEED is None:
            return None
        rng = _chaos_rngs.get(name)
        if rng is None:
            import zlib

            child = (_CHAOS_SEED << 32) ^ zlib.crc32(name.encode())
            rng = _chaos_rngs[name] = random.Random(child)
        return rng


# site -> _Fault. THE hot-path gate: empty and untouched unless an
# operator armed something, so FAULT() below is one dict lookup.
_ARMED: dict = {}
# site -> [arms, hits, fired]; survives clear() so pg_stat_faults keeps
# telling the story of a chaos run after the faults are disarmed
_stats: dict = {}
# site -> [count, total_ms] of injected delay/hang windows — the
# FaultInjection wait-event rows merged into pg_stat_wait_events
_wait_stats: dict = {}
_mu = threading.Lock()


def FAULT(site: str, **ctx) -> Optional[str]:
    """The failpoint hook. Returns None (the overwhelmingly common
    case), sleeps (delay/hang), raises (error/drop_conn), or returns a
    site-handled action name (crash_node/wal_torn). CPython's
    vectorcall protocol makes the off-path allocation-free even with
    keyword context."""
    f = _ARMED.get(site)
    if f is None:
        return None
    return f.evaluate(ctx)


def _split_spec(spec: str) -> list:
    """Split the spec on top-level commas only — ``prob(0.5, 42)``
    keeps its seed."""
    out, cur, depth = [], [], 0
    for ch in spec:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(depth - 1, 0)
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _parse_spec(spec: str):
    """Parse the third pg_fault_inject argument: comma-separated trigger
    (``once`` / ``every(n)`` / ``after(n)`` / ``prob(p, seed)``) and
    ``k=v`` context filters, in any order."""
    trigger, n, p, seed = "once", 1, 0.0, 0
    filters: dict = {}
    for item in _split_spec(spec or ""):
        item = item.strip()
        if not item:
            continue
        low = item.lower()
        if low == "once":
            trigger = "once"
        elif low.startswith("every(") and low.endswith(")"):
            trigger, n = "every", int(low[6:-1])
            if n < 1:
                raise ValueError("every(n) requires n >= 1")
        elif low.startswith("after(") and low.endswith(")"):
            trigger, n = "after", int(low[6:-1])
        elif low.startswith("prob(") and low.endswith(")"):
            # accept prob(p, seed), prob(p; seed), prob(p seed), prob(p)
            inner = low[5:-1].replace(";", " ").replace(",", " ")
            parts = inner.split()
            if len(parts) == 1:
                parts = [parts[0], "0"]
            trigger, p, seed = "prob", float(parts[0]), int(parts[1])
            if not 0.0 <= p <= 1.0:
                raise ValueError("prob(p, seed) requires 0 <= p <= 1")
        elif "=" in item:
            k, _, v = item.partition("=")
            filters[k.strip()] = v.strip()
        else:
            raise ValueError(f"unrecognized fault spec item {item!r}")
    return trigger, n, p, seed, filters


def _parse_action(action: str):
    a = (action or "").strip().lower()
    ms = 0
    if "(" in a and a.endswith(")"):
        name, _, arg = a[:-1].partition("(")
        name = name.strip()
        if name not in ACTIONS or not ACTIONS[name]:
            raise ValueError(f"unknown fault action {action!r}")
        ms = int(float(arg.strip() or 0))
        return name, ms
    if a not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r}")
    if ACTIONS[a]:
        raise ValueError(f"action {a!r} requires (ms)")
    return a, ms


# prob(p, seed) specs hold "p, seed" — but the spec itself splits on
# commas, so accept "prob(0.5; 42)" and "prob(0.5 42)" forms too; the
# SQL surface passes the whole spec as one string either way.


def inject(site: str, action: str, spec: str = "") -> _Fault:
    """Arm one failpoint (pg_fault_inject's engine half). Re-arming a
    site replaces the previous fault."""
    if not site or not isinstance(site, str):
        raise ValueError("fault site must be a non-empty string")
    name, ms = _parse_action(action)
    trigger, n, p, seed, filters = _parse_spec(spec)
    f = _Fault(site, name, ms, trigger, n, p, seed, filters)
    with _mu:
        # arm under the same lock evaluate()'s compare-and-remove
        # holds, so a spent 'once' fault can never pop a replacement
        _stats.setdefault(site, [0, 0, 0])[0] += 1
        _ARMED[site] = f
    return f


def clear(site: Optional[str] = None) -> int:
    """Disarm one site, or every site (pg_fault_clear). Counters in
    ``stats()`` survive so a chaos run stays auditable."""
    if site is not None:
        return 1 if _ARMED.pop(site, None) is not None else 0
    k = len(_ARMED)
    _ARMED.clear()
    return k


def reset_stats() -> None:
    """Forget the cumulative counters too (test isolation)."""
    with _mu:
        _stats.clear()
        _wait_stats.clear()


def wait_rows() -> list:
    """[(site, count, total_ms)] — injected delay/hang windows, the
    FaultInjection wait-event rows (pg_stat_wait_events merges them;
    pg_stat_reset leaves them alone — fault telemetry is owned by
    pg_fault_clear/reset_stats)."""
    with _mu:
        return [
            (site, ent[0], round(ent[1], 3))
            for site, ent in sorted(_wait_stats.items())
        ]


def armed() -> dict:
    """site -> armed _Fault (live registry view)."""
    return dict(_ARMED)


def stats() -> list:
    """[(site, action, trigger, arms, hits, fired, armed)] — the local
    process's pg_stat_faults rows."""
    out = []
    with _mu:
        sites = set(_stats) | set(_ARMED)
        for site in sorted(sites):
            arms, hits, fired = _stats.get(site, [0, 0, 0])
            f = _ARMED.get(site)
            out.append((
                site,
                f.action_str() if f is not None else "",
                f.describe() if f is not None else "",
                arms, hits, fired,
                f is not None,
            ))
    return out


def site_rng(site: str) -> random.Random:
    """The armed fault's deterministic RNG (site-handled actions like
    wal_torn use it to pick byte-arbitrary tear positions so a seeded
    chaos run replays identically); inside an active chaos schedule,
    the schedule's per-site stream; else a fresh seeded RNG if the
    fault has none."""
    rng = chaos_rng(f"fault/{site}")
    if rng is not None:
        return rng
    f = _ARMED.get(site)
    if f is not None and f._rng is not None:
        return f._rng
    return random.Random(f.seed if f is not None else 0)


# bottom import: partition.py needs FAULT/FaultDropConnection from this
# module, so the re-export has to come after they exist
from opentenbase_tpu_torch.fault.partition import (  # noqa: E402
    NET_CHECK,
    NetMatrix,
    active_matrix,
    current_actor,
    install_matrix,
    net_actor,
    partitioned_peers,
    set_thread_actor,
)

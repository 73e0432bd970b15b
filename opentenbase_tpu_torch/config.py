"""Settings and the configuration file (the reference's
opentenbase_tpu/config.py, cut to the settings the port acts on).

A cluster with a data directory reads ``<data_dir>/opentenbase.conf``
(``name = value`` lines, ``#`` comments) into ``Cluster.conf_gucs``:
the session defaults of the settings below, and the HA controller's
(ha.py) detection, lease and hysteresis budgets. Each value is
validated as the reference validates it. A setting the reference knows
and the port does not act on is refused by name (``NotPorted``, with
the ROADMAP item that brings its subsystem) when the cluster is built
or a session SETs it, so a conf file never quietly means less than it
says; an unknown name is an error unless it is namespaced with a dot
(PostgreSQL's custom-variable rule).
"""

from __future__ import annotations

import os
from typing import Optional

from opentenbase_tpu_torch.errors import NotPorted


class GucError(ValueError):
    pass


def _bool(v):
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("true", "on", "yes", "1"):
        return True
    if s in ("false", "off", "no", "0"):
        return False
    raise GucError(f"invalid boolean: {v!r}")


def _str(v):
    return str(v)


def _int(v):
    if isinstance(v, bool):
        raise GucError(f"invalid integer: {v!r}")
    try:
        return int(v)
    except (TypeError, ValueError):
        raise GucError(f"invalid integer: {v!r}") from None


_DURATION_UNITS = {"us": 0.001, "ms": 1, "s": 1000, "min": 60000, "h": 3600000}


def _duration(v):
    """int milliseconds, or a PG duration string ('150ms', '2s')."""
    if isinstance(v, bool):
        raise GucError(f"invalid duration: {v!r}")
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip()
    for unit, mult in sorted(
        _DURATION_UNITS.items(), key=lambda kv: -len(kv[0])
    ):
        if s.endswith(unit):
            num = s[: -len(unit)].strip()
            try:
                return int(float(num) * mult)
            except ValueError:
                break
    try:
        return int(s)
    except ValueError:
        raise GucError(f"invalid duration: {v!r}") from None


def _enum(*allowed):
    def f(v):
        if isinstance(v, bool):
            v = "on" if v else "off"
        s = str(v).lower()
        if s not in allowed:
            raise GucError(f"must be one of {allowed}, got {v!r}")
        return s

    return f


# name -> (validator, default), the reference's entries for the
# settings the port acts on; None: the engine decides
GUCS: dict = {
    "enable_fused_execution": (_bool, True),
    # TLS is not ported: only "off" is taken (otb_server refuses "on"
    # by name before it builds a cluster)
    "ssl": (_bool, False),
    # the reference's names for the two kernel routes, so conf files
    # written for it load unchanged: K1 (csrc/scan_agg.cu) for a
    # single partial-aggregate fragment, K2 (csrc/radix_probe.cu) for
    # the fused DAG's radix joins. None (the default) is on: the kernel
    # on the card, its wrapper's plain version on a CPU tensor. Off
    # takes the fragment program, or the DAG's other join modes
    "enable_pallas_scan": (_bool, None),
    "enable_pallas_join": (_bool, None),
    # the fused DAG's join formulation: 'auto' picks fold > radix >
    # sort-merge by the planner's estimates; forcing one is for tests,
    # EXPLAIN checks and triage
    "join_mode": (_enum("auto", "radix", "sortmerge"), "auto"),
    # the device bytes the radix join's batch planner sizes its tables
    # against (plan/batchplan.py); 0 = the env knob, else the default
    "device_memory_limit": (_int, 0),
    # accepted and stored, as the reference does (no fast-query-
    # shipping planner, one flat namespace, no NOTICE channel)
    "enable_fast_query_shipping": (_bool, True),
    "search_path": (_str, "public"),
    "session_authorization": (_str, None),
    "role": (_str, None),
    "application_name": (_str, ""),
    "client_min_messages": (
        _enum("debug", "log", "notice", "warning", "error"), "notice",
    ),
    "statement_timeout": (_duration, 0),
    # self-healing reads (executor/dist.py): extra attempts for a failed
    # remote read fragment before it fails over to the coordinator's
    # own stores; writes never retry
    "fragment_retries": (_int, 2),
    "fragment_retry_backoff_ms": (_duration, 25),
    # the HA controller (ha.py): the monitor probes every
    # failover_detect_ms / failover_beats and promotes after
    # failover_beats consecutive missed beats
    "failover_detect_ms": (_duration, 3000),
    "failover_beats": (_int, 3),
    # the serving lease (ha.ServingLease); 0 = leases off
    "lease_ttl_ms": (_duration, 0),
    "lease_skew_ms": (_duration, 100),
    "failover_retry_max_ms": (_duration, 10000),
    "failover_cooldown_ms": (_duration, 2000),
    "synchronous_commit": (
        _enum("off", "local", "remote_write", "on"), "local",
    ),
    "enable_group_commit": (_bool, True),
    "commit_delay_us": (_int, 0),
    "commit_siblings": (_int, 5),
    # multi-row INSERT ... VALUES of plain literals (and a prepared
    # INSERT's EXECUTE) build per-column arrays without a plan; off =
    # the general pipeline (the differential's baseline)
    "enable_bulk_insert_rewrite": (_bool, True),
    # row and table lock waits (lmgr.py); 0 = no lock timeout
    "lock_timeout": (_duration, 0),
    "deadlock_timeout": (_duration, 1000),
    # the background delta compaction job (storage/compaction.py); 0 =
    # none: deltas fold at VACUUM, past MAX_DELTAS or by compact_deltas
    "delta_compaction_naptime_ms": (_duration, 0),
    # scans read base rows and pending delta batches without folding
    # them (on); off restores fold on read: host scans fold first, the
    # device cache compacts before a refresh and keeps the flat
    # >8-entry MVCC full-plane cutoff (bench.py's HTAP baseline)
    "enable_delta_scan": (_bool, True),
    # within-fragment parallel workers a datanode process runs a
    # fragment's base scan on (executor/local.py run_fragment_parallel)
    "dn_parallel_workers": (_int, 4),
    # workload management (wlm/): every statement's memory estimate is
    # at least work_mem (bytes); resource_group overrides the role's
    # binding ('' = ALTER ROLE ... RESOURCE GROUP, else default_group);
    # wlm_queue_timeout caps the admission-queue wait when
    # statement_timeout is 0 (0 = no cap)
    "work_mem": (_int, 65536),
    "resource_group": (_str, ""),
    "wlm_queue_timeout": (_duration, 0),
    # answer a SELECT equal to a fresh materialized view's defining
    # query from the view (matview/rewrite.py)
    "enable_matview_rewrite": (_bool, True),
    # pg_fault_inject() arms failpoints only on a session that turned
    # this on (fault/): a stray statement cannot arm a fault
    "fault_injection": (_bool, False),
}

# the reference's settings the port does not act on yet, each with the
# ROADMAP item that brings its subsystem
NOT_ACTED_ON: dict = {
    "ssl_cert_file": "A.9", "ssl_key_file": "A.9",
    "log_min_messages": "A.7", "log_destination": "A.7",
    "log_directory": "A.7", "metrics_port": "A.7",
    "auto_explain_min_duration_ms": "A.7",
    "enable_stat_statements": "A.7", "stat_statements_max": "A.7",
    "log_min_duration_statement": "A.7", "trace_queries": "A.7",
    "expected_device_platform": "A.7",
    "enable_plan_cache": "A.9", "plan_cache_size": "A.9",
    "enable_result_cache": "A.9", "result_cache_size": "A.9",
    "gtm_standby_addr": "A.9", "read_routing": "A.9",
    "max_staleness": "A.9", "replica_read_fallback": "A.9",
    "replica_read_wait_ms": "A.9",
    "rebalance_rate_limit": "A.8",
    "autovacuum": "A.7", "autovacuum_naptime_s": "A.7",
    "autovacuum_scale_factor_pct": "A.7",
}


def validate(name: str, value):
    """The validated value; a namespaced name ('ext.knob') passes as
    is, a setting the port does not act on raises ``NotPorted``."""
    entry = GUCS.get(name)
    if entry is None:
        if name in NOT_ACTED_ON:
            raise NotPorted(
                f"setting {name} (ROADMAP {NOT_ACTED_ON[name]})")
        if "." not in name:
            raise GucError(f'unrecognized configuration parameter "{name}"')
        return value
    fn, _default = entry
    return fn(value)


def defaults() -> dict:
    """Every setting's default, where it has one (the session's
    starting values before the conf file's)."""
    return {name: default for name, (_fn, default) in GUCS.items()
            if default is not None}


def load_conf(data_dir: Optional[str]) -> dict:
    """Read <data_dir>/opentenbase.conf: ``name = value`` per line, '#'
    comments, validated on load."""
    out: dict = {}
    if not data_dir:
        return out
    path = os.path.join(data_dir, "opentenbase.conf")
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise GucError(
                    f"{path}:{lineno}: expected name = value, got {raw!r}"
                )
            name, _, value = line.partition("=")
            name = name.strip()
            value = value.strip().strip("'\"")
            out[name] = validate(name, value)
    if out.get("ssl"):
        raise NotPorted("TLS (ssl = on)")
    _check_lease_budget(out, path)
    return out


def _check_lease_budget(conf: dict, path: str) -> None:
    """With leases on, the failure-detection budget must exceed the
    lease TTL plus skew: failover waits out the old lease before it
    flips routing, which holds only when a partitioned primary's lease
    lapses before the monitor can promote a successor."""
    ttl = int(conf.get("lease_ttl_ms", GUCS["lease_ttl_ms"][1]) or 0)
    if ttl <= 0:
        return
    detect = int(
        conf.get("failover_detect_ms", GUCS["failover_detect_ms"][1])
    )
    beats = int(conf.get("failover_beats", GUCS["failover_beats"][1]))
    skew = int(conf.get("lease_skew_ms", GUCS["lease_skew_ms"][1]))
    if detect * beats <= ttl + skew:
        raise GucError(
            f"{path}: failover_detect_ms ({detect}) x failover_beats "
            f"({beats}) must exceed lease_ttl_ms ({ttl}) + "
            f"lease_skew_ms ({skew}) — a primary's lease must lapse "
            f"before a successor can be promoted"
        )

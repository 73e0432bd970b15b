"""Self-healing HA on the card (no JAX in this file: it runs on the GPU
machine, where only the port is installed)."""

import time

import pytest

from opentenbase_tpu_torch.ha import HAMonitor, HATopology, RoutingClient

HA_CONF = {
    "enable_fused_execution": "off",
    "synchronous_commit": "on",
    "failover_detect_ms": 1000,
    "failover_beats": 3,
    "fragment_retries": 1,
    "fragment_retry_backoff_ms": 5,
    "statement_timeout": 8000,
}


@pytest.mark.gpu
def test_ha_topology_fails_over_on_the_card(tmp_path):
    """An HATopology built with no device runs every node on cuda:0; the
    monitor promotes a datanode within its detection budget after the
    primary crashes, the routing client's writes resume there, and every
    acknowledged row is present; the ex-primary rejoins on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the topology runs on cuda:0 "
                    "and has no CPU fallback")
    topo = HATopology(str(tmp_path / "ha"), num_datanodes=2,
                      shard_groups=16, conf_gucs=HA_CONF)
    mon = None
    rc = RoutingClient(topo)
    try:
        assert topo.primary.device == torch.device("cuda", 0)
        assert all(dn.device == torch.device("cuda", 0) for dn in topo.dns)
        rc.execute("create table t (k bigint, v bigint) "
                   "distribute by shard(k)")
        rc.execute("insert into t values " + ",".join(
            f"({k}, {k % 7})" for k in range(2000)))
        mon = HAMonitor(topo).start()
        t_crash = time.time()
        topo.crash_primary()
        deadline = time.time() + 30
        resumed = False
        while time.time() < deadline and not resumed:
            try:
                rc.execute("insert into t values (5000, 1)")
                resumed = True
            except Exception:
                time.sleep(0.05)
        assert resumed, topo.events
        assert (mon.declared_dead_at - t_crash) * 1000 <= 1000 + 1000 / 3 \
            + 600
        assert topo.active_cluster.device == torch.device("cuda", 0)
        assert rc.query("select count(*), sum(v) from t") == [
            (2001, sum(k % 7 for k in range(2000)) + 1)]
        sb = topo.rejoin_ex_primary()
        assert sb.cluster.device == torch.device("cuda", 0)
        end = topo.active_cluster.persistence.wal.position
        deadline = time.time() + 30
        while sb.applied < end and time.time() < deadline:
            time.sleep(0.02)
        assert sb.session().query("select count(*) from t") == [(2001,)]
    finally:
        rc.close()
        if mon is not None:
            mon.stop()
        topo.stop()

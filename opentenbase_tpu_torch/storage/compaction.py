"""Background delta compaction (the reference's storage/compaction.py).

Ingest appends park as delta batches in front of each shard store's
base arrays, and reads scan them in place (``ShardStore.scan_view``).
This job folds them into the base arrays ahead of time, one concatenate
per column per store, so a long write-only burst does not accumulate an
unbounded delta list. A fold keeps every row's position, so the device
cache's planes stay valid, and it is in memory only: the rows are
already durable in their WAL 'G' frames, and a crash mid-fold loses
nothing.

The job runs where the conf setting ``delta_compaction_naptime_ms`` is
above 0 (``Cluster.__init__``); ``Cluster.compact_deltas()`` is the one
verb the job and callers share. Its failpoints,
``storage/compaction_start`` before any fold and
``storage/compaction_end`` after it, show that a pass dying at either
loses nothing.
"""

from __future__ import annotations

import logging
import threading

from opentenbase_tpu_torch.fault import FAULT

log = logging.getLogger(__name__)


def compact_cluster(cluster) -> int:
    """Fold the pending deltas of every shard store; returns the delta
    batches folded."""
    folded = 0
    # the job dying before any fold: the deltas intact, the read path
    # still serves every row
    FAULT("storage/compaction_start")
    for stores in list(cluster.stores.values()):
        for store in list(stores.values()):
            compact = getattr(store, "compact", None)
            if compact is not None and store.pending_delta_rows:
                folded += compact()
    # the fold done, the job dying before its accounting: each store's
    # fold is atomic under its delta lock, so the stores are consistent
    FAULT("storage/compaction_end", folded=folded)
    if folded:
        with cluster._ingest_stats_mu:
            cluster.ingest_stats["compactions"] += 1
            cluster.ingest_stats["batches_folded"] += folded
    return folded


def start_compaction(cluster, interval_s: float):
    """The compaction daemon, a pass every ``interval_s``; returns a
    stop() callable (autovacuum's launcher shape)."""
    stop = threading.Event()

    def loop() -> None:
        while not stop.wait(interval_s):
            try:
                compact_cluster(cluster)
            except Exception:
                # the daemon outlives a failed pass, and says so
                log.warning("delta compaction pass failed", exc_info=True)

    t = threading.Thread(target=loop, name="delta-compaction", daemon=True)
    t.start()

    def stopper() -> None:
        stop.set()
        t.join(timeout=5)

    return stopper

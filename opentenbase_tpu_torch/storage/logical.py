"""Logical replication: publications, logical decoding, apply workers
(the reference's opentenbase_tpu/storage/logical.py; the WAL it decodes
is the reference's format, so either package decodes the other's).

OpenTenBase ships logical decoding + pgoutput (src/backend/replication/
logical/), CREATE PUBLICATION/SUBSCRIPTION catalogs with OpenTenBase's
shard-filtered variants (src/include/catalog/pg_publication_shard.h,
pg_subscription_shard.h), and CN-coordinated cluster subscriptions
(contrib/opentenbase_subscription). The flow rebuilt here:

- **Decoding** (publisher side): the cluster WAL's 'G' frames carry every
  committed transaction's inserts (full column data) and deletes (stable
  row ids). ``decode_changes`` walks the WAL from a slot offset and turns
  each frame into row-level changes: inserts decode straight from the
  frame's arrays; deletes resolve row ids against the live store, whose
  dead versions remain until vacuum — the same trick logical decoding
  plays with the old tuple via REPLICA IDENTITY. Replicated tables
  deduplicate to one copy; a publication's node filter implements the
  shard-filtered publication (changes only from the listed datanodes).
- **Transport**: the subscriber PULLS over the ordinary wire protocol by
  calling ``pg_logical_slot_changes('<pub>', <lsn>)`` on the publisher —
  the CN-coordinated shape of contrib/opentenbase_subscription, which
  also drives replication through SQL on the coordinator.
- **Apply** (subscriber side): ``apply_frame`` applies one decoded commit
  frame atomically through the engine's normal transaction machinery —
  per table deletes first (matched by primary key, else full row), then
  inserts routed by the subscriber's own locator, so publisher and
  subscriber may shard the same table differently.
- ``SubscriptionWorker``: the apply-worker process — a thread polling the
  publisher, applying frames, advancing the durable slot offset, and
  reconnecting on failure.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Publisher: logical decoding
# ---------------------------------------------------------------------------


def _frame_self_deletes(header: dict, arrays) -> set:
    """Frame-local compaction, shared by BOTH delta consumers (the
    publication decoder and matview incremental maintenance): an
    insert-then-update/delete txn both inserts a row version and
    deletes it IN THE SAME FRAME (by its rowid). Such self-deleted
    versions must never surface on either side of a delta — shipping
    them reordered would resurrect the old version or trip the
    subscriber's PK check. Keys are (node, table, rowid); rowids are
    per-(node, table) stable ids. ``kind: "dict"`` sub-records
    (dictionary deltas riding shipped-DML frames) are skipped."""
    self_del: set[tuple] = set()
    ins_ranges: dict[tuple, list[tuple[int, int]]] = {}
    for i, wm in enumerate(header["writes"]):
        if wm.get("kind") == "dict":
            continue
        key = (wm["node"], wm["table"])
        if wm["kind"] == "ins":
            rid0 = wm["row_id_start"]
            ins_ranges.setdefault(key, []).append(
                (rid0, rid0 + wm["nrows"])
            )
        else:
            for rid in np.asarray(arrays[f"w{i}_del"]).tolist():
                if any(
                    lo <= rid < hi
                    for lo, hi in ins_ranges.get(key, ())
                ):
                    self_del.add((*key, rid))
    return self_del


def decode_changes(
    cluster, pub: dict, from_off: int, limit_frames: int = 200
) -> tuple[int, list[dict]]:
    """Decode committed frames after WAL offset ``from_off`` that touch
    the publication's tables. Returns (next_off, frames); each frame is
    {"commit_ts": int, "changes": [{"table", "op": "insert"|"delete",
    "rows": [ {col: value}... ]}]} with frame atomicity preserved."""
    from opentenbase_tpu_torch.storage.persist import WAL
    from opentenbase_tpu_torch.storage.column import Column
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    p = cluster.persistence
    if p is None:
        raise ValueError("logical decoding requires a durable cluster "
                         "(data_dir)")
    tables = pub.get("tables")  # None = FOR ALL TABLES
    nodes = pub.get("nodes")  # None = every datanode (no shard filter)
    frames: list[dict] = []
    next_off = from_off
    for tag, header, arrays, off in WAL.read_records(
        p.wal.path, start=from_off
    ):
        next_off = off
        if tag != "G":
            if len(frames) >= limit_frames:
                break
            continue
        self_del = _frame_self_deletes(header, arrays)
        changes: list[dict] = []
        for i, wm in enumerate(header["writes"]):
            table = wm["table"]
            if tables is not None and table not in tables:
                continue
            if not cluster.catalog.has(table):
                continue
            tm = cluster.catalog.get(table)
            if tm.dist.is_replicated:
                # one copy is the logical truth
                if wm["node"] != min(tm.node_indices):
                    continue
            elif nodes is not None and wm["node"] not in nodes:
                continue  # shard-filtered publication
            if wm["kind"] == "ins":
                cols = {}
                for colname, ty in tm.schema.items():
                    key = f"w{i}_{colname}"
                    if key not in arrays:  # column added after this frame
                        continue
                    cols[colname] = Column(
                        ty, arrays[key], arrays.get(f"w{i}__v_{colname}"),
                        tm.dictionaries.get(colname),
                    )
                if not cols:
                    continue
                batch = ColumnBatch(cols, wm["nrows"])
                data = batch.to_pydict()
                rid0 = wm["row_id_start"]
                rows = [
                    {c: data[c][r] for c in data}
                    for r in range(wm["nrows"])
                    if (wm["node"], table, rid0 + r) not in self_del
                ]
                if rows:
                    changes.append(
                        {"table": table, "op": "insert", "rows": rows}
                    )
            else:
                rowids = [
                    rid
                    for rid in np.asarray(arrays[f"w{i}_del"]).tolist()
                    if (wm["node"], table, rid) not in self_del
                ]
                rows = _resolve_deleted_rows(
                    cluster, tm, wm["node"], rowids
                )
                if rows:
                    changes.append(
                        {"table": table, "op": "delete", "rows": rows}
                    )
        if changes:
            frames.append(
                {"commit_ts": header["commit_ts"], "changes": changes,
                 "next_off": next_off}
            )
            if len(frames) >= limit_frames:
                break
    return next_off, frames


def _resolve_deleted_rows(cluster, tm, node: int, rowids) -> list[dict]:
    """Old-tuple lookup for deletes: the dead versions are still in the
    store until vacuum reclaims them (REPLICA IDENTITY via the heap)."""
    store = cluster.stores.get(node, {}).get(tm.name)
    if store is None or store.nrows == 0:
        return []
    if not len(rowids):
        return []
    pos = np.nonzero(
        np.isin(store.scan_view().row_id(),
                np.asarray(rowids, dtype=np.int64))
    )[0]
    if not len(pos):
        return []  # vacuumed away: the change is unrecoverable, skip
    batch = store.take_batch(pos)
    data = batch.to_pydict()
    return [
        {c: data[c][r] for c in data} for r in range(len(pos))
    ]


def decode_table_deltas(
    cluster, table: str, from_off: int, upto: Optional[int] = None
) -> tuple[list[dict], list[dict], bool]:
    """Row-level deltas of ONE table from committed 'G' frames in
    ``(from_off .. upto]`` — the matview incremental-maintenance feed.
    Returns (ins_rows, del_rows, complete); ``complete`` is False when
    a delete's old tuple was already vacuumed away (the delta stream
    is unrecoverable there and the caller must fall back to a full
    recompute — never silently under-apply deletes, which the
    publication decoder is allowed to do but IVM is not)."""
    from opentenbase_tpu_torch.matview.defs import CONTENT_DDL_OPS
    from opentenbase_tpu_torch.storage.column import Column
    from opentenbase_tpu_torch.storage.persist import WAL
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    p = cluster.persistence
    if p is None:
        raise ValueError(
            "incremental maintenance requires a durable cluster "
            "(data_dir)"
        )
    if not cluster.catalog.has(table):
        return [], [], False
    tm = cluster.catalog.get(table)
    ins_rows: list[dict] = []
    del_rows: list[dict] = []
    for tag, header, arrays, off in WAL.read_records(
        p.wal.path, start=from_off
    ):
        if upto is not None and off > upto:
            break
        if tag == "D" and header.get("name") == table and (
            header.get("op") in CONTENT_DDL_OPS
        ):
            # content/row-id-rewriting DDL leaves no 'G' frames (and
            # redistribution renumbers the stable row ids old delete
            # frames reference): the delta stream breaks here — the
            # caller must full-recompute
            return [], [], False
        if tag == "T" and any(
            wm.get("table") == table
            for wm in header.get("writes", ())
        ):
            # explicitly-PREPAREd writes commit later as a compact 'C'
            # decision with no row frame — row-accurate delta replay
            # across the 2PC split is not worth the bookkeeping, so
            # the stream breaks (full recompute)
            return [], [], False
        if tag == "C":
            # a commit decision for a 'T' record that may predate this
            # window (tables unknown from the 'C' alone): conservative
            # break
            return [], [], False
        if tag != "G":
            continue
        self_del = _frame_self_deletes(header, arrays)
        for i, wm in enumerate(header["writes"]):
            if wm.get("kind") == "dict" or wm["table"] != table:
                continue
            if tm.dist.is_replicated and wm["node"] != min(
                tm.node_indices
            ):
                continue  # one copy is the logical truth
            if wm["kind"] == "ins":
                cols = {}
                for colname, ty in tm.schema.items():
                    k = f"w{i}_{colname}"
                    if k not in arrays:
                        continue  # column added after this frame
                    cols[colname] = Column(
                        ty, arrays[k], arrays.get(f"w{i}__v_{colname}"),
                        tm.dictionaries.get(colname),
                    )
                if not cols:
                    continue
                data = ColumnBatch(cols, wm["nrows"]).to_pydict()
                rid0 = wm["row_id_start"]
                for r in range(wm["nrows"]):
                    if (wm["node"], table, rid0 + r) in self_del:
                        continue
                    row = {c: data[c][r] for c in data}
                    for c in tm.schema:
                        row.setdefault(c, None)
                    ins_rows.append(row)
            else:
                rowids = [
                    rid
                    for rid in np.asarray(arrays[f"w{i}_del"]).tolist()
                    if (wm["node"], table, rid) not in self_del
                ]
                rows = _resolve_deleted_rows(
                    cluster, tm, wm["node"], rowids
                )
                if len(rows) < len(rowids):
                    # vacuum reclaimed a dead version the delta needs
                    return [], [], False
                del_rows.extend(rows)
    return ins_rows, del_rows, True


# ---------------------------------------------------------------------------
# Subscriber: frame apply
# ---------------------------------------------------------------------------


STATE_TABLE = "otb_subscription_state"


def ensure_state_table(session) -> None:
    """The subscriber-side replication-origin catalog: one replicated row
    per subscription holding (lsn, synced), updated INSIDE each apply
    transaction so the slot position commits atomically with the applied
    rows (the replication_origin LSN-in-commit-record contract)."""
    cluster = session.cluster
    if not cluster.catalog.has(STATE_TABLE):
        session.execute(
            f"create table {STATE_TABLE} (subname text, lsn bigint, "
            "synced bigint) distribute by replication"
        )


def read_slot_state(session, name: str):
    cluster = session.cluster
    if not cluster.catalog.has(STATE_TABLE):
        return None
    rows = session.query(
        f"select lsn, synced from {STATE_TABLE} "
        f"where subname = '{name}'"
    )
    if not rows:
        return None
    return int(rows[0][0]), bool(rows[0][1])


def apply_frame(session, frame: dict, slot_state=None) -> int:
    """Apply one decoded commit frame atomically on the subscriber via
    the normal transaction machinery (worker.c's apply loop). Deletes
    match by primary key when the table has one, else by full row, one
    store row per change row. ``slot_state`` = (subname, lsn, synced):
    replaces the subscription's state row IN THE SAME transaction, so a
    crash can never separate applied rows from the slot position.
    Returns rows applied."""
    from opentenbase_tpu_torch.storage.table import ColumnBatch

    cluster = session.cluster
    if slot_state is not None:
        name, lsn, synced = slot_state
        frame = {
            "changes": list(frame.get("changes", ())) + [
                {"table": STATE_TABLE, "op": "delete",
                 "rows": [{"subname": name}]},
                {"table": STATE_TABLE, "op": "insert",
                 "rows": [{"subname": name, "lsn": int(lsn),
                           "synced": int(synced)}]},
            ]
        }
    txn, _ = session._begin_implicit()
    applied = 0
    try:
        by_table: dict[str, dict[str, list]] = {}
        for ch in frame["changes"]:
            by_table.setdefault(
                ch["table"], {"insert": [], "delete": [], "sync": []}
            )[ch["op"]].extend(ch["rows"])
        for table, ops in by_table.items():
            if not cluster.catalog.has(table):
                continue  # not replicated on this side
            meta = cluster.catalog.get(table)
            if ops["sync"]:
                # initial table sync: replace local contents atomically
                # (idempotent, so a crash mid-sync just re-syncs)
                _register_all_live_as_deleted(session, txn, meta)
                ops["insert"] = ops["sync"] + ops["insert"]
            # deletes BEFORE inserts: an UPDATE decodes as delete+insert
            # of the same logical row (same-frame self-deletes were
            # compacted away at decode time), and the new version must
            # survive
            for row in ops["delete"]:
                applied += _apply_delete(session, txn, meta, row)
            rows = [
                {k: v for k, v in row.items() if k in meta.schema}
                for row in ops["insert"]
            ]
            if rows:
                data = {
                    c: [r.get(c) for r in rows] for c in meta.schema
                }
                batch = ColumnBatch.from_pydict(
                    data, meta.schema, meta.dictionaries
                )
                applied += session._route_and_append(meta, batch, txn)
    except Exception:
        session._abort_txn(txn)
        raise
    session._commit_txn(txn)
    return applied


def _live_rows(cluster, txn, meta, node: int, store) -> np.ndarray:
    """Positions of ``store``'s rows visible to ``txn`` (its own writes
    laid over its snapshot)."""
    from opentenbase_tpu_torch.executor.local import predicate_rows

    return predicate_rows(
        cluster.catalog, store, meta.name, None, txn.snapshot_ts,
        txn.own_writes_view().get(node, {}).get(meta.name))


def _register_all_live_as_deleted(session, txn, meta) -> None:
    cluster = session.cluster
    for node in meta.node_indices:
        store = cluster.stores[node].get(meta.name)
        if store is None or store.nrows == 0:
            continue
        idx = _live_rows(cluster, txn, meta, node, store)
        if len(idx):
            txn.pin(store)
            txn.w(node, meta.name).del_idx.extend(idx.tolist())


def _apply_delete(session, txn, meta, row: dict) -> int:
    """Delete ONE live row matching the replica identity."""
    cluster = session.cluster
    pk = getattr(meta, "primary_key", None)
    ident_cols = [pk] if pk and pk in row else [
        c for c in meta.schema if c in row
    ]
    for node in meta.node_indices:
        store = cluster.stores[node].get(meta.name)
        if store is None or store.nrows == 0:
            continue
        idx = _live_rows(cluster, txn, meta, node, store)
        if not len(idx):
            continue
        mask = np.ones(len(idx), dtype=bool)
        sv = store.scan_view()
        for c in ident_cols:
            col = sv.col_at(c, idx)
            want = row[c]
            if want is None:  # NULL identity (checked before TEXT decode)
                vm = sv.validity_at(c, idx)
                mask &= (
                    ~vm if vm is not None
                    else np.zeros(len(idx), bool)
                )
            elif meta.schema[c].id.name == "TEXT":
                d = meta.dictionaries.get(c)
                code = d.get_code(want) if d is not None else None
                if code is None:
                    mask[:] = False
                    break
                mask &= col == code
            else:
                mask &= col == _encode_scalar(meta, c, want)
        hit = idx[mask]
        already = set(txn.writes.get(node, {}).get(meta.name,
                                                   _EMPTY).del_idx)
        hit = [h for h in hit.tolist() if h not in already]
        if hit:
            txn.pin(store)
            txn.w(node, meta.name).del_idx.append(hit[0])
            if meta.dist.is_replicated:
                continue  # delete the same logical row on every copy
            return 1
    return 1 if meta.dist.is_replicated else 0


class _Empty:
    del_idx: list = []


_EMPTY = _Empty()


def _encode_scalar(meta, col: str, value):
    """Python value -> stored numeric representation for comparisons."""
    from opentenbase_tpu_torch.storage.column import column_from_python

    c = column_from_python([value], meta.schema[col],
                           meta.dictionaries.get(col))
    return c.data[0]


# ---------------------------------------------------------------------------
# Subscriber: apply worker
# ---------------------------------------------------------------------------


def parse_conninfo(conninfo: str) -> dict:
    out = {}
    for part in conninfo.split():
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


class SubscriptionWorker:
    """Logical-replication apply worker (one per subscription): polls the
    publisher's slot over the wire protocol, applies frames, advances
    the durable slot offset, reconnects on failure."""

    def __init__(self, cluster, name: str, conninfo: str, publication: str,
                 poll_s: float = 0.1):
        self.cluster = cluster
        self.name = name
        self.conninfo = conninfo
        self.publication = publication
        self.poll_s = poll_s
        self.lsn = 0
        self.synced = False
        self.last_error: str = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "SubscriptionWorker":
        self._thread = threading.Thread(
            target=self._loop, name=f"logical-apply-{self.name}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, join: bool = True) -> None:
        """``join=False`` when the caller holds the cluster statement
        lock (DROP SUBSCRIPTION under the wire server): the worker may be
        blocked on that very lock, so joining would stall — the worker
        re-checks the stop flag under the lock and exits without applying
        anything further."""
        self._stop.set()
        if join and self._thread is not None:
            self._thread.join(timeout=5)

    def _connect(self):
        from opentenbase_tpu_torch.net.client import connect_tcp

        info = parse_conninfo(self.conninfo)
        return connect_tcp(
            info.get("host", "127.0.0.1"), int(info["port"])
        )

    # -- initial table sync + streaming ----------------------------------
    def _bootstrap(self, client, sess) -> None:
        """First-connect setup: restore the durable slot state (written
        atomically with applies into the state table), then either run
        the initial table sync or — for copy_data=off — capture the
        publisher's CURRENT lsn so history is never replayed."""
        with self.cluster._exec_lock:
            ensure_state_table(sess)
            state = read_slot_state(sess, self.name)
        if state is not None:
            self.lsn, synced = state
            self.synced = self.synced or synced
            if self.synced:
                return
        if self.synced:
            # copy_data=off and no durable state yet: stream starts at
            # the publisher's current position, not at WAL offset 0
            self.lsn = int(
                client.query("select pg_current_wal_lsn()")[0][0]
            )
            with self.cluster._exec_lock:
                apply_frame(
                    sess, {"changes": []},
                    slot_state=(self.name, self.lsn, True),
                )
            return
        self._initial_sync(client, sess)

    def _initial_sync(self, client, sess) -> None:
        """Initial table sync (tablesync.c): ONE publisher statement
        returns the copy AND the lsn it is consistent with (the wire
        server holds the publisher's statement lock for the whole call,
        so no commit can slip between them), applied here as ONE atomic
        replace-contents frame — idempotent, so a subscriber crash
        mid-sync simply re-syncs on restart. The slot state commits in
        the same transaction as the copy."""
        rows = client.query(
            f"select pg_logical_sync('{self.publication}')"
        )
        lsn = 0
        by_table: dict[str, list] = {}
        for table, payload in rows:
            if table == "":
                lsn = int(payload)
            else:
                by_table.setdefault(table, []).append(json.loads(payload))
        changes = [
            {"table": tb, "op": "sync", "rows": rws}
            for tb, rws in by_table.items()
            if self.cluster.catalog.has(tb)
        ]
        with self.cluster._exec_lock:
            if self._stop.is_set():
                return
            apply_frame(
                sess, {"changes": changes},
                slot_state=(self.name, lsn, True),
            )
        self.lsn = lsn
        self.synced = True

    def _loop(self) -> None:
        client = None
        sess = self.cluster.session()
        while not self._stop.is_set():
            try:
                if client is None:
                    client = self._connect()
                    self._bootstrap(client, sess)
                rows = client.query(
                    "select pg_logical_slot_changes("
                    f"'{self.publication}', {self.lsn})"
                )
                fast_forward = None
                for next_off, frame_json in rows:
                    if frame_json:
                        frame = json.loads(frame_json)
                        # serialize with other sessions the way the wire
                        # server does (apply-worker vs. query interlock);
                        # the slot advance commits WITH the frame
                        with self.cluster._exec_lock:
                            if self._stop.is_set():
                                return
                            apply_frame(
                                sess, frame,
                                slot_state=(
                                    self.name, int(next_off), True
                                ),
                            )
                        self.lsn = max(self.lsn, int(next_off))
                    else:
                        # empty frame = fast-forward past WAL activity
                        # on unpublished tables
                        fast_forward = int(next_off)
                if fast_forward is not None and fast_forward > self.lsn:
                    self.lsn = fast_forward
                    with self.cluster._exec_lock:
                        if self._stop.is_set():
                            return
                        apply_frame(
                            sess, {"changes": []},
                            slot_state=(self.name, self.lsn, True),
                        )
                self.last_error = ""
            except Exception as e:  # connection drop, publisher restart
                self.last_error = str(e)
                log.warning("subscription %r poll failed (reconnecting "
                            "next cycle): %.200r", self.name, e)
                try:
                    if client is not None:
                        client.close()
                except Exception as ce:
                    # close on an already-broken publisher socket; the
                    # reconnect below replaces it either way, but the
                    # double fault is worth a log line
                    log.info("subscription %r: close of broken publisher "
                             "connection failed: %.120r", self.name, ce)
                client = None
            self._stop.wait(self.poll_s)
        if client is not None:
            try:
                client.close()
            except Exception as e:
                # teardown path: the worker is exiting and the socket
                # dies with the process, but a failed close still marks
                # the channel broken in the log
                log.info("subscription %r: close at shutdown failed: "
                         "%.120r", self.name, e)


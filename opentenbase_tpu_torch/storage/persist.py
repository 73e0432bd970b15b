"""Durability: the write-ahead log, checkpoints and crash recovery (the
reference's opentenbase_tpu/storage/persist.py, same on-disk format).

The cluster WAL is one ordered log of committed changes, framed

  record := u32 len | u8 tag | u32 hlen | header (json) | arrays

with tags 'D' (DDL and dictionary growth, json), 'G' (one committed
transaction, atomically framed: json header + raw 1-D arrays) and 'B'
(a barrier, read and kept). Deletes are logged by stable row id, never
by position: replayed stores omit aborted rows, so positions drift
while row ids do not.

A checkpoint is an npz snapshot of every shard store under a fresh
generation number plus checkpoint.json (the atomic rename) naming that
generation and the WAL position it covers; recovery restores the
latest checkpoint and replays the WAL from there. The reference and the
port recover each other's data directories.

A commit whose write set was also shipped to datanode processes inside
their 2PC prepare (implicit 2PC, engine.py) is a 'G' frame tagged with
its gid and led by each touched dictionary's delta ("dict"
sub-records): a datanode that applied the journaled copy skips the
frame, exactly once across the two delivery paths. ``wal_senders`` are
the walsenders streaming this WAL (storage/replication.py). Each gid's
commit is remembered as its decision (``gid_decision``), which the
in-doubt resolver reads after a failover.

Self-healing HA: a promotion logs the timeline's fencing generation as
an ``ha_generation`` 'D' record, replayed as a monotone maximum into
``cluster.node_generation``; a checkpoint carries the generation too.

Explicit two-phase commit: PREPARE TRANSACTION is a 'T' record that
carries the transaction's writes (twophase.c's state file: recovery
materializes them at PENDING_TS), COMMIT / ROLLBACK PREPARED are 'C' /
'R' records naming the gid; a checkpoint keeps a prepared
transaction's rows and names them under "prepared". After redo a
transaction still undecided is parked again (``_finish_recovery``:
its delete targets reserved at RESERVED_TS, registered in the GTM).
The GTM's sequence events are 'D' records (``seq_event``). A CREATE
TABLE record and a checkpoint carry the table's constraints; TRUNCATE,
ALTER TABLE ADD / DROP COLUMN and DISTRIBUTE BY are 'D' records
(``truncate``, ``add_column``, ``drop_column``, ``redistribute``),
replayed through the cluster's own verbs. Materialized views
(``create_matview``, ``drop_matview``; the checkpoint's "matviews"),
resource groups (``wlm_state``, the whole configuration; the
checkpoint's "wlm") and logical replication (``create_publication``,
``drop_publication``, ``create_subscription``, ``drop_subscription``,
``subscription_state``) are 'D' records too. Redo of a commit advances
its tables' committed-write counters (``Cluster.bump_table_versions``).

Not ported, each refused by name: point-in-time recovery to a barrier
(``recover(until_barrier=...)``), and every DDL record of a statement
the port does not take (node groups, nodes, ...). Left out: base
backups and rebalance journals.

Failpoints (fault/): ``storage/wal_write`` before a record's first
byte, ``storage/group_flush`` at the group-commit flush,
``storage/wal_close`` at the shutdown flush, ``storage/checkpoint`` at
a checkpoint's entry and ``storage/checkpoint_write`` where its files
are written.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
import time
from typing import Optional

import numpy as np

from opentenbase_tpu_torch import types as t
from opentenbase_tpu_torch.catalog.distribution import (
    DistributionSpec,
    DistStrategy,
)
from opentenbase_tpu_torch.errors import FrameTooLarge, NotPorted
from opentenbase_tpu_torch.fault import FAULT
from opentenbase_tpu_torch.storage.column import Column, Dictionary
from opentenbase_tpu_torch.storage.table import (
    PENDING_TS,
    RESERVED_TS,
    ColumnBatch,
    ShardStore,
)

# the frame length is a u32 that counts the tag byte and the payload
MAX_FRAME_BYTES = 2**32 - 1


def _type_to_str(ty: t.SqlType) -> str:
    if ty.id == t.TypeId.DECIMAL:
        return f"decimal({ty.precision},{ty.scale})"
    return ty.id.value


def _type_from_str(s: str) -> t.SqlType:
    if s.startswith("decimal("):
        p, sc = s[8:-1].split(",")
        return t.decimal(int(p), int(sc))
    return t.SqlType(t.TypeId(s))


def apply_constraints(meta, cons: Optional[dict]) -> None:
    """A CREATE TABLE record's (or a checkpoint's) column constraints
    onto the table's catalog entry."""
    cons = cons or {}
    meta.not_null = set(cons.get("not_null", ()))
    meta.defaults = dict(cons.get("defaults", {}))
    meta.primary_key = cons.get("primary_key")


def encode_commit_group(writes, stores, catalog=None, dict_synced=None):
    """(sub, arrays) for one committed transaction: the 'G'-frame body,
    shared by WAL logging and the payload shipped to datanode processes,
    so a direct apply there is byte-identical to stream replay.
    ``writes``: iterable of (node, table, ins_ranges, del_idx). Array
    keys are indexed by each record's position in ``sub``.

    With ``catalog`` the frame also carries each touched TEXT column's
    dictionary values above the ``dict_synced`` watermark, as
    ``kind: "dict"`` sub-records ahead of the rows, with their absolute
    start (an empty delta too: the receiver's gap check needs the
    watermark)."""
    sub = []
    arrays: dict = {}
    if catalog is not None:
        for table in sorted({w[1] for w in writes}):
            tm = catalog.get(table)
            for col in sorted(tm.dictionaries):
                d = tm.dictionaries[col]
                start = (dict_synced or {}).get(f"{table}.{col}", 0)
                sub.append({
                    "kind": "dict", "table": table, "column": col,
                    "start": int(start),
                    "values": list(d.values[start:]),
                })
    for node, table, ins_ranges, del_idx in writes:
        store = stores[node][table]
        for s, e in ins_ranges:
            i = len(sub)
            cols, vals, rid0 = store.slice_insert_arrays(s, e)
            for name in store.schema:
                arrays[f"w{i}_{name}"] = cols[name]
                vm = vals.get(name)
                if vm is not None:
                    arrays[f"w{i}__v_{name}"] = vm
            sub.append(
                {"node": node, "table": table, "kind": "ins",
                 "nrows": e - s, "cols": list(store.schema),
                 "row_id_start": rid0}
            )
        if len(del_idx):
            i = len(sub)
            idx = np.asarray(del_idx, dtype=np.int64)
            arrays[f"w{i}_del"] = store.peek_row_id_at(idx)
            sub.append({"node": node, "table": table, "kind": "del"})
    return sub, arrays


# Raw framing of a dict of 1-D arrays: magic, count, then (name,
# dtype.str, length, bytes) per array. Anything else is an npz.
_ARR_MAGIC = b"OTB1"


def _array_parts(arrays: dict) -> list:
    """The byte parts of ``pack_arrays(arrays)``, unjoined: a writer
    sends them one by one and never holds a second copy of a large
    payload."""
    if any(np.asarray(a).ndim != 1 for a in arrays.values()):
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return [buf.getvalue()]
    parts = [_ARR_MAGIC, struct.pack("<H", len(arrays))]
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        nb = name.encode()
        ds = a.dtype.str.encode()
        parts.append(struct.pack("<HBI", len(nb), len(ds), a.size))
        parts.append(nb)
        parts.append(ds)
        parts.append(memoryview(a).cast("B"))
    return parts


def pack_arrays(arrays: dict) -> bytes:
    return b"".join(bytes(p) for p in _array_parts(arrays))


def unpack_arrays(data: bytes) -> dict:
    """Decode a WAL array payload: raw framing by magic, npz otherwise."""
    if not data.startswith(_ARR_MAGIC):
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    (cnt,) = struct.unpack_from("<H", data, 4)
    off = 6
    out: dict = {}
    for _ in range(cnt):
        ln, ld, size = struct.unpack_from("<HBI", data, off)
        off += 7
        name = data[off : off + ln].decode()
        off += ln
        dt = np.dtype(data[off : off + ld].decode())
        off += ld
        nbytes = size * dt.itemsize
        # copy: a frombuffer view is read-only, and replay mutates
        out[name] = np.frombuffer(
            data[off : off + nbytes], dtype=dt
        ).copy()
        off += nbytes
    return out


def pow2_bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class WAL:
    """Append-only framed log with group fsync: ``append`` writes and
    OS-flushes one frame under ``_mu``; ``flush_to(end)`` makes it
    durable with leader election, so concurrent committers share one
    fsync (``sync=True`` fsyncs the frame itself)."""

    def __init__(self, path: str):
        self.path = path
        # a crash mid-append leaves a torn record at the tail; recovery
        # stops there, so anything appended after it would be lost:
        # truncate it before reopening for append
        if os.path.exists(path):
            end = WAL.scan_end(path)
            if os.path.getsize(path) > end:
                with open(path, "r+b") as f:
                    f.truncate(end)
        self._f = open(path, "ab")
        self._mu = threading.Lock()
        self._flush_cv = threading.Condition(threading.Lock())
        self._flushed = self._f.tell()
        self._flush_leader = False
        self._unsynced_commits = 0
        # counters: fsync calls, leader fsyncs of the group flush,
        # commits that waited for durability, batch-size histogram
        self.fsyncs = 0
        self.group_fsyncs = 0
        self.commit_flushes = 0
        self.batch_hist: dict[int, int] = {}

    def append(
        self, tag: bytes, header: dict,
        arrays: Optional[dict] = None, sync: bool = True,
    ) -> int:
        # failpoint: a disk failure before any byte lands (the commit
        # path rolls back); delay is a saturated log device
        FAULT("storage/wal_write", tag=tag.decode("latin1"))
        hdr = json.dumps(header).encode()
        parts = [struct.pack("<I", len(hdr)), hdr]
        if arrays is not None:
            parts += _array_parts(arrays)
        length = 1 + sum(len(p) for p in parts)
        if length > MAX_FRAME_BYTES:
            raise FrameTooLarge(
                f"WAL record of {length} bytes exceeds the "
                f"{MAX_FRAME_BYTES}-byte frame limit (u32 length)"
            )
        head = struct.pack("<IB", length, tag[0])
        with self._mu:
            self._f.write(head)
            for p in parts:
                self._f.write(p)
            self._f.flush()
            if not sync:
                self._unsynced_commits += 1
                return self._f.tell()
            os.fsync(self._f.fileno())
            self.fsyncs += 1
            end = self._f.tell()
        with self._flush_cv:
            self._flushed = max(self._flushed, end)
        return end

    def flush_to(
        self, end: int, delay_us: int = 0, siblings_ok: bool = False,
    ) -> None:
        """Block until every byte up to ``end`` is fsynced. One leader
        fsyncs for everyone waiting; ``delay_us`` with ``siblings_ok``
        (commit_delay / commit_siblings) naps the leader first so
        concurrent committers' frames join its batch."""
        # failpoint: the group flush (error: the batch's fsync failing,
        # every waiter sees it; delay stretches the whole batch)
        FAULT("storage/group_flush")
        with self._flush_cv:
            self.commit_flushes += 1
        while True:
            with self._flush_cv:
                if self._flushed >= end:
                    return
                if not self._flush_leader:
                    self._flush_leader = True
                    break
                self._flush_cv.wait(timeout=5.0)
        synced = None
        try:
            if delay_us > 0 and siblings_ok:
                time.sleep(delay_us / 1e6)
            with self._mu:
                target = self._f.tell()
                batch = self._unsynced_commits
                self._unsynced_commits = 0
            os.fsync(self._f.fileno())
            synced = target
            with self._mu:
                self.fsyncs += 1
                self.group_fsyncs += 1
                if batch:
                    b = pow2_bucket(batch)
                    self.batch_hist[b] = self.batch_hist.get(b, 0) + 1
        finally:
            with self._flush_cv:
                self._flush_leader = False
                # publish only on success: a failed fsync wakes the
                # waiters to elect a new leader
                if synced is not None:
                    self._flushed = max(self._flushed, synced)
                self._flush_cv.notify_all()

    def close(self) -> None:
        """Fsync the tail (synchronous_commit = off's unsynced frames
        become durable at a clean shutdown) and close."""
        # failpoint: the disk dying under the final fsync
        FAULT("storage/wal_close")
        try:
            with self._mu:
                self._f.flush()
                os.fsync(self._f.fileno())
        except (OSError, ValueError):
            pass
        self._f.close()

    def truncate_to(self, offset: int) -> None:
        """Discard everything after ``offset`` (a standby's torn stream
        tail) and continue appending from there."""
        with self._mu:
            self._f.close()
            with open(self.path, "r+b") as f:
                f.truncate(offset)
            self._f = open(self.path, "ab")
        with self._flush_cv:
            self._flushed = min(self._flushed, offset)

    @property
    def position(self) -> int:
        return self._f.tell()

    def stat_snapshot(self) -> dict:
        with self._mu:
            snap = {
                "position": self._f.tell(),
                "fsyncs": self.fsyncs,
                "group_fsyncs": self.group_fsyncs,
                "batch_hist": dict(self.batch_hist),
            }
        with self._flush_cv:
            snap["commit_flushes"] = self.commit_flushes
            snap["flushed"] = self._flushed
        return snap

    @staticmethod
    def scan_end(path: str) -> int:
        """Offset just past the last intact record (frame headers only,
        seeking past bodies)."""
        end = 0
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            while True:
                head = f.read(5)
                if len(head) < 5:
                    return end
                (length, _tag) = struct.unpack("<IB", head)
                # minimum frame: tag + header-length word; a zero-filled
                # tail would otherwise parse as endless empty frames
                if length < 5:
                    return end
                nxt = end + 4 + length
                if nxt > size:
                    return end
                f.seek(nxt)
                end = nxt

    @staticmethod
    def read_stream(f, decode_arrays: bool = True):
        """Yield (tag, header, arrays_or_None, end_offset) from a binary
        file positioned at a record boundary; stops at a torn or
        zero-filled tail."""
        while True:
            head = f.read(5)
            if len(head) < 5:
                return
            length, tag = struct.unpack("<IB", head)
            if length < 5:
                return
            body = f.read(length - 1)
            if len(body) < length - 1:
                return
            (hlen,) = struct.unpack_from("<I", body, 0)
            header = json.loads(body[4 : 4 + hlen].decode())
            arrays = None
            rest = body[4 + hlen :]
            if rest and decode_arrays:
                arrays = unpack_arrays(rest)
            yield chr(tag), header, arrays, f.tell()

    @staticmethod
    def read_records(path: str, start: int = 0, decode_arrays: bool = True):
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            f.seek(start)
            yield from WAL.read_stream(f, decode_arrays)


class ClusterPersistence:
    """Checkpoint and WAL manager bound to one Cluster."""

    def __init__(self, cluster, data_dir: str):
        self.cluster = cluster
        self.dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.wal = WAL(os.path.join(data_dir, "wal.log"))
        # per dictionary, the count of values already WAL-logged:
        # replayed inserts need every code they carry
        self._dict_synced: dict[str, int] = {}
        # the last recovery: seconds, records replayed, bytes read
        self.last_recovery: dict = {}
        # name -> (next value, increment) of the sequences a replay
        # created in a GTM over the wire (which no op reads back)
        self._seq_replayed: dict[str, tuple] = {}
        # live WalSenders streaming this WAL (storage/replication.py
        # registers and deregisters them)
        self.wal_senders: list = []
        # gid -> (outcome, commit_ts) of the gid-tagged commits logged
        # or replayed here, oldest evicted first
        self._gid_decisions: dict[str, tuple] = {}
        self._gid_decisions_mu = threading.Lock()
        # gid -> {"gxid", "writes"} of PREPAREd transactions redo met and
        # no decision has closed yet (_finish_recovery parks them)
        self._pending: dict[str, dict] = {}
        # True while redo replays: replayed side effects (the GTM's
        # sequence events) are not logged again
        self._in_recovery = False

    def sync_dicts(self, table: str) -> None:
        tm = self.cluster.catalog.get(table)
        for col, d in tm.dictionaries.items():
            key = f"{table}.{col}"
            synced = self._dict_synced.get(key, 0)
            n = len(d)
            if n > synced:
                self.log_ddl({
                    "op": "dict_extend", "table": table, "column": col,
                    "values": d.values[synced:n],
                })
                self._dict_synced[key] = n

    def forget_dicts(self, table: str) -> None:
        """A dropped table's dictionaries are gone: a table created
        again under its name logs its own from the first value."""
        for key in [k for k in self._dict_synced
                    if k.startswith(f"{table}.")]:
            del self._dict_synced[key]

    def _record_decision(self, gid: str, outcome: str, ts) -> None:
        with self._gid_decisions_mu:
            self._gid_decisions[gid] = (outcome, ts)
            while len(self._gid_decisions) > 8192:
                self._gid_decisions.pop(next(iter(self._gid_decisions)),
                                        None)

    def gid_decision(self, gid: str):
        """("commit", commit_ts), ("abort", None), or None: no durable
        decision, which the 2PC protocol reads as presumed abort."""
        return self._gid_decisions.get(gid)

    # -- 2PC records (twophase.c's on-disk prepared state) ---------------
    def log_prepare(self, txn, stores) -> None:
        """PREPARE TRANSACTION's 'T' record: the transaction's pending
        writes, so the in-doubt transaction survives a crash and can
        still be committed or rolled back after recovery."""
        writes = []
        arrays: dict = {}
        for table in {tb for tabs in txn.writes.values() for tb in tabs}:
            self.sync_dicts(table)
        for node, tabs in txn.writes.items():
            for table, tw in tabs.items():
                store = stores[node][table]
                for s, e in tw.ins_ranges:
                    i = len(writes)
                    cols, vals, rid0 = store.slice_insert_arrays(s, e)
                    for name in store.schema:
                        arrays[f"w{i}_{name}"] = cols[name]
                        vm = vals.get(name)
                        if vm is not None:
                            arrays[f"w{i}__v_{name}"] = vm
                    writes.append({"node": node, "table": table,
                                   "kind": "ins", "nrows": e - s,
                                   "row_id_start": rid0})
                if tw.del_idx:
                    i = len(writes)
                    idx = np.asarray(tw.del_idx, dtype=np.int64)
                    arrays[f"w{i}_del"] = store.peek_row_id_at(idx)
                    writes.append({"node": node, "table": table,
                                   "kind": "del"})
        self.wal.append(
            b"T",
            {"gid": txn.prepared_gid, "gxid": txn.gxid, "writes": writes},
            arrays or None,
        )

    def log_commit_prepared(self, gid: str, commit_ts: int) -> None:
        self.wal.append(b"C", {"gid": gid, "commit_ts": int(commit_ts)})
        self._record_decision(gid, "commit", int(commit_ts))

    def log_rollback_prepared(self, gid: str) -> None:
        self.wal.append(b"R", {"gid": gid})
        self._record_decision(gid, "abort", None)

    def _prepared_writes_meta(self, txn) -> list[dict]:
        """A prepared transaction's writes by stable row ids, for the
        checkpoint."""
        stores = self.cluster.stores
        ws = []
        for node, tabs in txn.writes.items():
            for table, tw in tabs.items():
                store = stores[node][table]
                for s, e in tw.ins_ranges:
                    _c, _v, rid0 = store.slice_insert_arrays(s, e)
                    ws.append({"node": node, "table": table, "kind": "ins",
                               "nrows": e - s, "row_id_start": rid0})
                if tw.del_idx:
                    idx = np.asarray(tw.del_idx, dtype=np.int64)
                    ws.append({"node": node, "table": table, "kind": "del",
                               "rowids": store.peek_row_id_at(idx).tolist()})
        return ws

    # -- WAL hooks (called by the engine) -------------------------------
    def log_ddl(self, op: dict) -> None:
        self.wal.append(b"D", op)

    def log_commit_group(
        self, writes, stores, commit_ts: int, gid=None, frame=None,
        sync_mode: str = "local", commit_delay_us: int = 0,
        commit_siblings: int = 5, group_commit: bool = True,
        commit_active: int = 1,
    ) -> Optional[int]:
        """Log one committed transaction as ONE 'G' frame (a commit over
        many tables and nodes is atomic under the torn-tail rule, which
        holds per frame). Returns the WAL offset just past the frame
        (the LSN a synchronous_commit wait targets), None when the
        transaction wrote nothing.

        ``gid``: set when the writes were also shipped to datanode
        processes in their 2PC prepare; the tag lets a datanode that
        applied the journaled copy skip this frame. ``frame``: the
        (sub, arrays) already encoded for that payload.

        ``sync_mode`` 'off' writes and OS-flushes the frame without
        waiting for its fsync (a process crash loses nothing, an OS
        crash may lose the tail); 'local' joins the group flush, one
        leader fsync for every concurrent committer, napping
        ``commit_delay_us`` first when at least ``commit_siblings``
        other sessions are mid-commit. ``group_commit`` False fsyncs
        each frame on its own."""
        writes = list(writes)
        sub, arrays = (frame if frame is not None
                       else encode_commit_group(writes, stores))
        for table in {w[1] for w in writes}:
            self.sync_dicts(table)
        if not sub:
            return None
        header = {"commit_ts": int(commit_ts), "writes": sub}
        if gid is not None:
            header["gid"] = gid
        if not group_commit and sync_mode != "off":
            end = self.wal.append(b"G", header, arrays or None, sync=True)
            if gid is not None:
                self._record_decision(gid, "commit", int(commit_ts))
            return end
        end = self.wal.append(b"G", header, arrays or None, sync=False)
        if gid is not None:
            self._record_decision(gid, "commit", int(commit_ts))
        if sync_mode != "off":
            self.wal.flush_to(
                end, delay_us=int(commit_delay_us),
                siblings_ok=int(commit_active) - 1 >= int(commit_siblings),
            )
        return end

    # -- checkpoint -----------------------------------------------------
    def checkpoint(self) -> None:
        """Snapshot the catalog and every shard store; records the WAL
        position so recovery replays only the tail.

        Store files go under a fresh generation and checkpoint.json (an
        atomic rename) names it: a crash mid-checkpoint leaves the
        previous json naming the previous generation's files. Rows of
        transactions still in flight (xmin PENDING) are left out: if
        they commit, their 'G' frame replays them."""
        # failpoint: a failure at the checkpoint's start; recovery
        # works from the previous generation and the WAL tail
        FAULT("storage/checkpoint")
        c = self.cluster
        gen = self._next_ckpt_gen()
        # failpoint where the snapshot files are written: a failure here
        # leaves the previous generation's json untouched
        FAULT("storage/checkpoint_write", gen=gen)
        # a prepared transaction's rows (xmin PENDING) are decidable:
        # they stay in the snapshot, named by gid under "prepared"
        prep_ranges: dict[tuple[int, str], list[tuple[int, int]]] = {}
        for txn in c._prepared.values():
            for node, tabs in txn.writes.items():
                for table, tw in tabs.items():
                    prep_ranges.setdefault((node, table), []).extend(
                        tw.ins_ranges)
        meta = {
            "gen": gen,
            "wal_position": self.wal.position,
            "tables": {},
            "shardmap": c.shardmap.map.tolist(),
            "num_shards": c.shardmap.num_shards,
            "barriers": [list(b) for b in c.barriers],
            "literals": list(c.catalog.literals.values),
            "datanodes": [
                {"name": n.name, "mesh_index": n.mesh_index}
                for n in c.nodes.datanodes
            ],
            "prepared": {
                gid: {"gxid": txn.gxid,
                      "writes": self._prepared_writes_meta(txn)}
                for gid, txn in c._prepared.items()
            },
            # what the reference's checkpoint also carries, empty: the
            # port has no node groups or rebalance. (SQL and PL/pgSQL
            # functions ride the WAL only, as in the reference's
            # checkpoint.)
            "groups": [],
            "rebalance": [],
            "partitions": {
                name: ps.spec for name, ps in c.partitions.items()
            },
            "views": {name: text for name, (_q, text) in c.views.items()},
            # matview definitions (their backing and aux tables are in
            # "tables", their refresh state in otb_matview_state)
            "matviews": {
                name: {"text": d.text, "options": dict(d.options),
                       "aux_schema": d.aux_schema}
                for name, d in c.matviews.items()
            },
            "users": dict(c.users),
            "wlm": c.wlm.dump_state(),
            # a checkpoint past an ha_generation record must carry the
            # generation the replayed tail no longer holds
            "node_generation": int(c.node_generation),
        }
        for name in c.catalog.table_names():
            tm = c.catalog.get(name)
            meta["tables"][name] = {
                "schema": {k: _type_to_str(v) for k, v in tm.schema.items()},
                "strategy": tm.dist.strategy.value,
                "key_columns": list(tm.dist.key_columns),
                "group": tm.dist.group,
                "nodes": list(tm.node_indices),
                "dictionaries": {
                    col: list(d.values) for col, d in tm.dictionaries.items()
                },
                "constraints": {
                    "not_null": sorted(tm.not_null),
                    "defaults": dict(tm.defaults),
                    "primary_key": tm.primary_key,
                },
                "zone_cols": sorted(tm.zone_cols),
                "foreign": tm.foreign,
            }
            for node in tm.node_indices:
                store = c.stores[node].get(name)
                if store is None:
                    continue
                # a non-folding capture: delta-resident rows write out
                # straight from their batches
                sv = store.scan_view()
                n = sv.nrows
                xmin = sv.xmin()
                keep = xmin != PENDING_TS
                for s, e in prep_ranges.get((node, name), []):
                    keep[s:e] = True
                arrays = {"__xmin": xmin[keep],
                          "__xmax": sv.xmax()[keep],
                          "__rowid": sv.row_id()[keep]}
                for col in store.schema:
                    arrays[col] = sv.col(col, 0, n)[keep]
                    vm = sv.validity(col, 0, n)
                    if vm is not None:
                        arrays[f"__v_{col}"] = vm[keep]
                path = os.path.join(self.dir, f"ckpt{gen}_dn{node}_{name}.npz")
                with open(path + ".tmp", "wb") as f:
                    np.savez(f, **arrays)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(path + ".tmp", path)
        tmp = os.path.join(self.dir, "checkpoint.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, "checkpoint.json"))
        self._gc_checkpoints(gen)
        # the checkpoint covers every dictionary value up to now
        for name in c.catalog.table_names():
            for col, d in c.catalog.get(name).dictionaries.items():
                self._dict_synced[f"{name}.{col}"] = len(d)

    def _next_ckpt_gen(self) -> int:
        ckpt_path = os.path.join(self.dir, "checkpoint.json")
        if os.path.exists(ckpt_path):
            with open(ckpt_path) as f:
                return int(json.load(f).get("gen", 0)) + 1
        return 1

    def _gc_checkpoints(self, live_gen: int) -> None:
        """Remove the snapshot files of superseded generations."""
        live = f"ckpt{live_gen}"
        for fn in os.listdir(self.dir):
            if fn.startswith("ckpt") and fn.split("_", 1)[0] != live:
                if fn.endswith(".npz") or fn.endswith(".npz.tmp"):
                    try:
                        os.remove(os.path.join(self.dir, fn))
                    except OSError:
                        pass

    def checkpoint_bytes(self) -> int:
        """Bytes of the live checkpoint's files (json and snapshots)."""
        total = 0
        for fn in os.listdir(self.dir):
            if fn == "checkpoint.json" or (
                fn.startswith("ckpt") and fn.endswith(".npz")
            ):
                total += os.path.getsize(os.path.join(self.dir, fn))
        return total

    # -- recovery -------------------------------------------------------
    def recover(self, until_barrier: Optional[str] = None) -> int:
        """Rebuild the cluster: restore the checkpoint, replay the WAL
        tail. Returns the number of records applied; ``last_recovery``
        holds the seconds, records and bytes."""
        if until_barrier is not None:
            raise NotPorted("recovery to a barrier (PITR)")
        t0 = time.perf_counter()
        c = self.cluster
        ckpt_path = os.path.join(self.dir, "checkpoint.json")
        wal_path = os.path.join(self.dir, "wal.log")
        start = 0
        if os.path.exists(ckpt_path):
            with open(ckpt_path) as f:
                meta = json.load(f)
            start = meta["wal_position"]
            self._restore_checkpoint(meta)
        applied = 0
        last = start
        self._in_recovery = True
        try:
            for tag, header, arrays, off in WAL.read_records(wal_path,
                                                             start):
                if tag == "B":
                    c.barriers.append((header["name"], header["ts"]))
                else:
                    self._apply(tag, header, arrays)
                    applied += 1
                last = off
        finally:
            self._in_recovery = False
        self._finish_recovery()
        self.last_recovery = {
            "seconds": time.perf_counter() - t0,
            "records": applied,
            "wal_bytes_replayed": last - start,
            "wal_bytes": (os.path.getsize(wal_path)
                          if os.path.exists(wal_path) else 0),
            "checkpoint_bytes": self.checkpoint_bytes(),
        }
        return applied

    def _finish_recovery(self) -> None:
        """After redo (a recovery, or a standby's promotion): every
        PREPAREd transaction no decision closed is parked again
        (twophase.c's RecoverPrepared pass: its delete targets reserved
        at RESERVED_TS, its stores pinned, registered in the GTM where
        the GTM does not list it), so COMMIT / ROLLBACK PREPARED work
        after a crash; and the WAL holds every dictionary value the
        stores do, so the next commit logs only new ones."""
        from opentenbase_tpu_torch.engine import Transaction

        c = self.cluster
        known = None
        for gid, pend in self._pending.items():
            txn = Transaction(pend["gxid"], 0)
            txn.prepared_gid = gid
            # a fresh grace period: clean2pc must neither kill recovered
            # transactions at once nor treat them as new for ever
            txn.prepared_at = time.time()
            for wm in pend["writes"]:
                store = c.stores[wm["node"]][wm["table"]]
                tw = txn.w(wm["node"], wm["table"])
                if wm["kind"] == "ins":
                    tw.ins_ranges.append(tuple(wm["range"]))
                else:
                    pos = np.nonzero(np.isin(store.scan_view().row_id(),
                                             wm["rowids"]))[0]
                    tw.del_idx.extend(int(i) for i in pos)
                    # the PREPARE's reservation again: new writers
                    # conflict with the in-doubt delete
                    store.stamp_xmax(pos, RESERVED_TS)
                txn.pin(store)
            c._prepared[gid] = txn
            # the GTM must know the in-doubt transaction too (a native
            # GTM journals it itself; one in process lost it)
            if known is None:
                try:
                    known = {p.gid for p in c.gts.prepared_txns()}
                except Exception:
                    known = set()
            if gid not in known:
                c.gts.prepare(pend["gxid"], gid,
                              tuple(txn.touched_nodes()))
            nx = getattr(c.gts, "_next_gxid", None)
            if nx is not None and pend["gxid"] >= nx:
                c.gts._next_gxid = pend["gxid"] + 1
        self._pending = {}
        for name in c.catalog.table_names():
            for col, d in c.catalog.get(name).dictionaries.items():
                self._dict_synced[f"{name}.{col}"] = len(d)

    def _restore_checkpoint(self, meta: dict) -> None:
        c = self.cluster
        g = int(meta.get("node_generation", 0))
        if g > c.node_generation:
            c.node_generation = g
        if meta.get("rebalance"):
            raise NotPorted("checkpoint with rebalance")
        if meta.get("wlm"):
            c.wlm.load_state(meta["wlm"])
        for g in meta.get("groups", []):
            if not c.nodes.has_group(g["name"]):
                raise NotPorted("node groups")
        for nd in meta.get("datanodes", []):
            if not c.nodes.has(nd["name"]) or (
                c.nodes.get(nd["name"]).mesh_index != nd["mesh_index"]
            ):
                raise NotPorted("CREATE NODE")
        c.users.update(meta.get("users", {}))
        c.shardmap.map = np.asarray(meta["shardmap"], dtype=np.int32)
        c.shardmap.num_shards = int(
            meta.get("num_shards", len(c.shardmap.map)))
        c.shardmap.row_stats = np.zeros(c.shardmap.num_shards, dtype=np.int64)
        c.barriers = [tuple(b) for b in meta["barriers"]]
        c.catalog.literals = Dictionary(meta.get("literals", []))
        gen = meta.get("gen", 0)
        max_ts = 0
        for name, tmeta in meta["tables"].items():
            schema = {k: _type_from_str(v) for k, v in tmeta["schema"].items()}
            spec = DistributionSpec(
                DistStrategy(tmeta["strategy"]), tuple(tmeta["key_columns"]),
                group=tmeta.get("group"),
            )
            if not c.catalog.has(name):
                c.catalog.create_table(name, schema, spec)
            tm = c.catalog.get(name)
            apply_constraints(tm, tmeta.get("constraints"))
            tm.zone_cols.update(tmeta.get("zone_cols", []))
            if tmeta.get("foreign"):
                tm.foreign = dict(tmeta["foreign"])
                tm.node_indices = tm.node_indices[:1]
                continue  # no stores: its scan reads the source
            tm.node_indices = list(tmeta["nodes"])
            tm.locator.node_indices = list(tmeta["nodes"])
            for col, values in tmeta["dictionaries"].items():
                tm.dictionaries[col] = Dictionary(values)
            for node in tm.node_indices:
                store = ShardStore(tm.schema, tm.dictionaries)
                path = os.path.join(self.dir, f"ckpt{gen}_dn{node}_{name}.npz")
                if os.path.exists(path):
                    with np.load(path, allow_pickle=False) as z:
                        n = len(z["__xmin"])
                        if n:
                            cols = {}
                            for colname, ty in tm.schema.items():
                                vm = (z[f"__v_{colname}"]
                                      if f"__v_{colname}" in z.files
                                      else None)
                                cols[colname] = Column(
                                    ty, z[colname], vm,
                                    tm.dictionaries.get(colname))
                            store.append_batch(ColumnBatch(cols, n), 0)
                            xmin, xmax = z["__xmin"], z["__xmax"]
                            store.xmin_ts[:n] = xmin
                            store.xmax_ts[:n] = xmax
                            store.row_id[:n] = z["__rowid"]
                            store.next_row_id = int(z["__rowid"].max()) + 1
                            # commit stamps only: a prepared row's xmin
                            # (PENDING) and xmax (RESERVED) are not
                            stamps = np.concatenate([xmin, xmax])
                            max_ts = max(max_ts, int(stamps[
                                stamps < RESERVED_TS].max(initial=0)))
                c.stores.setdefault(node, {})[name] = store
        from opentenbase_tpu_torch.sql.parser import Parser

        for name, text in meta.get("views", {}).items():
            c.views[name] = (Parser(text).parse_select(), text)
        if meta.get("matviews"):
            from opentenbase_tpu_torch.matview.defs import register

            for name, mrec in meta["matviews"].items():
                register(c, name, mrec["text"], mrec.get("options") or {},
                         aux_schema=mrec.get("aux_schema"))
        from opentenbase_tpu_torch.plan.partition import PartitionSpec

        for name, pclause in meta.get("partitions", {}).items():
            if not c.catalog.has(name):
                continue
            tm = c.catalog.get(name)
            ps = PartitionSpec.build(name, pclause,
                                     tm.schema[pclause["column"]])
            c.partitions[name] = ps
            # the snapshot gave each child its own (equal) dictionaries;
            # the children share the parent's again, which new rows
            # encode against
            for child in ps.children():
                if not c.catalog.has(child):
                    continue
                cm = c.catalog.get(child)
                cm.dictionaries = tm.dictionaries
                for node in cm.node_indices:
                    store = c.stores.get(node, {}).get(child)
                    if store is not None:
                        store.dictionaries = tm.dictionaries
        c.gts_advance_to(max_ts)
        # the in-doubt transactions this checkpoint holds are pending
        # again, their stable row ids mapped back to restored positions
        for gid, pm in meta.get("prepared", {}).items():
            ws = []
            for wm in pm["writes"]:
                store = c.stores[wm["node"]][wm["table"]]
                rid = store.scan_view().row_id()
                if wm["kind"] == "ins":
                    rid0, n = wm["row_id_start"], wm["nrows"]
                    pos = np.nonzero((rid >= rid0) & (rid < rid0 + n))[0]
                    rng = ((int(pos[0]), int(pos[-1]) + 1) if len(pos)
                           else (0, 0))
                    ws.append({**wm, "range": rng})
                else:
                    ws.append({**wm, "rowids": np.asarray(
                        wm["rowids"], dtype=np.int64)})
            self._pending[gid] = {"gxid": pm["gxid"], "writes": ws}

    def _apply(self, tag: str, header: dict, arrays) -> None:
        c = self.cluster
        if tag == "D":
            op = header["op"]
            if op == "create_table":
                if c.catalog.has(header["name"]):
                    return
                schema = {
                    k: _type_from_str(v) for k, v in header["schema"].items()
                }
                spec = DistributionSpec(
                    DistStrategy(header["strategy"]),
                    tuple(header["key_columns"]),
                    group=header.get("group"),
                )
                meta = c.catalog.create_table(header["name"], schema, spec)
                apply_constraints(meta, header.get("constraints"))
                # a partition shares its parent's dictionaries (the
                # parent's record replays first); exact membership: a
                # table whose name merely holds "$p" keeps its own
                parent = header["name"].split("$p")[0]
                if (parent != header["name"] and parent in c.partitions
                        and header["name"]
                        in c.partitions[parent].children()):
                    meta.dictionaries = c.catalog.get(parent).dictionaries
                c.create_table_stores(meta)
            elif op == "drop_table":
                if c.catalog.has(header["name"]):
                    c.catalog.drop_table(header["name"])
                    c.drop_table_stores(header["name"])
            elif op == "create_parent":
                from opentenbase_tpu_torch.plan.partition import (
                    PartitionSpec,
                )

                if not c.catalog.has(header["name"]):
                    schema = {k: _type_from_str(v)
                              for k, v in header["schema"].items()}
                    pm = c.catalog.create_table(
                        header["name"], schema, DistributionSpec(
                            DistStrategy(header["strategy"]),
                            tuple(header["key_columns"])))
                    apply_constraints(pm, header.get("constraints"))
                    pclause = header["partition"]
                    c.partitions[header["name"]] = PartitionSpec.build(
                        header["name"], pclause, schema[pclause["column"]])
            elif op == "drop_parent":
                c.partitions.pop(header["name"], None)
                if c.catalog.has(header["name"]):
                    c.catalog.drop_table(header["name"])
            elif op == "add_partitions":
                if header["name"] in c.partitions:
                    c.extend_partitions(header["name"], header["count"])
            elif op == "create_foreign_table":
                if not c.catalog.has(header["name"]):
                    schema = {k: _type_from_str(v)
                              for k, v in header["schema"].items()}
                    meta = c.catalog.create_table(
                        header["name"], schema,
                        DistributionSpec(DistStrategy.REPLICATED))
                    meta.node_indices = meta.node_indices[:1]
                    meta.foreign = dict(header["options"])
                    meta.foreign["server"] = header["server"]
            elif op == "create_user":
                c.users[header["name"]] = header["verifier"]
            elif op == "drop_user":
                c.users.pop(header["name"], None)
            elif op == "create_index":
                if c.catalog.has(header["table"]):
                    meta = c.catalog.get(header["table"])
                    for col in header["columns"]:
                        if col in meta.schema:
                            meta.zone_cols.add(col)
            elif op == "dict_extend":
                d = c.catalog.get(header["table"]).dictionaries[
                    header["column"]]
                for v in header["values"]:
                    d.encode_one(v)
            elif op == "ha_generation":
                # a promotion's fencing generation: a monotone maximum,
                # never regressing one learned elsewhere
                g = int(header.get("generation", 0))
                if g > c.node_generation:
                    c.node_generation = g
            elif op == "seq_event":
                self._apply_seq_event(header["event"], header["payload"])
            elif op == "create_view":
                from opentenbase_tpu_torch.sql.parser import Parser

                c.views[header["name"]] = (
                    Parser(header["text"]).parse_select(), header["text"])
            elif op == "drop_view":
                c.views.pop(header["name"], None)
            elif op == "create_function":
                if header.get("language") == "plpgsql":
                    from opentenbase_tpu_torch.plan.plpgsql import (
                        PlpgsqlFunction as fn_cls,
                    )
                else:
                    from opentenbase_tpu_torch.plan.functions import (
                        SqlFunction as fn_cls,
                    )

                c.functions[header["name"]] = fn_cls.create(
                    header["name"], [tuple(a) for a in header["args"]],
                    header["rettype"], header["body"])
            elif op == "drop_function":
                c.functions.pop(header["name"], None)
            elif op == "truncate":
                if c.catalog.has(header["name"]):
                    c.truncate_table(header["name"])
            elif op == "add_column":
                if c.catalog.has(header["name"]):
                    c.alter_add_column(header["name"], header["column"],
                                       _type_from_str(header["type"]))
            elif op == "drop_column":
                if c.catalog.has(header["name"]):
                    c.alter_drop_column(header["name"], header["column"])
            elif op == "redistribute":
                if c.catalog.has(header["name"]):
                    c.redistribute_table(header["name"], DistributionSpec(
                        DistStrategy(header["strategy"]),
                        tuple(header["key_columns"])))
            elif op in ("create_matview", "drop_matview"):
                self._apply_matview(op, header)
            elif op == "wlm_state":
                c.wlm.load_state(header["payload"])
            elif op in ("create_publication", "drop_publication",
                        "create_subscription", "drop_subscription",
                        "subscription_state"):
                self._apply_logical(op, header)
            else:
                raise NotPorted(f"WAL DDL record {op!r}")
            return
        if tag == "G":
            cts = int(header["commit_ts"])
            if header.get("gid"):
                self._record_decision(header["gid"], "commit", cts)
            writes = self._materialize_writes(header["writes"], arrays, cts)
            for wm in writes:
                if wm["kind"] == "del":
                    store = c.stores[wm["node"]][wm["table"]]
                    pos = np.nonzero(
                        np.isin(store.scan_view().row_id(), wm["rowids"])
                    )[0]
                    store.stamp_xmax(pos, cts)
            c.bump_table_versions({wm["table"] for wm in writes})
            c.gts_advance_to(cts)
            return
        if tag == "T":
            # PREPARE TRANSACTION: its writes materialize pending
            self._pending[header["gid"]] = {
                "gxid": header["gxid"],
                "writes": self._materialize_writes(header["writes"],
                                                   arrays, PENDING_TS),
            }
            return
        if tag in ("C", "R"):
            cts = header.get("commit_ts")
            self._record_decision(header["gid"],
                                  "commit" if tag == "C" else "abort", cts)
            pend = self._pending.pop(header["gid"], None)
            if pend is None:
                return
            for wm in pend["writes"]:
                store = c.stores[wm["node"]][wm["table"]]
                if wm["kind"] == "ins":
                    s, e = wm["range"]
                    if tag == "C":
                        store.stamp_xmin(s, e, int(cts))
                    else:
                        store.truncate_range(s, e)
                else:
                    pos = np.nonzero(np.isin(store.scan_view().row_id(),
                                             wm["rowids"]))[0]
                    if tag == "C":
                        store.stamp_xmax(pos, int(cts))
                    else:
                        # release a reservation a checkpoint carried
                        res = pos[store.peek_xmax_at(pos) == RESERVED_TS]
                        if len(res):
                            store.unstamp_xmax(res)
            if tag == "C":
                c.bump_table_versions({wm["table"] for wm in pend["writes"]})
                c.gts_advance_to(int(cts))
            return
        raise NotPorted(f"WAL record {tag!r}")

    def _apply_matview(self, op: str, header: dict) -> None:
        """Redo of CREATE / DROP MATERIALIZED VIEW: the backing and aux
        tables, and the definition (its refresh state comes back with
        the otb_matview_state rows, folded in after redo)."""
        c = self.cluster
        name = header["name"]
        aux_name = f"{name}$aux"
        if op == "drop_matview":
            c.matviews.pop(name, None)
            for tb in (name, aux_name):
                if c.catalog.has(tb):
                    c.catalog.drop_table(tb)
                    c.drop_table_stores(tb)
            return
        if name in c.matviews:
            return
        if not c.catalog.has(name):
            m = c.catalog.create_table(
                name,
                {k: _type_from_str(v) for k, v in header["schema"].items()},
                DistributionSpec(DistStrategy(header["strategy"]),
                                 tuple(header["key_columns"])))
            c.create_table_stores(m)
        aux = header.get("aux_schema")
        if aux and not c.catalog.has(aux_name):
            am = c.catalog.create_table(
                aux_name, {k: _type_from_str(v) for k, v in aux.items()},
                DistributionSpec(DistStrategy.ROUNDROBIN))
            c.create_table_stores(am)
        from opentenbase_tpu_torch.matview.defs import register

        register(c, name, header["text"], header.get("options") or {},
                 aux_schema=aux)

    def _apply_logical(self, op: str, header: dict) -> None:
        """Redo of publication and subscription DDL. A subscription's
        apply worker is built here and started by ``Cluster.recover``
        once redo is done."""
        c = self.cluster
        name = header["name"]
        if op == "create_publication":
            c.publications[name] = {"tables": header["tables"],
                                    "nodes": header["nodes"]}
        elif op == "drop_publication":
            c.publications.pop(name, None)
        elif op == "create_subscription":
            from opentenbase_tpu_torch.storage.logical import (
                SubscriptionWorker,
            )

            w = SubscriptionWorker(c, name, header["conninfo"],
                                   header["publication"])
            if not header.get("copy_data", True):
                w.synced = True
            c.subscriptions[name] = w
        elif op == "drop_subscription":
            w = c.subscriptions.pop(name, None)
            if w is not None:
                w.stop()
        else:  # subscription_state
            w = c.subscriptions.get(name)
            if w is not None:
                w.lsn = max(w.lsn, header["lsn"])
                w.synced = w.synced or header.get("synced", False)

    def _apply_seq_event(self, event: str, pl: dict) -> None:
        """Replay one of the GTM's sequence events into the cluster's GTM.
        A replayed reservation only moves a sequence forward (the GTM's
        own durable mark may be ahead of the WAL); an explicit setval
        always applies. A GTM over the wire keeps its own durable
        sequence state, read by no op: there only a sequence this replay
        created is moved."""
        g = self.cluster.gts
        name = pl["name"]
        if event == "seq_create":
            try:
                g.create_sequence(
                    name, pl.get("start", 1), pl.get("increment", 1),
                    pl.get("min", 1), pl.get("max", 2**62),
                    pl.get("cycle", False))
            except ValueError:
                return  # the GTM's own state has it already
            self._seq_replayed[name] = (int(pl.get("start", 1)),
                                        int(pl.get("increment", 1)))
        elif event == "seq_drop":
            g.drop_sequence(name)
            self._seq_replayed.pop(name, None)
        elif event in ("seq_next", "seq_set"):
            target = pl.get("next", pl.get("value"))
            if target is None:
                return
            seqs = getattr(g, "_seqs", None)
            if seqs is not None:
                s = seqs.get(name)
                if s is None:
                    return
                cur, inc = s.next_value, s.increment
            elif name in self._seq_replayed:
                cur, inc = self._seq_replayed[name]
            else:
                return
            ahead = target > cur if inc >= 0 else target < cur
            if event == "seq_set" or ahead:
                g.setval(name, int(target))
                if seqs is None:
                    self._seq_replayed[name] = (int(target), inc)

    def _apply_dict_delta(self, wm: dict) -> None:
        """An absolutely positioned dictionary extend, idempotent: values
        already present are skipped by ``encode_one``'s dedup. A gap
        (the local dictionary shorter than ``start``) means earlier
        values have not arrived: appending now would mint wrong codes,
        so nothing is applied (a direct apply checks
        ``frame_apply_gap`` first; in stream order the gap cannot
        happen)."""
        c = self.cluster
        if not c.catalog.has(wm["table"]):
            return
        tm = c.catalog.get(wm["table"])
        d = tm.dictionaries.setdefault(wm["column"], Dictionary())
        if len(d) < int(wm.get("start", 0)):
            return
        for v in wm["values"]:
            d.encode_one(v)

    def frame_apply_gap(self, sub: list) -> bool:
        """True when a direct apply of this frame would lose or corrupt
        data because this replica is behind the coordinator's WAL: a
        touched table's DDL has not streamed yet, a dictionary record
        starts above the local dictionary's length, or an insert names
        a column the local schema lacks. The caller defers to stream
        delivery, which replays the missing records in order."""
        c = self.cluster
        for wm in sub:
            if not c.catalog.has(wm["table"]):
                return True
            tm = c.catalog.get(wm["table"])
            if wm.get("kind") == "dict":
                d = tm.dictionaries.get(wm["column"])
                have = 0 if d is None else len(d)
                if have < int(wm.get("start", 0)):
                    return True
            elif wm.get("kind") == "ins":
                if not set(wm.get("cols", ())) <= set(tm.schema):
                    return True
        return False

    def _materialize_writes(
        self, writes: list[dict], arrays, xmin_ts: int
    ) -> list[dict]:
        """Apply the dictionary and insert sub-records of a 'G' frame
        (inserts at ``xmin_ts``) and return the row sub-records with
        replayed positions; delete sub-records pass through with their
        row ids."""
        c = self.cluster
        out = []
        for i, wm in enumerate(writes):
            kind = wm.get("kind")
            if kind == "dict":
                # before the rows that carry its codes; ``i`` stays
                # aligned because the encoder counted this record too
                self._apply_dict_delta(wm)
                continue
            if kind not in ("ins", "del"):
                raise NotPorted(f"commit sub-record {kind!r}")
            if not c.catalog.has(wm["table"]):
                continue
            tm = c.catalog.get(wm["table"])
            node = wm["node"]
            if node not in tm.node_indices:
                raise NotPorted("MOVE DATA record")
            if kind == "ins":
                cols = {
                    colname: Column(
                        ty, arrays[f"w{i}_{colname}"],
                        arrays.get(f"w{i}__v_{colname}"),
                        tm.dictionaries.get(colname))
                    for colname, ty in tm.schema.items()
                }
                s, e = c.stores[node][wm["table"]].append_delta(
                    ColumnBatch(cols, wm["nrows"]), xmin_ts,
                    row_id_start=wm["row_id_start"],
                )
                out.append({**wm, "range": (s, e)})
            else:
                out.append({**wm, "rowids": arrays[f"w{i}_del"]})
        return out


"""Partitioned durable log connector — the Kafka connector analog (port of
``flink_tpu/connectors/partitioned_log.py``: the same partition files, FTB
frames through the port's ``native/codec.py``).

The reference's flagship connector is Kafka
(``flink-connectors/flink-connector-kafka``: ``KafkaSource`` FLIP-27 +
exactly-once ``KafkaSink`` with transactions).  No broker exists in this
environment, so the same *semantics* are provided against a local durable
partitioned log: N append-only partition files of CRC-framed FTB batches.

- :class:`PartitionedLog` — the "broker": append/read per partition, byte
  offsets are the consumer positions (Kafka offsets analog).
- :class:`LogSource` — FLIP-27 source: one split per partition, reader
  position = byte offset, checkpointed by the executor and resumed exactly
  (``KafkaSourceReader`` offset snapshot analog).  Bounded (read to current
  end) or unbounded (tail with polling).
- :class:`LogSink` — transactional sink (``KafkaSink`` EXACTLY_ONCE analog):
  batches buffer in memory per epoch; ``snapshot_state`` stages them as a
  transaction in the checkpoint; ``notify_checkpoint_complete`` appends to
  the log and records the committed transaction id in a sidecar, so a
  restore never double-commits (two-phase commit protocol,
  ``TwoPhaseCommitSinkFunction.java`` analog).
"""

from __future__ import annotations

import json
import os
import struct
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from flink_tpu_torch.connectors.sources import Source, SourceSplit
from flink_tpu_torch.core.batch import RecordBatch, StreamElement

_FRAME = struct.Struct("<II")  # payload_len, crc32


class PartitionedLog:
    """Local durable partitioned log of RecordBatches."""

    def __init__(self, directory: str, num_partitions: int = 1):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        meta = os.path.join(directory, "_meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                self.num_partitions = json.load(f)["num_partitions"]
        else:
            self.num_partitions = num_partitions
            with open(meta, "w") as f:
                json.dump({"num_partitions": num_partitions}, f)

    def _path(self, partition: int) -> str:
        return os.path.join(self.directory, f"partition-{partition:04d}.log")

    @staticmethod
    def exists(directory: str) -> bool:
        return os.path.exists(os.path.join(directory, "_meta.json"))

    def append(self, partition: int, batch: RecordBatch) -> int:
        """Append one batch; returns the end offset after the write."""
        from flink_tpu_torch.formats import write_frame
        from flink_tpu_torch.native.codec import encode_batch

        with open(self._path(partition), "ab") as f:
            write_frame(f, encode_batch(batch))
            f.flush()
            os.fsync(f.fileno())
            return f.tell()

    def end_offset(self, partition: int) -> int:
        p = self._path(partition)
        return os.path.getsize(p) if os.path.exists(p) else 0

    def read_from(self, partition: int, offset: int):
        """Yield ``(batch, next_offset)`` from ``offset`` to current end."""
        from flink_tpu_torch.formats import read_frames
        from flink_tpu_torch.native.codec import decode_batch

        p = self._path(partition)
        if not os.path.exists(p):
            return
        for payload, next_off in read_frames(p, offset):
            yield decode_batch(payload), next_off


class _LogSplitReader:
    """Reader for one partition; ``position`` = committed byte offset."""

    def __init__(self, log: PartitionedLog, partition: int, position: int,
                 bounded: bool, poll_interval_ms: int, idle_timeout_ms: int):
        self.log = log
        self.partition = partition
        self.position = int(position)
        self.bounded = bounded
        self.poll_interval_ms = poll_interval_ms
        self.idle_timeout_ms = idle_timeout_ms
        self._gen = self._run()

    def _run(self) -> Iterator[StreamElement]:
        idle_since = time.monotonic()
        while True:
            got = False
            for batch, next_off in self.log.read_from(self.partition, self.position):
                self.position = next_off
                got = True
                idle_since = time.monotonic()
                yield batch
            if self.bounded:
                return
            if not got:
                if (self.idle_timeout_ms and (time.monotonic() - idle_since)
                        * 1000 > self.idle_timeout_ms):
                    return
                time.sleep(self.poll_interval_ms / 1000.0)
                # yield control to the executor: an idle partition must not
                # starve the other splits' round-robin (empty batches route
                # harmlessly); also lets wall/record budgets + checkpoints run
                yield RecordBatch({})

    def __iter__(self):
        return self

    def __next__(self) -> StreamElement:
        return next(self._gen)


class LogSource(Source):
    """FLIP-27 source over a PartitionedLog: one split per partition."""

    def __init__(self, directory: str, bounded: bool = True,
                 poll_interval_ms: int = 20, idle_timeout_ms: int = 0):
        self.directory = directory
        self.bounded = bounded
        self.poll_interval_ms = poll_interval_ms
        self.idle_timeout_ms = idle_timeout_ms

    def create_splits(self, parallelism: int) -> List[SourceSplit]:
        if not PartitionedLog.exists(self.directory):
            # a typo'd path must fail loudly, not create an empty log and
            # run a successful empty job
            raise FileNotFoundError(
                f"LogSource: no partitioned log at {self.directory!r}")
        log = PartitionedLog(self.directory)
        return [LogSplit(self, p, log.num_partitions, partition=p)
                for p in range(log.num_partitions)]

    def open_split(self, split: "LogSplit",
                   position: Optional[int]) -> _LogSplitReader:
        return _LogSplitReader(PartitionedLog(self.directory), split.partition,
                               position or 0, self.bounded,
                               self.poll_interval_ms, self.idle_timeout_ms)


@dataclass
class LogSplit(SourceSplit):
    partition: int = 0

    @property
    def split_id(self) -> str:
        return f"partition-{self.partition}"

    def read(self) -> Iterator[StreamElement]:
        return self.source.open_split(self, 0)


class LogSink:
    """Exactly-once transactional sink into a PartitionedLog.

    Partitioning: ``hash(key_column) % num_partitions`` when a key column is
    given, else round-robin per batch.

    Parallel use: the runtime CLONES this sink per subtask
    (``clone_per_subtask``) — every instance gets its own attempt id, epoch
    buffer, and commit sidecar, so per-subtask barriers stage disjoint
    transactions.
    """

    clone_per_subtask = True

    def __init__(self, directory: str, num_partitions: int = 1,
                 key_column: Optional[str] = None, txn_id: str = "logsink"):
        import uuid

        self.log = PartitionedLog(directory, num_partitions)
        self.key_column = key_column
        self.txn_id = txn_id
        #: unique per sink attempt; committed-txn dedup keys on
        #: (attempt, cid), so a FRESH job writing to a directory with a
        #: stale sidecar never mistakes its own new txns for committed ones.
        #: A restore adopts the snapshot's attempt (see restore_state).
        self._attempt = uuid.uuid4().hex[:12]
        self._epoch: List[RecordBatch] = []
        self._staged: Dict[int, List[RecordBatch]] = {}
        self._rr = 0
        self.directory = directory
        # a crashed predecessor may have left a half-appended transaction
        self._recover_partial_commits()

    @property
    def _commits_path(self) -> str:
        # per-ATTEMPT sidecar: parallel clones and restored instances never
        # read-modify-write one shared file
        return os.path.join(self.directory,
                            f"_commits-{self.txn_id}-{self._attempt}.json")

    def _txn_lock(self):
        """Exclusive cross-process/thread lock for commit + recovery critical
        sections: sibling subtask clones share the directory, and recovery
        must never observe (or truncate under) a sibling's in-flight commit."""
        import fcntl
        from contextlib import contextmanager

        @contextmanager
        def lock():
            fd = os.open(os.path.join(self.directory, "_txnlock"),
                         os.O_CREAT | os.O_RDWR)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                yield
            finally:
                os.close(fd)  # releases the flock

        return lock()

    def on_cloned(self) -> None:
        """Fresh identity for a per-subtask clone."""
        import uuid

        self._attempt = uuid.uuid4().hex[:12]
        self._epoch = []
        self._staged = {}

    def _committed_ids(self) -> List[str]:
        """UNION over every attempt's sidecar (+ the legacy shared file):
        recovery decisions must see commits recorded by ANY prior attempt or
        sibling — keys are attempt-qualified, so the union never collides."""
        out: List[str] = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        prefix = f"_commits-{self.txn_id}"
        for f in names:
            if f.startswith(prefix) and f.endswith(".json"):
                try:
                    with open(os.path.join(self.directory, f)) as fh:
                        out.extend(json.load(fh))
                except (OSError, ValueError):
                    continue
        return out

    def _commit_key(self, checkpoint_id: int) -> str:
        return f"{self._attempt}:{checkpoint_id}"

    def _record_commit(self, checkpoint_id: int) -> None:
        # write ONLY this attempt's keys into its own sidecar (reads union
        # all attempts): mixing the union in would evict other attempts'
        # keys in arbitrary order once the 100-entry bound is hit
        own: List[str] = []
        if os.path.exists(self._commits_path):
            try:
                with open(self._commits_path) as f:
                    own = json.load(f)
            except (OSError, ValueError):
                own = []
        own.append(self._commit_key(checkpoint_id))
        tmp = self._commits_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(own[-100:], f)
        os.replace(tmp, self._commits_path)

    # -- Sink interface ------------------------------------------------------
    def write_batch(self, batch: RecordBatch) -> None:
        if len(batch):
            self._epoch.append(batch)

    def flush(self) -> None:
        # bounded end: no more barriers will come. ORDER MATTERS: staged
        # (older) transactions must land in the log BEFORE the final epoch's
        # rows, or consumers reading "last value per key" see stale data
        for cid in sorted(self._staged):
            self._commit(cid)
        for b in self._epoch:
            self._append(b)
        self._epoch = []

    def close(self) -> None:
        pass

    def _append(self, batch: RecordBatch) -> None:
        from flink_tpu_torch.core.keygroups import hash_keys

        n_p = self.log.num_partitions
        if self.key_column is None or n_p == 1:
            self.log.append(self._rr % n_p, batch)
            self._rr += 1
            return
        # stable hash (process-seeded builtins would reshuffle key->partition
        # affinity across restarts, breaking per-key ordering)
        keys = np.asarray(batch.column(self.key_column))
        parts = (np.abs(hash_keys(keys).astype(np.int64)) % n_p).astype(np.int32)
        for p in np.unique(parts).tolist():
            self.log.append(int(p), batch.select(parts == p))

    # -- two-phase commit ----------------------------------------------------
    def snapshot_state(self) -> Dict[str, Any]:
        """Pre-commit: stage this epoch's batches under the NEXT barrier id
        (the executor calls snapshot then notify with the same id)."""
        staged_now = self._epoch
        self._epoch = []
        self._staged_counter = getattr(self, "_staged_counter", 0) + 1
        self._staged[self._staged_counter] = staged_now
        return {"staged": dict(self._staged), "counter": self._staged_counter,
                "attempt": self._attempt}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._recover_partial_commits()
        # adopt the snapshot's attempt: its committed txn keys must match
        self._attempt = snap.get("attempt", self._attempt)
        self._staged_counter = int(snap.get("counter", 0))
        committed = set(self._committed_ids())
        self._staged = {}
        for cid, batches in snap.get("staged", {}).items():
            cid = int(cid)
            if self._commit_key(cid) in committed:
                continue  # already in the log: never double-append
            self._staged[cid] = list(batches)
        # transactions staged in a completed checkpoint are owed to the log
        for cid in sorted(self._staged):
            self._commit(cid)

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        for cid in sorted(self._staged):
            self._commit(cid)

    # -- atomic commit protocol ---------------------------------------------
    # A commit writes an *intent* file (txn id + current end offsets) before
    # appending, and removes it after the sidecar records the commit. A crash
    # mid-append leaves the intent behind; recovery truncates each partition
    # back to the intent offsets and the restore re-appends the whole txn —
    # the log never holds a half transaction (2PC with rollback, the
    # ``TwoPhaseCommitSinkFunction`` recoverAndAbort analog).

    def _intent_path(self, cid: int) -> str:
        return os.path.join(self.log.directory,
                            f"_intent-{self.txn_id}-{self._attempt}-{cid}.json")

    def _recover_partial_commits(self) -> None:
        with self._txn_lock():
            committed = set(self._committed_ids())
            for f in os.listdir(self.log.directory):
                if not f.startswith(f"_intent-{self.txn_id}-"):
                    continue
                path = os.path.join(self.log.directory, f)
                try:
                    with open(path) as fh:
                        intent = json.load(fh)
                except (FileNotFoundError, ValueError):
                    continue  # sibling recovered it concurrently
                if intent["key"] not in committed:
                    for p_str, off in intent["offsets"].items():
                        lp = self.log._path(int(p_str))
                        if os.path.exists(lp) and os.path.getsize(lp) > off:
                            with open(lp, "r+b") as lf:
                                lf.truncate(off)
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass

    def _commit(self, cid: int) -> None:
        batches = self._staged.pop(cid, None)
        if batches is None or self._commit_key(cid) in self._committed_ids():
            return
        if not batches:
            self._record_commit(cid)
            return
        # the whole intent->append->record->cleanup sequence runs under the
        # directory txn lock so a sibling's recovery can never truncate a
        # half-appended transaction that is actually in progress
        with self._txn_lock():
            offsets = {p: self.log.end_offset(p)
                       for p in range(self.log.num_partitions)}
            tmp = self._intent_path(cid) + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"key": self._commit_key(cid), "offsets": offsets},
                          f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._intent_path(cid))
            for b in batches:
                self._append(b)
            self._record_commit(cid)
            try:
                os.remove(self._intent_path(cid))
            except FileNotFoundError:
                pass

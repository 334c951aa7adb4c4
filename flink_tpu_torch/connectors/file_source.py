"""File system connector: split-based source + two-phase-commit sink (the
port's copy of ``flink_tpu/connectors/file_source.py``).

The FLIP-27 file source analog (``flink-connectors/flink-connector-files``:
``FileSource`` + ``SplitEnumerator`` over file splits): one split per
matched file, readers track a **row position** so checkpoints capture exact
resume points — the executor snapshots ``reader.position`` per split and
hands it back to ``open_split`` on restore (``SourceReader.snapshotState``
analog).  The SQL ``filesystem`` connector reads through it.

Sink side is the ``StreamingFileSink``/``FileSink`` two-phase commit:
records append to an in-progress part file; ``snapshot_state`` rolls it into
the *pending* set (pre-commit); ``notify_checkpoint_complete`` atomically
renames pending parts to their final names (commit).  A restore re-commits
pending parts from the snapshot and discards orphaned in-progress files —
exactly-once file output.  Parts are the same bytes as JAX's, and a pending
group either package snapshots commits or restores in the other.
"""

from __future__ import annotations

import glob as _glob
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.connectors.sources import Source, SourceSplit
from flink_tpu_torch.core.batch import RecordBatch, StreamElement
from flink_tpu_torch.formats import reader_for, writer_for


class _PositionedFileReader:
    """Iterator over one file's batches; ``position`` = rows already emitted
    (checkpointable, consumed by ``open_split`` on restore)."""

    def __init__(self, source: "FileSource", path: str, start_row: int):
        self.position = int(start_row)
        self._it = source._read_file(path, start_row)

    def __iter__(self):
        return self

    def __next__(self) -> StreamElement:
        el = next(self._it)
        if isinstance(el, RecordBatch):
            self.position += len(el)
        return el


class FileSource(Source):
    """Reads a file, directory, or glob in any format of
    :data:`~flink_tpu_torch.formats.FORMATS` (``csv``, ``jsonl``, ``ftb``,
    ``avro``, ``parquet``, ``orc``, ``seq``).  One split per file
    (``FileSourceSplit`` analog)."""

    def __init__(self, path: str, format: str = "csv",
                 timestamp_column: Optional[str] = None,
                 batch_size: int = 8192, **format_kwargs):
        self.path = path
        self.format = format
        self.timestamp_column = timestamp_column
        self.batch_size = batch_size
        self.format_kwargs = format_kwargs
        reader_for(format)  # validate eagerly

    def _files(self) -> List[str]:
        if os.path.isdir(self.path):
            fs = [os.path.join(self.path, f) for f in sorted(os.listdir(self.path))
                  if not f.startswith((".", "_"))]
        else:
            fs = sorted(_glob.glob(self.path)) or [self.path]
        files = [f for f in fs if os.path.isfile(f)]
        if not files and not os.path.isdir(self.path):
            # a typo'd path must fail loudly, not run an empty job to success
            raise FileNotFoundError(
                f"FileSource: no files match {self.path!r}")
        return files

    def create_splits(self, parallelism: int) -> List[SourceSplit]:
        files = self._files()
        return [FileSplit(self, i, len(files), path=f) for i, f in enumerate(files)]

    def _read_file(self, path: str, start_row: int) -> Iterator[StreamElement]:
        read = reader_for(self.format)
        kw = dict(self.format_kwargs)
        if self.format in ("csv", "jsonl", "seq"):
            kw.setdefault("batch_size", self.batch_size)
            kw["timestamp_column"] = self.timestamp_column
            kw["skip_rows"] = start_row
            yield from read(path, **kw)
        else:  # ftb: frame-level skip by rows
            skipped = 0
            for b in read(path, **kw):
                if skipped + len(b) <= start_row:
                    skipped += len(b)
                    continue
                if skipped < start_row:  # partial batch resume
                    b = b.take(np.arange(start_row - skipped, len(b)))
                    skipped = start_row
                yield b

    # stateful-reader protocol (used by the executor; falls back to
    # ``split.read()`` for sources that don't implement it)
    def open_split(self, split: "FileSplit",
                   position: Optional[int]) -> _PositionedFileReader:
        return _PositionedFileReader(self, split.path, position or 0)


@dataclass
class FileSplit(SourceSplit):
    path: str = ""

    @property
    def split_id(self) -> str:
        return self.path

    def read(self) -> Iterator[StreamElement]:
        return self.source.open_split(self, 0)


@dataclass
class RollingPolicy:
    """When an in-progress part rolls (``DefaultRollingPolicy`` analog,
    ``flink-connector-files/.../sink/FileSink.java:1``): by rows, bytes, or
    age.  Every policy ALSO rolls at checkpoints — the exactly-once part
    lifecycle here binds parts to checkpoint ids (the reference's
    ``OnCheckpointRollingPolicy`` made universal; the reference's
    resumable in-progress writer — truncate-on-restore — is simplified
    away, at the cost of at least one part per checkpoint interval)."""

    max_rows: int = 1 << 20
    max_bytes: int = 128 << 20
    rollover_interval_ms: Optional[int] = None


class DateTimeBucketAssigner:
    """Per-row event-time buckets (``DateTimeBucketAssigner`` analog):
    rows land in ``<directory>/<strftime(fmt)>/part-...``."""

    def __init__(self, fmt: str = "%Y-%m-%d--%H"):
        self.fmt = fmt

    def __call__(self, batch: RecordBatch) -> List[str]:
        import datetime
        ts = batch.timestamps
        if ts is None:
            return [""] * len(batch)
        # strftime only the distinct SECONDS (bucket formats are >= 1s
        # resolution), not every row — batches land in a handful of buckets
        secs = np.asarray(ts, np.int64) // 1000
        uniq, inv = np.unique(secs, return_inverse=True)
        names = [datetime.datetime.fromtimestamp(
            int(s), tz=datetime.timezone.utc).strftime(self.fmt)
            for s in uniq.tolist()]
        return [names[i] for i in inv.tolist()]


class _InProgressPart:
    """One bucket's open part.  Row formats (csv/jsonl) STREAM to a real
    ``.inprogress`` file (bounded memory); bulk formats (ftb/avro) buffer
    batches and materialize at roll (the reference's row-encoded vs bulk
    writer split)."""

    def __init__(self, fmt: str, path: str, row_format: bool):
        self.fmt = fmt
        self.path = path                   # local .inprogress path
        self.row_format = row_format
        self.rows = 0
        self.bytes = 0
        self.created = time.time()
        self._buf: List[RecordBatch] = []
        self._fh = None
        self._columns: Optional[List[str]] = None

    def append(self, batch: RecordBatch) -> None:
        self.rows += len(batch)
        if not self.row_format:
            self._buf.append(batch)
            self.bytes += sum(np.asarray(v).nbytes
                              for v in batch.columns.values())
            return
        import csv as _csv
        import io
        import json as _json
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "ab")
        out = io.StringIO()
        cols = {k: np.asarray(v) for k, v in batch.columns.items()}
        if self.fmt == "csv":
            # csv.writer for quoting/escaping (commas, quotes, newlines in
            # string values) — same dialect formats.write_csv produces
            if self._columns is None:
                self._columns = list(cols)
            cw = _csv.writer(out)
            if self.bytes == 0:
                cw.writerow(self._columns)
            for i in range(len(batch)):
                cw.writerow([_plain(cols[c][i]) for c in self._columns])
        else:                              # jsonl
            names = list(cols)
            for i in range(len(batch)):
                out.write(_json.dumps({c: _plain(cols[c][i])
                                       for c in names}) + "\n")
        data = out.getvalue().encode()
        self._fh.write(data)
        self.bytes += len(data)

    def finish(self) -> None:
        """Materialize/close the .inprogress file."""
        if self.row_format:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        writer_for(self.fmt)(self._buf, self.path)
        self._buf = []

    def abandon(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if os.path.exists(self.path):
            os.remove(self.path)


def _plain(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()                  # multi-dim column cell
    return v


class FileSink:
    """Exactly-once two-phase-commit file sink (``FileSink.java:1`` +
    ``StreamingFileSink`` analog).  Part lifecycle: a real
    ``.inprogress`` file per bucket → rolled (policy or checkpoint) into
    ``.pending`` bound to the checkpoint id of the snapshot that rolled it
    (``current_checkpoint_id()``) → finalized when THAT checkpoint (or a
    later one) completes.  A pending part of checkpoint N+1 is NOT
    committed by checkpoint N's notification — a restore to N after N+1
    fails would otherwise double its rows.  Restore re-commits the
    snapshot's pending groups (idempotent) and discards this subtask's
    orphaned in-progress/pending files.

    ``filesystem``: None writes to the local directory; an object with
    ``put_object(key, bytes)``/``list_keys(prefix)`` (the in-repo
    :class:`~flink_tpu_torch.filesystems.s3.S3Client`) stages parts in the
    local ``directory`` and uploads on commit — the S3 committer pattern (no
    rename on object stores)."""

    clone_per_subtask = True

    def on_cloned(self) -> None:
        import uuid

        self._attempt = uuid.uuid4().hex[:8]
        self._parts = {}
        self._groups = []
        self._open_group = []

    def __init__(self, directory: str, format: str = "csv",
                 rolling_records: Optional[int] = None, prefix: str = "part",
                 rolling_policy: Optional[RollingPolicy] = None,
                 bucket_assigner=None, filesystem=None):
        import uuid

        self.directory = directory
        self.format = format
        self.prefix = prefix
        if rolling_policy is None:
            self.policy = RollingPolicy(max_rows=rolling_records or (1 << 20))
        elif rolling_records is not None:
            # never mutate the caller's (possibly shared) policy object
            import dataclasses
            self.policy = dataclasses.replace(rolling_policy,
                                              max_rows=rolling_records)
        else:
            self.policy = rolling_policy
        self.bucket_assigner = bucket_assigner
        self.fs = filesystem
        self._row_format = format in ("csv", "jsonl")
        #: unique per sink attempt, so a restarted job never collides with an
        #: orphaned part file of a previous attempt (reference part files
        #: carry subtask + bucket uid for the same reason)
        self._attempt = uuid.uuid4().hex[:8]
        #: set by open(ctx); scopes part names AND orphan cleanup so parallel
        #: sink subtasks sharing a directory never delete each other's parts
        self._subtask_index = 0
        self._counter = 0
        #: bucket -> open _InProgressPart
        self._parts: Dict[str, _InProgressPart] = {}
        #: rolled parts awaiting their checkpoint's completion:
        #: [(checkpoint_id | None, [(local_pending_path, final_name), ...])]
        self._groups: List[Tuple[Optional[int], List[Tuple[str, str]]]] = []
        #: parts rolled since the last snapshot (join the next group)
        self._open_group: List[Tuple[str, str]] = []
        writer_for(format)
        os.makedirs(directory, exist_ok=True)

    # -- Sink interface ------------------------------------------------------
    def open(self, ctx) -> None:
        self._subtask_index = getattr(ctx, "subtask_index", 0)

    def write_batch(self, batch: RecordBatch) -> None:
        if len(batch) == 0:
            return
        if self.bucket_assigner is None:
            self._write_bucket("", batch)
            return
        buckets = self.bucket_assigner(batch)
        if isinstance(buckets, str):
            self._write_bucket(buckets, batch)
            return
        arr = np.asarray(buckets)
        for b in sorted(set(arr.tolist())):
            self._write_bucket(str(b), batch.select(arr == b))

    def _write_bucket(self, bucket: str, batch: RecordBatch) -> None:
        part = self._parts.get(bucket)
        if part is None:
            part = self._parts[bucket] = _InProgressPart(
                self.format, self._local_path(bucket, self._counter)
                + ".inprogress", self._row_format)
            self._counter += 1
        part.append(batch)
        p = self.policy
        age_ms = (time.time() - part.created) * 1000.0
        if (part.rows >= p.max_rows or part.bytes >= p.max_bytes
                or (p.rollover_interval_ms is not None
                    and age_ms >= p.rollover_interval_ms)):
            self._roll_bucket(bucket)

    def _final_name(self, bucket: str, n: int) -> str:
        name = (f"{self.prefix}-s{self._subtask_index}-{self._attempt}-"
                f"{n:05d}.{self.format}")
        return f"{bucket}/{name}" if bucket else name

    def _local_path(self, bucket: str, n: int) -> str:
        return os.path.join(self.directory, self._final_name(bucket, n))

    def _roll_bucket(self, bucket: str) -> None:
        part = self._parts.pop(bucket, None)
        if part is None or part.rows == 0:
            if part is not None:
                part.abandon()
            return
        part.finish()
        base = part.path[: -len(".inprogress")]
        pending = base + ".pending"
        os.replace(part.path, pending)
        self._open_group.append(
            (pending, os.path.relpath(base, self.directory)))

    def _roll(self) -> None:
        for bucket in list(self._parts):
            self._roll_bucket(bucket)

    def flush(self) -> None:
        # bounded end-of-input: roll and commit immediately (no more barriers)
        self._roll()
        self._groups.append((None, self._open_group))
        self._open_group = []
        self.commit_pending()

    def close(self) -> None:
        pass

    # -- two-phase commit ----------------------------------------------------
    def snapshot_state(self) -> Dict[str, Any]:
        from flink_tpu_torch.operators.base import current_checkpoint_id

        self._roll()
        if self._open_group:
            cp = current_checkpoint_id()
            if cp is None:
                # outside snapshot_scope the group cannot be bound to a
                # checkpoint: it will commit on the NEXT notification of ANY
                # checkpoint — weaker than the id-bound contract, so surface
                # the misuse (in-repo runtimes always set the scope)
                import warnings
                warnings.warn(
                    "FileSink.snapshot_state() called outside "
                    "snapshot_scope(checkpoint_id); pending parts commit on "
                    "the next notification instead of their own checkpoint",
                    RuntimeWarning, stacklevel=2)
            self._groups.append((cp, self._open_group))
            self._open_group = []
        return {"pending_groups": [(cp, list(parts))
                                   for cp, parts in self._groups],
                # legacy flat view (pre-r4 snapshots carried "pending")
                "pending": [p for _cp, parts in self._groups
                            for p, _f in parts],
                "counter": self._counter}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        self._counter = int(snap.get("counter", 0))
        if "pending_groups" in snap:
            self._groups = [(cp, [tuple(e) for e in parts])
                            for cp, parts in snap["pending_groups"]]
        else:
            self._groups = [(None, [(p, os.path.relpath(
                p[: -len(".pending")], self.directory))
                for p in snap.get("pending", [])])]
        # parts pending in a COMPLETED checkpoint belong to the output:
        # re-commit them all (idempotent — a missing staged file means the
        # commit already happened before the crash)
        self.commit_pending()
        # orphaned in-progress/pending files from a FAILED epoch are not in
        # the snapshot and must not leak into results.  Scope to THIS
        # subtask's slot of THIS prefix — sibling subtasks and other sinks
        # sharing the directory own their own parts.
        scope = f"{self.prefix}-s{self._subtask_index}-"
        for root, _dirs, files in os.walk(self.directory):
            for f in files:
                if (f.endswith((".pending", ".inprogress"))
                        and f.startswith(scope)):
                    os.remove(os.path.join(root, f))

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        self.commit_pending(checkpoint_id)

    def commit_pending(self, up_to_checkpoint: Optional[int] = None) -> None:
        """Finalize pending groups bound to checkpoints <= the completed id
        (None = everything: restore re-commit and bounded end-of-input)."""
        keep = []
        for cp, parts in self._groups:
            if (up_to_checkpoint is not None and cp is not None
                    and cp > up_to_checkpoint):
                keep.append((cp, parts))
                continue
            for pending, final_name in parts:
                if not os.path.exists(pending):
                    continue                       # already committed
                if self.fs is None:
                    os.replace(pending,
                               os.path.join(self.directory, final_name))
                else:
                    with open(pending, "rb") as f:
                        self.fs.put_object(final_name.replace(os.sep, "/"),
                                           f.read())
                    os.remove(pending)
        self._groups = keep

    # -- inspection ----------------------------------------------------------
    def committed_files(self) -> List[str]:
        if self.fs is not None:
            return sorted(k for k in self.fs.list_keys("")
                          if os.path.basename(k).startswith(self.prefix))
        out = []
        for root, _dirs, files in os.walk(self.directory):
            for f in files:
                if (f.startswith(self.prefix)
                        and not f.endswith((".pending", ".inprogress"))):
                    out.append(os.path.join(root, f))
        return sorted(out)

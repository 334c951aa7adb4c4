"""Runtime split enumeration: the FLIP-27 ``SplitEnumerator`` on the
coordinator (VERDICT r1 #6).

The reference runs a ``SplitEnumerator`` inside the JobMaster's
``SourceCoordinator`` (``flink-runtime/.../source/coordinator/
SourceCoordinator.java:75``): readers send ``RequestSplitEvent``s over RPC
(handled at ``:155-170``), the enumerator assigns splits one at a time, and
its state is snapshotted into every checkpoint (``checkpointCoordinator``
path ``:229``).  This module is the framework-side contract plus a
directory-watching file source whose split list GROWS while the job runs —
the dynamic case static deploy-time split creation cannot express.

Runtime wiring: ``cluster/minicluster.py`` hosts a ``SourceCoordinator``
(same process, RPC collapsed to a locked call) and ``cluster/distributed.py``
carries ``split_request``/``split_assign`` control messages between worker
processes and the coordinator (the actual RPC case).

The port's copy of ``flink_tpu/connectors/enumerator.py`` (host Python, as JAX's).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

from flink_tpu_torch.connectors.sources import Source, SourceSplit


class SplitEnumerator:
    """Coordinator-side split assignment (``SplitEnumerator.java`` analog).

    Contract: ``next_split`` hands out each split exactly once; ``None``
    with ``done() == False`` means "nothing right now, poll again" (an
    unbounded directory may grow); ``done() == True`` ends the reader."""

    def next_split(self, reader_id: int) -> Optional[SourceSplit]:
        raise NotImplementedError

    def done(self) -> bool:
        raise NotImplementedError

    def snapshot_state(self) -> Dict[str, Any]:
        """Checkpointed with the job (``SourceCoordinator.java:229``)."""
        return {}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        pass

    def reclaim(self, split) -> None:
        """Restore reconciliation: a split found in a READER's restored
        snapshot is owned by that reader even if it was assigned after this
        enumerator's snapshot — never hand it out again.  Accepts a split
        object OR its plain ``split_id()`` string (readers snapshot ids)."""
        pass


class _StaticEnumerator(SplitEnumerator):
    """Wraps a fixed split list (the deploy-time behavior, made requestable).

    Tracks the assigned-id SET (not a cursor) and honors ``reclaim()``: a
    split handed out after this enumerator's trigger-time snapshot but owned
    by a reader at the barrier is re-marked assigned on restore instead of
    being assigned twice (duplicate reads)."""

    def __init__(self, splits: List[SourceSplit]):
        from flink_tpu_torch.connectors.sources import split_id_of

        self._splits = list(splits)
        self._ids = [split_id_of(s) for s in self._splits]  # precomputed
        self._assigned: set = set()
        self._cursor = 0     # first possibly-unassigned position
        self._lock = threading.Lock()

    def next_split(self, reader_id: int) -> Optional[SourceSplit]:
        with self._lock:
            while self._cursor < len(self._splits):
                i = self._cursor
                self._cursor += 1
                if self._ids[i] not in self._assigned:
                    self._assigned.add(self._ids[i])
                    return self._splits[i]
            return None

    def done(self) -> bool:
        with self._lock:
            return (self._cursor >= len(self._splits)
                    or all(i in self._assigned
                           for i in self._ids[self._cursor:]))

    def snapshot_state(self) -> Dict[str, Any]:
        with self._lock:
            return {"assigned": sorted(self._assigned)}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        with self._lock:
            if "next" in snap:   # pre-r3 cursor snapshots
                self._assigned = set(self._ids[:snap["next"]])
            else:
                self._assigned = set(snap.get("assigned", []))
            self._cursor = 0

    def reclaim(self, split) -> None:
        from flink_tpu_torch.connectors.sources import split_id_of

        if split is not None:
            with self._lock:
                self._assigned.add(
                    split if isinstance(split, str) else split_id_of(split))


class DynamicFileSource(Source):
    """Directory-watching file source: every file is one split, NEW files
    appearing while the job runs become new splits (the continuous
    ``FileSource`` / ``ContinuousFileSplitEnumerator`` behavior).

    ``done_marker``: enumeration finishes once a file by this name exists
    AND every other file has been assigned — giving bounded tests a clean
    end; without the marker the source is unbounded."""

    def __init__(self, directory: str, format: str = "csv",
                 done_marker: Optional[str] = "_DONE",
                 timestamp_column: Optional[str] = None):
        self.directory = directory
        self.format = format
        self.done_marker = done_marker
        self.timestamp_column = timestamp_column
        self.bounded = done_marker is not None

    # static fallback (executors without runtime coordination read the
    # directory as it looks at deploy time)
    def create_splits(self, parallelism: int) -> List[SourceSplit]:
        enum = DirectoryEnumerator(self)
        out: List[SourceSplit] = []
        while True:
            s = enum.next_split(0)
            if s is None:
                break
            out.append(s)
        return out

    def create_enumerator(self) -> "DirectoryEnumerator":
        return DirectoryEnumerator(self)

    def read_file(self, path: str, start_row: int = 0):
        from flink_tpu_torch.connectors.file_source import FileSource

        fs = FileSource(path, format=self.format,
                        timestamp_column=self.timestamp_column)
        return fs._read_file(path, start_row)


class FilePathSplit(SourceSplit):
    """One file as a split, resumable at a row offset."""

    def __init__(self, source: DynamicFileSource, path: str):
        super().__init__(source, 0, 1)
        self.path = path

    def split_id(self) -> str:
        return self.path

    def read(self):
        return self.source.read_file(self.path, 0)


class DirectoryEnumerator(SplitEnumerator):
    """Scans the directory on every request; assigns unseen files in sorted
    order.  Snapshot = the assigned-file set (so restore never re-reads a
    file a reader already owns — in-flight progress lives in the READER's
    snapshot, exactly the reference split ownership model)."""

    def __init__(self, source: DynamicFileSource):
        self.source = source
        self._assigned: set = set()
        self._lock = threading.Lock()

    def _scan(self) -> List[str]:
        d = self.source.directory
        try:
            names = sorted(os.listdir(d))
        except FileNotFoundError:
            return []
        return [os.path.join(d, n) for n in names
                if not n.startswith("_") and not n.startswith(".")]

    def next_split(self, reader_id: int) -> Optional[FilePathSplit]:
        with self._lock:
            for path in self._scan():
                if path not in self._assigned:
                    self._assigned.add(path)
                    return FilePathSplit(self.source, path)
            return None

    def done(self) -> bool:
        marker = self.source.done_marker
        if marker is None:
            return False
        if not os.path.exists(os.path.join(self.source.directory, marker)):
            return False
        with self._lock:
            return all(p in self._assigned for p in self._scan())

    def snapshot_state(self) -> Dict[str, Any]:
        with self._lock:
            return {"assigned": sorted(self._assigned)}

    def restore_state(self, snap: Dict[str, Any]) -> None:
        with self._lock:
            self._assigned = set(snap.get("assigned", []))

    def reclaim(self, split) -> None:
        # FilePathSplit.split_id() IS the path, so ids land in the same set
        if split is not None:
            with self._lock:
                self._assigned.add(
                    split if isinstance(split, str) else split.path)


class SourceCoordinator:
    """Per-job registry of live enumerators (the ``SourceCoordinator``
    collapsed onto the in-process JobMaster; the multi-process path sends
    the same requests as control-plane messages)."""

    def __init__(self):
        self._enums: Dict[str, SplitEnumerator] = {}

    def register(self, vertex_uid: str, enum: SplitEnumerator) -> None:
        self._enums[vertex_uid] = enum

    def request_split(self, vertex_uid: str, reader_id: int):
        """-> (split | None, done: bool)"""
        enum = self._enums[vertex_uid]
        s = enum.next_split(reader_id)
        return s, (s is None and enum.done())

    def snapshot(self) -> Dict[str, Any]:
        return {uid: e.snapshot_state() for uid, e in self._enums.items()}

    def restore(self, snap: Optional[Dict[str, Any]]) -> None:
        for uid, s in (snap or {}).items():
            if uid in self._enums:
                self._enums[uid].restore_state(s)

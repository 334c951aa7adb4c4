"""Checkpoint storage: durable snapshot persistence + metadata.

Analog of the reference's checkpoint storage stack
(``CheckpointStorageCoordinatorView`` / ``FsCheckpointStorageAccess`` +
versioned metadata ``runtime/checkpoint/Checkpoints.java`` and
``metadata/MetadataSerializer``): a checkpoint is a directory
``chk-{id}/`` holding one ``.npz`` per operator uid (numpy trees, pickled
object leaves for key dictionaries) plus ``_metadata.json`` (version, id,
uids, timestamp).  Savepoints are the same format at a user-chosen path —
rescalable and inspectable offline (state-processor analog reads them back).

The port's copy of ``flink_tpu/runtime/checkpoint/storage.py``: the same
files, so a checkpoint or savepoint either package writes loads in the
other.  :func:`_to_numpy` downloads the port's tensors (a CUDA tensor
included) to numpy before a tree is pickled; the chaos points
``checkpoint.store``/``checkpoint.load`` fire through the port's
``testing/chaos.py``.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from flink_tpu_torch.testing import chaos

METADATA_FILE = "_metadata.json"
FORMAT_VERSION = 1


class CorruptCheckpointError(ValueError):
    """A checkpoint on disk failed its integrity check (torn write,
    truncated file, checksum mismatch, unreadable metadata).  Retrying
    cannot help — recovery must fall back to an older checkpoint, which
    is exactly what ``load_latest`` does."""


class InMemoryCheckpointStorage:
    """Test/local storage (``MemoryStateBackend``-style): deep-copied trees."""

    def __init__(self, retain: int = 3):
        self.retain = retain
        self._store: Dict[int, Dict[str, Any]] = {}

    def store(self, checkpoint_id: int, snapshot: Dict[str, Any]) -> None:
        chaos.fire("checkpoint.store", checkpoint_id=checkpoint_id)
        self._store[checkpoint_id] = pickle.loads(pickle.dumps(snapshot))
        while len(self._store) > self.retain:
            del self._store[min(self._store)]

    def checkpoint_ids(self) -> List[int]:
        return sorted(self._store)

    def load(self, checkpoint_id: int) -> Dict[str, Any]:
        chaos.fire("checkpoint.load", checkpoint_id=checkpoint_id)
        return pickle.loads(pickle.dumps(self._store[checkpoint_id]))

    def load_latest(self) -> Optional[Dict[str, Any]]:
        ids = self.checkpoint_ids()
        return self.load(ids[-1]) if ids else None


class FileCheckpointStorage:
    """Filesystem checkpoint storage (``FsStateBackend`` analog).

    Hardened commit protocol: operator files are written into a
    ``chk-N.inprogress`` staging dir with a CRC32 + size per file
    recorded in ``_metadata.json``, then published by one atomic
    ``os.replace``.  A crash mid-write leaves only an ignored staging dir;
    a torn file that survives anyway (lost data blocks after the rename)
    fails its checksum at ``load`` and is *skipped* by ``load_latest``,
    which falls back to the newest intact checkpoint.  ``fsync=True``
    additionally syncs every file before the publish for power-loss
    durability — off by default because it multiplies store latency and
    the checksum gate already catches whatever a crash tears."""

    def __init__(self, base_dir: str, retain: int = 3, fsync: bool = False):
        self.base_dir = base_dir
        self.retain = retain
        self.fsync = fsync
        #: coordinator HA: optional zero-arg callable returning
        #: a checkpoint id retention must NEVER evict (or None) — re-read
        #: FRESH at every cleanup pass, so the HA completed-checkpoint
        #: pointer stays restorable even when a stale leader's concurrent
        #: retention runs against the same directory
        self.pin_provider: Optional[Callable[[], Optional[int]]] = None
        os.makedirs(base_dir, exist_ok=True)

    def _dir(self, checkpoint_id: int) -> str:
        return os.path.join(self.base_dir, f"chk-{checkpoint_id}")

    def store(self, checkpoint_id: int, snapshot: Dict[str, Any]) -> None:
        chaos.fire("checkpoint.store", checkpoint_id=checkpoint_id)
        d = self._dir(checkpoint_id)
        tmp = d + ".inprogress"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        uids = []
        for uid, op_snap in snapshot.items():
            fname = f"op-{len(uids)}.pkl"
            payload = pickle.dumps(_to_numpy(op_snap), protocol=4)
            uids.append({"uid": uid, "file": fname,
                         "crc32": zlib.crc32(payload), "size": len(payload)})
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(payload)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
        meta = {"version": FORMAT_VERSION, "checkpoint_id": checkpoint_id,
                "timestamp_ms": int(time.time() * 1000), "operators": uids}
        with open(os.path.join(tmp, METADATA_FILE), "w") as f:
            json.dump(meta, f, indent=2)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        if self.fsync:
            # the rename is only durable once the directory entries are:
            # sync the staging dir's entries, then (below) the parent so
            # the publish itself survives power loss
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)  # atomic publish (reference: finalize + rename)
        if self.fsync:
            fd = os.open(self.base_dir, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        self._cleanup()

    def _cleanup(self):
        ids = self.checkpoint_ids()
        pinned = None
        if self.pin_provider is not None:
            try:
                pinned = self.pin_provider()
            except Exception:  # noqa: BLE001 — pin source unreadable:
                pinned = None  # fall back to plain retention
        for cid in ids[: max(0, len(ids) - self.retain)]:
            if pinned is not None and cid == pinned:
                continue
            shutil.rmtree(self._dir(cid), ignore_errors=True)

    def checkpoint_ids(self) -> List[int]:
        out = []
        for name in os.listdir(self.base_dir):
            # skip leftover chk-N.inprogress dirs from a crash mid-publish
            if not (name.startswith("chk-") and name[4:].isdigit()):
                continue
            if os.path.isfile(os.path.join(self.base_dir, name, METADATA_FILE)):
                out.append(int(name[4:]))
        return sorted(out)

    def load(self, checkpoint_id: int) -> Dict[str, Any]:
        chaos.fire("checkpoint.load", checkpoint_id=checkpoint_id)
        d = self._dir(checkpoint_id)
        try:
            with open(os.path.join(d, METADATA_FILE)) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CorruptCheckpointError(
                f"chk-{checkpoint_id}: unreadable metadata ({e})") from e
        if meta["version"] > FORMAT_VERSION:
            raise ValueError(f"checkpoint format {meta['version']} too new")
        out: Dict[str, Any] = {}
        for entry in meta["operators"]:
            try:
                with open(os.path.join(d, entry["file"]), "rb") as f:
                    payload = f.read()
            except OSError as e:
                raise CorruptCheckpointError(
                    f"chk-{checkpoint_id}/{entry['file']}: {e}") from e
            # integrity gate: size first (cheap torn-write detector), then
            # CRC32 — only checkpoints written before checksums existed
            # (no "crc32" key) skip verification
            if "size" in entry and len(payload) != entry["size"]:
                raise CorruptCheckpointError(
                    f"chk-{checkpoint_id}/{entry['file']}: torn write "
                    f"({len(payload)} bytes, expected {entry['size']})")
            if "crc32" in entry and zlib.crc32(payload) != entry["crc32"]:
                raise CorruptCheckpointError(
                    f"chk-{checkpoint_id}/{entry['file']}: checksum mismatch")
            try:
                out[entry["uid"]] = loads(payload)
            except Exception as e:  # noqa: BLE001 — any unpickle error
                raise CorruptCheckpointError(
                    f"chk-{checkpoint_id}/{entry['file']}: undecodable "
                    f"({e})") from e
        return out

    def load_latest(self) -> Optional[Dict[str, Any]]:
        """Newest INTACT checkpoint: corrupt/torn ones are skipped (never
        served), falling back to the next older id."""
        for cid in reversed(self.checkpoint_ids()):
            try:
                return self.load(cid)
            except CorruptCheckpointError:
                continue
        return None

    def metadata(self, checkpoint_id: int) -> Dict[str, Any]:
        with open(os.path.join(self._dir(checkpoint_id), METADATA_FILE)) as f:
            return json.load(f)


class RetryingCheckpointStorage:
    """Bounded-exponential-backoff retry wrapper around any storage backend
    (``RetryingExecutor`` / s3 retry-policy analog): transient store/load
    errors are retried up to ``max_attempts`` with
    ``initial_backoff_ms * multiplier^k`` sleeps capped at
    ``max_backoff_ms``.  :class:`CorruptCheckpointError` is NOT retried —
    a bad checksum never heals; ``load_latest`` already falls back.

    ``sleep`` is injectable so tests assert the backoff sequence without
    wall-clock waits."""

    def __init__(self, inner, max_attempts: int = 3,
                 initial_backoff_ms: int = 10, multiplier: float = 2.0,
                 max_backoff_ms: int = 1000,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.inner = inner
        self.max_attempts = max_attempts
        self.initial_backoff_ms = initial_backoff_ms
        self.multiplier = multiplier
        self.max_backoff_ms = max_backoff_ms
        self._sleep = sleep
        #: attempts beyond the first, across all operations (retry metric)
        self.retries = 0

    def _retry(self, fn: Callable, *args):
        backoff_ms = float(self.initial_backoff_ms)
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args)
            except CorruptCheckpointError:
                raise
            except Exception:
                if attempt >= self.max_attempts:
                    raise
                self.retries += 1
                self._sleep(min(backoff_ms, self.max_backoff_ms) / 1000.0)
                backoff_ms *= self.multiplier

    def store(self, checkpoint_id: int, snapshot: Dict[str, Any]) -> None:
        self._retry(self.inner.store, checkpoint_id, snapshot)

    def load(self, checkpoint_id: int) -> Dict[str, Any]:
        return self._retry(self.inner.load, checkpoint_id)

    def load_latest(self) -> Optional[Dict[str, Any]]:
        return self._retry(self.inner.load_latest)

    def checkpoint_ids(self) -> List[int]:
        return self._retry(self.inner.checkpoint_ids)

    def __getattr__(self, name):
        # metadata() and backend-specific extras pass through un-retried
        return getattr(self.inner, name)


class _PortUnpickler(pickle.Unpickler):
    """Loads a pickle either package wrote: a class of the JAX package
    (``flink_tpu.<module>``: an incremental checkpoint's ``BlobRef``, a
    channel-state ``RecordBatch``) resolves to the port's class of the same
    module and name, so the JAX package is never imported."""

    def find_class(self, module: str, name: str):
        if module == "flink_tpu" or module.startswith("flink_tpu."):
            module = "flink_tpu_torch" + module[len("flink_tpu"):]
        return super().find_class(module, name)


def loads(payload: bytes) -> Any:
    """``pickle.loads`` through :class:`_PortUnpickler`."""
    return _PortUnpickler(io.BytesIO(payload)).load()


def _to_numpy(tree: Any) -> Any:
    """Device arrays -> host numpy throughout a snapshot tree (a torch
    tensor on any device is downloaded and detached)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [_to_numpy(v) for v in tree]
        return tuple(t) if isinstance(tree, tuple) else t
    if hasattr(tree, "__array__") and not isinstance(tree, np.ndarray):
        return np.asarray(tree)
    return tree


def write_savepoint(path: str, snapshot: Dict[str, Any]) -> str:
    """User-triggered rescalable savepoint (``Savepoint`` analog)."""
    storage = FileCheckpointStorage(path, retain=1_000_000)
    sid = (max(storage.checkpoint_ids()) + 1) if storage.checkpoint_ids() else 1
    storage.store(sid, snapshot)
    return os.path.join(path, f"chk-{sid}")


def read_savepoint(path: str) -> Dict[str, Any]:
    """Load a savepoint directory written by ``write_savepoint`` (accepts the
    ``chk-N`` dir itself or its parent)."""
    if os.path.isfile(os.path.join(path, METADATA_FILE)):
        parent, name = os.path.split(path.rstrip("/"))
        return FileCheckpointStorage(parent).load(int(name[4:]))
    storage = FileCheckpointStorage(path)
    snap = storage.load_latest()
    if snap is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    return snap

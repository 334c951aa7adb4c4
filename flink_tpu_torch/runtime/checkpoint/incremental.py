"""Incremental checkpoints: content-addressed shared state + refcounting
(port of ``flink_tpu/runtime/checkpoint/incremental.py``).

Analog of the reference's incremental RocksDB checkpoints
(``RocksIncrementalSnapshotStrategy.java:83``: previously-uploaded SST files
are re-referenced, not re-uploaded) + ``SharedStateRegistry`` (refcounts
shared artifacts across retained checkpoints, deletes on last release).

Redesigned for array state: every large numpy leaf in a snapshot tree is
content-hashed; the blob is uploaded once into ``shared/`` and later
checkpoints that contain the identical array just reference the hash.  A
registry file tracks ``hash -> [checkpoint ids]``; retention eviction
releases references and deletes unreferenced blobs.

This storage is additionally the durable format for **increment chains**
(``runtime/checkpoint/delta.py``): a stored tree may contain increment
nodes; ``load`` walks back to the newest increment-free base and resolves
``base + ordered increment replay`` before returning, so callers always
receive the dense full-snapshot interchange.  Retention never evicts a
checkpoint that a retained checkpoint's chain still walks through, and a
background compaction thread re-bases (rewrites the newest checkpoint
self-contained) once a chain grows past ``max_increments_per_base`` —
crash-safe by construction: the compacted pickle publishes by one atomic
rename; a crash mid-compaction leaves an ignored tmp file and the old
chain still resolves.

Crash-consistency hardening (parity with ``FileCheckpointStorage``):
``snapshot.pkl`` is staged + atomically renamed with its CRC32/size
recorded in ``_metadata.json`` (written last — ``checkpoint_ids`` ignores
half-written directories), blobs carry CRC32/size in their
:class:`BlobRef`, and every verification failure raises
:class:`CorruptCheckpointError` so ``load_latest`` (and the coordinators'
restart recovery) falls back to an older intact base.

The port writes the JAX package's files: a directory either package wrote
loads in the other.  ``snapshot.pkl`` names its :class:`BlobRef` class by
module; the port's loader (:func:`storage.loads`) maps the JAX package's
``flink_tpu.runtime.checkpoint.incremental.BlobRef`` to this module's class
without importing the JAX package.  Tensor leaves are downloaded to numpy
before they are hashed.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.runtime.checkpoint import delta
from flink_tpu_torch.runtime.checkpoint.storage import (CorruptCheckpointError,
                                                       _to_numpy, loads)
from flink_tpu_torch.testing import chaos

METADATA_FILE = "_metadata.json"


@dataclass(frozen=True)
class BlobRef:
    """Placeholder for a deduplicated array leaf.  ``crc32``/``nbytes``
    default to None so pickles written before the hardening still load
    (verification is skipped for them)."""

    digest: str
    shape: Tuple[int, ...]
    dtype: str
    crc32: Optional[int] = None
    nbytes: Optional[int] = None


class IncrementalCheckpointStorage:
    """Durable checkpoint storage with cross-checkpoint blob dedup and
    increment-chain resolution."""

    #: coordinators store RAW increment trees here (this storage resolves
    #: chains itself at load); plain storages receive pre-resolved trees
    supports_increments = True

    def __init__(self, directory: str, retain: int = 3,
                 min_blob_bytes: int = 4096,
                 max_increments_per_base: int = 8,
                 compact_in_background: bool = True):
        self.directory = directory
        self.retain = retain
        self.min_blob_bytes = min_blob_bytes
        self.max_increments_per_base = max_increments_per_base
        self.compact_in_background = compact_in_background
        self.shared_dir = os.path.join(directory, "shared")
        os.makedirs(self.shared_dir, exist_ok=True)
        self._registry_path = os.path.join(directory, "_registry.json")
        self._registry: Dict[str, List[int]] = {}
        self._lock = threading.RLock()
        self._compact_thread: Optional[threading.Thread] = None
        #: compactions performed (observability + tests)
        self.compactions = 0
        #: coordinator HA: optional zero-arg callable returning
        #: a checkpoint id retention must never evict (or None).  Re-read
        #: FRESH per eviction pass, and the pinned cut's WHOLE increment
        #: chain is kept — the HA completed-checkpoint pointer stays
        #: restorable even under a stale leader's concurrent retention.
        self.pin_provider = None
        if os.path.exists(self._registry_path):
            with open(self._registry_path) as f:
                self._registry = {k: list(v) for k, v in json.load(f).items()}

    # -- tree walk -----------------------------------------------------------
    def _dedup(self, obj: Any, cid: int, new_blobs: Dict[str, np.ndarray]) -> Any:
        if isinstance(obj, np.ndarray) and obj.dtype != object and \
                obj.nbytes >= self.min_blob_bytes:
            arr = np.ascontiguousarray(obj)
            payload = arr.tobytes()
            digest = hashlib.sha256(payload).hexdigest()[:32]
            if digest not in self._registry:
                new_blobs[digest] = arr
            self._registry.setdefault(digest, [])
            if cid not in self._registry[digest]:
                self._registry[digest].append(cid)
            return BlobRef(digest, tuple(arr.shape), arr.dtype.str,
                           zlib.crc32(payload), arr.nbytes)
        if isinstance(obj, dict):
            return {k: self._dedup(v, cid, new_blobs) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            out = [self._dedup(v, cid, new_blobs) for v in obj]
            return type(obj)(out) if isinstance(obj, tuple) else out
        return obj

    def _resolve(self, obj: Any) -> Any:
        if isinstance(obj, BlobRef):
            path = os.path.join(self.shared_dir, obj.digest + ".blob")
            try:
                payload = open(path, "rb").read()
            except OSError as e:
                raise CorruptCheckpointError(
                    f"missing shared blob {obj.digest}: {e}") from e
            if obj.nbytes is not None and len(payload) != obj.nbytes:
                raise CorruptCheckpointError(
                    f"shared blob {obj.digest} is {len(payload)} bytes, "
                    f"expected {obj.nbytes} (torn write)")
            if obj.crc32 is not None and zlib.crc32(payload) != obj.crc32:
                raise CorruptCheckpointError(
                    f"shared blob {obj.digest} failed CRC32 verification")
            arr = np.frombuffer(payload, np.dtype(obj.dtype))
            return arr.reshape(obj.shape).copy()
        if isinstance(obj, dict):
            return {k: self._resolve(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            out = [self._resolve(v) for v in obj]
            return type(obj)(out) if isinstance(obj, tuple) else out
        return obj

    # -- storage interface ---------------------------------------------------
    def store(self, checkpoint_id: int, snapshot: Dict[str, Any]) -> None:
        chaos.fire("checkpoint.store", checkpoint_id=checkpoint_id)
        snapshot = _to_numpy(snapshot)
        has_delta = delta.tree_has_increment(snapshot)
        with self._lock:
            new_blobs: Dict[str, np.ndarray] = {}
            deduped = self._dedup(snapshot, checkpoint_id, new_blobs)
            for digest, arr in new_blobs.items():
                tmp = os.path.join(self.shared_dir, f".{digest}.tmp")
                arr.tofile(tmp)
                os.replace(tmp, os.path.join(self.shared_dir,
                                             digest + ".blob"))
            cdir = os.path.join(self.directory, f"chk-{checkpoint_id}")
            os.makedirs(cdir, exist_ok=True)
            payload = pickle.dumps(deduped, protocol=4)
            keep = len(payload)
            if has_delta:
                # fault point on the increment-append write: a TruncatedWrite
                # schedule tears the published record short (post-rename data
                # loss); the CRC gate below catches it at load and recovery
                # falls back past the torn increment to an older base
                keep = chaos.truncated("checkpoint.increment_append",
                                       len(payload),
                                       checkpoint_id=checkpoint_id)
            tmp = os.path.join(cdir, ".snapshot.pkl.tmp")
            with open(tmp, "wb") as f:
                f.write(payload[:keep])
            os.replace(tmp, os.path.join(cdir, "snapshot.pkl"))
            meta = {"checkpoint_id": checkpoint_id,
                    "incremental": True,
                    "delta": has_delta,
                    "new_blobs": len(new_blobs),
                    "referenced_blobs": self._count_refs(deduped),
                    "snapshot_crc32": zlib.crc32(payload),
                    "snapshot_size": len(payload)}
            mtmp = os.path.join(cdir, "." + METADATA_FILE + ".tmp")
            with open(mtmp, "w") as f:
                json.dump(meta, f)
            os.replace(mtmp, os.path.join(cdir, METADATA_FILE))
            self._save_registry()
            self._evict()
        self._maybe_compact(checkpoint_id)

    def _count_refs(self, obj: Any) -> int:
        if isinstance(obj, BlobRef):
            return 1
        if isinstance(obj, dict):
            return sum(self._count_refs(v) for v in obj.values())
        if isinstance(obj, (list, tuple)):
            return sum(self._count_refs(v) for v in obj)
        return 0

    def checkpoint_ids(self) -> List[int]:
        ids = []
        for d in os.listdir(self.directory):
            if not d.startswith("chk-"):
                continue
            # half-written directories (crash between snapshot.pkl and the
            # metadata publish) are invisible: metadata is written LAST
            if not os.path.exists(os.path.join(self.directory, d,
                                               METADATA_FILE)):
                continue
            try:
                ids.append(int(d[4:]))
            except ValueError:
                continue
        return sorted(ids)

    def _load_raw(self, checkpoint_id: int) -> Dict[str, Any]:
        """One checkpoint's stored tree, blob-resolved and verified but NOT
        increment-resolved (may contain increment nodes)."""
        cdir = os.path.join(self.directory, f"chk-{checkpoint_id}")
        spath = os.path.join(cdir, "snapshot.pkl")
        try:
            payload = open(spath, "rb").read()
        except OSError as e:
            raise CorruptCheckpointError(
                f"checkpoint {checkpoint_id}: unreadable snapshot.pkl: "
                f"{e}") from e
        meta = self.metadata(checkpoint_id)
        if "snapshot_size" in meta and len(payload) != meta["snapshot_size"]:
            raise CorruptCheckpointError(
                f"checkpoint {checkpoint_id}: snapshot.pkl is "
                f"{len(payload)} bytes, expected {meta['snapshot_size']} "
                f"(torn write)")
        if "snapshot_crc32" in meta and \
                zlib.crc32(payload) != meta["snapshot_crc32"]:
            raise CorruptCheckpointError(
                f"checkpoint {checkpoint_id}: snapshot.pkl failed CRC32 "
                f"verification")
        try:
            tree = loads(payload)
        except Exception as e:  # noqa: BLE001 — any unpickle error = corrupt
            raise CorruptCheckpointError(
                f"checkpoint {checkpoint_id}: undecodable snapshot.pkl: "
                f"{type(e).__name__}: {e}") from e
        return self._resolve(tree)

    def _chain_ids(self, checkpoint_id: int,
                   ids: Optional[List[int]] = None) -> List[int]:
        """The stored checkpoint ids whose increments resolve
        ``checkpoint_id``, ascending — every stored id from the newest
        increment-free base up to and including ``checkpoint_id`` (each
        may carry dirt the next increment's union no longer re-ships)."""
        if ids is None:
            ids = self.checkpoint_ids()
        if checkpoint_id not in ids:
            raise CorruptCheckpointError(
                f"checkpoint {checkpoint_id} not stored")
        chain = []
        for cid in sorted((i for i in ids if i <= checkpoint_id),
                          reverse=True):
            chain.append(cid)
            if not self._is_delta(cid):
                return list(reversed(chain))
        raise CorruptCheckpointError(
            f"checkpoint {checkpoint_id}: no increment-free base retained "
            f"below it")

    def _is_delta(self, checkpoint_id: int) -> bool:
        try:
            return bool(self.metadata(checkpoint_id).get("delta"))
        except (OSError, ValueError):
            return False

    def load(self, checkpoint_id: int) -> Dict[str, Any]:
        chaos.fire("checkpoint.load", checkpoint_id=checkpoint_id)
        with self._lock:
            raws = [self._load_raw(cid)
                    for cid in self._chain_ids(checkpoint_id)]
        try:
            return delta.resolve_chain(raws)
        except delta.IncrementChainError as e:
            raise CorruptCheckpointError(
                f"checkpoint {checkpoint_id}: broken increment chain: "
                f"{e}") from e

    def load_latest(self) -> Optional[Dict[str, Any]]:
        """Newest restorable checkpoint: a corrupt snapshot/blob/increment
        anywhere in the newest chain falls back to the next-older
        checkpoint whose chain is intact."""
        for cid in sorted(self.checkpoint_ids(), reverse=True):
            try:
                return self.load(cid)
            except CorruptCheckpointError:
                continue
        return None

    def metadata(self, checkpoint_id: int) -> Dict[str, Any]:
        cdir = os.path.join(self.directory, f"chk-{checkpoint_id}")
        with open(os.path.join(cdir, METADATA_FILE)) as f:
            return json.load(f)

    def chain_length(self, checkpoint_id: int) -> int:
        """Number of stored checkpoints (base included) resolving this one."""
        with self._lock:
            return len(self._chain_ids(checkpoint_id))

    # -- compaction ----------------------------------------------------------
    def _maybe_compact(self, checkpoint_id: int) -> None:
        """Re-base once the newest chain outgrows ``max_increments_per_base``:
        rewrite ``checkpoint_id`` self-contained (resolved tree, deduped
        against the registry) so restores stop replaying long chains and
        retention can release the old bases.  Runs on a daemon thread by
        default — never on the ack/store path's critical section."""
        with self._lock:
            try:
                if not self._is_delta(checkpoint_id) or \
                        len(self._chain_ids(checkpoint_id)) - 1 \
                        <= self.max_increments_per_base:
                    return
            except CorruptCheckpointError:
                return
        if not self.compact_in_background:
            self._compact(checkpoint_id)
            return
        t = threading.Thread(target=self._compact, args=(checkpoint_id,),
                             daemon=True, name=f"chk-compact-{checkpoint_id}")
        with self._lock:
            self._compact_thread = t
        t.start()

    def _compact(self, checkpoint_id: int) -> None:
        try:
            resolved = self.load(checkpoint_id)
            chaos.fire("checkpoint.compact", checkpoint_id=checkpoint_id)
            with self._lock:
                if checkpoint_id not in self.checkpoint_ids():
                    return                      # evicted while resolving
                new_blobs: Dict[str, np.ndarray] = {}
                deduped = self._dedup(resolved, checkpoint_id, new_blobs)
                for digest, arr in new_blobs.items():
                    tmp = os.path.join(self.shared_dir, f".{digest}.tmp")
                    arr.tofile(tmp)
                    os.replace(tmp, os.path.join(self.shared_dir,
                                                 digest + ".blob"))
                cdir = os.path.join(self.directory, f"chk-{checkpoint_id}")
                payload = pickle.dumps(deduped, protocol=4)
                tmp = os.path.join(cdir, ".snapshot.pkl.tmp")
                with open(tmp, "wb") as f:
                    f.write(payload)
                meta = self.metadata(checkpoint_id)
                meta.update({"delta": False, "compacted": True,
                             "snapshot_crc32": zlib.crc32(payload),
                             "snapshot_size": len(payload),
                             "referenced_blobs": self._count_refs(deduped)})
                # pickle first, metadata second — a crash between the two
                # leaves a self-contained pickle whose metadata still says
                # "delta": resolution walks one chain link too many, which
                # is harmless (absolute values, full tree overwrites)
                os.replace(tmp, os.path.join(cdir, "snapshot.pkl"))
                mtmp = os.path.join(cdir, "." + METADATA_FILE + ".tmp")
                with open(mtmp, "w") as f:
                    json.dump(meta, f)
                os.replace(mtmp, os.path.join(cdir, METADATA_FILE))
                self._save_registry()
                self.compactions += 1
                self._evict()   # old bases may now be releasable
        except (CorruptCheckpointError, chaos.InjectedFault, OSError):
            # compaction is best-effort: a crash/fault mid-compaction leaves
            # the old chain fully intact (tmp files are ignored) — restore
            # still resolves base + replay
            return

    def wait_for_compaction(self, timeout: float = 30.0) -> None:
        """Join any in-flight background compaction (tests/benchmarks)."""
        with self._lock:
            t = self._compact_thread
        if t is not None:
            t.join(timeout)

    # -- retention / registry ------------------------------------------------
    def _needed_ids(self, ids: List[int]) -> set:
        """Checkpoints retention must keep: the newest ``retain`` heads
        plus every chain member a retained head still resolves through —
        and the HA-pinned cut's whole chain, when a pin provider is set."""
        heads = list(ids[-self.retain:]) if self.retain else []
        if self.pin_provider is not None:
            try:
                pinned = self.pin_provider()
            except Exception:  # noqa: BLE001 — pin source unreadable
                pinned = None
            if pinned is not None and pinned in ids and pinned not in heads:
                heads.append(pinned)
        needed = set()
        for head in heads:
            try:
                needed.update(self._chain_ids(head, ids))
            except CorruptCheckpointError:
                needed.add(head)
        return needed

    def _evict(self) -> None:
        ids = self.checkpoint_ids()
        if len(ids) <= self.retain:
            return
        needed = self._needed_ids(ids)
        for victim in ids:
            if len(self.checkpoint_ids()) <= self.retain:
                break
            if victim in needed:
                continue
            self.release(victim)

    def release(self, checkpoint_id: int) -> None:
        """Drop a checkpoint and delete blobs nothing references anymore
        (``SharedStateRegistry.unregisterUnusedState`` analog)."""
        import shutil

        with self._lock:
            cdir = os.path.join(self.directory, f"chk-{checkpoint_id}")
            if os.path.isdir(cdir):
                shutil.rmtree(cdir)
            dead = []
            for digest, refs in self._registry.items():
                if checkpoint_id in refs:
                    refs.remove(checkpoint_id)
                if not refs:
                    dead.append(digest)
            for digest in dead:
                del self._registry[digest]
                path = os.path.join(self.shared_dir, digest + ".blob")
                if os.path.exists(path):
                    os.remove(path)
            self._save_registry()

    def _save_registry(self) -> None:
        tmp = self._registry_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._registry, f)
        os.replace(tmp, self._registry_path)

    def shared_blob_count(self) -> int:
        return len([f for f in os.listdir(self.shared_dir)
                    if f.endswith(".blob")])

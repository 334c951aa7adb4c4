"""Task-local state store: a worker-side SECONDARY copy of that worker's
own subtask snapshots.

Analog of ``TaskLocalStateStoreImpl``
(``flink-runtime/src/main/java/org/apache/flink/runtime/state/
TaskLocalStateStoreImpl.java:54``) and the
``flink-local-recovery-and-allocation-test`` e2e: every checkpoint ack ALSO
writes the snapshot to a worker-local directory; on a same-worker restart
the restore reads the local copy and touches the remote (primary)
checkpoint storage only for states the local store lacks — recovery cost
stops scaling with remote-storage bandwidth.

The primary store (``FileCheckpointStorage`` / object store) stays the
source of truth: local copies are best-effort (``confirm`` prunes
everything older than the last completed checkpoint; a missing or corrupt
local entry silently falls back to the shipped remote state).

The port's copy of ``flink_tpu/runtime/checkpoint/local.py`` (host Python, as JAX's).
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
import urllib.parse
from typing import Any, Dict, List, Optional

from flink_tpu_torch.runtime.checkpoint.storage import _to_numpy, loads


class TaskLocalStateStore:
    """Per-worker local snapshot directory:
    ``<base>/worker-<idx>/chk-<cid>/<uid>-<subtask>.pkl``."""

    def __init__(self, base_dir: str, worker_index: int):
        self.dir = os.path.join(base_dir, f"worker-{worker_index}")
        os.makedirs(self.dir, exist_ok=True)

    def _chk_dir(self, checkpoint_id: int) -> str:
        return os.path.join(self.dir, f"chk-{checkpoint_id}")

    def _path(self, checkpoint_id: int, uid: str, subtask: int) -> str:
        safe = urllib.parse.quote(uid, safe="")
        return os.path.join(self._chk_dir(checkpoint_id),
                            f"{safe}-{subtask}.pkl")

    def store(self, checkpoint_id: int, uid: str, subtask: int,
              snapshot: Dict[str, Any]) -> None:
        """Best-effort local write (never fails the checkpoint ack: the
        primary copy rides the ack to the coordinator regardless).

        Incremental checkpoints: an increment-bearing snapshot
        is stored RAW with a ``.delta`` marker next to it — ``load``
        resolves the chain by walking older local entries, and ``confirm``
        keeps every entry a live chain still reaches back to."""
        try:
            os.makedirs(self._chk_dir(checkpoint_id), exist_ok=True)
            path = self._path(checkpoint_id, uid, subtask)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(_to_numpy(snapshot), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            from flink_tpu_torch.runtime.checkpoint import delta
            if delta.tree_has_increment(snapshot):
                with open(path + ".delta", "wb"):
                    pass
            else:
                # a full cut ends any previous chain under this name
                try:
                    os.unlink(path + ".delta")
                except OSError:
                    pass
            os.replace(tmp, path)
        except OSError:
            pass

    def _read(self, checkpoint_id: int, uid: str,
              subtask: int) -> Optional[Dict[str, Any]]:
        path = self._path(checkpoint_id, uid, subtask)
        try:
            with open(path, "rb") as f:
                return loads(f.read())
        except (OSError, pickle.PickleError, EOFError):
            return None        # fall back to the remote copy

    def load(self, checkpoint_id: int, uid: str,
             subtask: int) -> Optional[Dict[str, Any]]:
        """The subtask's snapshot at ``checkpoint_id``, increment chains
        resolved against older local entries.  Any gap in the chain (a
        pruned, missing or unreadable link) returns None — the restore
        silently falls back to the coordinator-shipped remote state."""
        snap = self._read(checkpoint_id, uid, subtask)
        if snap is None:
            return None
        from flink_tpu_torch.runtime.checkpoint import delta
        if not delta.tree_has_increment(snap):
            return snap
        chain = [snap]
        older = [i for i in self.checkpoint_ids() if i < checkpoint_id]
        while delta.tree_has_increment(chain[-1]):
            if not older:
                return None          # chain base pruned: remote fallback
            prev = self._read(older.pop(), uid, subtask)
            if prev is None:
                return None
            chain.append(prev)
        try:
            resolved = chain.pop()
            while chain:
                resolved = delta.apply_increments(resolved, chain.pop())
            return resolved
        except delta.IncrementChainError:
            return None

    def _chain_floor(self, checkpoint_id: int, ids: List[int]) -> int:
        """Oldest checkpoint id any of ``checkpoint_id``'s entries still
        chains back to (walks the cheap ``.delta`` markers, no unpickling);
        ``checkpoint_id`` itself when every entry is self-contained."""
        floor = checkpoint_id
        try:
            names = os.listdir(self._chk_dir(checkpoint_id))
        except OSError:
            return floor
        for name in names:
            if not name.endswith(".pkl"):
                continue
            cur = checkpoint_id
            while os.path.exists(os.path.join(self._chk_dir(cur), name)
                                 + ".delta"):
                prev = [i for i in ids if i < cur]
                if not prev:
                    break
                cur = max(prev)
            floor = min(floor, cur)
        return floor

    def confirm(self, checkpoint_id: int) -> None:
        """Checkpoint ``checkpoint_id`` completed: local copies no live
        increment chain reaches any more can never be restored from again
        — prune them (``TaskLocalStateStoreImpl.pruneCheckpoints``; with
        full snapshots the floor is simply ``checkpoint_id``)."""
        ids = self.checkpoint_ids()
        floor = (self._chain_floor(checkpoint_id, ids)
                 if checkpoint_id in ids else checkpoint_id)
        for cid in ids:
            if cid < floor:
                shutil.rmtree(self._chk_dir(cid), ignore_errors=True)

    def checkpoint_ids(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        for n in names:
            m = re.fullmatch(r"chk-(\d+)", n)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

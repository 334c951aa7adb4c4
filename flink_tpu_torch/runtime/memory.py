"""Per-slot managed memory accounting (``MemoryManager.java`` analog) (port of ``flink_tpu/runtime/memory.py``).

The reference gives every task slot a fixed budget of *managed memory*
(``taskmanager.memory.managed.size`` split over the slots); memory-hungry
operators — sort buffers, hash tables, the RocksDB tier, python UDF
workers — RESERVE fractions of it up front and fail fast (or spill
earlier) instead of OOM-ing the process mid-job
(``MemoryManager.java:1``, ``computeMemorySize``, FLIP-49/53 weights).

Same role here: a :class:`MemoryManager` per slot, handed to operators
via ``RuntimeContext.memory_manager``.  Budgeted components consult it:
the spill-tier keyed backend reserves its resident-byte budget, external
sort/shuffle buffers can size themselves from
:meth:`MemoryManager.compute_operator_share`, and an over-committed slot
raises :class:`MemoryReservationError` at reserve time — deployment
failure surfaces at schedule time, not as a mid-job OOM.

Reservations are plain accounting (Python/numpy own the actual bytes —
there is no Unsafe to wrap); what the manager provides is the CONTRACT:
a slot's operators cannot collectively claim more than the slot's share.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class MemoryReservationError(MemoryError):
    """A reservation exceeded the slot's remaining managed memory."""


class MemoryReservation:
    """One owner's claim on a slice of a slot's managed memory."""

    __slots__ = ("manager", "owner", "nbytes", "_released")

    def __init__(self, manager: "MemoryManager", owner: str, nbytes: int):
        self.manager = manager
        self.owner = owner
        self.nbytes = int(nbytes)
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self.manager._release(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class MemoryManager:
    """Byte-accounted managed memory for ONE slot."""

    def __init__(self, total_bytes: int):
        if total_bytes < 0:
            raise ValueError("total_bytes must be >= 0")
        self.total = int(total_bytes)
        self._used = 0
        self._by_owner: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- accounting ---------------------------------------------------------
    def reserve(self, owner: str, nbytes: int) -> MemoryReservation:
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError("nbytes must be >= 0")
        with self._lock:
            if self._used + nbytes > self.total:
                raise MemoryReservationError(
                    f"{owner!r} requested {nbytes} managed bytes; only "
                    f"{self.total - self._used} of {self.total} remain "
                    f"(held: {dict(self._by_owner)})")
            self._used += nbytes
            self._by_owner[owner] = self._by_owner.get(owner, 0) + nbytes
        return MemoryReservation(self, owner, nbytes)

    def _release(self, res: MemoryReservation) -> None:
        with self._lock:
            # clamp to the owner's live bytes: a reservation released after
            # release_all(owner) must not double-decrement (negative _used
            # would silently void the over-commit invariant)
            freed = min(res.nbytes, self._by_owner.get(res.owner, 0))
            self._used -= freed
            left = self._by_owner.get(res.owner, 0) - freed
            if left > 0:
                self._by_owner[res.owner] = left
            else:
                self._by_owner.pop(res.owner, None)

    def release_all(self, owner: str) -> int:
        """Drop every reservation of ``owner`` (task teardown); returns the
        bytes freed."""
        with self._lock:
            freed = self._by_owner.pop(owner, 0)
            self._used -= freed
            return freed

    def available(self) -> int:
        with self._lock:
            return self.total - self._used

    def used(self) -> int:
        with self._lock:
            return self._used

    def usage_by_owner(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._by_owner)

    # -- fraction splitting (computeMemorySize / FLIP-53 weights) -----------
    def compute_operator_share(self, weights: Dict[str, float],
                               owner: str) -> int:
        """``owner``'s byte share of this slot's TOTAL managed memory when
        the slot's operators declare relative ``weights`` (the reference
        splits a slot's managed memory by declared use-case weights rather
        than first-come-first-served)."""
        total_w = sum(w for w in weights.values() if w > 0)
        if total_w <= 0 or weights.get(owner, 0) <= 0:
            return 0
        return int(self.total * weights[owner] / total_w)


def slot_memory_managers(total_bytes: int,
                         num_slots: int) -> List[MemoryManager]:
    """Split a task executor's managed memory evenly over its slots
    (``taskmanager.memory.managed.size`` / ``numberOfTaskSlots``)."""
    if num_slots <= 0:
        raise ValueError("num_slots must be > 0")
    share = int(total_bytes) // num_slots
    return [MemoryManager(share) for _ in range(num_slots)]


def memory_manager_for(config=None,
                       num_slots: Optional[int] = None) -> MemoryManager:
    """One slot's manager from configuration (None config = defaults;
    ``num_slots`` None reads ``taskmanager.numberOfTaskSlots``)."""
    from flink_tpu_torch.config.config_option import Configuration
    from flink_tpu_torch.config.options import TaskManagerOptions

    cfg = config if config is not None else Configuration()
    total = cfg.get(TaskManagerOptions.MANAGED_MEMORY_SIZE)
    if num_slots is None:
        num_slots = cfg.get(TaskManagerOptions.NUM_TASK_SLOTS)
    return MemoryManager(int(total) // max(1, int(num_slots)))


class SlotMemoryPool:
    """A task executor's fixed slot managers, assigned round-robin — the
    aggregate managed memory of every subtask in the process is bounded by
    ``taskmanager.memory.managed.size``, however many subtasks launch (or
    relaunch) over the executor's lifetime."""

    def __init__(self, config=None):
        from flink_tpu_torch.config.config_option import Configuration
        from flink_tpu_torch.config.options import TaskManagerOptions

        cfg = config if config is not None else Configuration()
        n = max(1, int(cfg.get(TaskManagerOptions.NUM_TASK_SLOTS)))
        total = int(cfg.get(TaskManagerOptions.MANAGED_MEMORY_SIZE))
        self.slots = slot_memory_managers(total, n)
        self._next = 0
        self._lock = threading.Lock()

    def assign(self) -> MemoryManager:
        with self._lock:
            mm = self.slots[self._next % len(self.slots)]
            self._next += 1
            return mm

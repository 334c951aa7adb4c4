"""Data-plane channels between subtasks, with credit-style backpressure.

Analog of the reference's network stack (``ResultPartition``/``InputGate``
over Netty with credit-based flow control, SURVEY §2.2 "Network stack"):
in-process exchanges are bounded queues — a full queue blocks the producer,
which is exactly the reference's credit-exhaustion backpressure, while
barrier alignment *stops polling* a blocked channel so its data queues up
behind the barrier (``SingleCheckpointBarrierHandler`` semantics: blocked
channels buffer, they don't drop).

Partitioners mirror ``runtime/partitioner/``: forward, hash (key groups →
operator index, the exact ``KeyGroupStreamPartitioner`` formula), rebalance
(round-robin), broadcast.  Control elements (watermarks, barriers, end of
input) always go to every target channel, like the reference's
``RecordWriter.broadcastEvent``.

The port's copy of ``flink_tpu/cluster/channels.py`` (host Python, as JAX's).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.core import keygroups
from flink_tpu_torch.core.batch import (CheckpointBarrier, EndOfInput, RecordBatch,
                                  StreamElement)
from flink_tpu_torch.testing import chaos


def take_until_barrier_locked(q: deque, announced: deque,
                              checkpoint_id: int):
    """Shared barrier-extraction loop (the caller holds the queue's lock):
    pop the elements queued IN FRONT of checkpoint ``checkpoint_id``'s
    barrier; consume the barrier itself when present (returning the
    ELEMENT — its ``is_savepoint`` flag matters) and keep the announced
    deque in sync.  Stops at any barrier or EndOfInput, never extracting
    past a channel-terminating event.  One implementation for BOTH channel
    flavors (``LocalChannel`` and ``net._ReceiveQueue``) so the
    stop/announce invariants cannot silently diverge."""
    out = []
    barrier = None
    while q:
        el = q[0]
        if isinstance(el, CheckpointBarrier):
            if el.checkpoint_id == checkpoint_id:
                barrier = q.popleft()
                if announced:
                    announced.popleft()
            break
        if isinstance(el, EndOfInput):
            break
        out.append(q.popleft())
    return out, barrier


def element_bytes(el: StreamElement) -> int:
    """Approximate wire size of one stream element (RecordBatch column
    nbytes; control elements a small constant) — the unit the unaligned
    checkpoint accounting (overtaken / persisted in-flight bytes) and the
    backpressure gauges report in."""
    if isinstance(el, RecordBatch):
        total = 0
        for name in el.columns:
            col = el.column(name)
            nbytes = getattr(col, "nbytes", None)
            total += int(nbytes) if nbytes is not None else 8 * len(el)
        return max(total, 16)
    return 16


class LocalChannel:
    """Bounded in-memory channel (one producer subtask → one consumer
    subtask).  ``capacity`` plays the role of the channel's credit budget.

    Observability: ``backpressured_ns`` accumulates the time producers
    spend blocked in :meth:`put` waiting for credit (the reference's
    per-channel ``backPressuredTimeMsPerSecond``), and :meth:`depth` /
    :meth:`queued_bytes` read the current backlog — both monitoring-grade
    (one lock acquisition, no barriers)."""

    def __init__(self, capacity: int = 32, name: str = ""):
        self.capacity = capacity
        self.name = name
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        #: producer time spent waiting for credit (backpressured)
        self.backpressured_ns = 0
        #: checkpoint ids of barriers currently QUEUED (oldest first) — the
        #: priority-event announcement of the reference: the consumer's
        #: barrier handler learns a barrier arrived without draining the
        #: backlog in front of it
        self._announced: deque = deque()

    def put(self, el: StreamElement, timeout_s: Optional[float] = None) -> bool:
        # fault point: a partitioned link stalls (bytes neither flow nor
        # error — FreezableProxy semantics); fail/delay schedules raise/slow.
        # Fired ONCE per put — while dropped, poll blocked() so the firing
        # counter/history stay deterministic regardless of stall duration
        if not chaos.fire("channel.send", channel=self.name):
            deadline = (None if timeout_s is None
                        else time.monotonic() + timeout_s)
            while chaos.blocked("channel.send"):
                if self._closed:
                    return False
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                time.sleep(0.01)
        with self._not_full:
            if len(self._q) >= self.capacity and not self._closed:
                t0 = time.monotonic_ns()
                while len(self._q) >= self.capacity and not self._closed:
                    if not self._not_full.wait(timeout=timeout_s):
                        self.backpressured_ns += time.monotonic_ns() - t0
                        return False
                self.backpressured_ns += time.monotonic_ns() - t0
            if self._closed:
                return False
            self._q.append(el)
            if isinstance(el, CheckpointBarrier):
                self._announced.append(el.checkpoint_id)
            self._not_empty.notify()
            return True

    def poll(self, timeout_s: float = 0.0) -> Optional[StreamElement]:
        with self._not_empty:
            if not self._q and timeout_s > 0:
                self._not_empty.wait(timeout=timeout_s)
            if not self._q:
                return None
            el = self._q.popleft()
            if isinstance(el, CheckpointBarrier) and self._announced:
                self._announced.popleft()
            self._not_full.notify()
        # fault point: a SLOW CONSUMER drains this channel with bursty
        # stalls (chaos.SlowConsumer).  Outside the lock — a stalled
        # consumer must not also block the producer's put
        chaos.fire("channel.recv", channel=self.name)
        return el

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def queued_bytes(self) -> int:
        with self._lock:
            return sum(element_bytes(el) for el in self._q)

    def announced_barrier(self) -> Optional[int]:
        """Oldest checkpoint barrier currently queued (or None): the
        consumer's barrier handler reads this to react to a barrier ON
        ARRIVAL instead of after draining the backlog in front of it."""
        with self._lock:
            return self._announced[0] if self._announced else None

    def take_until_barrier(self, checkpoint_id: int):
        """Barrier overtake (unaligned checkpoints): atomically extract the
        queued elements IN FRONT of checkpoint ``checkpoint_id``'s barrier
        — the in-flight data the barrier jumps over.  Returns
        ``(elements, barrier)`` where ``barrier`` is the consumed barrier
        ELEMENT (its ``is_savepoint`` flag matters to the caller) or None
        when it was not queued.  Extraction stops at any barrier or
        EndOfInput; it never reaches past a channel-terminating event.
        Bypasses :meth:`poll` (and its slow-consumer fault point) by
        design: persisting in-flight data must not be throttled by the
        very backpressure it escapes."""
        with self._not_full:
            out, barrier = take_until_barrier_locked(
                self._q, self._announced, checkpoint_id)
            if out or barrier is not None:
                self._not_full.notify_all()
        return out, barrier

    def close(self) -> None:
        """Unblock producers/consumers (used on cancel/teardown)."""
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class OutputDispatcher:
    """Routes one subtask's emissions to target channels per edge semantics
    (``RecordWriter`` + ``StreamPartitioner`` analog)."""

    def __init__(self, partitioning: str, channels: Sequence[LocalChannel],
                 max_parallelism: int = 128, subtask_index: int = 0,
                 key_column: Optional[str] = None):
        self.partitioning = partitioning
        self.channels = list(channels)
        self.max_parallelism = max_parallelism
        self.key_column = key_column  # hash edges key on this column
        self._rr = subtask_index  # stagger round-robin starts across producers

    def emit(self, el: StreamElement) -> None:
        n = len(self.channels)
        if n == 0:
            return
        if not isinstance(el, RecordBatch):
            from flink_tpu_torch.core.batch import TaggedBatch
            if isinstance(el, TaggedBatch):
                # side-output DATA: route to one consumer (round-robin), not
                # the control-broadcast path — broadcasting would duplicate
                # side-output rows x parallelism
                self.channels[self._rr % n].put(el)
                self._rr += 1
                return
            for ch in self.channels:   # broadcast control elements
                ch.put(el)
            return
        if len(el) == 0:
            return
        if n == 1:
            self.channels[0].put(el)
        elif self.partitioning == "hash":
            self._emit_hash(el)
        elif self.partitioning == "broadcast":
            for ch in self.channels:
                ch.put(el)
        elif self.partitioning == "global":
            self.channels[0].put(el)   # everything to subtask 0
        elif self.partitioning in ("rebalance", "rescale", "shuffle"):
            self.channels[self._rr % n].put(el)
            self._rr += 1
        else:  # forward with n>1 targets is a wiring bug
            raise ValueError(
                f"forward edge cannot fan out to {n} channels")

    def _emit_hash(self, batch: RecordBatch) -> None:
        kg = batch.key_groups
        if kg is None and self.key_column is not None:
            # the keying operator lives at the consumer chain head; the
            # producer-side partitioner derives key groups from the key
            # column itself (KeyGroupStreamPartitioner's key selector)
            keys = np.asarray(batch.column(self.key_column))
            kg = keygroups.assign_to_key_group(keygroups.hash_keys(keys),
                                               self.max_parallelism)
        if kg is None:
            raise ValueError("hash edge requires key_groups on the batch "
                             "(key_by upstream)")
        n = len(self.channels)
        # KeyGroupRangeAssignment.computeOperatorIndexForKeyGroup
        target = (np.asarray(kg, np.int64) * n) // self.max_parallelism
        for t in range(n):
            sel = target == t
            if sel.any():
                self.channels[t].put(batch.select(sel))

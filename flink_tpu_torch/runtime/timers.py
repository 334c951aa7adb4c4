"""Keyed timer service, batched (port of ``flink_tpu/runtime/timers.py``,
host numpy as JAX's).

Analog of ``InternalTimerServiceImpl.java:43``: per-key event-time and
processing-time timers with (key, namespace, timestamp) identity, fired in
timestamp order when the watermark / processing clock advances.  Re-designed
batched: registrations arrive as **arrays of (slot, namespace, ts)** per
micro-batch (one numpy append + one dedup at fire time instead of a
key-grouped priority-queue poll per timer), which is the only shape the
batched operators produce anyway.

Fire order matches the reference: ascending timestamp, and each fired batch
is handed back as arrays so the operator can run its ``on_timer`` logic
vectorized over every key firing at the same watermark advance.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.batch import LONG_MIN


class _TimerTable:
    """Append-only (slot, namespace, ts) triples with lazy dedup/compaction."""

    def __init__(self):
        self._slots = np.zeros(0, np.int64)
        self._ns = np.zeros(0, np.int64)
        self._ts = np.zeros(0, np.int64)

    def __len__(self) -> int:
        return self._slots.size

    def register(self, slots, timestamps, namespaces=None) -> None:
        slots = np.asarray(slots, np.int64)
        if slots.size == 0:
            return
        ts = np.asarray(timestamps, np.int64)
        ns = (np.zeros(slots.size, np.int64) if namespaces is None
              else np.asarray(namespaces, np.int64))
        self._slots = np.concatenate([self._slots, slots])
        self._ns = np.concatenate([self._ns, ns])
        self._ts = np.concatenate([self._ts, ts])

    def delete(self, slots, timestamps, namespaces=None) -> None:
        """``deleteEventTimeTimer`` analog: drop matching (slot, ns, ts)."""
        if self._slots.size == 0:
            return
        slots = np.asarray(slots, np.int64)
        ts = np.asarray(timestamps, np.int64)
        ns = (np.zeros(slots.size, np.int64) if namespaces is None
              else np.asarray(namespaces, np.int64))
        # structured view for row-wise membership
        mine = self._pack()
        kill = _pack3(slots, ns, ts)
        keep = ~np.isin(mine, kill)
        self._keep(keep)

    def _pack(self) -> np.ndarray:
        return _pack3(self._slots, self._ns, self._ts)

    def _keep(self, mask: np.ndarray) -> None:
        self._slots = self._slots[mask]
        self._ns = self._ns[mask]
        self._ts = self._ts[mask]

    def pop_due(self, up_to_inclusive: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Remove and return all unique timers with ts <= bound, sorted by
        (ts, slot) — the reference's queue-poll order."""
        if self._slots.size == 0:
            return (np.zeros(0, np.int64),) * 3
        due = self._ts <= up_to_inclusive
        if not due.any():
            return (np.zeros(0, np.int64),) * 3
        s, n, t = self._slots[due], self._ns[due], self._ts[due]
        self._keep(~due)
        # dedup (registration is idempotent in the reference)
        packed = _pack3(s, n, t)
        _, first = np.unique(packed, return_index=True)
        first = np.sort(first)
        s, n, t = s[first], n[first], t[first]
        order = np.lexsort((s, t))
        return s[order], n[order], t[order]

    def min_timestamp(self) -> Optional[int]:
        return int(self._ts.min()) if self._ts.size else None

    def snapshot(self) -> Dict[str, np.ndarray]:
        packed = self._pack()
        _, first = np.unique(packed, return_index=True)
        return {"slots": self._slots[first].copy(),
                "ns": self._ns[first].copy(),
                "ts": self._ts[first].copy()}

    def restore(self, snap: Dict[str, np.ndarray]) -> None:
        self._slots = np.asarray(snap["slots"], np.int64).copy()
        self._ns = np.asarray(snap["ns"], np.int64).copy()
        self._ts = np.asarray(snap["ts"], np.int64).copy()


def _pack3(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Row-wise identity of (slot, ns, ts) triples via a void view."""
    m = np.empty((a.size, 3), np.int64)
    m[:, 0], m[:, 1], m[:, 2] = a, b, c
    return np.ascontiguousarray(m).view([("", np.int64)] * 3).ravel()


class InternalTimerService:
    """Event + processing time timers for one keyed operator
    (``InternalTimerServiceImpl`` analog, snapshotted with operator state)."""

    def __init__(self):
        self.event_timers = _TimerTable()
        self.proc_timers = _TimerTable()
        self.current_watermark: int = LONG_MIN
        #: high-water processing time: the service is MONOTONE even when
        #: the driving clock is not (chaos ClockSkew / NTP step-back) —
        #: ``ProcessingTimeService`` contract.  A backward step can
        #: neither re-fire popped timers (they left the table) nor fire
        #: pending ones early; a forward jump fires everything due at once
        #: (no stuck timers).
        self.current_processing_time: int = LONG_MIN

    # -- registration (batched) ---------------------------------------------
    def register_event_time(self, slots, timestamps, namespaces=None) -> None:
        self.event_timers.register(slots, timestamps, namespaces)

    def register_processing_time(self, slots, timestamps, namespaces=None) -> None:
        self.proc_timers.register(slots, timestamps, namespaces)

    def delete_event_time(self, slots, timestamps, namespaces=None) -> None:
        self.event_timers.delete(slots, timestamps, namespaces)

    def delete_processing_time(self, slots, timestamps, namespaces=None) -> None:
        self.proc_timers.delete(slots, timestamps, namespaces)

    # -- advance -------------------------------------------------------------
    def advance_watermark(self, watermark: int):
        """Returns (slots, namespaces, timestamps) of event-time timers due at
        this watermark, in fire order (``advanceWatermark`` analog)."""
        self.current_watermark = watermark
        return self.event_timers.pop_due(watermark)

    def advance_processing_time(self, now_ms: int):
        self.current_processing_time = max(self.current_processing_time,
                                           now_ms)
        return self.proc_timers.pop_due(self.current_processing_time)

    def next_processing_time(self) -> Optional[int]:
        """Earliest pending processing-time timer (executor wakeup hint)."""
        return self.proc_timers.min_timestamp()

    # -- snapshot ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {"event": self.event_timers.snapshot(),
                "proc": self.proc_timers.snapshot(),
                "watermark": self.current_watermark,
                "proc_time": self.current_processing_time}

    def restore(self, snap: Dict[str, Any]) -> None:
        self.event_timers.restore(snap["event"])
        self.proc_timers.restore(snap["proc"])
        self.current_watermark = int(snap.get("watermark", LONG_MIN))
        self.current_processing_time = int(snap.get("proc_time", LONG_MIN))

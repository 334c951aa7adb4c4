"""KeyedProcessFunction operator: user logic + keyed state + timers (port
of ``flink_tpu/operators/process.py``, host numpy as JAX's).

Analog of ``KeyedProcessOperator`` running a ``KeyedProcessFunction``
(``flink-streaming-java/.../api/operators/KeyedProcessOperator.java``),
batched: the user function receives a whole ``RecordBatch`` plus a context
exposing vectorized keyed state (``state/heap.py``) and batched
timer registration (``runtime/timers.py``); ``on_timer_batch``
receives ALL timers firing at one watermark advance as arrays.

Timer snapshots store raw keys (not backend-local slot ids) so they survive
key-group redistribution on rescale — the same property the reference gets
from key-grouped timer queues (``InternalTimerServiceImpl.java:50``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from flink_tpu_torch.core import keygroups
from flink_tpu_torch.core.batch import (LONG_MIN, OutputTag, RecordBatch,
                                        StreamElement, TaggedBatch, Watermark)
from flink_tpu_torch.core.functions import RichFunction, RuntimeContext
from flink_tpu_torch.operators.base import (StreamOperator,
                                            current_checkpoint_id,
                                            snapshot_is_incremental)
from flink_tpu_torch.runtime.timers import InternalTimerService
from flink_tpu_torch.state.heap import HeapKeyedStateBackend
from flink_tpu_torch.state.redistribute import (merge_keyed_snapshots,
                                                split_keyed_snapshot)


class KeyedProcessFunction(RichFunction):
    """Batched ``KeyedProcessFunction`` contract.

    process_batch(ctx, batch)        -> elements to emit (list or None)
    on_timer_batch(ctx, slots, ts)   -> elements to emit for fired timers
    """

    def process_batch(self, ctx: "Context", batch: RecordBatch):
        raise NotImplementedError

    def on_timer_batch(self, ctx: "OnTimerContext", slots: np.ndarray,
                       timestamps: np.ndarray):
        return None


class TimerServiceView:
    """User-facing timer registration surface (``TimerService`` analog)."""

    def __init__(self, timers: InternalTimerService):
        self._timers = timers

    def current_watermark(self) -> int:
        return self._timers.current_watermark

    def register_event_time_timers(self, slots, timestamps) -> None:
        self._timers.register_event_time(slots, timestamps)

    def register_processing_time_timers(self, slots, timestamps) -> None:
        self._timers.register_processing_time(slots, timestamps)

    def delete_event_time_timers(self, slots, timestamps) -> None:
        self._timers.delete_event_time(slots, timestamps)

    def delete_processing_time_timers(self, slots, timestamps) -> None:
        self._timers.delete_processing_time(slots, timestamps)


class Context:
    """Per-batch context: state access + timers + key metadata."""

    def __init__(self, op: "KeyedProcessOperator", slots: Optional[np.ndarray]):
        self._op = op
        self.slots = slots  # dense slot per row of the current batch
        self.timer_service = TimerServiceView(op.timers)
        self._side: list = []

    def side_output(self, tag, columns, timestamps=None) -> None:
        """Emit a batch to the named side output (``Context.output`` analog).
        ``tag`` is an OutputTag or its name string."""
        name = tag.name if isinstance(tag, OutputTag) else str(tag)
        self._side.append(TaggedBatch(
            name, RecordBatch({k: np.asarray(v) for k, v in columns.items()},
                              timestamps=timestamps)))

    def state(self, descriptor):
        return self._op.backend.get_state(descriptor)

    def keys_of(self, slots: np.ndarray) -> np.ndarray:
        return self._op.backend.slot_keys(slots)

    @property
    def current_watermark(self) -> int:
        return self._op.timers.current_watermark


class OnTimerContext(Context):
    pass


class KeyedProcessOperator(StreamOperator):
    def __init__(self, fn: KeyedProcessFunction, key_column: str,
                 name: str = "keyed-process", backend=None):
        self.fn = fn
        self.key_column = key_column
        self.name = name
        #: configurable keyed backend (state.backend): heap / native spill /
        #: changelog wrapper — same vectorized State API either way
        self.backend = backend if backend is not None \
            else HeapKeyedStateBackend()
        self.timers = InternalTimerService()
        #: incremental checkpoints: ship changelog-suffix increments when
        #: the backend supports them (runtime enables this per job)
        self.incremental_state = False

    def open(self, ctx: RuntimeContext) -> None:
        super().open(ctx)
        self.backend.max_parallelism = ctx.max_parallelism
        # budgeted backends claim their share of the slot's managed memory
        mm = getattr(ctx, "memory_manager", None)
        if mm is not None and hasattr(self.backend, "reserve_managed"):
            self.backend.reserve_managed(
                mm, owner=f"{ctx.task_name}[{ctx.subtask_index}]")
        self.fn.open(ctx)

    def process_batch(self, batch: RecordBatch) -> List[StreamElement]:
        slots = self.backend.key_slots(np.asarray(batch.column(self.key_column)))
        batch = batch.with_keys(slots, batch.key_groups)
        ctx = Context(self, slots)
        out = self.fn.process_batch(ctx, batch)
        return _normalize(out) + ctx._side

    def process_watermark(self, watermark: Watermark) -> List[StreamElement]:
        slots, _ns, ts = self.timers.advance_watermark(watermark.timestamp)
        if slots.size == 0:
            return []
        ctx = OnTimerContext(self, None)
        out = self.fn.on_timer_batch(ctx, slots, ts)
        return _normalize(out) + ctx._side

    def on_processing_time(self, timestamp_ms: int) -> List[StreamElement]:
        slots, _ns, ts = self.timers.advance_processing_time(timestamp_ms)
        if slots.size == 0:
            return []
        ctx = OnTimerContext(self, None)
        out = self.fn.on_timer_batch(ctx, slots, ts)
        return _normalize(out) + ctx._side

    # -- checkpointing -------------------------------------------------------
    def _timer_snapshot(self) -> Dict[str, Any]:
        tsnap = self.timers.snapshot()
        # slot ids -> raw keys for rescale-safety
        for part in ("event", "proc"):
            slots = tsnap[part]["slots"]
            tsnap[part] = dict(tsnap[part])
            tsnap[part]["keys"] = (self.backend.slot_keys(slots)
                                   if slots.size else np.zeros(0, np.int64))
            del tsnap[part]["slots"]
        return tsnap

    def snapshot_state(self) -> Dict[str, Any]:
        cid = current_checkpoint_id()
        if self.incremental_state and cid is not None \
                and snapshot_is_incremental() \
                and hasattr(self.backend, "snapshot_increment"):
            inc = self.backend.snapshot_increment(cid)
            if inc is not None:
                # timers ride in extras (small, shipped whole every cut:
                # the applier overwrites them onto the resolved base)
                inc["extras"] = {"timers": self._timer_snapshot()}
                return inc
            # fall through: full cut (the backend froze the position, so
            # confirmation still advances the suffix base to this cut)
        snap = self.backend.snapshot()
        snap["timers"] = self._timer_snapshot()
        return snap

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        if hasattr(self.backend, "notify_checkpoint_complete"):
            self.backend.notify_checkpoint_complete(checkpoint_id)
        super().notify_checkpoint_complete(checkpoint_id)

    def restore_state(self, snap: Dict[str, Any]) -> None:
        tsnap = snap.get("timers")
        self.backend.restore({k: v for k, v in snap.items() if k != "timers"})
        if tsnap is not None:
            ctx = getattr(self, "ctx", None)
            my_range = (keygroups.compute_key_group_range(
                ctx.max_parallelism, ctx.parallelism, ctx.subtask_index)
                if ctx is not None else None)
            restored = {"watermark": tsnap.get("watermark", LONG_MIN)}
            for part in ("event", "proc"):
                p = dict(tsnap[part])
                keys = np.asarray(p.pop("keys"))
                if keys.size and my_range is not None and ctx.parallelism > 1:
                    # rescale: a split snapshot carries every subtask's timers;
                    # keep only keys in this subtask's key-group range
                    kg = keygroups.assign_to_key_group(
                        keygroups.hash_keys(keys), ctx.max_parallelism)
                    mine = (kg >= my_range.start) & (kg <= my_range.end)
                    keys = keys[mine]
                    p["ns"] = np.asarray(p["ns"])[mine]
                    p["ts"] = np.asarray(p["ts"])[mine]
                p["slots"] = (self.backend.key_slots(keys).astype(np.int64)
                              if keys.size else np.zeros(0, np.int64))
                restored[part] = p
            self.timers.restore(restored)

    def close(self) -> None:
        self.fn.close()
        # releases the backend's managed-memory claim + spill resources
        if hasattr(self.backend, "close"):
            self.backend.close()

    # -- rescale hooks (StateAssignmentOperation analog) ---------------------
    @staticmethod
    def split_snapshot(snap: Dict[str, Any], max_parallelism: int,
                       new_parallelism: int) -> List[Dict[str, Any]]:
        """Each part carries the full timer set; ``restore_state`` filters by
        the restoring subtask's key-group range."""
        return split_keyed_snapshot(snap, HeapKeyedStateBackend.row_fields(snap),
                                    max_parallelism, new_parallelism)

    @staticmethod
    def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Scale-down merge: keyed rows via the shared redistribution path,
        timers unioned across every part (they are not per-slot row fields)."""
        fields = HeapKeyedStateBackend.row_fields(snaps[0]) if snaps else []
        merged = merge_keyed_snapshots(snaps, fields)
        timer_parts = [s["timers"] for s in snaps if "timers" in s]
        if timer_parts:
            union: Dict[str, Any] = {
                "watermark": max(t.get("watermark", LONG_MIN)
                                 for t in timer_parts)}
            for part in ("event", "proc"):
                union[part] = {
                    f: np.concatenate([np.asarray(t[part][f])
                                       for t in timer_parts])
                    for f in ("keys", "ns", "ts")}
            merged["timers"] = union
        return merged


def _normalize(out) -> List[StreamElement]:
    if out is None:
        return []
    if isinstance(out, RecordBatch):
        return [out]
    return [o for o in out if o is not None and (not o.is_batch() or len(o))]

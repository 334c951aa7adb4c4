"""Local pipeline executor — the MiniCluster/mailbox analog (port of
``flink_tpu/runtime/executor.py``).

Runs an ``ExecutionPlan`` in one process: every vertex is a single-writer
operator instance (the structural race-avoidance of the reference's mailbox
model, ``MailboxProcessor.java:66``); sources are drained split-by-split in
round-robin (pipeline parallelism across vertices comes from the dataflow
itself); watermarks from multiple inputs are aligned with a per-vertex
min-valve (``StatusWatermarkValve.java:38``); bounded input ends with
MAX_WATERMARK + ``end_input`` cascade in topological order, mirroring the
reference's end-of-input flushing.

Elements are delivered depth-first: an operator's emissions reach downstream
*before* the element that caused them is forwarded — the same ordering the
reference gets from in-band control flow, and the property checkpoint barrier
alignment relies on.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from flink_tpu_torch.core.batch import (LONG_MIN, MAX_WATERMARK, CheckpointBarrier,
                                  RecordBatch, StreamElement, StreamStatus,
                                  TaggedBatch, Watermark)
from flink_tpu_torch.core.functions import RuntimeContext
from flink_tpu_torch.graph.stream_graph import ExecutionPlan, PlanVertex
from flink_tpu_torch.operators.base import StreamOperator


class WatermarkValve:
    """Min-across-inputs watermark alignment (``StatusWatermarkValve``).

    Idleness (``StreamStatus``, ``StatusWatermarkValve.java`` markIdle
    semantics): an IDLE input is excluded from the min, so one stalled
    source cannot freeze event time for the whole pipeline; when every
    input is idle no watermark advances (nothing can be proven)."""

    def __init__(self, num_inputs: int):
        self.per_input = [LONG_MIN] * max(1, num_inputs)
        self.idle = [False] * max(1, num_inputs)
        self.current = LONG_MIN
        self._last_combined = False  # last combined status forwarded

    def _advance(self) -> Optional[int]:
        active = [wm for wm, idl in zip(self.per_input, self.idle)
                  if not idl]
        if not active:
            return None
        new_min = min(active)
        if new_min > self.current:
            self.current = new_min
            return new_min
        return None

    def record_activity(self, input_index: int) -> Optional[bool]:
        """Any element on an idle channel reactivates it; returns the new
        COMBINED status iff it changed (the caller forwards it downstream —
        the reference forwards ACTIVE on any reactivating element)."""
        if not self.idle[input_index]:
            return None
        self.idle[input_index] = False
        combined = all(self.idle)
        if combined != self._last_combined:
            self._last_combined = combined
            return combined
        return None

    def input_watermark(self, input_index: int, ts: int) -> Optional[int]:
        # a watermark is proof of activity; idleness-aware callers invoke
        # record_activity FIRST to forward the transition — this fallback
        # keeps the combined memory consistent for everyone else
        if self.idle[input_index]:
            self.idle[input_index] = False
            self._last_combined = all(self.idle)
        if ts > self.per_input[input_index]:
            self.per_input[input_index] = ts
        return self._advance()

    def input_status(self, input_index: int, idle: bool) -> Optional[int]:
        """Mark a channel idle/active; going idle can UNBLOCK the min."""
        self.idle[input_index] = idle
        return self._advance()

    def status_update(self, input_index: int,
                      idle: bool) -> Tuple[Optional[int], bool, bool]:
        """One StreamStatus arrival: returns (advanced watermark or None,
        combined idle status, whether the combined status CHANGED — the
        reference forwards status only on change)."""
        adv = self.input_status(input_index, idle)
        combined = all(self.idle)
        changed = combined != self._last_combined
        self._last_combined = combined
        return adv, combined, changed

    # -- snapshot (idle flags must survive recovery: a restored subtask
    # will never be re-sent an idle channel's status) --------------------
    def snapshot(self) -> Dict[str, Any]:
        return {"per_input": list(self.per_input), "idle": list(self.idle),
                "current": self.current, "combined": self._last_combined}

    def restore(self, snap) -> None:
        if isinstance(snap, dict):
            self.per_input = list(snap["per_input"])
            self.idle = list(snap.get("idle", [False] * len(self.per_input)))
            self.current = snap.get("current", LONG_MIN)
            self._last_combined = snap.get("combined", False)
        else:  # legacy list-only snapshots
            self.per_input = list(snap)
            self.idle = [False] * len(self.per_input)
            self.current = min(self.per_input)
        active = [wm for wm, idl in zip(self.per_input, self.idle)
                  if not idl]
        if active:
            self.current = max(self.current, min(active))


@dataclass
class RunningVertex:
    vertex: PlanVertex
    operator: StreamOperator
    valve: WatermarkValve
    # (target RunningVertex, input index at target)
    targets: List[Tuple["RunningVertex", int]] = field(default_factory=list)
    ended_inputs: int = 0
    num_inputs: int = 0
    io: Any = None  # OperatorIOMetrics


@dataclass
class JobExecutionResult:
    job_name: str
    net_runtime_ms: float
    records_emitted: int = 0
    accumulators: Dict[str, float] = field(default_factory=dict)

    def get_accumulator_result(self, name: str) -> float:
        """``JobExecutionResult.getAccumulatorResult`` analog."""
        return self.accumulators[name]


class LocalExecutor:
    """Single-process executor (reference analog: ``LocalExecutor`` +
    ``MiniCluster`` running a job with real operator semantics in one JVM)."""

    def __init__(self, checkpoint_interval_ms: int = 0,
                 checkpoint_storage=None,
                 listeners: Optional[List[Callable[[str, Any], None]]] = None,
                 max_records: Optional[int] = None,
                 max_wall_ms: Optional[int] = None,
                 metric_registry=None, config=None):
        self.checkpoint_interval_ms = checkpoint_interval_ms
        self.checkpoint_storage = checkpoint_storage
        self.listeners = listeners or []
        self.max_records = max_records      # unbounded-source record budget
        self.max_wall_ms = max_wall_ms      # unbounded-source wall budget
        self.metric_registry = metric_registry
        self.config = config
        self._cancelled = False
        self._records = 0

    def cancel(self) -> None:
        """Cooperative cancellation (``JobMaster.cancel`` analog): the source
        loop stops at the next batch boundary and flushes bounded-end path."""
        self._cancelled = True

    # ------------------------------------------------------------- wiring
    def _build(self, plan: ExecutionPlan,
               restore: Optional[Dict[str, Any]] = None) -> Dict[int, RunningVertex]:
        from flink_tpu_torch.metrics import (MetricRegistry, OperatorIOMetrics,
                                       task_metric_group)

        if self.metric_registry is None:
            self.metric_registry = MetricRegistry()
        # local execution = one slot: every operator shares this slot's
        # managed-memory accountant (budgeted components reserve from it)
        from flink_tpu_torch.runtime.memory import memory_manager_for
        slot_memory = memory_manager_for(self.config)
        running: Dict[int, RunningVertex] = {}
        for v in plan.vertices:
            op = v.build_operator()
            group = task_metric_group(self.metric_registry, plan.job_name,
                                      v.name, 0)
            ctx = RuntimeContext(task_name=v.name, subtask_index=0, parallelism=1,
                                 max_parallelism=v.max_parallelism,
                                 metrics=group, memory_manager=slot_memory)
            op.open(ctx)
            if restore and v.uid in restore:
                op.restore_state(restore[v.uid])
            rv = RunningVertex(v, op, WatermarkValve(0))
            rv.io = OperatorIOMetrics(group)
            running[v.id] = rv
        # wire edges by the target's declared logical input port
        in_counts: Dict[int, int] = {v.id: 0 for v in plan.vertices}
        for v in plan.vertices:
            for e in v.out_edges:
                tgt = running[e.target_id]
                in_counts[e.target_id] += 1
                running[v.id].targets.append((tgt, e.input_index))
        for v in plan.vertices:
            rv = running[v.id]
            rv.num_inputs = max(1, in_counts[v.id])
            rv.valve = WatermarkValve(rv.num_inputs)
        return running

    # ----------------------------------------------------------- delivery
    def _route(self, rv: RunningVertex, elements: List[StreamElement]) -> None:
        for el in elements:
            if isinstance(el, RecordBatch):
                self._records += len(el)
                if rv.io is not None:
                    rv.io.records_out.inc(len(el))
            for tgt, idx in rv.targets:
                self._deliver(tgt, idx, el)

    def _deliver(self, rv: RunningVertex, input_index: int,
                 el: StreamElement) -> None:
        op = rv.operator
        if isinstance(el, RecordBatch):
            if len(el):
                st = rv.valve.record_activity(input_index)
                if st is not None:
                    self._route(rv, [StreamStatus(st)])
                if rv.io is not None:
                    rv.io.records_in.inc(len(el))
                if getattr(op, "is_two_input", False):
                    self._route(rv, op.process_batch2(el, input_index))
                else:
                    self._route(rv, op.process_batch(el))
        elif isinstance(el, Watermark):
            st = rv.valve.record_activity(input_index)
            if st is not None:
                self._route(rv, [StreamStatus(st)])
            advanced = rv.valve.input_watermark(input_index, el.timestamp)
            if advanced is not None:
                if rv.io is not None:
                    rv.io.watermark.set(advanced)
                wm = Watermark(advanced)
                self._route(rv, op.process_watermark(wm))
                if op.forwards_watermarks:
                    self._route(rv, [wm])
        elif isinstance(el, CheckpointBarrier):
            # single-input-per-vertex local mode: barrier alignment is trivial;
            # snapshot on first arrival, forward once all inputs delivered it.
            self._on_barrier(rv, input_index, el)
        elif isinstance(el, TaggedBatch):
            # side-output routing: only the matching SideOutputOperator
            # consumes it; every other vertex drops it
            if getattr(op, "accepts_tag", None) == el.tag:
                self._route(rv, op.process_tagged(el.batch))
        elif isinstance(el, StreamStatus):
            # idleness: excluding the idle channel can itself advance the
            # min watermark (StatusWatermarkValve.markIdle)
            advanced, combined, changed = rv.valve.status_update(
                input_index, el.idle)
            if advanced is not None:
                wm = Watermark(advanced)
                self._route(rv, op.process_watermark(wm))
                if op.forwards_watermarks:
                    self._route(rv, [wm])
            if changed:  # vertex's COMBINED status, forwarded on change
                self._route(rv, [StreamStatus(combined)])
        else:
            self._route(rv, [el])

    # barrier handling is installed by a checkpointing runtime — default:
    # pass through.
    def _on_barrier(self, rv: RunningVertex, input_index: int,
                    barrier: CheckpointBarrier) -> None:
        self._route(rv, [barrier])


    @staticmethod
    def _close_all(plan, running) -> None:
        """Close every operator even when one close() raises (a pipelined
        operator surfaces parked hot-stage errors at close): remaining
        operators must still release their threads/spill files/native
        handles.  The FIRST error wins and re-raises after the sweep."""
        first: Optional[BaseException] = None
        for v in plan.vertices:
            try:
                running[v.id].operator.close()
            except BaseException as e:  # noqa: BLE001 — collected, re-raised
                if first is None:
                    first = e
        if first is not None:
            raise first


    # ---------------------------------------------------------------- run
    def execute(self, plan: ExecutionPlan,
                restore: Optional[Dict[str, Any]] = None,
                drain: bool = True) -> JobExecutionResult:
        t0 = time.monotonic()
        running = self._build(plan, restore)
        self.running = running
        self.plan = plan
        source_vertices = [running[v.id] for v in plan.sources]

        # split readers, round-robin (SourceReaderBase poll loop analog);
        # stateful sources (open_split + reader.position) resume from the
        # checkpointed position — FLIP-27 SourceReader.snapshotState analog
        restored_positions = (restore or {}).get("__sources__", {})
        readers: List[Tuple[RunningVertex, Any]] = []
        self._split_readers: List[Tuple[str, str, Any]] = []  # (uid, split_id, reader)
        for rv in source_vertices:
            src = rv.vertex.chain[0].source
            positions = restored_positions.get(rv.vertex.uid, {})
            for split in src.create_splits(rv.vertex.parallelism):
                from flink_tpu_torch.connectors.sources import split_id_of
                split_id = split_id_of(split)
                if hasattr(src, "open_split"):
                    reader = src.open_split(split, positions.get(split_id))
                else:
                    reader = split.read()
                readers.append((rv, reader))
                self._split_readers.append((rv.vertex.uid, split_id, reader))

        # checkpoint cadence through the injectable clock seam, clamped
        # monotone: a chaos ClockSkew backward step must not stall the
        # periodic trigger (nor a forward jump double-fire after recovery)
        from flink_tpu_torch.utils.clock import MonotoneElapsed
        ckpt_timer = MonotoneElapsed()
        ckpt_id = 0
        while readers and not self._cancelled:
            if self.max_records is not None and self._records >= self.max_records:
                break
            if (self.max_wall_ms is not None
                    and (time.monotonic() - t0) * 1000 >= self.max_wall_ms):
                break
            self._advance_processing_time(running)
            still: List[Tuple[RunningVertex, Any]] = []
            for rv, it in readers:
                try:
                    el = next(it)
                except StopIteration:
                    # source exhausted: this vertex goes quiet until the
                    # bounded-end cascade — flush pipelined operators now
                    # so their in-flight hot stages don't idle undispatched
                    flush = getattr(rv.operator, "flush_pipeline", None)
                    if flush is not None:
                        self._route(rv, flush())
                    continue
                # a source vertex's chain may include chained operators:
                # feed the element through its own operator first
                if isinstance(el, RecordBatch):
                    self._route(rv, rv.operator.process_batch(el))
                elif isinstance(el, Watermark):
                    adv = rv.valve.input_watermark(0, el.timestamp)
                    if adv is not None:
                        wm = Watermark(adv)
                        self._route(rv, rv.operator.process_watermark(wm))
                        if rv.operator.forwards_watermarks:
                            self._route(rv, [wm])
                else:
                    self._route(rv, [el])
                still.append((rv, it))
            readers = still
            if (self.checkpoint_interval_ms and self.checkpoint_storage and
                    ckpt_timer.ms() >= self.checkpoint_interval_ms):
                ckpt_id += 1
                self.trigger_checkpoint(ckpt_id)
                ckpt_timer = MonotoneElapsed()

        # bounded end: MAX_WATERMARK from sources, then end_input in topo
        # order.  drain=False (stop-with-savepoint --no-drain analog) keeps
        # in-progress windows unfired so a restore continues them.
        if not drain:
            self._close_all(plan, running)
            return JobExecutionResult(plan.job_name,
                                      (time.monotonic() - t0) * 1000.0,
                                      self._records,
                                      self._collect_accumulators(running))
        for rv in source_vertices:
            adv = rv.valve.input_watermark(0, MAX_WATERMARK)
            if adv is not None:
                wm = Watermark(adv)
                self._route(rv, rv.operator.process_watermark(wm))
                self._route(rv, [wm])
        for v in plan.vertices:
            rv = running[v.id]
            self._route(rv, rv.operator.end_input())
        self._close_all(plan, running)
        return JobExecutionResult(plan.job_name,
                                  (time.monotonic() - t0) * 1000.0,
                                  self._records,
                                  self._collect_accumulators(running))

    def _collect_accumulators(self, running) -> Dict[str, float]:
        """Merge per-subtask user counters (reference: accumulators shipped
        with the final task state and merged on the JobMaster)."""
        out: Dict[str, float] = {}
        for rv in running.values():
            ctx = getattr(rv.operator, "ctx", None)
            for name, v in (ctx.accumulator_results() if ctx else {}).items():
                out[name] = out.get(name, 0.0) + v
        return out

    def _advance_processing_time(self, running: Dict[int, RunningVertex]) -> None:
        """Fire due processing-time timers on every vertex (the
        ``ProcessingTimeService`` tick; local mode polls wall clock between
        source rounds — same granularity as the mailbox checking its mail).

        Reads through the injectable clock seam (``utils/clock.py``) and
        clamps MONOTONE at this boundary: a backward-stepped wall clock
        (chaos ``ClockSkew``, NTP) must never rewind processing time —
        the reference's ``ProcessingTimeService`` is monotone by contract,
        so timers can neither re-fire nor fire early on a step back."""
        from flink_tpu_torch.utils import clock
        now_ms = max(clock.now_ms(), getattr(self, "_proc_time_ms", 0))
        self._proc_time_ms = now_ms
        for rv in running.values():
            out = rv.operator.on_processing_time(now_ms)
            if out:
                self._route(rv, out)

    # ------------------------------------------------------- checkpointing
    def trigger_checkpoint(self, checkpoint_id: int) -> Dict[str, Any]:
        """Synchronous aligned checkpoint of all vertices (local mode: the
        depth-first delivery order means no in-flight data exists between
        vertices at this point — alignment is implicit)."""
        from flink_tpu_torch.operators.base import snapshot_scope

        # pre-barrier drain: async emissions reach downstream BEFORE the
        # snapshot (AbstractPythonFunctionOperator.prepareSnapshotPreBarrier
        # analog) — topo order so drained elements flow through the plan
        plan = getattr(self, "plan", None)
        for v in plan.vertices if plan is not None else []:
            rv = self.running.get(v.id)
            if rv is None:
                continue
            prep = getattr(rv.operator, "prepare_snapshot_pre_barrier",
                           None)
            drained = prep() if prep is not None else []
            if drained:
                self._route(rv, drained)
        with snapshot_scope(checkpoint_id):
            snapshot = {rv.vertex.uid: rv.operator.snapshot_state()
                        for rv in self.running.values()}
        sources: Dict[str, Dict[str, Any]] = {}
        for uid, split_id, reader in getattr(self, "_split_readers", []):
            pos = getattr(reader, "position", None)
            if pos is not None:
                sources.setdefault(uid, {})[split_id] = pos
        if sources:
            snapshot["__sources__"] = sources
        if self.checkpoint_storage is not None:
            # any object with ``store(id, snapshot)`` (the storages of
            # ``runtime/checkpoint/``)
            self.checkpoint_storage.store(checkpoint_id, snapshot)
            # checkpoint durable -> commit side effects (CheckpointListener.
            # notifyCheckpointComplete: two-phase-commit sinks publish here)
            for rv in self.running.values():
                rv.operator.notify_checkpoint_complete(checkpoint_id)
        return snapshot

"""Subtask: one parallel instance of a job vertex, on its own thread.

Analog of ``runtime/taskmanager/Task.java:564`` + the StreamTask mailbox
(``MailboxProcessor.java:66``): a dedicated thread runs a loop whose default
action is polling input channels and whose "mail" is the command queue
(checkpoint triggers, cancel).  All operator mutation happens on this one
thread — the reference's single-writer discipline.

Covers both task flavors:
- **SourceSubtask** (``SourceStreamTask`` analog): drives a split iterator,
  injects checkpoint barriers *between* elements on command (trigger RPC →
  mail, same as the reference's source-task checkpoint trigger, SURVEY §3.4),
  and snapshots its replay offset (element count) — the FLIP-27
  split-state analog for deterministic replayable sources.
- **Subtask**: consumes input channels with per-channel watermark valves
  (``StatusWatermarkValve``) and ALIGNED barrier handling: a channel that
  delivered barrier N stops being polled until every channel delivered N
  (``SingleCheckpointBarrierHandler.processBarrier:194``), then the operator
  snapshot is taken and the barrier forwarded downstream.

The port's copy of ``flink_tpu/cluster/task.py`` (host Python, as JAX's).
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from flink_tpu_torch.core.batch import (LONG_MIN, MAX_WATERMARK, CheckpointBarrier,
                                  EndOfInput, LatencyMarker, RecordBatch,
                                  StreamElement, StreamStatus, TaggedBatch,
                                  Watermark)
from flink_tpu_torch.core.functions import RuntimeContext
from flink_tpu_torch.cluster.channels import (LocalChannel, OutputDispatcher,
                                        element_bytes)
from flink_tpu_torch.observability import tracing
from flink_tpu_torch.runtime.executor import WatermarkValve
from flink_tpu_torch.testing import chaos
from flink_tpu_torch.utils import clock
from flink_tpu_torch.utils.clock import MonotoneElapsed


class AlignmentBufferOverflowError(RuntimeError):
    """The blocked-channel alignment queue hit its configured cap
    (``execution.checkpointing.alignment-queue-max-elements``) while
    alignment-timeout escalation is DISABLED: the subtask cannot keep
    buffering barrier-blocked data without growing memory without bound,
    and it cannot escalate to an unaligned checkpoint either.  A loud,
    classified failure beats silent unbounded growth; enable
    ``alignment_timeout_ms`` (or raise the cap) to let the barrier
    overtake instead."""


class TaskStates:
    DEPLOYING = "DEPLOYING"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    CANCELED = "CANCELED"
    FAILED = "FAILED"


class _Cancel(Exception):
    pass


class SubtaskBase:
    #: set by the deploying cluster when incremental checkpointing is on:
    #: periodic checkpoint cuts run inside snapshot_scope(incremental=True)
    #: so delta-tracking operators may ship increments.  Savepoints and
    #: final (FLIP-147) snapshots stay full regardless — they are the
    #: rescale/interchange format
    incremental_checkpoints = False

    def __init__(self, vertex_uid: str, subtask_index: int, operator,
                 outputs: Sequence[OutputDispatcher],
                 ctx: RuntimeContext,
                 listener: "TaskListener"):
        self.vertex_uid = vertex_uid
        self.subtask_index = subtask_index
        self.operator = operator
        self.outputs = list(outputs)
        self.ctx = ctx
        self.listener = listener
        self.commands: "queue.Queue[tuple]" = queue.Queue()
        self.state = TaskStates.DEPLOYING
        self._thread: Optional[threading.Thread] = None
        self._cancelled = threading.Event()
        #: busy/idle/backpressure time accounting (TimerGauge analog,
        #: ``runtime/metrics/TimerGauge.java`` — surfaced by the REST API)
        self.busy_ns = 0
        self.idle_ns = 0
        self.backpressure_ns = 0
        self.records_in = 0
        self.records_out = 0
        #: per-(source, hop) latency recorder (observability/latency.py):
        #: attached by the deploying cluster; every LatencyMarker this
        #: subtask sees records marked_time→now at THIS hop
        self.latency_tracker = None
        #: deploy barrier (threading.Barrier, set by the cluster before
        #: start()): no subtask of one deployment processes input until
        #: EVERY subtask finished open+restore.  Shared-instance sinks
        #: (the collect path) restore by REPLACING their rows; a sibling
        #: appending a fire before the owner subtask's restore ran would
        #: be silently wiped — rescale redeploys hit exactly that race
        self._deploy_gate = None

    # -- lifecycle -----------------------------------------------------------
    def start(self, restore: Optional[Dict[str, Any]] = None) -> None:
        self._restore = restore
        self._thread = threading.Thread(
            target=self._run,
            name=f"task-{self.vertex_uid}-{self.subtask_index}", daemon=True)
        self._thread.start()

    def cancel(self) -> None:
        self._cancelled.set()
        self._abort_deploy_gate()   # a task parked at the barrier must wake
        self.commands.put(("cancel",))
        # Unblock a task thread stuck in a full output channel (backpressure
        # from a dead downstream) or an empty input poll: closed channels
        # refuse puts and wake waiters, so the loop reaches _check_cancel.
        for out in self.outputs:
            for ch in getattr(out, "channels", []):
                ch.close()
        for ch in getattr(self, "inputs", []):
            ch.close()

    def join(self, timeout_s: float = 10.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    # -- shared plumbing -----------------------------------------------------
    def _emit(self, elements: Sequence[StreamElement]) -> None:
        t0 = time.monotonic_ns()
        for el in elements:
            if isinstance(el, RecordBatch):
                self.records_out += len(el)
            for out in self.outputs:
                out.emit(el)
        # time spent pushing into (possibly full) output channels is
        # backpressure: the reference gauges recordWriter availability
        self.backpressure_ns += time.monotonic_ns() - t0

    def _transition(self, state: str, error: Optional[str] = None) -> None:
        self.state = state
        self.listener.task_state_changed(self.vertex_uid, self.subtask_index,
                                         state, error)

    def _open_and_restore(self) -> None:
        self.operator.open(self.ctx)
        self._opened = True
        if self._restore is not None and self._restore.get("operator") is not None:
            self.operator.restore_state(self._restore["operator"])

    def _check_cancel(self) -> None:
        if self._cancelled.is_set():
            raise _Cancel()

    def _wait_deploy_gate(self) -> None:
        """Hold at the deploy barrier until every sibling subtask finished
        open+restore.  Broken/timed-out barriers (a sibling failed during
        restore, cancel during deploy) degrade to the old
        start-immediately behavior — liveness first."""
        gate = self._deploy_gate
        if gate is None:
            return
        try:
            gate.wait(timeout=30.0)
        except threading.BrokenBarrierError:
            pass

    def _abort_deploy_gate(self) -> None:
        gate = self._deploy_gate
        if gate is not None:
            try:
                gate.abort()
            except Exception:  # noqa: BLE001 — best-effort wakeup
                pass

    def _run(self) -> None:
        try:
            if self._restore is not None and self._restore.get("finished"):
                # restored from a FINAL snapshot (FLIP-147): this task's
                # data is already reflected in every downstream snapshot of
                # the same checkpoint — only the channel-TERMINATION
                # signals must be replayed, or downstream restored tasks
                # would wait forever.  That is BOTH signals the original
                # emitted: the final MAX watermark and EndOfInput.  A
                # downstream subtask restored with a fresh valve (a
                # rescale redeploy) still holds not-yet-fired event-time
                # state; without the watermark those windows would never
                # fire — records silently lost at end of stream.  The
                # watermark is monotone, so downstreams whose valve
                # already saw MAX absorb the duplicate as a no-op.  The
                # state must still be MATERIALIZED in the operator
                # instance: terminal collection (chained collect sinks)
                # reads rows from the live operator, not the snapshot dict
                self.final_snapshot = dict(self._restore)
                self._open_and_restore()
                self._transition(TaskStates.RUNNING)
                self._wait_deploy_gate()
                self._emit([Watermark(MAX_WATERMARK), EndOfInput()])
                self._transition(TaskStates.FINISHED)
                return
            self._open_and_restore()
            self._transition(TaskStates.RUNNING)
            self._wait_deploy_gate()
            self._invoke()
            # FLIP-147 (checkpoints after tasks finish): capture the FINAL
            # state so checkpoints completing after this task ends still
            # contain its contribution — restoring such a checkpoint must
            # not lose finished subtasks' state
            self.final_snapshot = self._final_snapshot()
            self._closed = True   # before close(): a close() that raises
            #                       mid-teardown must not be re-entered below
            self.operator.close()
            self._transition(TaskStates.FINISHED)
        except _Cancel:
            self._abort_deploy_gate()   # siblings must not wait on us
            self._transition(TaskStates.CANCELED)
        except Exception as e:  # noqa: BLE001
            self._abort_deploy_gate()   # a failed restore unblocks siblings
            traceback.print_exc()
            self._transition(TaskStates.FAILED, f"{type(e).__name__}: {e}")
        finally:
            # FAILED/CANCELED tasks must still release operator resources
            # (managed-memory reservations, spill files, sockets): the slot's
            # MemoryManager pool is reused across pipelined-region restarts,
            # so a leaked reservation compounds until reserve_managed fails
            # permanently inside open() (Task.releaseResources in the
            # reference runs on every terminal state, not just FINISHED)
            if getattr(self, "_opened", False) and not getattr(self, "_closed", False):
                try:
                    self.operator.close()
                except Exception:  # noqa: BLE001
                    pass  # teardown best-effort; original failure already reported

    def _invoke(self) -> None:
        raise NotImplementedError

    def _tick_processing_time(self) -> None:
        """Periodic ProcessingTimeService tick on the task thread (the
        reference's timer callbacks run on the mailbox): fires due
        processing-time timers through the operator between elements.
        Rate-limited on RAW monotonic time; the time handed to the
        operator reads through the injectable clock seam and is clamped
        MONOTONE here, so a chaos ``ClockSkew`` backward step can neither
        rewind processing time nor re-fire timers."""
        mono = time.monotonic()
        if mono - getattr(self, "_last_tick_mono", 0.0) < 0.05:
            return
        self._last_tick_mono = mono
        from flink_tpu_torch.utils import clock
        now = max(clock.now_ms(), getattr(self, "_proc_now_ms", 0))
        self._proc_now_ms = now
        out = self.operator.on_processing_time(now)
        if out:
            self._emit(out)

    def _final_snapshot(self) -> Dict[str, Any]:
        return {"operator": self.operator.snapshot_state(), "finished": True}


class SourceSubtask(SubtaskBase):
    """Runs one source split (static deploy) OR a runtime-assigned split
    sequence (FLIP-27 coordination: ``split_requester`` pulls splits from
    the job's ``SourceCoordinator``, the ``RequestSplitEvent`` loop of
    ``SourceCoordinator.java:155-170``); checkpoints replay offsets and the
    in-flight split."""

    def _final_snapshot(self) -> Dict[str, Any]:
        snap = {"operator": self.operator.snapshot_state(),
                "source_offset": self._emitted, "finished": True}
        if self.split_requester is not None:
            # split ownership must survive into checkpoints completed AFTER
            # this reader finished, or restore re-reads its splits
            snap["current_split"] = self._current_split
            snap["finished_splits"] = list(self._finished_splits)
        return snap

    def __init__(self, vertex_uid: str, subtask_index: int, operator,
                 outputs, ctx, listener, split,
                 split_requester=None):
        super().__init__(vertex_uid, subtask_index, operator, outputs, ctx,
                         listener)
        self.split = split
        #: dynamic mode: () -> (split | None, done) — None+not-done means
        #: poll again (the directory may grow)
        self.split_requester = split_requester
        self._emitted = 0          # elements pulled from the current split
        self._current_split = split
        #: dynamic mode: split IDS fully consumed by THIS reader —
        #: snapshotted so a split finished between the enumerator's
        #: trigger-time snapshot and this reader's barrier is still
        #: reclaimed on restore (its records were emitted pre-barrier;
        #: re-reading would duplicate).  Ids, not split objects, and pruned
        #: once a checkpoint containing them COMPLETES (the enumerator's own
        #: snapshot in that checkpoint already covers older assignments), so
        #: snapshot size stays bounded on long-running dynamic sources.
        self._finished_splits: list = []
        self._finished_in_ckpt: Dict[int, int] = {}  # cid -> total at snapshot
        self._finished_total = 0
        self._finished_pruned = 0
        #: stop-with-savepoint: a paused source emits nothing but keeps
        #: serving its command queue (so the savepoint barrier still flows)
        self._paused = threading.Event()
        #: emit a LatencyMarker every N batches (0 = off); the markers ride
        #: the dataflow around user functions (``LatencyMarker.java:32``)
        self.latency_marker_interval = 0
        #: TIME-based emission cadence in ms (0 = off) — what the
        #: ``metrics.latency.interval`` config key wires to; read through
        #: the injectable clock seam so ClockSkew chaos covers latency
        #: tracking like it covers timers.  Batch-based interval wins when
        #: both are set (back-compat with the raw attribute).
        self.latency_marker_interval_ms = 0
        self._last_marker_wall_ms: Optional[int] = None

    def _invoke(self) -> None:
        if self.split_requester is None:
            skip = (self._restore or {}).get("source_offset", 0)
            self._read_split(self.split, skip)
        else:
            restore = self._restore or {}
            cur = restore.get("current_split")
            skip = restore.get("source_offset", 0)
            self._finished_splits = list(restore.get("finished_splits", []))
            self._finished_total = len(self._finished_splits)
            while True:
                if cur is None:
                    self._check_cancel()
                    self._drain_commands()
                    cur, done = self.split_requester()
                    if cur is None:
                        if done:
                            break
                        time.sleep(0.01)   # nothing yet: poll again
                        continue
                    skip = 0
                self._current_split = cur
                self._read_split(cur, skip)
                self._finished_splits.append(self._split_id_of(cur))
                self._finished_total += 1
                self._current_split = cur = None
                self._emitted = 0
        # bounded end: final watermark flushes event-time state downstream
        wm = Watermark(MAX_WATERMARK)
        self._emit(self.operator.process_watermark(wm))
        self._emit([wm])
        self._emit(self.operator.end_input())
        self._emit([EndOfInput()])

    def _read_split(self, split, skip: int) -> None:
        it = iter(split.read())
        for _ in range(skip):      # deterministic replay: skip to the offset
            try:
                next(it)
            except StopIteration:
                break
        self._emitted = skip
        while True:
            self._check_cancel()
            self._drain_commands()
            self._tick_processing_time()
            if self._paused.is_set():
                time.sleep(0.002)  # paused: commands/cancel only
                continue
            try:
                el = next(it)
            except StopIteration:
                break
            self._emitted += 1
            if isinstance(el, RecordBatch):
                # fault point: crash-mid-stream in the source thread (the
                # task FAILs; the restart strategy drives recovery)
                chaos.fire("subtask.run", task=self.vertex_uid,
                           subtask=self.subtask_index)
                self.records_in += len(el)
                self._batches_since_marker = getattr(
                    self, "_batches_since_marker", 0) + 1
                if self._marker_due():
                    self._batches_since_marker = 0
                    # marked_time through the clock seam (not time.time()):
                    # the ClockSkew nemesis must cover latency tracking
                    self._emit([LatencyMarker(clock.now_ms_f() / 1000.0,
                                              subtask_index=self.subtask_index,
                                              source=self.vertex_uid)])
                t0 = time.monotonic_ns()
                out = self.operator.process_batch(el)
                self.busy_ns += time.monotonic_ns() - t0
                self._emit(out)
            elif isinstance(el, Watermark):
                self._emit(self.operator.process_watermark(el))
                if self.operator.forwards_watermarks:
                    self._emit([el])
            else:
                self._emit([el])

    def _marker_due(self) -> bool:
        """Latency-marker cadence: batch-count interval when configured,
        else the wall-clock interval of ``metrics.latency.interval``."""
        if self.latency_marker_interval:
            return (self._batches_since_marker
                    >= self.latency_marker_interval)
        if self.latency_marker_interval_ms:
            now = clock.now_ms()
            last = self._last_marker_wall_ms
            if last is None or now - last >= self.latency_marker_interval_ms \
                    or now < last:          # skew step backward: re-arm
                self._last_marker_wall_ms = now
                return True
        return False

    def _drain_commands(self) -> None:
        while True:
            try:
                cmd = self.commands.get_nowait()
            except queue.Empty:
                return
            if cmd[0] == "checkpoint":
                cid = cmd[1]
                # savepoint barriers stay ALIGNED end-to-end (no barrier
                # overtake, no channel state): the snapshot must remain
                # rescalable/rewritable (drain-then-rescale contract)
                sp = bool(cmd[2]) if len(cmd) > 2 else False
                from flink_tpu_torch.operators.base import snapshot_scope
                try:
                    chaos.fire("subtask.snapshot", task=self.vertex_uid,
                               subtask=self.subtask_index, checkpoint=cid)
                    # drain async emissions downstream BEFORE the barrier
                    prep = getattr(self.operator,
                                   "prepare_snapshot_pre_barrier", None)
                    if prep is not None:
                        self._emit(prep())
                    with tracing.span("checkpoint.snapshot",
                                      cat="checkpoint", checkpoint=cid,
                                      task=self.vertex_uid,
                                      subtask=self.subtask_index), \
                            snapshot_scope(
                                cid, self.incremental_checkpoints
                                and not sp):
                        snap = {"operator": self.operator.snapshot_state(),
                                "source_offset": self._emitted}
                except _Cancel:
                    raise
                except Exception as e:  # noqa: BLE001
                    # snapshot failure DECLINES the checkpoint instead of
                    # killing the task (CheckpointException -> decline);
                    # the barrier still flows so downstream alignment ends
                    self._emit([CheckpointBarrier(cid, timestamp=0,
                                                  is_savepoint=sp)])
                    self.listener.decline_checkpoint(
                        cid, self.vertex_uid, self.subtask_index,
                        f"{type(e).__name__}: {e}")
                    continue
                if self.split_requester is not None:
                    # dynamic mode: the in-flight split AND consumed splits
                    # are reader state (the enumerator's own snapshot can
                    # race assignments made after the trigger)
                    snap["current_split"] = self._current_split
                    snap["finished_splits"] = list(self._finished_splits)
                    self._finished_in_ckpt[cid] = self._finished_total
                barrier = CheckpointBarrier(cid, timestamp=0,
                                            is_savepoint=sp)
                self._emit([barrier])
                self.listener.acknowledge_checkpoint(
                    cid, self.vertex_uid, self.subtask_index, snap)
            elif cmd[0] == "notify_complete":
                self.operator.notify_checkpoint_complete(cmd[1])
                self._prune_finished(cmd[1])
            elif cmd[0] == "cancel":
                raise _Cancel()

    def _split_id_of(self, split) -> str:
        from flink_tpu_torch.connectors.sources import split_id_of
        return split_id_of(split)

    def _prune_finished(self, completed_cid: int) -> None:
        """Drop finished-split ids already covered by a COMPLETED checkpoint:
        a restore from that checkpoint (or any later one) re-marks them via
        the enumerator's own snapshotted assigned-set."""
        covered = [c for c in self._finished_in_ckpt if c <= completed_cid]
        if not covered:
            return
        high = max(self._finished_in_ckpt.pop(c) for c in covered)
        drop = high - self._finished_pruned
        if drop > 0:
            del self._finished_splits[:drop]
            self._finished_pruned = high


class Subtask(SubtaskBase):
    """Channel-consuming subtask with aligned, unaligned, or
    aligned-with-timeout barrier handling.

    Aligned (default): a channel that delivered barrier N stops being
    processed until every channel delivered N
    (``SingleCheckpointBarrierHandler`` semantics) — its post-barrier
    elements buffer in a bounded per-subtask alignment queue
    (``alignment_queue_max`` elements; overflow raises the classified
    :class:`AlignmentBufferOverflowError` when escalation is disabled).

    Unaligned (``unaligned=True`` / ``alignment_timeout_ms=0``): the
    barrier OVERTAKES — on first arrival the operator snapshots and the
    barrier is forwarded immediately; the in-flight elements queued in (or
    still arriving on) not-yet-barriered channels are recorded as
    **channel state** in the snapshot while also being processed; the ack
    happens once every channel delivered the barrier
    (``ChannelStateWriterImpl`` analog).  On restore the recorded elements
    are replayed into the operator BEFORE any new input.

    Aligned-with-timeout (``alignment_timeout_ms > 0``, FLIP-76's
    ``execution.checkpointing.alignment-timeout``): start aligned; once
    alignment exceeds the timeout (measured through the injectable clock
    seam, monotone under ClockSkew) the handler ESCALATES to the unaligned
    path — checkpoint duration stops depending on backpressure.
    """

    def __init__(self, vertex_uid: str, subtask_index: int, operator,
                 outputs, ctx, listener,
                 input_channels: Sequence[LocalChannel],
                 unaligned: bool = False,
                 input_logical: Optional[Sequence[int]] = None,
                 alignment_timeout_ms: Optional[float] = None,
                 alignment_queue_max: int = 8192,
                 input_routing: Optional[Sequence[Dict[str, Any]]] = None):
        super().__init__(vertex_uid, subtask_index, operator, outputs, ctx,
                         listener)
        self.inputs = list(input_channels)
        self.unaligned = unaligned
        #: per-input-channel routing metadata the deploying cluster
        #: captured from the edge ({"partitioning", "key_column",
        #: "max_parallelism", "logical"}): written into the v2
        #: channel-state section so a RESCALE restore can re-route each
        #: persisted in-flight element by the record's own key
        #: (state/redistribute.redistribute_channel_state)
        self.input_routing = ([dict(r) for r in input_routing]
                              if input_routing is not None
                              else [{} for _ in self.inputs])
        #: None = stay aligned forever; 0 = overtake at first arrival
        #: (pure unaligned); >0 = aligned-with-timeout escalation
        self.alignment_timeout_ms = (
            0.0 if unaligned and alignment_timeout_ms is None
            else alignment_timeout_ms)
        self.alignment_queue_max = max(1, int(alignment_queue_max))
        #: physical channel index -> logical input port (two-input operators)
        self.input_logical = (list(input_logical) if input_logical is not None
                              else [0] * len(self.inputs))
        # ---- barrier-handler state (initialized here so job_status() can
        # read the gauges before/while the task thread runs) ----
        self._ended = [False] * len(self.inputs)
        self._barriered: Dict[int, int] = {}   # channel idx -> barrier id
        self._pending_barrier: Optional[CheckpointBarrier] = None
        self._pending_snapshot: Optional[Dict[str, Any]] = None
        self._snapshot_error: Optional[str] = None
        self._overtaken = False                # barrier already overtook
        self._channel_state: List[tuple] = []  # [(input_idx, element), ...]
        self._cs_bytes = 0                     # persisted in-flight bytes
        self._overtaken_bytes = 0
        self._align_queue: List[deque] = [deque()
                                          for _ in range(len(self.inputs))]
        self._align_queued = 0                 # elements across channels
        self._align_timer: Optional[MonotoneElapsed] = None
        #: announcement timer: a barrier QUEUED behind a backlog starts the
        #: clock before the consumer ever drains to it (Flink's priority
        #: barrier announcement); inherited by the alignment timer
        self._announce_timer: Optional[MonotoneElapsed] = None
        self._force_escalate = False
        #: highest barrier id this subtask ever started aligning on: a
        #: LOWER-id barrier finally draining out of a backlog is STALE
        #: (its checkpoint was superseded/expired) and must be dropped,
        #: never allowed to abort a healthy newer alignment
        self._max_barrier_cid = 0
        #: queue-depth gauge peaks: lifetime (the job_status gauge) and
        #: per-alignment (reset at each first barrier — what
        #: last_checkpoint_stats reports, so one historical deep backlog
        #: is never misattributed to later checkpoints)
        self.alignment_queue_peak = 0
        self._align_peak_ckpt = 0
        self.last_checkpoint_stats: Dict[str, Any] = {}

    # ------------------------------------------------------ observability
    @property
    def alignment_queued(self) -> int:
        return self._align_queued

    def channel_stats(self) -> List[Dict[str, Any]]:
        """Per-input-channel backpressure view (monitoring-grade): queue
        depth + bytes and the producer's accumulated credit-wait time."""
        out = []
        for i, ch in enumerate(self.inputs):
            depth_fn = getattr(ch, "depth", None)
            bytes_fn = getattr(ch, "queued_bytes", None)
            out.append({
                "name": getattr(ch, "name", f"in{i}"),
                "depth": int(depth_fn() if depth_fn else len(ch)),
                "queued_bytes": int(bytes_fn()) if bytes_fn else 0,
                "backpressured_ms": round(
                    getattr(ch, "backpressured_ns", 0) / 1e6, 3)})
        return out

    # ------------------------------------------------------------ driving
    def _is_blocked(self, i: int) -> bool:
        """Aligned-phase block: the channel delivered the pending barrier
        and the barrier has not (yet) overtaken."""
        return (self._pending_barrier is not None and not self._overtaken
                and i in self._barriered)

    def _invoke(self) -> None:
        n = len(self.inputs)
        self._valve = WatermarkValve(n)
        # restore the valve FIRST: channel-state replay may carry watermarks
        # (upstream will not resend them), which must advance past the
        # snapshot-time valve, not be clobbered by it
        restored_valve = (self._restore or {}).get("valve")
        if restored_valve is not None:
            self._valve.restore(restored_valve)
        # unaligned restore: replay persisted in-flight channel state into
        # the operator BEFORE any new input (versioned v1 section; legacy
        # bare lists still restore)
        for i, el in self._restored_channel_state():
            self._handle_data(i, el)
        while not all(self._ended):
            self._check_cancel()
            self._drain_commands()
            self._tick_processing_time()
            self._maybe_escalate()
            self._check_announcements()
            progressed = False
            for i, ch in enumerate(self.inputs):
                if self._ended[i]:
                    continue
                el = ch.poll(timeout_s=0.0)
                if el is None:
                    continue
                progressed = True
                if self._is_blocked(i):
                    self._enqueue_aligned(i, el)
                else:
                    self._handle(i, el)
            if not progressed:
                # input momentarily empty: the driver decides this is a
                # pipeline flush point — complete the operator's in-flight
                # hot stages rather than letting results wait on the NEXT
                # batch's arrival (no-op for non-pipelined operators;
                # getattr: duck-typed test operators need not subclass)
                flush = getattr(self.operator, "flush_pipeline", None)
                if flush is not None:
                    self._emit(flush())
                # nothing readable: brief blocking poll on one open channel
                t0 = time.monotonic_ns()
                for i, ch in enumerate(self.inputs):
                    if not self._ended[i] and not self._is_blocked(i):
                        el = ch.poll(timeout_s=0.01)
                        if el is not None:
                            self.idle_ns += time.monotonic_ns() - t0
                            self._handle(i, el)
                        else:
                            self.idle_ns += time.monotonic_ns() - t0
                        break
        self._emit(self.operator.end_input())
        self._emit([EndOfInput()])

    def _restored_channel_state(self) -> List[tuple]:
        cs = (self._restore or {}).get("channel_state")
        if not cs:
            return []
        if isinstance(cs, dict):
            from flink_tpu_torch.state.redistribute import CHANNEL_STATE_VERSIONS
            version = cs.get("version")
            if version not in CHANNEL_STATE_VERSIONS:
                raise ValueError(
                    f"unknown channel-state snapshot version {version!r} "
                    f"(this runtime reads "
                    f"{'/'.join(f'v{v}' for v in CHANNEL_STATE_VERSIONS)})"
                    f" — the checkpoint was written by an incompatible "
                    f"runtime")
            elements = list(cs.get("elements", []))
            if cs.get("by_logical_port"):
                # rescale-redistributed section: elements are keyed by
                # LOGICAL input port (the old physical channel indices
                # died with the old topology) — replay each on the first
                # input channel of its port
                mapped = []
                for port, el in elements:
                    try:
                        i = self.input_logical.index(port)
                    except ValueError:
                        i = 0
                    mapped.append((i, el))
                return mapped
            return elements
        return list(cs)   # legacy: bare [(i, el), ...] list

    def _handle(self, i: int, el: StreamElement) -> None:
        """Single dispatch point for every input element (the mailbox default
        action), including barrier bookkeeping."""
        if isinstance(el, CheckpointBarrier):
            pending = self._pending_barrier
            cid = el.checkpoint_id
            if cid < self._max_barrier_cid:
                # STALE: this barrier's checkpoint was already superseded
                # (it expired while the barrier sat behind a backlog).
                # Its alignment can never complete — every other channel
                # consumed it long ago — so dropping it is the only move
                # that does not abort a HEALTHY newer alignment and
                # cascade spurious declines downstream
                return
            if pending is not None and cid > pending.checkpoint_id:
                # the coordinator gave up on the pending checkpoint (it
                # expired) and triggered a NEWER one: abandon the stale
                # alignment — its recorded channel state belongs to the
                # aborted checkpoint and must not leak into this one
                self._abort_alignment(f"superseded by checkpoint {cid}")
            first = self._pending_barrier is None
            if first:
                tracing.instant("checkpoint.barrier", cat="checkpoint",
                                checkpoint=cid, task=self.vertex_uid,
                                subtask=self.subtask_index)
                self._pending_barrier = el
                self._max_barrier_cid = max(self._max_barrier_cid, cid)
                self._overtaken = False
                self._pending_snapshot = None
                self._snapshot_error = None
                self._channel_state = []
                self._cs_bytes = 0
                self._overtaken_bytes = 0
                self._align_peak_ckpt = 0
                # alignment timer through the injectable clock seam,
                # clamped monotone (ClockSkew must not un-expire it);
                # an announcement that preceded the barrier's arrival
                # already started the clock — alignment time measures
                # from the barrier ENTERING the input, not being drained
                self._align_timer = (self._announce_timer
                                     if self._announce_timer is not None
                                     else MonotoneElapsed())
                self._announce_timer = None
            self._barriered[i] = cid
            if first and not el.is_savepoint \
                    and (self.alignment_timeout_ms == 0
                         or self._force_escalate):
                self._escalate()   # pure unaligned / announced overtake
            self._maybe_complete_alignment()
        elif isinstance(el, EndOfInput):
            self._ended[i] = True
            # a channel ending mid-alignment completes the barrier
            self._maybe_complete_alignment()
        else:
            if (self._pending_barrier is not None and self._overtaken
                    and i not in self._barriered):
                # pre-barrier in-flight data on a not-yet-barriered channel
                # after the overtake: record into channel state AND process
                self._channel_state.append((i, el))
                self._cs_bytes += element_bytes(el)
            self._handle_data(i, el)

    # ------------------------------------------------ alignment machinery
    def _enqueue_aligned(self, i: int, el: StreamElement) -> None:
        """Aligned phase: buffer a blocked channel's post-barrier element.
        The queue is the bounded stand-in for the reference's
        blocked-channel buffer accumulation; its cap either escalates to
        unaligned or fails loudly — never unbounded growth."""
        if self._align_queued >= self.alignment_queue_max:
            barrier = self._pending_barrier
            if barrier is not None and barrier.is_savepoint:
                # a USER-TRIGGERED savepoint must not kill the job: abort
                # just this savepoint (decline + release the buffered
                # elements + forward its barrier) — savepoint() reports
                # None and the job keeps running, memory stays bounded
                self._abort_alignment(
                    f"savepoint {barrier.checkpoint_id} alignment queue "
                    f"overflow ({self._align_queued} elements, cap "
                    f"{self.alignment_queue_max}): savepoints cannot "
                    f"escalate to unaligned — retry once backpressure "
                    f"clears, or raise "
                    f"execution.checkpointing.alignment-queue-max-elements")
                self._process_overtaken(i, el)
                return
            if self.alignment_timeout_ms is not None:
                # cap pressure escalates like timeout expiry does (the
                # size-based escalation of FLIP-182): the overtake drains
                # the queues, then this element processes in FIFO order
                self._escalate()
                self._maybe_complete_alignment()
                self._process_overtaken(i, el)
                return
            msg = (f"alignment queue overflow: {self._align_queued} "
                   f"elements buffered from barrier-blocked channels "
                   f"(cap {self.alignment_queue_max}) while aligning "
                   f"checkpoint "
                   f"{barrier.checkpoint_id if barrier else '?'} and "
                   f"alignment-timeout escalation is disabled — enable "
                   f"execution.checkpointing.alignment-timeout or raise "
                   f"execution.checkpointing.alignment-queue-max-elements")
            if barrier is not None:
                self.listener.decline_checkpoint(
                    barrier.checkpoint_id, self.vertex_uid,
                    self.subtask_index, msg)
            raise AlignmentBufferOverflowError(msg)
        self._align_queue[i].append(el)
        self._align_queued += 1
        self.alignment_queue_peak = max(self.alignment_queue_peak,
                                        self._align_queued)
        self._align_peak_ckpt = max(self._align_peak_ckpt,
                                    self._align_queued)

    def _maybe_escalate(self) -> None:
        """Aligned-with-timeout: escalate once the (monotone, skew-proof)
        alignment timer passes the configured timeout.  SAVEPOINTS never
        escalate: their whole point is a rescalable, rewritable snapshot,
        and channel state is neither (drain-then-rescale contract)."""
        if (self._pending_barrier is None or self._overtaken
                or self._pending_barrier.is_savepoint
                or self.alignment_timeout_ms is None
                or self._align_timer is None):
            return
        if self._align_timer.ms() >= self.alignment_timeout_ms:
            self._escalate()
            self._maybe_complete_alignment()

    def _check_announcements(self) -> None:
        """React to barriers QUEUED behind backlogs (the priority-event
        announcement): before any barrier was drained, an announcement
        starts the alignment clock and — on expiry — the handler jumps the
        queue to the barrier; after an overtake, announced pending-cid
        barriers on laggard channels are extracted the moment they arrive
        instead of waiting for the (backpressured) drain to reach them."""
        if self.alignment_timeout_ms is None:
            return
        if self._pending_barrier is None:
            ann = None
            for i, ch in enumerate(self.inputs):
                if self._ended[i]:
                    continue
                fn = getattr(ch, "announced_barrier", None)
                cid = fn() if fn is not None else None
                if cid is not None:
                    ann = (i, cid)
                    break
            if ann is None:
                self._announce_timer = None
                return
            i, cid = ann
            take = getattr(self.inputs[i], "take_until_barrier", None)
            if take is None:
                return
            if cid < self._max_barrier_cid:
                # a STALE barrier buried in the backlog: extract it so it
                # stops shadowing newer announcements; the elements in
                # front of it are live data, the barrier itself is dropped
                els, _bar = take(cid)
                for el in els:
                    self._process_overtaken(i, el)
                return
            if self._announce_timer is None:
                self._announce_timer = MonotoneElapsed()
            if self._announce_timer.ms() < self.alignment_timeout_ms:
                return
            # announced barrier still buried: extract it — the elements in
            # front of it are PRE-barrier and PRE-snapshot, so they process
            # normally (into the operator snapshot); then the barrier
            # overtakes immediately (savepoint barriers instead START a
            # normal ALIGNED alignment — savepoints never escalate)
            els, bar = take(cid)
            for el in els:
                self._process_overtaken(i, el)
            if bar is not None:
                self._force_escalate = not bar.is_savepoint
                try:
                    self._handle(i, bar)
                finally:
                    self._force_escalate = False
        elif self._overtaken:
            cid = self._pending_barrier.checkpoint_id
            for i, ch in enumerate(self.inputs):
                if self._ended[i] or i in self._barriered:
                    continue
                fn = getattr(ch, "announced_barrier", None)
                acid = fn() if fn is not None else None
                take = getattr(ch, "take_until_barrier", None)
                if acid is None or take is None:
                    continue
                if acid < cid:
                    # stale barrier shadowing the pending one: its
                    # in-front elements are still pre-PENDING-barrier
                    # in-flight data — record them; drop the barrier
                    els, _bar = take(acid)
                else:
                    if acid != cid:
                        continue
                    els, bar = take(cid)
                    if bar is not None:
                        self._barriered[i] = cid
                replay = []
                for el in els:
                    b = element_bytes(el)
                    self._cs_bytes += b
                    self._overtaken_bytes += b
                    self._channel_state.append((i, el))
                    replay.append(el)
                for el in replay:
                    self._process_overtaken(i, el)
            self._maybe_complete_alignment()

    def _escalate(self) -> None:
        """The barrier OVERTAKES: snapshot now, forward now, extract the
        in-flight elements queued in front of not-yet-delivered barriers
        into channel state, and unblock the aligned queues."""
        barrier = self._pending_barrier
        if barrier is None or self._overtaken:
            return
        cid = barrier.checkpoint_id
        from flink_tpu_torch.operators.base import snapshot_scope
        try:
            chaos.fire("subtask.snapshot", task=self.vertex_uid,
                       subtask=self.subtask_index, checkpoint=cid)
            prep = getattr(self.operator,
                           "prepare_snapshot_pre_barrier", None)
            if prep is not None:
                self._emit(prep())
            with tracing.span("checkpoint.snapshot", cat="checkpoint",
                              checkpoint=cid, task=self.vertex_uid,
                              subtask=self.subtask_index, overtake=True), \
                    snapshot_scope(cid, self.incremental_checkpoints
                                   and not barrier.is_savepoint):
                self._pending_snapshot = {
                    "operator": self.operator.snapshot_state(),
                    "valve": self._valve.snapshot()}
        except _Cancel:
            raise
        except Exception as e:  # noqa: BLE001
            # decline at alignment completion (barrier still flows)
            self._pending_snapshot = None
            self._snapshot_error = f"{type(e).__name__}: {e}"
        self._emit([barrier])
        self._overtaken = True
        replay: List[tuple] = []
        overtaken = 0
        # in-flight data the barrier jumps over: everything queued in
        # front of the barrier on not-yet-barriered channels is CHANNEL
        # STATE (persisted + processed); if the barrier itself is queued,
        # the channel counts as delivered without waiting for the
        # (backpressured) consumer to drain to it
        for i, ch in enumerate(self.inputs):
            if self._ended[i] or i in self._barriered:
                continue
            take = getattr(ch, "take_until_barrier", None)
            if take is None:
                continue
            els, bar = take(cid)
            for el in els:
                b = element_bytes(el)
                overtaken += b
                self._cs_bytes += b
                self._channel_state.append((i, el))
                replay.append((i, el))
            if bar is not None:
                self._barriered[i] = cid
        # unblock the aligned queues: their buffered elements are
        # POST-barrier data on already-delivered channels — overtaken by
        # the barrier, processed now, NOT part of the snapshot
        for i, q in enumerate(self._align_queue):
            while q:
                el = q.popleft()
                overtaken += element_bytes(el)
                replay.append((i, el))
        self._align_queued = 0
        self._overtaken_bytes += overtaken
        for i, el in replay:
            self._process_overtaken(i, el)

    def _process_overtaken(self, i: int, el: StreamElement) -> None:
        """Process an element released by an overtake/abort drain.  Data
        was already recorded into channel state where required, so it must
        NOT go back through ``_handle``'s recording path; barriers and
        end-of-input keep their full bookkeeping, and a NEW alignment
        started mid-drain re-blocks its channels."""
        if isinstance(el, (CheckpointBarrier, EndOfInput)):
            self._handle(i, el)
        elif self._is_blocked(i):
            self._enqueue_aligned(i, el)
        else:
            self._handle_data(i, el)

    def _abort_alignment(self, reason: str) -> None:
        """A superseding barrier invalidated the pending checkpoint: drop
        its recorded channel state, decline it (the coordinator already
        expired it — late declines are ignored), release the buffered
        elements, and make sure downstream alignment for it still ends."""
        barrier = self._pending_barrier
        if barrier is None:
            return
        cid = barrier.checkpoint_id
        was_overtaken = self._overtaken
        self._pending_barrier = None
        self._pending_snapshot = None
        self._snapshot_error = None
        self._overtaken = False
        self._channel_state = []
        self._cs_bytes = 0
        self._barriered.clear()
        self._align_timer = None
        queued: List[tuple] = []
        for i, q in enumerate(self._align_queue):
            while q:
                queued.append((i, q.popleft()))
        self._align_queued = 0
        for i, el in queued:
            self._process_overtaken(i, el)
        if not was_overtaken:
            # never forwarded: downstream alignment must still end
            self._emit([barrier])
        self.listener.decline_checkpoint(cid, self.vertex_uid,
                                         self.subtask_index, reason)

    def _emit_status_change(self, st) -> None:
        if st is not None:
            self._emit([StreamStatus(st)])

    def _handle_data(self, i: int, el: StreamElement) -> None:
        if isinstance(el, Watermark):
            self._emit_status_change(self._valve.record_activity(i))
            adv = self._valve.input_watermark(i, el.timestamp)
            if adv is not None:
                wm = Watermark(adv)
                self._emit(self.operator.process_watermark(wm))
                if self.operator.forwards_watermarks:
                    self._emit([wm])
        elif isinstance(el, StreamStatus):
            # idleness: drop the channel from the min; that alone can
            # advance event time (StatusWatermarkValve.markIdle)
            adv, combined, changed = self._valve.status_update(i, el.idle)
            if adv is not None:
                wm = Watermark(adv)
                self._emit(self.operator.process_watermark(wm))
                if self.operator.forwards_watermarks:
                    self._emit([wm])
            if changed:   # forward the SUBTASK's combined status, on change
                self._emit([StreamStatus(combined)])
        elif isinstance(el, TaggedBatch):
            if getattr(self.operator, "accepts_tag", None) == el.tag:
                self._emit(self.operator.process_tagged(el.batch))
        elif isinstance(el, RecordBatch):
            if len(el):
                # fault point: crash mid-stream in a consuming subtask
                chaos.fire("subtask.run", task=self.vertex_uid,
                           subtask=self.subtask_index)
                self._emit_status_change(self._valve.record_activity(i))
                self.records_in += len(el)
                t0 = time.monotonic_ns()
                if getattr(self.operator, "is_two_input", False):
                    out = self.operator.process_batch2(
                        el, self.input_logical[i])
                else:
                    out = self.operator.process_batch(el)
                self.busy_ns += time.monotonic_ns() - t0
                self._emit(out)
        elif isinstance(el, LatencyMarker):
            # LatencyMarker flows around user functions; sinks record it.
            # The hook may return elements to keep forwarding (chains).
            if self.latency_tracker is not None:
                # record marked_time→now at THIS hop: the sink hop's
                # histogram is the end-to-end latency, intermediate hops
                # decompose it per operator
                self.latency_tracker.record(el, self.vertex_uid)
            hook = getattr(self.operator, "on_latency_marker", None)
            if hook is not None:
                out = hook(el)
                if out:
                    self._emit(list(out))
            else:
                self._emit([el])
        else:
            self._emit([el])

    def _maybe_complete_alignment(self) -> None:
        if self._pending_barrier is None:
            return
        if not all(self._ended[j] or j in self._barriered
                   for j in range(len(self.inputs))):
            return
        barrier = self._pending_barrier
        self._take_checkpoint(barrier)
        self._barriered.clear()
        self._pending_barrier = None
        self._align_timer = None
        # aligned completion: the blocked channels' buffered post-barrier
        # elements process now, BEFORE any new poll of those channels
        # (overtaken completions drained them at escalation already)
        queued: List[tuple] = []
        for i, q in enumerate(self._align_queue):
            while q:
                queued.append((i, q.popleft()))
        self._align_queued = 0
        for i, el in queued:
            self._process_overtaken(i, el)

    def _record_checkpoint_stats(self, cid: int, align_ms: float,
                                 unaligned: bool, persisted: int) -> None:
        tracing.instant("checkpoint.alignment", cat="checkpoint",
                        checkpoint=cid, task=self.vertex_uid,
                        subtask=self.subtask_index,
                        alignment_ms=round(align_ms, 3),
                        unaligned=unaligned)
        self.last_checkpoint_stats = {
            "checkpoint_id": cid,
            "alignment_ms": round(align_ms, 3),
            "unaligned": unaligned,
            "overtaken_bytes": self._overtaken_bytes,
            "persisted_inflight_bytes": persisted,
            "alignment_queue_peak": self._align_peak_ckpt}

    def _take_checkpoint(self, barrier: CheckpointBarrier) -> None:
        cid = barrier.checkpoint_id
        align_ms = self._align_timer.ms() if self._align_timer else 0.0
        if self._overtaken:
            if self._pending_snapshot is None:
                # overtake-time snapshot failed: decline now that every
                # channel delivered the barrier (the recorded channel
                # state belongs to the aborted checkpoint — drop it)
                self._channel_state = []
                self._cs_bytes = 0
                self._record_checkpoint_stats(cid, align_ms, True, 0)
                self.listener.decline_checkpoint(
                    cid, self.vertex_uid, self.subtask_index,
                    self._snapshot_error or "snapshot failed")
                return
            snap = self._pending_snapshot
            # versioned channel-state section: the persisted in-flight
            # elements plus the overtake accounting.  v2 adds the
            # per-input routing metadata (key column / partitioning /
            # producer max-parallelism / logical port) that rescale-time
            # redistribution routes persisted elements by
            snap["channel_state"] = {
                "version": 2,
                "elements": list(self._channel_state),
                "inputs": [dict(r) for r in self.input_routing],
                "persisted_bytes": self._cs_bytes,
                "overtaken_bytes": self._overtaken_bytes,
                "alignment_ms": round(align_ms, 3),
                "unaligned": True}
            self._record_checkpoint_stats(cid, align_ms, True,
                                          self._cs_bytes)
            self._pending_snapshot = None
            self._channel_state = []
            self._cs_bytes = 0
            # barrier was already forwarded at the overtake
        else:
            from flink_tpu_torch.operators.base import snapshot_scope
            try:
                chaos.fire("subtask.snapshot", task=self.vertex_uid,
                           subtask=self.subtask_index, checkpoint=cid)
                prep = getattr(self.operator,
                               "prepare_snapshot_pre_barrier", None)
                if prep is not None:
                    self._emit(prep())
                with tracing.span("checkpoint.snapshot", cat="checkpoint",
                                  checkpoint=cid, task=self.vertex_uid,
                                  subtask=self.subtask_index), \
                        snapshot_scope(cid, self.incremental_checkpoints
                                       and not barrier.is_savepoint):
                    snap = {"operator": self.operator.snapshot_state(),
                            "valve": self._valve.snapshot()}
            except _Cancel:
                raise
            except Exception as e:  # noqa: BLE001
                self._emit([barrier])   # downstream alignment must end
                self._record_checkpoint_stats(cid, align_ms, False, 0)
                self.listener.decline_checkpoint(
                    cid, self.vertex_uid, self.subtask_index,
                    f"{type(e).__name__}: {e}")
                return
            snap["channel_state"] = {
                "version": 2, "elements": [],
                "inputs": [dict(r) for r in self.input_routing],
                "persisted_bytes": 0, "overtaken_bytes": 0,
                "alignment_ms": round(align_ms, 3), "unaligned": False}
            self._record_checkpoint_stats(cid, align_ms, False, 0)
            self._emit([barrier])
        self.listener.acknowledge_checkpoint(
            cid, self.vertex_uid, self.subtask_index, snap)

    def _drain_commands(self) -> None:
        while True:
            try:
                cmd = self.commands.get_nowait()
            except queue.Empty:
                return
            if cmd[0] == "notify_complete":
                self.operator.notify_checkpoint_complete(cmd[1])
            elif cmd[0] == "cancel":
                raise _Cancel()


def aggregate_channel_state(snapshots) -> Dict[str, Any]:
    """Roll up the subtask acks' channel-state (v1) sections for one
    completed checkpoint — shared by both coordinators so the schema has
    exactly one reader: max alignment across subtasks (the checkpoint's
    critical path), summed overtaken / persisted in-flight bytes, and
    whether ANY subtask's barrier overtook."""
    align_ms = 0.0
    overtaken = persisted = 0
    any_unaligned = False
    for snap in snapshots:
        cs = snap.get("channel_state") if isinstance(snap, dict) else None
        if isinstance(cs, dict):
            align_ms = max(align_ms, cs.get("alignment_ms", 0.0))
            overtaken += cs.get("overtaken_bytes", 0)
            persisted += cs.get("persisted_bytes", 0)
            any_unaligned |= bool(cs.get("unaligned"))
    return {"alignment_ms": round(align_ms, 3),
            "overtaken_bytes": overtaken,
            "persisted_inflight_bytes": persisted,
            "unaligned": any_unaligned}


class TaskListener:
    """Callbacks from subtask threads to the coordination layer."""

    def task_state_changed(self, vertex_uid: str, subtask_index: int,
                           state: str, error: Optional[str]) -> None:
        pass

    def acknowledge_checkpoint(self, checkpoint_id: int, vertex_uid: str,
                               subtask_index: int,
                               snapshot: Dict[str, Any]) -> None:
        pass

    def decline_checkpoint(self, checkpoint_id: int, vertex_uid: str,
                           subtask_index: int, error: str) -> None:
        """A task could not snapshot (``declineCheckpoint`` RPC analog):
        the coordinator aborts the pending checkpoint and charges it to
        the CheckpointFailureManager's tolerable budget."""
